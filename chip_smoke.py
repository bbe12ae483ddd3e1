#!/usr/bin/env python3
"""Smoke test of exonerate_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in the order they run, each of which raises on failure (the
script then exits non-zero and prints no result line):

1. Device: a CUDA card must be visible; prints its name and power limit.
2. Build: compiles csrc/*.cu with nvcc into build/cuda/ (one nvcc per
   source, all started together) and prints the build seconds and
   ptxas' register/shared-memory lines.
3. K6/K7 vs plain: the band kernels against the plain PyTorch band scan,
   exactly (boundary bits, column best, live, xband, band_end per
   locus), on a ragged batch of synthetic est2genome pairs and a ner
   joint-span pair (tests/torch_sdp_cases.py).  Then the
   est2genome_genomic golden through the port's CLI on the forced device
   route, byte-equal to the golden (this first heuristic run also builds
   the host's native libraries, so that phase 4 is timed warm).
4. The heuristic scan at full width (the main path of the band kernels):
   16 mutated calm cDNAs against a 1 Mb genome holding 8 spliced copies
   (benchmarks/genome_scan.py's recipe, rng 7), through the port's CLI
   with default routing and with EXONERATE_TPU_SDP=native; the outputs
   must be byte-equal, with 16 comparisons on cuda-sdp, K6/K7 launched,
   no fallback, 16/16 queries spliced and no plain-scan pass.  K6/K7
   are launched again on the scan's band batch, and worker processes
   start the plain passes over that batch on the CPU (in parallel, over
   slices of the batch), to be held against the kernels' outputs in
   phase 9.
5. K1 vs plain: est2genome, calm (tests/golden/data/all4.fa record 1)
   against itself, 2175x2175, B=64, score and region modes, plus a ragged
   batch; the kernel's outputs must equal the plain PyTorch version's
   exactly (score 10875).  Times both with CUDA events, in turns.
6. K4 + walk-back vs plain and vs the native dense DP, calm 2175^2 path.
7. CLI end to end: the port's CLI must reproduce the exhaustive_est2genome
   golden byte for byte and give vulgar score 10875 on calm x calm, with
   the kernels' launch counters above 0 and no engine fallback.
8. K6/K7 against the plain passes, exactly, on the est2genome_genomic
   comparison of phase 3, timed kernel vs plain with CUDA events, in
   turns.
9. The scan's plain check: every slice's plain pass must equal the
   kernels' outputs exactly (bits, live; column best, live, xband).

Phases 5-8 run on the card while the plain check of phase 4 runs on the
host's cores, so their host-clock and plain times share the host with
it.

The last three lines are nvidia-smi's name and power limit of the card,
a JSON object of the kernels (route, source, the TPU kernel each
replaces, main-path launches, max |kernel - plain|, kernel and plain
milliseconds), and the result object.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "golden", "data")
CALM_LEN = 2175
CALM_SELF_SCORE = 10875
BATCH = 64
SCAN_GENES, SCAN_QUERIES, SCAN_LEN = 8, 16, 1_000_000
SCAN_REV_CHUNKS, SCAN_FWD_CHUNKS = 2, 3  # plain-check worker processes
DEADLINE_S = 1100                        # the plain check's last moment
# worker pools and temporary directories, closed when the script ends
_EXIT = contextlib.ExitStack()
SCAN_ARGV = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
             "--showvulgar", "yes", "--showalignment", "no"]


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cuda_call(fn):
    """(fn(), its milliseconds by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _turns(plain, kernel, kernel_reps: int = 3):
    """Warm up both, then time plain, kernel, kernel, plain."""
    plain()
    kernel()
    torch.cuda.synchronize()
    p1 = _cuda_ms(plain)
    k1 = _cuda_ms(kernel, kernel_reps)
    k2 = _cuda_ms(kernel, kernel_reps)
    p2 = _cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def _synthetic_sdp_jobs():
    """A ragged est2genome batch (single exon, two exons with an intron,
    two seeds in one column, two distant loci) and a ner joint-span
    pair, from the cases of tests/torch_sdp_cases.py."""
    import torch_sdp_cases as tc
    e2g = tc.case("single_exon")[0]
    ragged = [tc.case(n, e2g)[1:] for n in (
        "single_exon", "two_exons_intron", "seed_layers_same_column",
        "distant_loci")]
    ner, pair, plan = tc.case("ner_joint_span")
    return [(e2g, ragged), (ner, [(pair, plan)])]


def _band_vs_plain(bi, label):
    """K6 then K7 against the plain passes on the same inputs, exactly.
    Returns (max |kernel - plain| over bits and column best, plain
    reverse ms, plain forward ms) with the plain passes timed by CUDA
    events."""
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import sdp_device as sd
    bits, live_r = cs.band_reverse(bi)
    colbest, live_f, xband = cs.band_forward(bi, bits)
    (p_bits, p_live_r), p_rev = _cuda_call(lambda: sd.plain_band_reverse(bi))
    (p_col, p_live_f, p_xb), p_fwd = _cuda_call(
        lambda: sd.plain_band_forward(bi, p_bits))
    err = max(_max_err(bits, p_bits), _max_err(colbest, p_col))
    if err or not (torch.equal(bits, p_bits) and torch.equal(colbest, p_col)
                   and torch.equal(live_r, p_live_r)
                   and torch.equal(live_f, p_live_f)
                   and torch.equal(xband, p_xb)):
        raise RuntimeError(f"K6/K7 {label}: kernel != plain (max err {err})")
    return err, p_rev, p_fwd


_BATCH_FIELDS = ("dims", "qvecs", "tvecs", "scalars")


def _plain_check(path: str, forward: bool, idx: list):
    """Worker process, CPU only: the plain pass over comparisons ``idx``
    of the band batch saved at ``path``, held against the kernels'
    outputs saved with it (the forward pass reads K6's bits, which the
    reverse workers hold to the plain reverse pass).  Returns (equal,
    max |kernel - plain|, seconds, diagonals walked)."""
    import dataclasses
    from exonerate_tpu_torch.engine import sdp_device as sd
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=True)
    ix = torch.tensor(idx)
    bi = sd.BandInputs(**saved["bi"])
    bi = dataclasses.replace(bi, **{f: getattr(bi, f)[ix]
                                    for f in _BATCH_FIELDS})
    t0 = time.perf_counter()
    if forward:
        got = sd.plain_band_forward(bi, saved["bits"][ix])
        want = [saved[k][ix] for k in ("colbest", "live_f", "xband")]
    else:
        got = sd.plain_band_reverse(bi)
        want = [saved[k][ix] for k in ("bits", "live_r")]
    secs = time.perf_counter() - t0
    return (all(torch.equal(g, w) for g, w in zip(got, want)),
            max(_max_err(g, w) for g, w in zip(got, want)), secs,
            int((bi.dims[:, 0] + bi.dims[:, 1]).max()) + 1)


def _start_plain_check(bi, outs: dict, tmp: str):
    """Save the batch and the kernels' outputs under ``tmp`` and start
    the plain passes in worker processes: K6's over SCAN_REV_CHUNKS
    slices of the batch, K7's over SCAN_FWD_CHUNKS (comparisons sorted
    by length).  Returns (pool, [(pass name, idx, async result)])."""
    import dataclasses
    import multiprocessing
    path = os.path.join(tmp, "scan_band.pt")
    fields = {f.name: getattr(bi, f.name) for f in dataclasses.fields(bi)}
    torch.save({"bi": {k: v.cpu() if torch.is_tensor(v) else v
                       for k, v in fields.items()},
                **{k: v.cpu() for k, v in outs.items()}}, path)
    length = (bi.dims[:, 0] + bi.dims[:, 1]).tolist()
    order = sorted(range(bi.batch), key=lambda b: -length[b])
    tasks = ([(False, c) for c in np.array_split(order, SCAN_REV_CHUNKS)]
             + [(True, c) for c in np.array_split(order, SCAN_FWD_CHUNKS)])
    pool = multiprocessing.get_context("spawn").Pool(len(tasks))
    return pool, [("K7" if fwd else "K6", [int(b) for b in idx],
                   pool.apply_async(_plain_check,
                                    (path, fwd, [int(b) for b in idx])))
                  for fwd, idx in tasks]


def _synthesize_scan(calm: str, tmp: str):
    """benchmarks/genome_scan.py's recipe (rng 7): 8 copies of calm[:1200]
    split into 3 exons with 200-1200 bp GT..AG introns, ~1% mutated, in
    a 1 Mb random genome; 16 queries with ~2% mutations.  Returns the
    query and target FASTA paths."""
    rng = np.random.default_rng(7)
    cdna = calm[:1200]
    exons = [cdna[:400], cdna[400:800], cdna[800:]]
    genome = rng.choice(list("acgt"), SCAN_LEN).tolist()
    spacing = SCAN_LEN // (SCAN_GENES + 1)
    for g in range(SCAN_GENES):
        pos = spacing * (g + 1)
        for i, exon in enumerate(exons):
            ex = list(exon)
            for _ in range(len(ex) // 100):
                ex[rng.integers(0, len(ex))] = rng.choice(list("ACGT"))
            genome[pos:pos + len(ex)] = ex
            pos += len(ex)
            if i < len(exons) - 1:
                ilen = int(rng.integers(200, 1200))
                genome[pos:pos + ilen] = (["g", "t"] + rng.choice(
                    list("acgt"), ilen - 4).tolist() + ["a", "g"])
                pos += ilen
    qf, tf = os.path.join(tmp, "q.fa"), os.path.join(tmp, "t.fa")
    with open(qf, "w") as fh:
        for qn in range(SCAN_QUERIES):
            q = list(cdna)
            for _ in range(len(q) // 50):
                q[rng.integers(0, len(q))] = rng.choice(list("ACGT"))
            fh.write(f">q{qn}\n{''.join(q)}\n")
    with open(tf, "w") as fh:
        fh.write(">genome\n" + "".join(genome) + "\n")
    return qf, tf


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    name = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi: {card}")

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from exonerate_tpu import observe
    from exonerate_tpu.alphabet import AlphabetType
    from exonerate_tpu.engine import sdp_native
    from exonerate_tpu.engine.region import Region
    from exonerate_tpu.model.affine import AffineModelType, affine_create
    from exonerate_tpu.model.data import AlignData
    from exonerate_tpu.model.est2genome import est2genome_create
    from exonerate_tpu.seqio import Sequence, iter_fasta
    from exonerate_tpu_torch import _cudabuild
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import sdp_device as sd
    from exonerate_tpu_torch.engine import sdp_hybrid as hy
    from exonerate_tpu_torch.engine import wavefront as wf
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    # -- 2. build (one nvcc per source, all started together) -----------
    from concurrent.futures import ThreadPoolExecutor
    stems = ("wavefront", "walkback", "sdp_band")
    with ThreadPoolExecutor(len(stems)) as ex:
        list(ex.map(_cudabuild.load, stems))
    for stem in stems:
        built = _cudabuild.builds[stem]
        print(f"build {stem}: {built.seconds:.2f} s -> "
              f"{os.path.relpath(built.path, ROOT)}")
        for ln in built.log.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln \
                    or "entry function" in ln:
                print(f"  {ln.strip()}")

    calm = next(iter(iter_fasta(os.path.join(DATA, "all4.fa"))))
    calm.strand = "+"
    if len(calm) != CALM_LEN:
        raise RuntimeError(f"calm is {len(calm)} bp, want {CALM_LEN}")
    model = est2genome_create()
    data = AlignData(calm, calm)
    full = Region(0, 0, CALM_LEN, CALM_LEN)
    Qp, Tp = wf._bucket(CALM_LEN), wf._bucket(CALM_LEN)
    inputs, kinds = wf.prepare_inputs(model, full, data, pad_to=(Qp, Tp),
                                      for_pallas=True)
    cells = CALM_LEN * CALM_LEN
    report = {}

    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    import cases
    engines = {}

    def run_cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        if cli_main(argv, out=buf) != 0:
            raise RuntimeError(f"CLI exit status for {argv}")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if observe.fallback_counts:
            raise RuntimeError(f"engine fallbacks: "
                               f"{dict(observe.fallback_counts)}")
        engines.update(observe.engine_counts)
        return buf.getvalue(), secs

    # the band batches the hybrid sends to the card, captured on the way
    captured = []
    real_batch = hy.run_device_batch

    def spy(model_, jobs_, device_):
        t0 = time.perf_counter()
        res = real_batch(model_, jobs_, device_)
        captured.append((model_, list(jobs_), time.perf_counter() - t0))
        return res

    # -- 3. K6/K7 vs plain, synthetic pairs ------------------------------
    band_err = 0
    for bmodel, jobs in _synthetic_sdp_jobs():
        drop = jobs[0][0].args.dropoff
        err, _, _ = _band_vs_plain(cs.band_inputs(bmodel, jobs, drop, dev),
                                   f"{bmodel.name} x{len(jobs)}")
        band_err = max(band_err, err)
        got = cs.run_kernel(bmodel, jobs, drop, dev)
        want = cs.run_kernel(bmodel, jobs, drop, cpu)
        for g, w in zip(got, want):
            if (g["live"], g["xband"]) != (w["live"], w["xband"]) \
                    or not np.array_equal(g["band_end"], w["band_end"]):
                raise RuntimeError(f"K6/K7 {bmodel.name}: run_kernel on "
                                   f"the card != on the CPU")
        print(f"K6/K7 {bmodel.name} x{len(jobs)}: kernel == plain "
              f"(bits, column best, live, xband, band_end per locus)")

    # the est2genome_genomic golden through the CLI on the forced device
    # route (this first heuristic run also builds the host's native
    # libraries, so that the scan below is timed warm)
    name_g = "est2genome_genomic"
    argv_g = dict((n, a) for n, _prog, a in cases.CASES)[name_g]
    captured.clear()
    hy.run_device_batch = spy
    os.environ["EXONERATE_TPU_SDP"] = "device"
    try:
        out, secs = run_cli(argv_g)
    finally:
        os.environ.pop("EXONERATE_TPU_SDP")
        hy.run_device_batch = real_batch
    with open(os.path.join(cases.OUTDIR, name_g + ".txt")) as fh:
        if cases.normalize(out) != fh.read():
            raise RuntimeError(f"CLI {name_g} (forced device route) differs "
                               f"from its golden")
    if observe.engine_counts.get(cs.engine_name(dev), 0) < 1:
        raise RuntimeError(f"{name_g}: no comparison on the band kernels")
    print(f"CLI {name_g} (forced device route): byte-equal to the golden "
          f"({secs:.2f} s host clock)")
    gmodel, gjobs, _ = captured[0]

    # -- 4. the heuristic scan at full width (the band kernels' main path)
    plain_passes = [0]
    real_pass = sd._run_pass

    def counted_pass(*args, **kwargs):
        plain_passes[0] += 1
        return real_pass(*args, **kwargs)

    with tempfile.TemporaryDirectory() as scan_dir:
        argv_s = SCAN_ARGV + list(_synthesize_scan(str(calm), scan_dir))
        captured.clear()
        sd._run_pass = counted_pass
        hy.run_device_batch = spy
        cs.band_reverse.launches = 0
        cs.band_forward.launches = 0
        try:
            out_dev, secs_dev = run_cli(argv_s)
            band_launches = {"K6": cs.band_reverse.launches,
                             "K7": cs.band_forward.launches}
            scan_engines = dict(observe.engine_counts)
            hy.run_device_batch = real_batch
            os.environ["EXONERATE_TPU_SDP"] = "native"
            out_nat, secs_nat = run_cli(argv_s)
        finally:
            os.environ.pop("EXONERATE_TPU_SDP", None)
            sd._run_pass = real_pass
            hy.run_device_batch = real_batch
    vulgar = [ln.split() for ln in out_dev.splitlines()
              if ln.startswith("vulgar:")]
    spliced = {v[1] for v in vulgar if "I" in v[10::3]}
    print(f"scan {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb est2genome "
          f"[{card}]: default routing {secs_dev:.2f} s, "
          f"EXONERATE_TPU_SDP=native {secs_nat:.2f} s (host clock); "
          f"engines {scan_engines}; launches {band_launches}; "
          f"{len(spliced)}/{SCAN_QUERIES} queries spliced")
    if out_dev != out_nat:
        raise RuntimeError("scan: the device route's output differs from "
                           "the native route's")
    if scan_engines.get(cs.engine_name(dev)) != 16:
        raise RuntimeError(f"scan: want 16 comparisons on "
                           f"{cs.engine_name(dev)}, got {scan_engines}")
    if min(band_launches.values()) < 1:
        raise RuntimeError(f"a band kernel never ran: {band_launches}")
    if len(spliced) != SCAN_QUERIES:
        raise RuntimeError(f"scan: {len(spliced)}/{SCAN_QUERIES} queries "
                           f"with a spliced alignment")
    if plain_passes[0]:
        raise RuntimeError(f"scan: {plain_passes[0]} plain band-scan passes "
                           f"ran on the main path")
    if len(captured) != 1:
        raise RuntimeError(f"scan: want one device batch, got "
                           f"{len(captured)}")
    smodel, sjobs, batch_secs = captured[0]
    bi = cs.band_inputs(smodel, sjobs, sjobs[0][0].args.dropoff, dev)
    (bits_s, live_r), s_rev = _cuda_call(lambda: cs.band_reverse(bi))
    (col_s, live_f, xb_s), s_fwd = _cuda_call(
        lambda: cs.band_forward(bi, bits_s))
    ws = [pl.W for _, pl in sjobs]
    print(f"scan band batch: B={len(sjobs)}, Qp {bi.Qp}, W {min(ws)}-"
          f"{max(ws)}, Wp {bi.Wp}, Dp {bi.Dp}, "
          f"{cs.pair_bytes(smodel, bi.Qp, bi.Wp, bi.tvecs.shape[1]) / 1e6:.1f}"
          f" MB per comparison [{card}]: K6 {s_rev:.3f} ms, K7 "
          f"{s_fwd:.3f} ms (CUDA events); in the default-route run the "
          f"batch took {batch_secs:.2f} s host clock (host prep, copies, "
          f"K6, K7)")
    check_dir = _EXIT.enter_context(tempfile.TemporaryDirectory())
    pool, pending = _start_plain_check(
        bi, {"bits": bits_s, "live_r": live_r, "colbest": col_s,
             "live_f": live_f, "xband": xb_s}, check_dir)
    _EXIT.callback(pool.join)
    _EXIT.callback(pool.terminate)
    check_t0 = time.perf_counter()
    del bi, bits_s, col_s

    # -- 5. K1 vs plain --------------------------------------------------
    for mode in ("score", "region"):
        ki = cw.to_kernel_inputs(model, [inputs] * BATCH, kinds, dev, mode)
        got = cw.wavefront_scan(ki)
        want = wf.plain_wavefront(ki)[0]
        torch.cuda.synchronize()
        err = _max_err(got, want)
        if err or not torch.equal(got, want):
            raise RuntimeError(f"K1 {mode}: kernel != plain (max err {err})")
        if set(got[0].tolist()) != {CALM_SELF_SCORE}:
            raise RuntimeError(f"K1 {mode}: scores {set(got[0].tolist())}")
        ms, plain_ms = _turns(lambda: wf.plain_wavefront(ki),
                              lambda: cw.wavefront_scan(ki))
        print(f"K1 {mode} calm {CALM_LEN}^2 x{BATCH} [{card}]: kernel "
              f"{ms:.3f} ms ({ms / BATCH:.4f} ms/pair, "
              f"{cells * BATCH / ms / 1e6:.3f} GCUPS), plain {plain_ms:.3f}"
              f" ms ({plain_ms / BATCH:.4f} ms/pair, "
              f"{cells * BATCH / plain_ms / 1e6:.4f} GCUPS)")
        report[f"K1_{mode}"] = (err, ms, plain_ms)
    ragged = [(Region(0, 0, 100, 160), data), (Region(40, 10, 80, 150), data),
              (Region(10, 30, 120, 90), data)]
    pa = Sequence("a", None, "MKVLAAGICAGWLLWKKMKVL")
    pb = Sequence("b", None, "MKVLGAGICAWWLLAKKMK")
    amodel = affine_create(AffineModelType.LOCAL, AlphabetType.PROTEIN,
                           AlphabetType.PROTEIN)
    for m, jobs in ((model, ragged),
                    (amodel, [(Region(0, 0, len(pa), len(pb)),
                               AlignData(pa, pb))])):
        for mode in ("score", "region"):
            g = cw.find_batched(m, jobs, mode, device=dev)
            c = cw.find_batched(m, jobs, mode, device=cpu)
            if g != c:
                raise RuntimeError(f"K1 {mode} ragged {m.name}: {g} != {c}")
    print("K1 ragged batches (est2genome x3, affine:local protein): equal")
    # the rest of the zoo the kernels serve: every start/end scope, the
    # K=4/6 carry rings of codon models, NER; region and path modes
    from exonerate_tpu.model import registry
    dna_q, dna_t = calm.subseq(0, 300), calm.subseq(20, 330)
    prot = Sequence("p", None, "MADQLTEEQIAEFKEAFSLFDKDGDGTITTKELGTVMRSL")
    names = []
    for mt, q, t in (("AFFINE_GLOBAL", dna_q, dna_t),
                     ("AFFINE_BESTFIT", dna_q, dna_t),
                     ("AFFINE_OVERLAP", dna_q, dna_t),
                     ("NER", dna_q, dna_t),
                     ("CODING2CODING", dna_q, dna_t),
                     ("PROTEIN2DNA", prot, dna_t)):
        mtype = getattr(registry.ModelType, mt)
        m = registry.get_model(mtype, q.alphabet.type, t.alphabet.type)
        jobs = [(Region(0, 0, len(q), len(t)),
                 AlignData(q, t, registry.translate_both(mtype)))]
        for mode in ("score", "region"):
            if cw.find_batched(m, jobs, mode, device=dev) != \
                    cw.find_batched(m, jobs, mode, device=cpu):
                raise RuntimeError(f"K1 {mode} != plain on {m.name}")
        if cw.find_path_batched(m, jobs, device=dev) != \
                cw.find_path_batched(m, jobs, device=cpu):
            raise RuntimeError(f"K4 + walk-back != plain on {m.name}")
        names.append(m.name)
    print(f"K1/K4 model zoo ({', '.join(names)}): equal")

    # -- 6. K4 + walk-back vs plain and the native dense DP --------------
    ki = cw.to_kernel_inputs(model, [inputs], kinds, dev, "path")
    stats, tb = cw.wavefront_path(ki)
    p_stats, p_tb = wf.plain_wavefront(ki)
    torch.cuda.synchronize()
    D, W = Qp + Tp + 1, Qp + 1
    d_ix = torch.arange(D, device=dev)[:, None]
    i_ix = torch.arange(W, device=dev)[None, :]
    valid = ((d_ix - i_ix >= 0) & (d_ix - i_ix <= CALM_LEN)
             & (i_ix <= CALM_LEN))[None, :, None, :].expand_as(tb)
    tb_err = _max_err(tb[valid], p_tb[valid])
    if tb_err or not torch.equal(stats, p_stats):
        raise RuntimeError(f"K4: kernel != plain (tb max err {tb_err})")
    cap = D + cw.WALK_SLACK
    ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, cap)
    p_ops, p_res = wf.plain_walkback(tb, stats, ki.walk, ki.end_id, cap)
    k = int(res[0, 0])
    if not torch.equal(res, p_res) or not torch.equal(ops[:, :k],
                                                      p_ops[:, :k]):
        raise RuntimeError("walk-back: kernel != plain")
    walk_err = _max_err(res, p_res)
    path_ms, path_plain_ms = _turns(lambda: wf.plain_wavefront(ki),
                                    lambda: cw.wavefront_path(ki), 2)
    walk_ms, walk_plain_ms = _turns(
        lambda: wf.plain_walkback(tb, stats, ki.walk, ki.end_id, cap),
        lambda: cw.walkback(tb, stats, ki.walk, ki.end_id, cap), 10)
    del tb, p_tb, valid
    got = cw.find_path_batched(model, [(full, data)], device=dev)[0]
    t0 = time.perf_counter()
    nat = sdp_native.run_viterbi(model, full, data, "path")
    nat_s = time.perf_counter() - t0
    if nat is None:
        raise RuntimeError("native dense DP unavailable")
    for field in ("score", "query_start", "target_start", "query_end",
                  "target_end"):
        if getattr(got, field) != getattr(nat, field):
            raise RuntimeError(f"K4 vs native: {field} {getattr(got, field)}"
                               f" != {getattr(nat, field)}")
    if got.score != CALM_SELF_SCORE or len(got.path) != len(nat.path) \
            or any(a is not b for a, b in zip(got.path, nat.path)):
        raise RuntimeError("K4 vs native: paths differ")
    print(f"K4 path calm {CALM_LEN}^2 x1 [{card}]: kernel {path_ms:.3f} ms,"
          f" plain {path_plain_ms:.3f} ms; walk-back kernel {walk_ms:.4f} ms"
          f", plain {walk_plain_ms:.3f} ms ({k} ops); native dense DP "
          f"{nat_s * 1e3:.1f} ms (host clock); path equals native")
    report["K4"] = (tb_err, path_ms, path_plain_ms)
    report["walkback"] = (walk_err, walk_ms, walk_plain_ms)

    # -- 7. the port's CLI, end to end (the exhaustive main path) -------
    golden = dict((n, argv) for n, _prog, argv in cases.CASES)[
        "exhaustive_est2genome"]
    cw.wavefront_scan.launches = 0
    cw.wavefront_path.launches = 0
    cw.walkback.launches = 0
    engines.clear()
    out, secs = run_cli(golden)
    with open(os.path.join(cases.OUTDIR, "exhaustive_est2genome.txt")) as fh:
        if cases.normalize(out) != fh.read():
            raise RuntimeError("CLI: exhaustive_est2genome differs from "
                               "its golden output")
    print(f"CLI exhaustive_est2genome: byte-equal to the golden "
          f"({secs:.2f} s host clock)")
    with open(os.path.join(DATA, "all4.fa")) as fh:
        calm_fa = ">" + fh.read()[1:].split("\n>")[0] + "\n"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calm.fa")
        with open(path, "w") as fh:
            fh.write(calm_fa)
        out, secs = run_cli(["-m", "est2genome", "-E", "yes", "-S", "no",
                             "--bestn", "1", path, path, "--showvulgar",
                             "yes", "--showalignment", "no"])
    vulgar = [ln.split() for ln in out.splitlines()
              if ln.startswith("vulgar:")]
    if not vulgar or int(vulgar[0][9]) != CALM_SELF_SCORE:
        raise RuntimeError(f"CLI calm x calm: vulgar {vulgar[:1]}")
    print(f"CLI est2genome -E calm x calm: vulgar score {vulgar[0][9]} "
          f"({secs:.2f} s host clock)")
    launches = {"K1": cw.wavefront_scan.launches,
                "K4": cw.wavefront_path.launches,
                "walkback": cw.walkback.launches}
    print(f"main-path launches {launches}; engines {engines}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the main path never ran: {launches}")
    if cw.engine_name(dev) not in engines:
        raise RuntimeError(f"the CLI did not use {cw.engine_name(dev)}")

    # -- 8. K6/K7 vs plain on est2genome_genomic's comparison, timed ----
    pair_g, plan_g = max(gjobs, key=lambda j: (j[0].region.query_length + 1)
                         * (j[1].W + 1))
    q_g, w_g = pair_g.region.query_length, plan_g.W
    bi = cs.band_inputs(gmodel, [(pair_g, plan_g)], pair_g.args.dropoff, dev)
    err, p_rev1, p_fwd1 = _band_vs_plain(bi, name_g)
    band_err = max(band_err, err)
    k_rev = (_cuda_ms(lambda: cs.band_reverse(bi), 3)
             + _cuda_ms(lambda: cs.band_reverse(bi), 3)) / 2
    bits_g = cs.band_reverse(bi)[0]
    k_fwd = (_cuda_ms(lambda: cs.band_forward(bi, bits_g), 3)
             + _cuda_ms(lambda: cs.band_forward(bi, bits_g), 3)) / 2
    p_rev = (p_rev1 + _cuda_ms(lambda: sd.plain_band_reverse(bi))) / 2
    p_fwd = (p_fwd1 + _cuda_ms(lambda: sd.plain_band_forward(bi, bits_g))) / 2
    n_diag_g = q_g + w_g + 1
    print(f"{name_g}'s comparison Q {q_g} x W {w_g} "
          f"({n_diag_g} diagonals) [{card}]: K6 kernel {k_rev:.3f} ms, "
          f"plain {p_rev:.3f} ms; K7 kernel {k_fwd:.3f} ms, plain "
          f"{p_fwd:.3f} ms; kernel == plain")

    # -- 9. the scan's plain check (started in phase 4) -------------------
    wait_t0 = time.perf_counter()
    for pname, idx, res in pending:
        left = DEADLINE_S - (time.perf_counter() - t_start)
        equal, err, secs, n_diag = res.get(timeout=max(left, 1.0))
        print(f"scan plain check {pname} over comparisons {idx} (B="
              f"{len(idx)}, {n_diag} diagonals): {secs:.1f} s on one host "
              f"core ({secs / n_diag * 1e3:.3f} ms per diagonal); max "
              f"|kernel - plain| {err}")
        if not equal:
            raise RuntimeError(f"K6/K7 scan batch: {pname} kernel != plain "
                               f"on comparisons {idx} (max err {err})")
        band_err = max(band_err, err)
    pool.close()
    print(f"scan plain check: kernel == plain on all {len(sjobs)} "
          f"comparisons (bits, live; column best, live, xband), "
          f"{time.perf_counter() - check_t0:.1f} s after it started, "
          f"{time.perf_counter() - wait_t0:.1f} s of it waited for")
    report["K6"] = (band_err, k_rev, p_rev)
    report["K7"] = (band_err, k_fwd, p_fwd)

    src = "exonerate_tpu_torch/csrc/"
    pw = "exonerate_tpu/engine/pallas_wavefront.py"
    kernels = [
        ("K1 wavefront_scan (region, calm 2175^2 x64)", "K1", "K1_region",
         src + "wavefront.cu", pw + ":427"),
        ("K4 wavefront_path (calm 2175^2 x1)", "K4", "K4",
         src + "wavefront.cu", pw + ":1147"),
        ("walkback (calm 2175^2 x1)", "walkback", "walkback",
         src + "walkback.cu", pw + ":1550"),
    ]
    sp = "exonerate_tpu/engine/sdp_pallas.py"
    kernels += [
        (f"K6 band_reverse ({name_g}, Q {q_g} x W {w_g})", "K6", "K6",
         src + "sdp_band.cu", sp + ":974"),
        (f"K7 band_forward ({name_g}, Q {q_g} x W {w_g})", "K7", "K7",
         src + "sdp_band.cu", sp + ":996"),
    ]
    launches.update(band_launches)
    rows = []
    for kname, lkey, rkey, source, replaces in kernels:
        err, ms, plain_ms = report[rkey]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[lkey],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(_card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with _EXIT:
        sys.exit(main())
