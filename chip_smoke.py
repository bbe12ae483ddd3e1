#!/usr/bin/env python3
"""Smoke test of exonerate_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Device: a CUDA card must be visible; prints its name and power limit.
2. Build: compiles csrc/*.cu with nvcc into build/cuda/ and prints the
   build seconds and ptxas' register/shared-memory lines.
3. K1 vs plain: est2genome, calm (tests/golden/data/all4.fa record 1)
   against itself, 2175x2175, B=64, score and region modes, plus a ragged
   batch; the kernel's outputs must equal the plain PyTorch version's
   exactly (score 10875).  Times both with CUDA events, in turns.
4. K4 + walk-back vs plain and vs the native dense DP, calm 2175^2 path.
5. CLI end to end: the port's CLI must reproduce the exhaustive_est2genome
   golden byte for byte and give vulgar score 10875 on calm x calm, with
   the kernels' launch counters above 0 and no engine fallback.

The last three lines are nvidia-smi's name and power limit of the card,
a JSON object of the kernels (route, source, the TPU kernel each
replaces, main-path launches, max |kernel - plain|, kernel and plain
milliseconds), and the result object.
"""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "golden", "data")
CALM_LEN = 2175
CALM_SELF_SCORE = 10875
BATCH = 64


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


def main() -> int:
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
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import wavefront as wf
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")

    # -- 2. build --------------------------------------------------------
    for stem in ("wavefront", "walkback"):
        _cudabuild.load(stem)
        built = _cudabuild.builds[stem]
        print(f"build {stem}: {built.seconds:.2f} s -> "
              f"{os.path.relpath(built.path, ROOT)}")
        for ln in built.log.splitlines():
            if "registers" in ln or "smem" in ln or "spill" in ln:
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

    # -- 3. K1 vs plain --------------------------------------------------
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

    # -- 4. K4 + walk-back vs plain and the native dense DP --------------
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

    # -- 5. the port's CLI, end to end (the main path) -------------------
    sys.path.insert(0, os.path.join(ROOT, "tests", "golden"))
    import cases
    golden = dict((n, argv) for n, _prog, argv in cases.CASES)[
        "exhaustive_est2genome"]
    cw.wavefront_scan.launches = 0
    cw.wavefront_path.launches = 0
    cw.walkback.launches = 0
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
    sys.exit(main())
