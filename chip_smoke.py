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
   locus), on a ragged batch of synthetic est2genome pairs, a ner
   joint-span pair and, per split-codon model (protein2genome,
   coding2genome, cdna2genome), a ragged pair of jobs whose exons split
   codons of both phases (kernel K9 inside K7; tests/torch_sdp_cases.py).
   Then the est2genome_genomic golden through the port's CLI on the
   forced device route, byte-equal to the golden (this first heuristic
   run also builds the host's native libraries, so that the scans are
   timed warm).
4. The est2genome scan at full width (the band kernels' first main
   path): 16 mutated calm cDNAs against a 1 Mb genome holding 8 spliced
   copies (benchmarks/genome_scan.py's recipe, rng 7), through the port's
   CLI with default routing and with EXONERATE_TPU_SDP=native; the
   outputs must be byte-equal, with 16 comparisons on cuda-sdp, K6/K7
   launched, no fallback, 16/16 queries spliced and no plain-scan pass.
   K6/K7 are launched again on the scan's band batch, and worker
   processes start the plain passes over that batch on the CPU (over
   slices of the batch), to be held against the kernels' outputs in the
   last phase.
5. The split-codon paths (kernel K9), each through the port's CLI
   against the native route, byte for byte, with its kernels launched and
   no fallback but one: in the coding2genome scan the hybrid's locus
   cross-check disagrees on one comparison (the host's re-run of one
   locus alone scores 2008 where the band scan of the whole comparison
   scores 2007; the comparison goes to the host, as in the JAX package's
   device tier on the same input); a second one fails the script.
   After each scan K6/K7 run again on every launch the main path made of
   its band batch (the same comparisons, Qp and Wp), and the comparisons
   whose cross-check disagreed, else the widest, start their plain check
   in two more worker processes at the shape of their launch.
   a. coding2genome scan: the 16 cDNAs against the same recipe's genome
      cut at cDNA 251 and 402 (a phase-1 and a phase-2 intron of calm's
      CDS), default routing; its output holds split-codon (S) operations.
   b. protein2genome scan: 8 mutated calm proteins against that genome on
      the forced device route (EXONERATE_TPU_SDP=device; by default the
      149-residue queries stay under DEVICE_MIN_Q); no fallback.
   c. protein2genome -E yes: the calm protein against a 12 kb locus of
      the same three exons; the region scan and the path DP run on K1
      and K4 (optimal's native cut-over set to 100,000 cells for this
      run), against the native dense DP; S operations at both introns.
      The run's K1/K4 inputs are captured; each launch is made again and
      its plain version (with the walk-back's) starts in one more worker
      process.
6. The SubOpt mask (kernel K3, the MASKED instantiation of K1/K4), each
   run through the port's CLI with no fallback:
   a. est2genome -E yes --bestn 2 --score 2000: calm (2175 bp) against a
      30 kb window holding two spliced copies of it, interleaved
      (tests/torch_split_cases.py two_copy_locus: exons at thirds, ~1%
      mutated, GT..AG gaps of 1200 bp, so each copy spans 8,425 bp and
      its box holds cells of the other's path).  The whole pair (65 M
      cells) and each copy's box (over 16 M) take the kernel route, so
      the second iteration runs K3 inside K1 and K4; byte-equal to the
      native dense DP route in the same process, both copies spliced.
      The widest masked region scan is timed (kernel K3's row) and, with
      the first masked K4 launch and its walk-back, held to the plain
      version in two more worker processes.
   b. The pooled locus heuristic (EXONERATE_TPU_HEURISTIC=locus) on
      phase 4's 16 cDNAs x 1 Mb genome with --bestn 10: at least one
      masked generation, K3 launched, 16/16 queries spliced, its time
      beside phase 4's SDP route.  The first masked region batch and its
      path batch are launched again on a sub-batch of their two widest
      pairs, held to the full batch's results for those pairs and, in two
      more worker processes, to the plain versions.
7. K1 vs plain: est2genome, calm (tests/golden/data/all4.fa record 1)
   against itself, 2175x2175, B=64, score and region modes, plus a ragged
   batch and the model zoo; the split-codon plans: the calm protein
   against 8 windows of the 12 kb locus (score, region, path), the
   coding2genome and cdna2genome split pairs; the protein2genome -E
   run's first widest region scan on its own inputs (B=1, Qp 256 x Tp
   12288), timed for kernel K9's row (its plain check runs in phase 5c's
   worker process).  Times with CUDA events.
8. K4 + walk-back vs plain and vs the native dense DP, calm 2175^2 path.
9. CLI end to end: the port's CLI must reproduce the exhaustive_est2genome
   golden byte for byte and give vulgar score 10875 on calm x calm, with
   the kernels' launch counters above 0 and no engine fallback.
10. K6/K7 against the plain passes, exactly, on the est2genome_genomic
    comparison of phase 3, timed kernel vs plain with CUDA events.
11. The plain checks of the worker processes: every slice's plain pass
    must equal the kernels' outputs exactly (bits, live; column best,
    live, xband), and every K1/K4 launch handed to them its plain
    version (scores, ends, starts; traceback cube, walk-back).

Phases 5-10 run on the card while the plain checks run on the host's
cores, so their host-clock and plain times share the host with them.

The last three lines are nvidia-smi's name and power limit of the card,
a JSON object of the kernels (route, source, the TPU kernel each
replaces, main-path launches, max |kernel - plain|, kernel and plain
milliseconds (the plain version on the card, but for K9 and K3 on one
host core in a worker process), the bound: the larger of the bytes moved
over 3.35 TB/s and the int32 operations over the int32 peak, and the
library call: none computes these DPs), and the result object.
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
SCAN_QUERIES, SCAN_LEN = 16, 1_000_000
SCAN_REV_CHUNKS, SCAN_FWD_CHUNKS = 2, 3  # plain-check worker processes
DEADLINE_S = 1100                        # the plain checks' last moment
# the card's peaks for the bound (NVIDIA H100 SXM data sheet: 3.35 TB/s
# of HBM3; Hopper white paper: 64 INT32 lanes per SM x 132 SMs x 1.98
# GHz boost = 16.7 T int32 operations/s)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
# worker pools and temporary directories, closed when the script ends
_EXIT = contextlib.ExitStack()
SCAN_ARGV = ["-m", "est2genome", "--bestn", "1", "--maxintron", "20000",
             "--showvulgar", "yes", "--showalignment", "no"]
C2G_ARGV = ["-m", "coding2genome", "--bestn", "1", "--maxintron", "20000",
            "--showvulgar", "yes", "--showalignment", "no"]
P2G_ARGV = ["-m", "protein2genome", "--bestn", "1", "--maxintron", "20000",
            "--showvulgar", "yes", "--showalignment", "no"]
P2G_E_CUTOVER = 100_000      # optimal.NATIVE_TPU_CELLS for the p2g -E run
# the -E yes Waterman-Eggert window: calm's two copies interleaved from
# WE_START, GT..AG gaps of WE_GAP (each copy spans 8,425 bp), WE_LEN bp in
# all; --score WE_SCORE ends the run after both copies (calm's internal
# repeats give local alignments of a few hundred, each one more masked
# iteration of the whole window)
WE_GAP, WE_LEN, WE_START, WE_SCORE = 1200, 30_000, 9000, 2000
LOCUS_ARGV = ["-m", "est2genome", "--bestn", "10", "--maxintron", "20000",
              "--showvulgar", "yes", "--showalignment", "no"]
CROSSCHECK = "sdp device->host: locus score mismatch"
# the one comparison of the coding2genome scan whose locus cross-check
# disagrees (query 9, 2008 != 2007), as in the JAX package's device tier
C2G_MAX_CROSSED = 1


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
    """Warm up the kernel, then time kernel, plain, kernel.  The plain
    loop runs once (its time is bound by the host's launch rate) and its
    output is returned for the caller's check: (kernel output, plain
    output, kernel ms, plain ms)."""
    got = kernel()
    torch.cuda.synchronize()
    k1 = _cuda_ms(kernel, kernel_reps)
    want, p = _cuda_call(plain)
    k2 = _cuda_ms(kernel, kernel_reps)
    return got, want, (k1 + k2) / 2, p


def _max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def _bound(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _tb_valid(ki, tb: torch.Tensor) -> torch.Tensor:
    """The cells of K4's traceback cube (B, D, S, W) that lie inside each
    pair's DP (cell (i, d - i) with i <= qlen and d - i <= tlen): the
    kernel leaves the others unwritten."""
    qlen = ki.dims[:, 2].long()[:, None, None]
    tlen = ki.dims[:, 3].long()[:, None, None]
    d = torch.arange(tb.shape[1], device=tb.device)[None, :, None]
    i = torch.arange(tb.shape[3], device=tb.device)[None, None, :]
    ok = (d - i >= 0) & (d - i <= tlen) & (i <= qlen)
    return ok[:, :, None, :].expand_as(tb)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _wave_work(ki, out_bytes: int):
    """Bytes (inputs read once, outputs written once) and int32 operations
    (an add and a compare per plan row per valid cell) of one K1/K4
    launch on ``ki``."""
    dims = ki.dims.long()
    cells = int(((dims[:, 2] + 1) * (dims[:, 3] + 1)).sum())
    n_in = _nbytes(ki.plan, ki.ring_row, ki.lane_row, ki.dims, ki.qvecs,
                   ki.tvecs, ki.tables, ki.scalars, ki.blocked)
    return n_in + out_bytes, 2 * cells * ki.plan.shape[0]


def _band_work(bi, forward: bool):
    """Bytes and int32 operations (an add and a compare per candidate per
    valid band cell) of one K6 (reverse) or K7 (forward) launch."""
    dims = bi.dims.long()
    cells = int(((dims[:, 0] + 1) * (dims[:, 1] + 1)).sum())
    bits = bi.batch * bi.Dp * bi.n_words * 4
    n_in = _nbytes(bi.fwd_plan if forward else bi.rev_plan, bi.spans,
                   bi.dims, bi.qvecs, bi.tvecs, bi.scalars)
    out = bi.batch * 4 * ((bi.Wp + 1) + 2 if forward else 1)
    plan = bi.fwd_plan if forward else bi.rev_plan
    return n_in + bits + out, 2 * cells * plan.shape[0]


def _synthetic_sdp_jobs():
    """A ragged est2genome batch (single exon, two exons with an intron,
    two seeds in one column, two distant loci), a ner joint-span pair
    and, per split-codon model, its split case with its wide-flanked
    twin, from the cases of tests/torch_sdp_cases.py."""
    import torch_sdp_cases as tc
    e2g = tc.case("single_exon")[0]
    ragged = [tc.case(n, e2g)[1:] for n in (
        "single_exon", "two_exons_intron", "seed_layers_same_column",
        "distant_loci")]
    ner, pair, plan = tc.case("ner_joint_span")
    out = [(e2g, ragged), (ner, [(pair, plan)])]
    for name in tc.SPLIT_CASES:
        m = tc.case(name)[0]
        out.append((m, [tc.case(n, m)[1:] for n in (name, name + "_wide")]))
    return out


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


def _start_plain_check(label, bi, outs: dict, tmp: str, tasks: list):
    """Save the batch and the kernels' outputs under ``tmp`` and start the
    plain passes in worker processes, one per (forward, comparisons)
    task.  Returns (pool, [(label and pass, idx, async result)])."""
    path = os.path.join(tmp, f"{label.replace(' ', '_')}_band.pt")
    torch.save({"bi": _cpu_fields(bi),
                **{k: v.cpu() for k, v in outs.items()}}, path)
    pool = _pool(len(tasks))
    return pool, [(f"{label} {'K7' if fwd else 'K6'}", [int(b) for b in idx],
                   pool.apply_async(_plain_check,
                                    (path, fwd, [int(b) for b in idx])))
                  for fwd, idx in tasks]


def _cpu_fields(obj) -> dict:
    """A dataclass's fields, tensors moved to the CPU (to be saved)."""
    import dataclasses
    return {f.name: (lambda v: v.cpu() if torch.is_tensor(v) else v)(
        getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _pool(n: int):
    """n spawned worker processes, ended when the script ends."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(n)
    _EXIT.callback(pool.join)
    _EXIT.callback(pool.terminate)
    return pool


def _plain_wave_check(path: str):
    """Worker process, CPU only: the plain wavefront over the K1/K4
    inputs saved at ``path``, held against the kernel's outputs saved
    with it; in path mode also the traceback cube's valid cells and the
    plain walk-back over the kernel's cube against the walk-back
    kernel's.  Returns (equal, max |kernel - plain|, seconds, diagonals
    walked)."""
    from exonerate_tpu_torch.engine import wavefront as wf
    torch.set_num_threads(1)
    saved = torch.load(path, weights_only=True)
    ki = wf.KernelInputs(**saved["ki"])
    t0 = time.perf_counter()
    stats, tb = wf.plain_wavefront(ki)
    secs = time.perf_counter() - t0
    err = _max_err(stats, saved["out"])
    ok = torch.equal(stats, saved["out"])
    if ki.mode == "path":
        valid = _tb_valid(ki, tb)
        err = max(err, _max_err(tb[valid], saved["tb"][valid]))
        ops, res = wf.plain_walkback(saved["tb"], saved["out"], ki.walk,
                                     ki.end_id, saved["cap"])
        ok = ok and not err and torch.equal(res, saved["res"]) and all(
            torch.equal(ops[b, :int(res[0, b])],
                        saved["ops"][b, :int(res[0, b])])
            for b in range(ki.batch))
    return ok, err, secs, int((ki.dims[:, 2] + ki.dims[:, 3]).max()) + 1


def _wave_outputs(cw, ki) -> dict:
    """K1 on ``ki`` (K4 and the walk-back in path mode): the outputs that
    ``_plain_wave_check`` holds to the plain version."""
    if ki.mode != "path":
        return {"out": cw.wavefront_scan(ki)}
    stats, tb = cw.wavefront_path(ki)
    cap = ki.Qp + ki.Tp + 1 + cw.WALK_SLACK
    ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, cap)
    return {"out": stats, "tb": tb, "ops": ops, "res": res, "cap": cap}


def _save_wave(path: str, ki, outs: dict) -> str:
    """Save K1/K4 inputs and the kernels' outputs for a worker process."""
    torch.save({"ki": _cpu_fields(ki),
                **{k: v.cpu() if torch.is_tensor(v) else v
                   for k, v in outs.items()}}, path)
    return path


def _sub_batch(ki, idx: list):
    """The pairs ``idx`` of a K1/K4 batch, at the batch's (Qp, Tp)."""
    import dataclasses
    ix = torch.tensor(idx, device=ki.dims.device)
    fields = {f: getattr(ki, f)[ix]
              for f in ("dims", "qvecs", "tvecs", "tables", "scalars")}
    if ki.masked:
        fields["blocked"] = ki.blocked[ix]
    return dataclasses.replace(ki, **fields)


def _widest(ki, n: int = 2) -> list:
    """The ``n`` pairs of a batch with the most cells, widest first."""
    cells = ((ki.dims[:, 2].long() + 1) * (ki.dims[:, 3].long() + 1)).tolist()
    return sorted(range(ki.batch), key=lambda b: -cells[b])[:n]


@contextlib.contextmanager
def _timed(mod, keys: dict, acc: dict):
    """While active, each function ``mod.<name>`` of ``keys`` adds its
    host seconds, ended by a device sync, to ``acc[keys[name](*args)]``."""
    real = {n: getattr(mod, n) for n in keys}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = keys[name](*args, **kwargs)
            acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for n, fn in real.items():
        setattr(mod, n, wrap(n, fn))
    try:
        yield acc
    finally:
        for n, fn in real.items():
            setattr(mod, n, fn)


# where the wavefront routes spend their host clock: host prep (the pairs'
# arrays and SubOpt mask grids; packing and copies), and K1 and K4 with
# and without the mask plane, timed around the uncounted launcher
# ``_launch`` (the counted wrappers keep their launch counters)
WAVE_CLOCKS = {
    "_buckets": lambda *a, **k: "prep: prepare_inputs (masks)",
    "to_kernel_inputs": lambda *a, **k: "prep: to_kernel_inputs (copies)",
    "_launch": lambda ki: ("K4" if ki.mode == "path" else "K1")
    + (" masked" if ki.masked else "")}


def _k2_mb(kis: list) -> list:
    """(B, Qp, Tp, MB) of each K1 batch by the JAX package's streaming test
    (``pallas_wavefront.py:1437-1443``; kernel K2 takes a batch over
    ``STREAM_VMEM_BYTES``, 24 MB): one reversed int32 vector of 2*QV + 128
    + Tp + 265 per target-indexed row (the port's ``tvecs`` rows) per
    pair, QV = Qp + 128 at the bucket ladder's sizes."""
    return [(k.batch, k.Qp, k.Tp, round(k.tvecs.shape[1] * k.batch * (
        2 * (k.Qp + 128) + 128 + k.Tp + 265) * 4 / 2**20, 2))
        for k in kis if k.mode != "path"]


def _breakdown(acc: dict, total: float) -> str:
    parts = [f"{k} {v:.2f} s" for k, v in sorted(acc.items())]
    return (", ".join(parts) + f", the rest (seeding, walk-backs, "
            f"alignments, masks' points, output) "
            f"{total - sum(acc.values()):.2f} s")


def _write_fasta(path: str, records) -> str:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")
    return path


def _vulgar_ops(out: str) -> list:
    """The operation letters of every vulgar line of ``out``."""
    return [ln.split()[10::3] for ln in out.splitlines()
            if ln.startswith("vulgar:")]


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
    import torch_split_cases as sc
    from exonerate_tpu_torch import _cudabuild, observe
    from exonerate_tpu_torch.alphabet import AlphabetType
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import cuda_sdp as cs
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import optimal
    from exonerate_tpu_torch.engine import sdp_device as sd
    from exonerate_tpu_torch.engine import sdp_hybrid as hy
    from exonerate_tpu_torch.engine import sdp_native
    from exonerate_tpu_torch.engine import wavefront as wf
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.model import registry
    from exonerate_tpu_torch.model.affine import (AffineModelType,
                                                  affine_create)
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.model.est2genome import est2genome_create
    from exonerate_tpu_torch.seqio import Annotation, Sequence, iter_fasta
    for mod in ("jax", "exonerate_tpu"):
        if sys.modules.get(mod) is not None:
            raise RuntimeError(f"the port imported {mod}")

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

    def run_cli(argv, allow_crosscheck=False):
        """The CLI's output and host seconds; raises on any engine
        fallback, except, with ``allow_crosscheck``, the hybrid's locus
        cross-check (see scan())."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        if cli_main(argv, out=buf) != 0:
            raise RuntimeError(f"CLI exit status for {argv}")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bad = {k: v for k, v in observe.fallback_counts.items()
               if not (allow_crosscheck and k.startswith(CROSSCHECK))}
        if bad:
            raise RuntimeError(f"engine fallbacks: {bad}")
        engines.update(observe.engine_counts)
        return buf.getvalue(), secs

    # launches of every kernel on the main paths: each path is driven with
    # the counters set to 0 just before it and read just after
    counters = {"K1": cw.wavefront_scan, "K4": cw.wavefront_path,
                "walkback": cw.walkback, "K6": cs.band_reverse,
                "K7": cs.band_forward, "K9": cw.K9, "K3": cw.K3}
    main_launches = dict.fromkeys(counters, 0)

    def zero_counts():
        for c in counters.values():
            c.launches = 0

    def read_counts(label, want):
        got = {k: c.launches for k, c in counters.items()}
        for k, v in got.items():
            main_launches[k] += v
        missing = [k for k in want if got[k] < 1]
        if missing:
            raise RuntimeError(f"{label}: kernels {missing} never ran on the "
                               f"main path ({got})")
        return {k: v for k, v in got.items() if v}

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
    split_band = None
    for bmodel, jobs in _synthetic_sdp_jobs():
        drop = jobs[0][0].args.dropoff
        bi = cs.band_inputs(bmodel, jobs, drop, dev)
        err, _, plain_fwd = _band_vs_plain(bi, f"{bmodel.name} x{len(jobs)}")
        band_err = max(band_err, err)
        if bi.split and bmodel.name.startswith("protein2genome"):
            bits0 = cs.band_reverse(bi)[0]
            split_band = (bmodel.name, bi.Qp, bi.Wp, _cuda_ms(
                lambda: cs.band_forward(bi, bits0), 3), plain_fwd)
        got = cs.run_kernel(bmodel, jobs, drop, dev)
        want = cs.run_kernel(bmodel, jobs, drop, cpu)
        for g, w in zip(got, want):
            if (g["live"], g["xband"]) != (w["live"], w["xband"]) \
                    or not np.array_equal(g["band_end"], w["band_end"]):
                raise RuntimeError(f"K6/K7 {bmodel.name}: run_kernel on "
                                   f"the card != on the CPU")
        print(f"K6/K7 {bmodel.name} x{len(jobs)}"
              f"{' (split codons, K9)' if bi.split else ''}: kernel == "
              f"plain (bits, column best, live, xband, band_end per locus)")

    # the est2genome_genomic golden through the CLI on the forced device
    # route (this first heuristic run also builds the host's native
    # libraries, so that the scans below are timed warm)
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

    # -- 4. the est2genome scan at full width (the band kernels' main path)
    plain_passes = [0]
    real_pass = sd._run_pass

    def counted_pass(*args, **kwargs):
        plain_passes[0] += 1
        return real_pass(*args, **kwargs)

    real_resolve = hy.HybridSDPPair._resolve
    route_secs = {}     # scan label -> (route's host s, native route's)

    def scan(label, argv, mode, want_kernels, force=None, max_crossed=0):
        """The CLI over ``argv`` on the route ``force`` (None: default)
        and on the native route; returns (output, engines, captured
        batches, [(batch, comparison) of each locus cross-check
        mismatch]).

        The hybrid's locus cross-check may disagree on at most
        ``max_crossed`` comparisons: the host's re-run of one locus alone
        finds another score than the band scan of the whole comparison,
        and the comparison goes to the host.  The JAX package's device
        tier does the same on such inputs (ROADMAP.md, Queue 3); the
        caller holds the kernels to the plain passes on each such
        comparison.  Any other fallback, or one more, fails."""
        captured.clear()
        mismatched = []

        def resolve(self, lx):
            try:
                return real_resolve(self, lx)
            except hy.HybridFallback:
                if self.plan is not None:
                    mismatched.append(self.plan)
                raise

        sd._run_pass = counted_pass
        hy.run_device_batch = spy
        hy.HybridSDPPair._resolve = resolve
        if force:
            os.environ["EXONERATE_TPU_SDP"] = force
        observe.reset()
        zero_counts()
        try:
            out_dev, secs_dev = run_cli(argv, max_crossed > 0)
            launches = read_counts(label, want_kernels)
            eng = dict(observe.engine_counts)
            falls = dict(observe.fallback_counts)
            hy.run_device_batch = real_batch
            hy.HybridSDPPair._resolve = real_resolve
            batches = list(captured)
            os.environ["EXONERATE_TPU_SDP"] = "native"
            observe.reset()
            out_nat, secs_nat = run_cli(argv)
        finally:
            os.environ.pop("EXONERATE_TPU_SDP", None)
            sd._run_pass = real_pass
            hy.run_device_batch = real_batch
            hy.HybridSDPPair._resolve = real_resolve
        route_secs[label] = (secs_dev, secs_nat)
        crossed = [(bx, jx) for bx, (_m, jobs_, _s) in enumerate(batches)
                   for jx, (_p, pl) in enumerate(jobs_)
                   if any(pl is q for q in mismatched)]
        print(f"{label} [{card}]: {mode} {secs_dev:.2f} s, "
              f"EXONERATE_TPU_SDP=native {secs_nat:.2f} s (host clock); "
              f"engines {eng}; launches {launches}; fallbacks {falls}")
        if sum(falls.values()) != len(crossed):
            raise RuntimeError(f"{label}: fallbacks {falls} are not the "
                               f"{len(crossed)} locus cross-checks found")
        if len(crossed) > max_crossed:
            raise RuntimeError(f"{label}: {len(crossed)} locus cross-check "
                               f"mismatches, at most {max_crossed} allowed")
        if out_dev != out_nat:
            raise RuntimeError(f"{label}: the {mode} output differs from "
                               f"the native route's")
        if eng.get(cs.engine_name(dev), 0) < 1:
            raise RuntimeError(f"{label}: no comparison on "
                               f"{cs.engine_name(dev)}: {eng}")
        if plain_passes[0]:
            raise RuntimeError(f"{label}: {plain_passes[0]} plain band-scan "
                               f"passes ran on the main path")
        return out_dev, eng, batches, crossed

    tmp_dir = _EXIT.enter_context(tempfile.TemporaryDirectory())
    queries, genome = sc.scan_genome((400, 800))
    qf = _write_fasta(os.path.join(tmp_dir, "q.fa"),
                      [(f"q{k}", q) for k, q in enumerate(queries)])
    tf = _write_fasta(os.path.join(tmp_dir, "t.fa"), [("genome", genome)])
    scan_label = f"scan {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb est2genome"
    out_dev, scan_eng, batches, _ = scan(
        scan_label,
        SCAN_ARGV + [qf, tf], "default routing", ("K6", "K7"))
    spliced = {v[1] for v in (ln.split() for ln in out_dev.splitlines()
                              if ln.startswith("vulgar:"))
               if "I" in v[10::3]}
    print(f"  {len(spliced)}/{SCAN_QUERIES} queries spliced")
    if scan_eng.get(cs.engine_name(dev)) != SCAN_QUERIES:
        raise RuntimeError(f"scan: want {SCAN_QUERIES} comparisons on "
                           f"{cs.engine_name(dev)}, got {scan_eng}")
    if len(spliced) != SCAN_QUERIES:
        raise RuntimeError(f"scan: {len(spliced)}/{SCAN_QUERIES} queries "
                           f"with a spliced alignment")
    if len(batches) != 1:
        raise RuntimeError(f"scan: want one device batch, got "
                           f"{len(batches)}")
    smodel, sjobs, batch_secs = batches[0]
    bi = cs.band_inputs(smodel, sjobs, sjobs[0][0].args.dropoff, dev)
    (bits_s, live_r), s_rev = _cuda_call(lambda: cs.band_reverse(bi))
    (col_s, live_f, xb_s), s_fwd = _cuda_call(
        lambda: cs.band_forward(bi, bits_s))
    scan_work = (_band_work(bi, False), _band_work(bi, True))
    ws = [pl.W for _, pl in sjobs]
    print(f"scan band batch: B={len(sjobs)}, Qp {bi.Qp}, W {min(ws)}-"
          f"{max(ws)}, Wp {bi.Wp}, Dp {bi.Dp}, "
          f"{cs.pair_bytes(smodel, bi.Qp, bi.Wp, bi.tvecs.shape[1]) / 1e6:.1f}"
          f" MB per comparison [{card}]: K6 {s_rev:.3f} ms, K7 "
          f"{s_fwd:.3f} ms (CUDA events); in the default-route run the "
          f"batch took {batch_secs:.2f} s host clock (host prep, copies, "
          f"K6, K7)")
    length = (bi.dims[:, 0] + bi.dims[:, 1]).tolist()
    order = sorted(range(bi.batch), key=lambda b: -length[b])
    tasks = [(fwd, c) for fwd, n in ((False, SCAN_REV_CHUNKS),
                                     (True, SCAN_FWD_CHUNKS))
             for c in np.array_split(order, min(n, bi.batch))]
    pool, pending = _start_plain_check(
        "scan", bi, {"bits": bits_s, "live_r": live_r, "colbest": col_s,
                     "live_f": live_f, "xband": xb_s}, tmp_dir, tasks)
    pools = [pool]
    check_t0 = time.perf_counter()
    del bi, bits_s, col_s

    def check_launches(label, model_, jobs_, check):
        """K6/K7 again on each launch that the main path made of the band
        batch ``jobs_`` (``cuda_sdp.launch_batches``), timed by CUDA
        events; the comparisons ``check`` start their plain check in
        worker processes at the shape of their launch.  Returns (K6 ms,
        K7 ms, each summed over the launches; (B, Qp, Wp) of each launch;
        the launches' summed (bytes, operations) for K6 and for K7)."""
        k6 = k7 = 0.0
        shapes, w6, w7 = [], [0, 0], [0, 0]
        for n, chunk in enumerate(cs.launch_batches(model_, jobs_)):
            bi = cs.band_inputs(model_, [jobs_[j] for j in chunk],
                                jobs_[0][0].args.dropoff, dev)
            (bits, live_r), t6 = _cuda_call(lambda: cs.band_reverse(bi))
            (col, live_f, xb), t7 = _cuda_call(
                lambda: cs.band_forward(bi, bits))
            k6, k7 = k6 + t6, k7 + t7
            shapes.append((len(chunk), bi.Qp, bi.Wp))
            for w, work in ((w6, _band_work(bi, False)),
                            (w7, _band_work(bi, True))):
                w[0], w[1] = w[0] + work[0], w[1] + work[1]
            mine = [chunk.index(j) for j in check if j in chunk]
            if mine:
                pool, more = _start_plain_check(
                    f"{label} launch {n}", bi,
                    {"bits": bits, "live_r": live_r, "colbest": col,
                     "live_f": live_f, "xband": xb}, tmp_dir,
                    [(False, mine), (True, mine)])
                pools.append(pool)
                pending.extend(more)
            del bi, bits, col
        return k6, k7, shapes, (tuple(w6), tuple(w7))

    def to_check(label, batches, crossed):
        """The band batch holding every cross-check mismatch (the largest
        batch when there is none) and the comparisons to hold to the
        plain passes: the mismatched ones, else the widest."""
        bx = max(range(len(batches)), key=lambda b: len(batches[b][1]))
        if any(b != bx for b, _ in crossed):
            raise RuntimeError(f"{label}: cross-check mismatches {crossed} "
                               f"outside the batch checked")
        widths = [pl.W for _, pl in batches[bx][1]]
        return (batches[bx], widths,
                [jx for _, jx in crossed] or [int(np.argmax(widths))])

    # -- 5. the split-codon paths (K9) -----------------------------------
    # a. coding2genome scan, default routing
    squeries, sgenome = sc.scan_genome(sc.CUTS)
    sqf = _write_fasta(os.path.join(tmp_dir, "sq.fa"),
                       [(f"q{k}", q) for k, q in enumerate(squeries)])
    stf = _write_fasta(os.path.join(tmp_dir, "st.fa"),
                       [("split_genome", sgenome)])
    c2g_out, c2g_eng, c2g_batches, c2g_crossed = scan(
        f"coding2genome scan {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb",
        C2G_ARGV + [sqf, stf], "default routing", ("K6", "K7", "K9"),
        max_crossed=C2G_MAX_CROSSED)
    if not any("S" in ops for ops in _vulgar_ops(c2g_out)):
        raise RuntimeError("coding2genome scan: no split-codon operation")
    (cmodel, cjobs, c_secs), c_ws, c_check = to_check(
        "coding2genome scan", c2g_batches, c2g_crossed)
    c_rev, c_fwd, c_shapes, c2g_work = check_launches(
        "coding2genome", cmodel, cjobs, c_check)
    print(f"  coding2genome band batch: B={len(cjobs)}, W {min(c_ws)}-"
          f"{max(c_ws)}, launches (B, Qp, Wp) {c_shapes} [{card}]: K6 "
          f"{c_rev:.3f} ms, K7 {c_fwd:.3f} ms (CUDA events); batch "
          f"{c_secs:.2f} s host clock; plain check of comparisons "
          f"{c_check} started")

    # b. protein2genome scan, forced device route
    proteins = sc.mutated_proteins(8)
    pqf = _write_fasta(os.path.join(tmp_dir, "pq.fa"),
                       [(f"p{k}", p) for k, p in enumerate(proteins)])
    p2g_out, _, p2g_batches, p2g_crossed = scan(
        "protein2genome scan 8 x 1 Mb", P2G_ARGV + [pqf, stf],
        "EXONERATE_TPU_SDP=device", ("K6", "K7", "K9"), force="device")
    if not any("S" in ops for ops in _vulgar_ops(p2g_out)):
        raise RuntimeError("protein2genome scan: no split-codon operation")
    (pmodel, pjobs, p_secs), p_ws, p_check = to_check(
        "protein2genome scan", p2g_batches, p2g_crossed)
    pk_rev, pk_fwd, p_shapes, p2g_work = check_launches(
        "protein2genome", pmodel, pjobs, p_check)
    print(f"  protein2genome band batch: B={len(pjobs)}, W {min(p_ws)}-"
          f"{max(p_ws)}, launches (B, Qp, Wp) {p_shapes} [{card}]: K6 "
          f"{pk_rev:.3f} ms, K7 {pk_fwd:.3f} ms (CUDA events, summed); "
          f"batch {p_secs:.2f} s host clock; plain check of comparisons "
          f"{p_check} started")

    # c. protein2genome -E yes: the calm protein x the 12 kb split locus
    locus = sc.split_locus()
    prot = sc.calm_protein()
    eqf = _write_fasta(os.path.join(tmp_dir, "calm_p.fa"), [("calm", prot)])
    etf = _write_fasta(os.path.join(tmp_dir, "locus.fa"), [("locus", locus)])
    argv_e = ["-m", "protein2genome", "-E", "yes", "--bestn", "1", eqf, etf,
              "--showvulgar", "yes", "--showalignment", "no"]
    p2g_cells = (len(prot) + 1) * (len(locus) + 1)
    saved_cut = optimal.NATIVE_TPU_CELLS
    # the K1/K4 inputs of the run, captured on the way
    e_kis = []
    real_tki = cw.to_kernel_inputs

    def capture_ki(*args, **kwargs):
        e_kis.append(real_tki(*args, **kwargs))
        return e_kis[-1]

    observe.reset()
    zero_counts()
    try:
        optimal.NATIVE_TPU_CELLS = P2G_E_CUTOVER
        cw.to_kernel_inputs = capture_ki
        out_e, secs_e = run_cli(argv_e)
        cw.to_kernel_inputs = real_tki
        e_launches = read_counts("protein2genome -E yes",
                                 ("K1", "K4", "walkback", "K9"))
        e_eng = dict(observe.engine_counts)
        optimal.NATIVE_TPU_CELLS = p2g_cells + 1
        observe.reset()
        nat_e, nat_secs_e = run_cli(argv_e)
    finally:
        optimal.NATIVE_TPU_CELLS = saved_cut
        cw.to_kernel_inputs = real_tki
    ops_e = _vulgar_ops(out_e)
    print(f"protein2genome -E yes calm protein {len(prot)} aa x locus "
          f"{len(locus)} bp [{card}]: kernels {secs_e:.2f} s, native "
          f"{nat_secs_e:.2f} s (host clock); engines {e_eng}; launches "
          f"{e_launches}; vulgar ops {ops_e}; K1/K4 inputs (mode, B, Qp, "
          f"Tp) {[(k.mode, k.batch, k.Qp, k.Tp) for k in e_kis]}")
    if out_e != nat_e:
        raise RuntimeError("protein2genome -E yes: the kernels' output "
                           "differs from the native route's")
    if len(ops_e) != 1 or ops_e[0].count("I") != 2 \
            or ops_e[0].count("S") != 4:
        raise RuntimeError("protein2genome -E yes: want split codons (S) "
                           "at both introns")
    # every K1/K4 launch of the run is held to the plain version on its
    # own inputs, in a worker process; the first widest region scan is
    # kernel K9's row (timed in phase 7)
    e_main = max((k for k in e_kis if k.mode == "region"),
                 key=lambda k: k.batch * (k.Qp + 1) * (k.Tp + 1))
    e_pool = _pool(1)
    pools.append(e_pool)
    for n, ki in enumerate(e_kis):
        path = _save_wave(os.path.join(tmp_dir, f"p2g_e_{n}.pt"), ki,
                          _wave_outputs(cw, ki))
        res = e_pool.apply_async(_plain_wave_check, (path,))
        if ki is e_main:
            e_pending = res
        pending.append((f"protein2genome -E launch {n} ({ki.mode}, Qp "
                        f"{ki.Qp} x Tp {ki.Tp})", list(range(ki.batch)),
                        res))

    # -- 6. the SubOpt mask (kernel K3) ----------------------------------
    # a. est2genome -E yes Waterman-Eggert: calm against two interleaved
    # spliced copies of itself in a 30 kb window
    calm_s = sc.calm()
    we_locus = sc.two_copy_locus(calm_s, WE_GAP, WE_LEN, WE_START)
    wqf = _write_fasta(os.path.join(tmp_dir, "calm.fa"), [("calm", calm_s)])
    wtf = _write_fasta(os.path.join(tmp_dir, "we.fa"), [("two_copies",
                                                          we_locus)])
    argv_we = ["-m", "est2genome", "-E", "yes", "--bestn", "2", "--score",
               str(WE_SCORE), wqf, wtf, "--showvulgar", "yes",
               "--showalignment", "no"]
    we_cells = (len(calm_s) + 1) * (len(we_locus) + 1)
    we_kis, iters = [], [0]
    real_fp = optimal.find_path

    def count_fp(model_, region, *args, **kwargs):
        # the Waterman-Eggert iterations: find_path on the whole pair
        if (region.query_length, region.target_length) == (
                len(calm_s), len(we_locus)):
            iters[0] += 1
        return real_fp(model_, region, *args, **kwargs)

    def capture_we(*args, **kwargs):
        we_kis.append(real_tki(*args, **kwargs))
        return we_kis[-1]

    saved_budget = optimal.NATIVE_TB_BUDGET
    we_time = {}
    observe.reset()
    zero_counts()
    try:
        cw.to_kernel_inputs = capture_we
        optimal.find_path = count_fp
        with _timed(cw, WAVE_CLOCKS, we_time):
            out_we, secs_we = run_cli(argv_we)
        cw.to_kernel_inputs = real_tki
        optimal.find_path = real_fp
        we_launches = read_counts("est2genome -E yes Waterman-Eggert",
                                  ("K1", "K4", "walkback", "K3"))
        we_eng = dict(observe.engine_counts)
        optimal.NATIVE_TPU_CELLS = we_cells + 1
        optimal.NATIVE_TB_BUDGET = we_cells * len(model.states) * 2
        observe.reset()
        nat_we, nat_secs_we = run_cli(argv_we)
    finally:
        optimal.NATIVE_TPU_CELLS = saved_cut
        optimal.NATIVE_TB_BUDGET = saved_budget
        cw.to_kernel_inputs = real_tki
        optimal.find_path = real_fp
    we_shapes = [(k.mode, k.batch, k.Qp, k.Tp, "masked" if k.masked
                  else "mask-free") for k in we_kis]
    print(f"est2genome -E yes Waterman-Eggert calm {len(calm_s)} x "
          f"{len(we_locus)} bp, two interleaved spliced copies [{card}]: "
          f"{iters[0]} iterations; kernels {secs_we:.2f} s, native "
          f"{nat_secs_we:.2f} s (host clock); engines {we_eng}; launches "
          f"{we_launches}; K1/K4 launches {we_shapes}")
    print(f"  where the kernel route's {secs_we:.2f} s go (host clock): "
          f"{_breakdown(we_time, secs_we)}; K1 batches by the JAX package's "
          f"K2 test (B, Qp, Tp, MB of 24): {_k2_mb(we_kis)}")
    if out_we != nat_we:
        raise RuntimeError("est2genome -E yes: the kernels' output differs "
                           "from the native route's")
    ops_we = _vulgar_ops(out_we)
    if len(ops_we) != 2 or any(o.count("I") != 2 for o in ops_we):
        raise RuntimeError(f"est2genome -E yes: want both copies with two "
                           f"introns each, got {ops_we}")
    n_masked = sum(k.masked for k in we_kis)
    if not any(k.masked and k.mode == "region" for k in we_kis) \
            or not any(k.masked and k.mode == "path" for k in we_kis) \
            or we_launches["K3"] != n_masked:
        raise RuntimeError(f"est2genome -E yes: K3 must run inside K1 and "
                           f"K4 ({we_shapes}; K3 launches "
                           f"{we_launches['K3']})")
    # the widest masked region scan (kernel K3's row, timed here) and the
    # first masked path DP are held to their plain versions in worker
    # processes
    we_main = max((k for k in we_kis if k.masked and k.mode == "region"),
                  key=lambda k: k.batch * (k.Qp + 1) * (k.Tp + 1))
    we_path = next(k for k in we_kis if k.masked and k.mode == "path")
    we_free = next(k for k in we_kis if not k.masked and k.mode == "region"
                   and (k.Qp, k.Tp) == (we_main.Qp, we_main.Tp))
    del we_kis
    we_pool = _pool(2)
    pools.append(we_pool)
    we_pending = {}
    for tag, ki in (("K1", we_main), ("K4", we_path)):
        outs = _wave_outputs(cw, ki)
        if tag == "K1":
            k3_ms = _cuda_ms(lambda: cw.wavefront_scan(we_main), 2)
            free_ms = _cuda_ms(lambda: cw.wavefront_scan(we_free), 1)
        path = _save_wave(os.path.join(tmp_dir, f"we_{tag}.pt"), ki, outs)
        del outs
        we_pending[tag] = we_pool.apply_async(_plain_wave_check, (path,))
        pending.append((f"est2genome -E yes masked {tag} ({ki.mode}, Qp "
                        f"{ki.Qp} x Tp {ki.Tp} x{ki.batch})",
                        list(range(ki.batch)), we_pending[tag]))
    k3_shape = (f"Qp {we_main.Qp} x Tp {we_main.Tp} x{we_main.batch}, "
                f"{len(calm_s)} x {len(we_locus)}")
    print(f"K1 region with K3, the -E run's widest masked scan ({k3_shape})"
          f" [{card}]: kernel {k3_ms:.3f} ms, the same pair mask-free "
          f"{free_ms:.3f} ms (CUDA events); its plain check"
          f" and the first masked K4's (Qp {we_path.Qp} x Tp {we_path.Tp}) "
          f"started")
    k3_work = _wave_work(we_main, 5 * we_main.batch * 4)

    # b. the pooled locus heuristic at the flagship's shape: phase 4's
    # scan with EXONERATE_TPU_HEURISTIC=locus and --bestn 10, so that no
    # comparison is full after the first generation
    lo_kis, lo_gens = [], []
    real_fb = cw.find_batched

    def capture_lo(*args, **kwargs):
        lo_kis.append(real_tki(*args, **kwargs))
        return lo_kis[-1]

    def count_gen(model_, jobs_, mode="region", device=None, subopt=None):
        lo_gens.append((len(jobs_), any(
            x is not None and x.points for x in subopt or [])))
        return real_fb(model_, jobs_, mode, device=device, subopt=subopt)

    argv_lo = LOCUS_ARGV + [qf, tf]
    lo_time = {}
    observe.reset()
    zero_counts()
    os.environ["EXONERATE_TPU_HEURISTIC"] = "locus"
    try:
        cw.to_kernel_inputs = capture_lo
        cw.find_batched = count_gen
        with _timed(cw, WAVE_CLOCKS, lo_time):
            out_lo, secs_lo = run_cli(argv_lo)
    finally:
        os.environ.pop("EXONERATE_TPU_HEURISTIC")
        cw.to_kernel_inputs = real_tki
        cw.find_batched = real_fb
    lo_launches = read_counts("locus pool", ("K1", "K4", "walkback", "K3"))
    lo_eng = dict(observe.engine_counts)
    spliced_lo = {v[1] for v in (ln.split() for ln in out_lo.splitlines()
                                 if ln.startswith("vulgar:"))
                  if "I" in v[10::3]}
    print(f"locus pool {SCAN_QUERIES} x {SCAN_LEN / 1e6:.0f} Mb est2genome "
          f"(EXONERATE_TPU_HEURISTIC=locus, --bestn 10) [{card}]: "
          f"{secs_lo:.2f} s host clock (phase 4's default SDP route "
          f"{route_secs[scan_label][0]:.2f} s); {len(lo_gens)} generations "
          f"(jobs, masked) {lo_gens}; engines {lo_eng}; launches "
          f"{lo_launches}; {len(spliced_lo)}/{SCAN_QUERIES} queries spliced;"
          f" K1/K4 launches (mode, B, Qp, Tp, masked) "
          f"{[(k.mode, k.batch, k.Qp, k.Tp, k.masked) for k in lo_kis]}")
    print(f"  where the locus pool's {secs_lo:.2f} s go (host clock): "
          f"{_breakdown(lo_time, secs_lo)}; the largest K1 batches by the "
          f"JAX package's K2 test (B, Qp, Tp, MB of 24): "
          f"{sorted(_k2_mb(lo_kis), key=lambda x: -x[3])[:4]}")
    if not any(m for _, m in lo_gens) or not lo_launches.get("K3"):
        raise RuntimeError("locus pool: no masked generation ran on K3")
    if len(spliced_lo) != SCAN_QUERIES:
        raise RuntimeError(f"locus pool: {len(spliced_lo)}/{SCAN_QUERIES} "
                           f"queries with a spliced alignment")
    # the first masked region batch and its path batch, again on a
    # sub-batch of their two widest pairs: equal to the full batch's
    # results for those pairs, and to the plain versions (worker processes)
    lo_reg = next(n for n, k in enumerate(lo_kis)
                  if k.masked and k.mode == "region")
    lo_path = next((n for n, k in enumerate(lo_kis)
                    if n > lo_reg and k.masked and k.mode == "path"),
                   next(n for n, k in enumerate(lo_kis)
                        if n > lo_reg and k.mode == "path"))
    lo_pool = _pool(2)
    pools.append(lo_pool)
    lo_checked = []
    for n in (lo_reg, lo_path):
        ki = lo_kis[n]
        idx = _widest(ki)
        whole = _wave_outputs(cw, ki)
        sub = _sub_batch(ki, idx)
        outs = _wave_outputs(cw, sub)
        ix = torch.tensor(idx, device=dev)
        same = torch.equal(outs["out"], whole["out"][:, ix])
        if ki.mode == "path":
            same = same and torch.equal(outs["res"], whole["res"][:, ix])
            same = same and all(
                torch.equal(outs["ops"][k, :int(outs["res"][0, k])],
                            whole["ops"][b, :int(outs["res"][0, k])])
                for k, b in enumerate(idx))
        del whole
        if not same:
            raise RuntimeError(f"locus pool launch {n} ({ki.mode}): pairs "
                               f"{idx} differ from the full batch's")
        path = _save_wave(os.path.join(tmp_dir, f"locus_{n}.pt"), sub, outs)
        del outs
        pending.append((f"locus pool launch {n} ({ki.mode}, masked "
                        f"{ki.masked}, Qp {ki.Qp} x Tp {ki.Tp}, pairs {idx} "
                        f"of B={ki.batch})", idx,
                        lo_pool.apply_async(_plain_wave_check, (path,))))
        lo_checked.append((n, ki.mode, ki.batch, ki.Qp, ki.Tp, idx))
    del lo_kis
    print(f"  locus pool: launches {lo_checked} (launch, mode, B, Qp, Tp, "
          f"pairs) equal the full batch's results; plain checks started")

    # -- 7. K1 vs plain --------------------------------------------------
    for mode in ("score", "region"):
        ki = cw.to_kernel_inputs(model, [inputs] * BATCH, kinds, dev, mode)
        got, want, ms, plain_ms = _turns(lambda: wf.plain_wavefront(ki)[0],
                                         lambda: cw.wavefront_scan(ki))
        err = _max_err(got, want)
        if err or not torch.equal(got, want):
            raise RuntimeError(f"K1 {mode}: kernel != plain (max err {err})")
        if set(got[0].tolist()) != {CALM_SELF_SCORE}:
            raise RuntimeError(f"K1 {mode}: scores {set(got[0].tolist())}")
        print(f"K1 {mode} calm {CALM_LEN}^2 x{BATCH} [{card}]: kernel "
              f"{ms:.3f} ms ({ms / BATCH:.4f} ms/pair, "
              f"{cells * BATCH / ms / 1e6:.3f} GCUPS), plain {plain_ms:.3f}"
              f" ms ({plain_ms / BATCH:.4f} ms/pair, "
              f"{cells * BATCH / plain_ms / 1e6:.4f} GCUPS)")
        report[f"K1_{mode}"] = (err, ms, plain_ms,
                                _wave_work(ki, 5 * BATCH * 4))
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
    # K=4/6 carry rings of codon models, NER; region and path modes; the
    # split-codon pairs of coding2genome and cdna2genome
    dna_q, dna_t = calm.subseq(0, 300), calm.subseq(20, 330)
    pep = Sequence("p", None, "MADQLTEEQIAEFKEAFSLFDKDGDGTITTKELGTVMRSL")
    zoo = [(mt, q, t) for mt, q, t in (
        ("AFFINE_GLOBAL", dna_q, dna_t), ("AFFINE_BESTFIT", dna_q, dna_t),
        ("AFFINE_OVERLAP", dna_q, dna_t), ("NER", dna_q, dna_t),
        ("CODING2CODING", dna_q, dna_t), ("PROTEIN2DNA", pep, dna_t))]
    for mt, cuts in (("CODING2GENOME", sc.C2G_CUTS), ("CDNA2GENOME", sc.CUTS)):
        q, t = sc.small_pair("cdna", cuts=cuts)
        qs = Sequence("q", None, q)
        if mt == "CDNA2GENOME":
            qs.annotation = Annotation(0, len(q))
        zoo.append((mt, qs, Sequence("t", None, t)))
    names = []
    for mt, q, t in zoo:
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
    # the split-codon plans at width: the calm protein against 8 windows
    # of the 12 kb locus (each holds the whole gene)
    p2g = registry.get_model(registry.ModelType.PROTEIN2GENOME,
                             AlphabetType.PROTEIN, AlphabetType.DNA)
    pdata = AlignData(Sequence("calm", None, prot),
                      Sequence("locus", None, locus))
    windows = [Region(0, 2800 + 30 * k, len(prot), 2000) for k in range(8)]
    wQp, wTp = wf._bucket(len(prot)), wf._bucket(2000)
    per = [wf.prepare_inputs(p2g, r, pdata, pad_to=(wQp, wTp),
                             for_pallas=True) for r in windows]
    for mode in ("score", "region", "path"):
        ki = cw.to_kernel_inputs(p2g, [p for p, _ in per], per[0][1], dev,
                                 mode)
        if mode == "path":
            (stats, tb), (p_stats, p_tb), ms, p_ms = _turns(
                lambda: wf.plain_wavefront(ki),
                lambda: cw.wavefront_path(ki), 1)
            valid = _tb_valid(ki, tb)
            err = max(_max_err(stats, p_stats),
                      _max_err(tb[valid], p_tb[valid]))
            ok = torch.equal(stats, p_stats) and not err
            cap = ki.Qp + ki.Tp + 1 + cw.WALK_SLACK
            ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, cap)
            p_ops, p_res = wf.plain_walkback(tb, stats, ki.walk, ki.end_id,
                                             cap)
            ok = ok and torch.equal(res, p_res) and all(
                torch.equal(ops[b, :int(res[0, b])],
                            p_ops[b, :int(res[0, b])])
                for b in range(ki.batch))
            del tb, p_tb
        else:
            got, want, ms, p_ms = _turns(
                lambda: wf.plain_wavefront(ki)[0],
                lambda: cw.wavefront_scan(ki))
            err = _max_err(got, want)
            ok = torch.equal(got, want)
        if not ok:
            raise RuntimeError(f"K1/K4 {mode} protein2genome windows: "
                               f"kernel != plain (max err {err})")
        print(f"K1/K4 {mode} protein2genome calm protein x 8 windows of "
              f"2000 bp (split codons, K9) [{card}]: kernel == plain; "
              f"kernel {ms:.3f} ms, plain {p_ms:.3f} ms")
    # K1 on the p2g -E yes run's own inputs (its first widest region scan,
    # B=1), timed: kernel K9's row (its plain check runs in a worker
    # process since phase 5c)
    e_ms = _cuda_ms(lambda: cw.wavefront_scan(e_main), 3)
    e_shape = (f"Qp {e_main.Qp} x Tp {e_main.Tp} x{e_main.batch}, "
               f"{len(prot)} x {len(locus)}")
    print(f"K1 region protein2genome -E yes run's scan ({e_shape}; split "
          f"codons, K9) [{card}]: kernel {e_ms:.3f} ms")
    k9_work = _wave_work(e_main, 5 * e_main.batch * 4)

    # -- 8. K4 + walk-back vs plain and the native dense DP --------------
    ki = cw.to_kernel_inputs(model, [inputs], kinds, dev, "path")
    (stats, tb), (p_stats, p_tb), path_ms, path_plain_ms = _turns(
        lambda: wf.plain_wavefront(ki), lambda: cw.wavefront_path(ki), 2)
    D, W = Qp + Tp + 1, Qp + 1
    valid = _tb_valid(ki, tb)
    tb_err = _max_err(tb[valid], p_tb[valid])
    if tb_err or not torch.equal(stats, p_stats):
        raise RuntimeError(f"K4: kernel != plain (tb max err {tb_err})")
    cap = D + cw.WALK_SLACK
    (ops, res), (p_ops, p_res), walk_ms, walk_plain_ms = _turns(
        lambda: wf.plain_walkback(tb, stats, ki.walk, ki.end_id, cap),
        lambda: cw.walkback(tb, stats, ki.walk, ki.end_id, cap), 10)
    k = int(res[0, 0])
    if not torch.equal(res, p_res) or not torch.equal(ops[:, :k],
                                                      p_ops[:, :k]):
        raise RuntimeError("walk-back: kernel != plain")
    walk_err = _max_err(res, p_res)
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
    S, B1 = ki.S, 1
    report["K4"] = (tb_err, path_ms, path_plain_ms,
                    _wave_work(ki, 5 * 4 + B1 * D * S * W))
    # per step the walk reads one cube byte and one id-table column and
    # writes one op
    report["walkback"] = (walk_err, walk_ms, walk_plain_ms,
                          (k * (1 + 16 + 4) + _nbytes(stats) + 12, 6 * k))

    # -- 9. the port's CLI, end to end (the exhaustive main path) -------
    golden = dict((n, argv) for n, _prog, argv in cases.CASES)[
        "exhaustive_est2genome"]
    engines.clear()
    observe.reset()
    zero_counts()
    out, secs = run_cli(golden)
    with open(os.path.join(cases.OUTDIR, "exhaustive_est2genome.txt")) as fh:
        if cases.normalize(out) != fh.read():
            raise RuntimeError("CLI: exhaustive_est2genome differs from "
                               "its golden output")
    print(f"CLI exhaustive_est2genome: byte-equal to the golden "
          f"({secs:.2f} s host clock)")
    with open(os.path.join(DATA, "all4.fa")) as fh:
        calm_fa = ">" + fh.read()[1:].split("\n>")[0] + "\n"
    path = os.path.join(tmp_dir, "calm.fa")
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
    launches = read_counts("exhaustive est2genome CLI",
                           ("K1", "K4", "walkback"))
    print(f"exhaustive main-path launches {launches}; engines {engines}")
    if cw.engine_name(dev) not in engines:
        raise RuntimeError(f"the CLI did not use {cw.engine_name(dev)}")

    # -- 10. K6/K7 vs plain on est2genome_genomic's comparison, timed ---
    pair_g, plan_g = max(gjobs, key=lambda j: (j[0].region.query_length + 1)
                         * (j[1].W + 1))
    q_g, w_g = pair_g.region.query_length, plan_g.W
    bi = cs.band_inputs(gmodel, [(pair_g, plan_g)], pair_g.args.dropoff, dev)
    err, p_rev, p_fwd = _band_vs_plain(bi, name_g)
    band_err = max(band_err, err)
    k_rev = (_cuda_ms(lambda: cs.band_reverse(bi), 3)
             + _cuda_ms(lambda: cs.band_reverse(bi), 3)) / 2
    bits_g = cs.band_reverse(bi)[0]
    k_fwd = (_cuda_ms(lambda: cs.band_forward(bi, bits_g), 3)
             + _cuda_ms(lambda: cs.band_forward(bi, bits_g), 3)) / 2
    n_diag_g = q_g + w_g + 1
    print(f"{name_g}'s comparison Q {q_g} x W {w_g} "
          f"({n_diag_g} diagonals) [{card}]: K6 kernel {k_rev:.3f} ms, "
          f"plain {p_rev:.3f} ms; K7 kernel {k_fwd:.3f} ms, plain "
          f"{p_fwd:.3f} ms; kernel == plain")
    genomic_work = (_band_work(bi, False), _band_work(bi, True))
    if split_band is not None:
        print(f"K7 on the split-codon synthetic batch {split_band[0]} (Qp "
              f"{split_band[1]}, Wp {split_band[2]}) [{card}]: kernel "
              f"{split_band[3]:.3f} ms, plain {split_band[4]:.3f} ms")
    print(f"K6/K7 at the scans' batches [{card}]: est2genome {s_rev:.3f} / "
          f"{s_fwd:.3f} ms; coding2genome {c_rev:.3f} / {c_fwd:.3f} ms; "
          f"protein2genome {pk_rev:.3f} / {pk_fwd:.3f} ms (summed over "
          f"{len(p_shapes)} launches)")

    # -- 11. the plain checks (started in phases 4 to 6) -----------------
    wait_t0 = time.perf_counter()
    for pname, idx, res in pending:
        left = DEADLINE_S - (time.perf_counter() - t_start)
        equal, err, secs, n_diag = res.get(timeout=max(left, 1.0))
        print(f"plain check {pname} over comparisons {idx} (B={len(idx)}, "
              f"{n_diag} diagonals): {secs:.1f} s on one host core "
              f"({secs / n_diag * 1e3:.3f} ms per diagonal); max "
              f"|kernel - plain| {err}")
        if not equal:
            raise RuntimeError(f"{pname}: kernel != plain on comparisons "
                               f"{idx} (max err {err})")
        band_err = max(band_err, err)
    for pool in pools:
        pool.close()
    print(f"plain checks: kernel == plain on all {len(sjobs)} comparisons "
          f"of the est2genome scan, comparisons {c_check} of the "
          f"coding2genome scan and {p_check} of the protein2genome scan "
          f"(bits, live; column best, live, xband) and on the protein2genome"
          f" -E run's other K1/K4 launches, the est2genome -E run's widest "
          f"masked K1 and first masked K4 and the locus pool's sampled pairs"
          f" (scores, ends, starts; cube, walk-back), "
          f"{time.perf_counter() - check_t0:.1f} s after they started, "
          f"{time.perf_counter() - wait_t0:.1f} s of it waited for")
    report["K6"] = (band_err, k_rev, p_rev, genomic_work[0])
    report["K7"] = (band_err, k_fwd, p_fwd, genomic_work[1])
    # K9's and K3's plain times: the plain version on one host core (worker
    # processes)
    _, k9_err, k9_plain_s, _ = e_pending.get()
    report["K9"] = (k9_err, e_ms, k9_plain_s * 1e3, k9_work)
    _, k3_err, k3_plain_s, _ = we_pending["K1"].get()
    report["K3"] = (k3_err, k3_ms, k3_plain_s * 1e3, k3_work)

    src = "exonerate_tpu_torch/csrc/"
    pw = "exonerate_tpu/engine/pallas_wavefront.py"
    sp = "exonerate_tpu/engine/sdp_pallas.py"
    kernels = [
        ("K1 wavefront_scan (region, calm 2175^2 x64)", "K1", "K1_region",
         src + "wavefront.cu", pw + ":427"),
        ("K4 wavefront_path (calm 2175^2 x1)", "K4", "K4",
         src + "wavefront.cu", pw + ":1147"),
        ("walkback (calm 2175^2 x1)", "walkback", "walkback",
         src + "walkback.cu", pw + ":1550"),
        (f"K6 band_reverse ({name_g}, Q {q_g} x W {w_g})", "K6", "K6",
         src + "sdp_band.cu", sp + ":974"),
        (f"K7 band_forward ({name_g}, Q {q_g} x W {w_g})", "K7", "K7",
         src + "sdp_band.cu", sp + ":996"),
        (f"K9 split codon: C_SPLIT inside K1 (region, the protein2genome "
         f"-E yes run's scan, {e_shape}; plain ms on one host core)", "K9",
         "K9",
         src + "wavefront.cu", "exonerate_tpu/model/phase.py:305"),
        (f"K3 SubOpt mask: the MASKED instantiation of K1 (region, the "
         f"est2genome -E yes run's widest masked scan, {k3_shape}; plain ms "
         f"on one host core)", "K3", "K3", src + "wavefront.cu",
         pw + ":1129"),
    ]
    rows = []
    for kname, lkey, rkey, source, replaces in kernels:
        err, ms, plain_ms, (n_bytes, n_ops) = report[rkey]
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": main_launches[lkey],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    for label, (rev, fwd), k6, k7 in (("est2genome scan", scan_work, s_rev,
                                       s_fwd),
                                      ("coding2genome scan", c2g_work, c_rev,
                                       c_fwd),
                                      ("protein2genome scan", p2g_work,
                                       pk_rev, pk_fwd)):
        print(f"bound at the {label}'s batch: K6 {_bound(*rev)[0]:.3f} ms "
              f"({_bound(*rev)[1]}; kernel {k6:.3f} ms), K7 "
              f"{_bound(*fwd)[0]:.3f} ms ({_bound(*fwd)[1]}; kernel "
              f"{k7:.3f} ms)")
    print(f"main-path launches {main_launches}; script "
          f"{time.perf_counter() - t_start:.1f} s")
    print(_card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    with _EXIT:
        sys.exit(main())
