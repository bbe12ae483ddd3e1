#!/usr/bin/env python3
"""Times the port's cluster kernel K2 against the cluster size C, and K2
against K1 on batches either side of the stream gate, on one card.

    python3 tools/torch_k2_sweep.py [--part PART] [--out FILE]

All inputs are est2genome in region mode, timed by CUDA events, one
launch each after a warm-up launch of each kernel on a small pair; calm
(record 1 of ``tests/golden/data/all4.fa``, Qp 2304) is the query of the
C sweep:

- C sweep: calm against a 300 kb window (150 kb to 450 kb, holding the
  first copy) of ``chromosome_locus``, the whole scan at C = 4, 8, 9, 12
  and 16; then calm against the whole 1.2 Mb target over its first
  150,000 diagonals (``_launch`` with a span) at C = 9 and 16.  Each is
  checked against the C = 9 run (score, ends, starts equal).  Prints the
  microseconds per diagonal.
- Gate: random est2genome batches at Qp 1280 (C = 6 by K2's rule): B=128
  x Tp 6144 (22.8 MB by the JAX package's footprint rule, under its 24
  MB: K1) and B=256 x Tp 6144 (45.7 MB: K2), and B=16 x Tp 92928 (29.3
  MB: a batch of more than three pairs above the gate), each on K1 and
  on K2, outputs equal.

- Segments (``--part segments``): the checkpointed traceback's launches
  (``cuda_wavefront.wavefront_segment``) on calm x the 1.2 Mb target
  under a mask of 2,176 points: 40 segments of 1,455 diagonals (the 32
  MB ``--dpmemory`` budget) in score mode (K2), region mode and path
  mode (K4 on a cluster), each launch (``_launch`` over a span) timed and followed by a stream
  sync; then score-mode segments again while K1 runs a calm x 30 kb pair
  on a side stream, and score-mode segments ten times as long beside
  K1.  ``--part beside``: segments of 14,550 diagonals in each mode,
  alone, then beside K1 over calm x a 300 kb window (about a minute)
  started 5 s before them, then alone again.  ``--part box``: the
  first 150,000 diagonals, from diagonal 0 in ten launches, of phase
  9d's box (2168 x 1,145,149 at (2, 40337)) and of the whole target,
  in score mode (inputs built in path mode, as
  ``find_path_checkpointed`` builds them) and region mode.

Prints one JSON line per measurement and the card's name and power
limit, and writes the lines to ``--out`` when given.  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from exonerate_tpu_torch import _cudabuild  # noqa: E402
from exonerate_tpu_torch.engine import cuda_wavefront as cw  # noqa: E402
from exonerate_tpu_torch.engine import wavefront as wf  # noqa: E402
from exonerate_tpu_torch.engine.region import Region  # noqa: E402
from exonerate_tpu_torch.model.data import AlignData  # noqa: E402
from exonerate_tpu_torch.model.est2genome import (  # noqa: E402
    est2genome_create)
from exonerate_tpu_torch.seqio import Sequence  # noqa: E402
import torch_split_cases as sc  # noqa: E402


def _inputs(model, jobs, dev):
    per, kinds = [], None
    Qp = wf._bucket(max(r.query_length for r, _ in jobs))
    Tp = wf._bucket(max(r.target_length for r, _ in jobs))
    for region, data in jobs:
        inp, kinds = wf.prepare_inputs(model, region, data, pad_to=(Qp, Tp),
                                       for_pallas=True)
        per.append(inp)
    return cw.to_kernel_inputs(model, per, kinds, dev, "region")


def _time(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--part", default="all",
                    choices=("all", "sweep", "gate", "segments",
                             "beside", "box"))
    args = ap.parse_args()
    _cudabuild.load("wavefront")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    lines = []

    def emit(**rec):
        rec["card"] = card
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    model = est2genome_create()
    calm_s = sc.calm()
    calm = Sequence("calm", None, calm_s)
    chrom = sc.chromosome_locus(calm_s)
    warm = _inputs(model, [(Region(0, 0, 300, 300), AlignData(calm, calm))],
                   dev)
    cw._launch(warm)
    cw._launch(warm, 0)

    if args.part in ("all", "sweep"):
        _sweep(model, calm, calm_s, chrom, dev, emit)
    if args.part in ("all", "gate"):
        _gate(model, dev, emit)
    if args.part in ("all", "segments", "beside", "box"):
        _segments(model, calm, calm_s, chrom, dev, emit,
                  "segments" if args.part == "all" else args.part)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(rec) + "\n")
    print(card)
    return 0


def _segments(model, calm, calm_s, chrom, dev, emit, part):
    from exonerate_tpu_torch.engine.subopt import SubOpt
    sub = SubOpt()
    for q in range(len(calm_s) + 1):
        sub.points.add((q, 300_000 + q))
        sub.by_row.setdefault(300_000 + q, set()).add(q)
    region = Region(0, 0, len(calm_s), len(chrom))
    data = AlignData(calm, Sequence("chrom", None, chrom))
    pads = (wf._bucket(len(calm_s)), wf._bucket(len(chrom)))
    inp, kinds = wf.prepare_inputs(model, region, data, subopt=sub,
                                   pad_to=pads, for_pallas=True)
    kis = {mode: cw.to_kernel_inputs(model, inp, kinds, dev, mode)
           for mode in ("score", "region", "path")}
    seg = (32 << 20) // ((kis["path"].Qp + 1) * kis["path"].S)
    k1_in = _inputs(model, [(Region(0, 0, len(calm_s), 30_000),
                             AlignData(calm, Sequence(
                                 "w", None, chrom[290_000:320_000])))], dev)

    def run(mode, n, length, beside_k1=False, d0=290_000):
        k = kis[mode]
        ring = cw.ring_buffers(k)
        side = torch.cuda.Stream()
        if beside_k1:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                cw._launch(k1_in)
        ms = []
        for s in range(n):
            span = (d0 + s * length, d0 + (s + 1) * length)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            cw._launch(k, 0, span, ring)
            b.record()
            torch.cuda.current_stream().synchronize()
            ms.append(a.elapsed_time(b))
        side.synchronize()
        emit(what="segments", mode=mode, n=n, diagonals=length,
             beside_k1=beside_k1, ms_mean=sum(ms) / n, ms_max=max(ms),
             us_per_diag=sum(ms) * 1e3 / (n * length))

    if part == "box":
        # the phase-9d box (the chain's 2168 x 1,145,149 region) from
        # diagonal 0, its inputs built as find_path_checkpointed builds
        # them (path mode, then mode="score"), against the whole target
        import dataclasses
        for name, reg in (("box", Region(2, 40_337, 2168, 1_145_149)),
                          ("whole", region)):
            pads = (wf._bucket(reg.query_length),
                    wf._bucket(reg.target_length))
            inp, kinds = wf.prepare_inputs(model, reg, data, subopt=sub,
                                           pad_to=pads, for_pallas=True)
            kp = cw.to_kernel_inputs(model, inp, kinds, dev, "path")
            for mode in ("score", "region"):
                k = (dataclasses.replace(kp, mode="score") if mode == "score"
                     else cw.to_kernel_inputs(model, inp, kinds, dev, mode))
                ring = cw.ring_buffers(k)
                ms = 0.0
                for s in range(10):
                    span = (s * 15_000, (s + 1) * 15_000)
                    (_o, _t, c), t = _time(
                        lambda: cw._launch(k, 0, span, ring))
                    ms += t
                emit(what="segments from diagonal 0", region=name,
                     mode=mode, C=c, masked=k.masked, diagonals=150_000,
                     ms=ms, us_per_diag=ms * 1e3 / 150_000)
        return
    if part == "segments":
        run("score", 40, seg)
        run("region", 40, seg)
        run("path", 40, seg)
        run("score", 40, seg, beside_k1=True)
        run("path", 40, seg, beside_k1=True)
        run("score", 10, 10 * seg, beside_k1=True)
        return
    # "beside": the same segments alone, then beside K1 over calm x a
    # 300 kb window (about a minute, one CTA), started 5 s before
    long_k1 = _inputs(model, [(Region(0, 0, len(calm_s), 300_000),
                               AlignData(calm, Sequence(
                                   "w", None, chrom[150_000:450_000])))], dev)
    for mode in ("score", "region", "path"):
        run(mode, 10, 10 * seg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k1_ev = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        k1_ev[0].record()
        cw._launch(long_k1)
        k1_ev[1].record()
    time.sleep(5)
    for mode in ("score", "region", "path"):
        run(mode, 10, 10 * seg)
        emit(what="K1 300 kb still running", done=side.query())
    side.synchronize()
    emit(what="K1 300 kb beside them", ms=k1_ev[0].elapsed_time(k1_ev[1]))
    run("score", 10, 10 * seg)


def _sweep(model, calm, calm_s, chrom, dev, emit):
    # C sweep at 300 kb, whole scans
    win = Sequence("w300", None, chrom[150_000:450_000])
    ki = _inputs(model, [(Region(0, 0, len(calm_s), len(win)),
                          AlignData(calm, win))], dev)
    n_diag = len(calm_s) + len(win) + 1
    ref = None
    for C in (9, 4, 8, 12, 16):
        (out, _tb, used), ms = _time(lambda: cw._launch(ki, C))
        ref = out if ref is None else ref
        emit(what="K2 C sweep, 300 kb whole scan", C=used, ms=ms,
             us_per_diag=ms * 1e3 / n_diag, Qp=ki.Qp, Tp=ki.Tp,
             equal_to_C9=bool(torch.equal(out, ref)),
             out=out[:, 0].tolist())

    # C = 9 against 16 on the 1.2 Mb target, a span of its diagonals
    ki = _inputs(model, [(Region(0, 0, len(calm_s), len(chrom)),
                          AlignData(calm, Sequence("chrom", None, chrom)))],
                 dev)
    span = (0, 150_000)
    ref = None
    for C in (9, 16, 9):
        (out, _tb, used), ms = _time(
            lambda: cw._launch(ki, C, span, cw.ring_buffers(ki)))
        ref = out if ref is None else ref
        emit(what="K2 C sweep, 1.2 Mb, first 150000 diagonals", C=used,
             ms=ms, us_per_diag=ms * 1e3 / span[1], Qp=ki.Qp, Tp=ki.Tp,
             equal_to_C9=bool(torch.equal(out, ref)))


def _gate(model, dev, emit):
    # K1 against K2 either side of the gate
    rng = np.random.default_rng(5)

    def random_jobs(B, qlen, tlen):
        jobs = []
        for b in range(B):
            q = "".join(rng.choice(list("acgt"), qlen))
            t = "".join(rng.choice(list("acgt"), tlen - 200)) \
                + q[:200]
            jobs.append((Region(0, 0, qlen, tlen),
                         AlignData(Sequence(f"q{b}", None, q),
                                   Sequence(f"t{b}", None, t))))
        return jobs

    for B, tlen in ((128, 6000), (256, 6000), (16, 85000)):
        ki = _inputs(model, random_jobs(B, 1200, tlen), dev)
        kinds_mb = cw.stream_bytes(
            tuple(("k", "tvec") for _ in range(ki.tvecs.shape[1])), B,
            ki.Qp, ki.Tp) / 2**20
        (k1, _t, _u), k1_ms = _time(lambda: cw._launch(ki))
        (k2, _t, used), k2_ms = _time(lambda: cw._launch(ki, 0))
        emit(what="K1 vs K2 at a batch", B=B, Qp=ki.Qp, Tp=ki.Tp,
             footprint_mb=kinds_mb, gate_says_k2=kinds_mb > 24,
             C=used, k1_ms=k1_ms, k2_ms=k2_ms,
             equal=bool(torch.equal(k1, k2)))


if __name__ == "__main__":
    sys.exit(main())
