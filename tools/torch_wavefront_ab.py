#!/usr/bin/env python3
"""Times the port's wavefront kernels K1 and K4 in several checkouts on
one card, so that two versions are compared inside one run.

    python3 tools/torch_wavefront_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout holding ``exonerate_tpu_torch``
(and, for a checkout whose port still took its host layer from it,
``exonerate_tpu``).  Each runs in a process of its own, in the order
given: it builds ``csrc/wavefront.cu`` on est2genome's region plan there
with that checkout's build helper (a fresh build's ptxas lines go into
its JSON line), then times
with CUDA events, after one warm-up launch each, K1 in score and region
mode at est2genome calm x calm (2175 x 2175, B=64) and K4 in path mode
at B=1, ``--reps`` launches each, and checks every score against calm's
self score 10875.  Prints one JSON line per run, then per checkout the
mean of its runs, then the card's name and power limit.  Needs one CUDA
card and the repository's ``tests/golden/data/all4.fa`` beside this
script.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CALM = os.path.join(os.path.dirname(HERE), "tests", "golden", "data",
                    "all4.fa")
CALM_SELF_SCORE = 10875
BATCH = 64
KEYS = ("K1_score_ms", "K1_region_ms", "K4_path_ms")


def _one(root: str, reps: int) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    port = "exonerate_tpu_torch"
    host = (port if os.path.isdir(os.path.join(root, port, "model"))
            else "exonerate_tpu")
    imp = importlib.import_module
    _cudabuild = imp(port + "._cudabuild")
    cw = imp(port + ".engine.cuda_wavefront")
    wf = imp(port + ".engine.wavefront")
    Region = imp(host + ".engine.region").Region
    AlignData = imp(host + ".model.data").AlignData
    est2genome_create = imp(host + ".model.est2genome").est2genome_create
    iter_fasta = imp(host + ".seqio").iter_fasta
    dev = torch.device("cuda", 0)
    calm = next(iter(iter_fasta(CALM)))
    calm.strand = "+"
    n = len(calm)
    model = est2genome_create()
    inputs, kinds = wf.prepare_inputs(
        model, Region(0, 0, n, n), AlignData(calm, calm),
        pad_to=(wf._bucket(n), wf._bucket(n)), for_pallas=True)
    # the region plan's library, built here so that its ptxas lines are
    # this run's (the other modes' build at their first launch)
    built = _cudabuild.build("wavefront", cw.to_kernel_inputs(
        model, inputs, kinds, torch.device("cpu"), "region").header)

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps

    res = {"root": root, "build_s": built.seconds,
           "ptxas": [ln.strip() for ln in built.log.splitlines()
                     if "registers" in ln or "Compiling" in ln]}
    for mode in ("score", "region"):
        ki = cw.to_kernel_inputs(model, [inputs] * BATCH, kinds, dev, mode)
        out, res[f"K1_{mode}_ms"] = timed(lambda: cw.wavefront_scan(ki))
        if set(out[0].tolist()) != {CALM_SELF_SCORE}:
            raise RuntimeError(f"{root}: K1 {mode} scores "
                               f"{set(out[0].tolist())}")
    ki = cw.to_kernel_inputs(model, [inputs], kinds, dev, "path")
    (stats, _tb), res["K4_path_ms"] = timed(lambda: cw.wavefront_path(ki))
    if int(stats[0, 0]) != CALM_SELF_SCORE:
        raise RuntimeError(f"{root}: K4 score {int(stats[0, 0])}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", action="store_true",
                    help="time the first root in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one(args.roots[0], args.reps)))
        return 0
    runs = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             "--reps", str(args.reps), root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"{root}: exit status {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for root in dict.fromkeys(args.roots):
        mine = [r for r in runs if r["root"] == root]
        print(json.dumps({"root": root, "runs": len(mine), **{
            k: sum(r[k] for r in mine) / len(mine) for k in KEYS}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
