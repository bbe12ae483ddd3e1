#!/usr/bin/env python3
"""Times the port's band kernels K6 and K7 in several checkouts on one
card, so that two versions are compared inside one run.

    python3 tools/torch_band_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout holding ``exonerate_tpu_torch``.
Each runs in a process of its own, in the order given: it builds
``csrc/sdp_band.cu`` there with that checkout's build helper (with the
comparison's plan compiled in, where the checkout compiles plans; a
fresh build's ptxas lines go into its JSON line), then times with CUDA
events,
after one warm-up launch each, K6 and K7 on one est2genome comparison of
a 1,200 bp query against a 6.6 kb target holding three 400 bp exons
(introns of 1,500 bp, ~1% mutated, seeded by one HSP per exon; made from
rng 3 with ``tests/torch_sdp_cases.py`` beside this script; its band
plan keeps 986 compressed columns), at B=1 and
B=16 (copies), ``--reps`` launches each, and checks that every copy's
band end scores equal the first's.  Prints one JSON line per run, then
per checkout the mean of its runs, then the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("K6_ms", "K7_ms", "K6_b16_ms", "K7_b16_ms")


def _comparison():
    """(model, pair, plan) of the timed comparison."""
    import numpy as np
    import torch_sdp_cases as tc
    rng = np.random.default_rng(3)
    exons = [tc.dna(rng, 400) for _ in range(3)]
    t = tc.dna(rng, 300)
    hsps = []
    for k, ex in enumerate(exons):
        hsps.append((k * 400 + 100, len(t) + 100, 200, 900))
        t += ex + ("GT" + tc.dna(rng, 1496) + "AG" if k < 2 else "")
    t += tc.dna(rng, 300)
    q = tc.mutate(rng, "".join(exons), 12)
    return tc.pair_and_plan("EST2GENOME", q, t, hsps)


def _one(root: str, reps: int) -> dict:
    import torch
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.join(os.path.dirname(HERE), "tests"))
    port = "exonerate_tpu_torch"
    _cudabuild = importlib.import_module(port + "._cudabuild")
    cs = importlib.import_module(port + ".engine.cuda_sdp")
    dev = torch.device("cuda", 0)
    model, pair, plan = _comparison()
    # a checkout whose band kernels run the plan compiled in builds one
    # library per plan (BandInputs.header); an older one its source alone
    header = getattr(cs.band_inputs(model, [(pair, plan)],
                                    pair.args.dropoff, dev), "header", None)
    built = (_cudabuild.build("sdp_band", header) if header
             else _cudabuild.build("sdp_band"))

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

    res = {"root": root, "build_s": built.seconds, "Q": pair.region
           .query_length, "W": plan.W,
           "ptxas": [ln.strip() for ln in built.log.splitlines()
                     if "registers" in ln or "Compiling" in ln]}
    first = None
    for tag, B in (("", 1), ("_b16", 16)):
        bi = cs.band_inputs(model, [(pair, plan)] * B, pair.args.dropoff,
                            dev)
        (bits, _), res[f"K6{tag}_ms"] = timed(lambda: cs.band_reverse(bi))
        (col, _, _), res[f"K7{tag}_ms"] = timed(
            lambda: cs.band_forward(bi, bits))
        ends = [cs.locus_best(c, plan).tolist() for c in col.cpu().numpy()]
        first = first or ends[0]
        if any(e != first for e in ends) or max(first) <= 0:
            raise RuntimeError(f"{root}: band ends {ends[:2]}")
    res["band_end"] = first
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
    if len({json.dumps(r["band_end"]) for r in runs}) != 1:
        raise SystemExit("the checkouts' band ends differ")
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
