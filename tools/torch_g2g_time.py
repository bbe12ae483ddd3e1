#!/usr/bin/env python3
"""Times genome2genome -E yes on the port's generic wavefront, on one card.

    python3 tools/torch_g2g_time.py [--score N] [--revcomp yes|no]
                                    [--device cuda]

Runs the port's CLI, ``-m genome2genome -E yes --showvulgar yes`` on the
in-repo ``tests/golden/data/cdna_mut.fa`` (1,200 bp) against
``genome.fa`` (12 kb) at the default budgets: the kernels refuse
genome2genome, each 1200 x 12000 path DP is over the native traceback
budget and its cube over --dpmemory, so each runs the generic
wavefront's checkpointed traceback.  ``--score`` (default 2000) bounds
the Waterman-Eggert loop; ``--revcomp no`` (the default here) keeps the
forward strands.  Prints, per path DP, its region, host seconds
and diagonal steps (forward pass and walk-back re-runs), then the run's
host seconds, engine counts and vulgar lines, then the card's name and
power limit, and one JSON line of the numbers.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "golden", "data")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--score", type=int, default=2000)
    ap.add_argument("--revcomp", default="no")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.environ["EXONERATE_TPU_TORCH_DEVICE"] = args.device
    sys.path.insert(0, ROOT)
    import torch
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.cli.exonerate import main as cli_main
    from exonerate_tpu_torch.engine import generic_wavefront as gw
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    steps = [0]
    real_step = gw.Engine.step

    def count_step(self, *a, **k):
        steps[0] += 1
        return real_step(self, *a, **k)

    dps = []
    real_ck = gw.find_path_checkpointed

    def timed_ck(model, region, *a, **k):
        s0, t0 = steps[0], time.perf_counter()
        res = real_ck(model, region, *a, **k)
        if args.device == "cuda":
            torch.cuda.synchronize()
        dps.append({"region": [region.query_start, region.target_start,
                               region.query_length, region.target_length],
                    "seconds": time.perf_counter() - t0,
                    "steps": steps[0] - s0, "score": res.score})
        print(json.dumps(dps[-1]), flush=True)
        return res

    gw.Engine.step = count_step
    gw.find_path_checkpointed = timed_ck
    argv = ["-m", "genome2genome", "-E", "yes", "--score", str(args.score),
            "--revcomp", args.revcomp, "--showvulgar", "yes",
            "--showalignment", "no",
            os.path.join(DATA, "cdna_mut.fa"), os.path.join(DATA, "genome.fa")]
    observe.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    if cli_main(argv, out=buf) != 0:
        raise SystemExit("CLI failed")
    secs = time.perf_counter() - t0
    vulgar = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("vulgar:")]
    print(f"{secs:.2f} s host clock; engines {dict(observe.engine_counts)};"
          f" fallbacks {dict(observe.fallback_counts)}; {steps[0]} diagonal "
          f"steps")
    for ln in vulgar:
        print(ln)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"seconds": secs, "steps": steps[0], "dps": dps,
                      "engines": dict(observe.engine_counts),
                      "vulgar": vulgar, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
