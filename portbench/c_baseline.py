"""The plain single-threaded baseline: exonerate's C binary on a cell's
inputs (not a metric of the benchmark).

    python3 portbench/c_baseline.py --workload e2g.scan --seed 1 \
        --binary build/ref/bin/exonerate [--invocations 1 ...]

Makes the cell's inputs from ``--seed`` as a run does, times the binary
(host clock, process start included) on the window's invocations named
(1, the window's first, by default) with the cell's flags, and holds its
alignments to the reference as a run's are.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402
from portbench.reference import judge  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--binary", required=True)
    ap.add_argument("--invocations", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    cfg = cell.config
    with tempfile.TemporaryDirectory(prefix="portbench-c-") as workdir:
        traffic = harness.make_traffic(
            cell, args.seed, workdir,
            {"invocations": 1 + max(args.invocations)})
        flags = cfg["argv"][traffic.mode]
        done, seconds, units = [], 0.0, 0
        for inv in (traffic.invocations[k] for k in args.invocations):
            t = time.perf_counter()
            r = subprocess.run([args.binary] + flags + [inv.query_file,
                                                        inv.target_file],
                               capture_output=True, text=True, check=True)
            seconds += time.perf_counter() - t
            units += inv.units
            done.append((r.stdout, inv.queries, inv.targets, inv.planted))
        v = judge.judge(cfg["model"], harness.flag(flags, "--maxintron",
                                                   200000),
                        harness.flag(flags, "--bestn", 1), done)
    rate = next(m["name"] for m in cell.end_to_end
                if m["name"] != "setup_s")
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "binary": args.binary, "seconds": seconds,
                      "units": units, rate: units / seconds,
                      "checks": v.numbers, "alignments": v.checked,
                      "worst": v.worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
