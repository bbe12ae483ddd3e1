"""The control of the correctness check: the reference put in the
program's place with one of the configuration's guarantees broken.

exonerate's spliced models (est2genome, protein2genome) state that an
alignment crosses introns.  The control answers each query as an aligner
without the intron model would: with the best single exon of each planted
path (its best ``M`` stretch, scored exactly), as many alignments as
``--bestn`` asks.  The judge must find it not correct on every seed:

    python3 -m portbench.reference.control --workload <cell> --seed <n>...
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import judge


def _exons(path: judge.Alignment) -> list:
    """Each ``M`` stretch of ``path`` as an alignment of its own, on the
    path's strands."""
    out, i, j = [], path.q_start, path.t_start
    step = -1 if path.t_strand == "-" else 1
    for label, qa, ta in path.ops:
        if label == "M":
            out.append(judge.Alignment(path.query, i, i + qa, path.q_strand,
                                       path.target, j, j + step * ta,
                                       path.t_strand, 0, [("M", qa, ta)]))
        i += qa
        j += step * ta
    return out


def answer(model: str, inv, max_intron: int) -> str:
    """The control's printed output for one invocation."""
    lines = []
    for qid, paths in inv.planted.items():
        for path in paths:
            best = None
            for ex in _exons(path):
                ex.score = judge.path_score(model, inv.queries[qid],
                                            inv.targets[ex.target], ex,
                                            max_intron)
                if best is None or ex.score > best.score:
                    best = ex
            ops = " ".join(f"{a} {b} {c}" for a, b, c in best.ops)
            lines.append(f"vulgar: {qid} {best.q_start} {best.q_end} "
                         f"{best.q_strand} {best.target} {best.t_start} "
                         f"{best.t_end} {best.t_strand} {best.score} {ops}")
    return "\n".join(lines) + "\n"


def readings(workload: str, seed: int, n_invocations: int,
             overrides: dict = None) -> judge.Verdict:
    from .. import harness
    cell = harness.resolve(workload)
    cfg = cell.config
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as d:
        traffic = harness.make_traffic(
            cell, seed, d, {"invocations": n_invocations,
                            **(overrides or {})})
        argv = cfg["argv"][traffic.mode]
        max_intron = harness.flag(argv, "--maxintron", 200000)
        done = [(answer(cfg["model"], inv, max_intron), inv.queries,
                 inv.targets, inv.planted) for inv in traffic.invocations]
        return judge.judge(cfg["model"], max_intron,
                           harness.flag(argv, "--bestn", 1), done)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--invocations", type=int, default=16,
                    help="invocations a seed answers (a run's window)")
    args = ap.parse_args(argv)
    from .. import harness
    limits = harness.resolve(args.workload).limits
    failed_all = True
    for seed in args.seed:
        v = readings(args.workload, seed, args.invocations)
        correct = all(v.numbers[n] <= limits[n] for n in limits)
        failed_all &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": v.numbers, "limits": limits,
                          "queries": v.queries, "correct": correct}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
