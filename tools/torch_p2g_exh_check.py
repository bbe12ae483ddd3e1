#!/usr/bin/env python3
"""protein2genome ``-E yes`` on the port against the plain reference's
optimum, on the inputs of the benchmark cell ``p2g.exh_locus``.

    python3 tools/torch_p2g_exh_check.py --seed N [N ...] \
        [--invocations K] [--traced K] [--device cuda|cpu] [--out FILE] \
        [--overrides JSON]

For each seed, builds the cell's traffic as ``portbench/run.py`` does
(``harness.make_traffic``: a 750-residue protein, 10% substituted afresh
in each invocation, against the 80 kb window of its 8-exon gene) and runs
each invocation (the first ``--invocations``, all by default) through
``exonerate_tpu_torch.cli.exonerate.main`` with the cell's flags, then
``portbench/reference/p2g_viterbi.py`` on the same pair and device, over
both target strands.  The printed best score must equal the reference's
optimum: the scores are sums of integers, so the tolerance is 0.  Each
printed alignment is rescored by the benchmark's judge too.  Reported per
seed: the pairs, the mismatches, seconds a pair of the CLI and of the
reference, the engines and fallbacks of ``observe``, and the cluster
kernel's launches by the home of its carry ring.

With ``--traced K`` the first seed's first K invocations also run under
the benchmark's profiler (``portbench/trace.py``): ``plan_kernel``'s
device seconds, split by the exhaustive route's span open at each
launch's midpoint (``portbench/kernel_spans.py``, as the metrics
``scan_us_per_diag.exh`` and ``path_us_per_diag.exh`` read them), and
``ring_kernel``'s so, with the diagonal counters and the trace's ``engine.*`` and ``fallback.*``
counters.  ``--overrides`` replaces parameters of the
traffic (a smaller pair for a rehearsal on the CPU).

Prints one JSON line a seed and a last line with the totals, and writes
them to ``--out`` when given; the exit code is 1 where any pair differs.
"""
import argparse
import collections
import io
import json
import os
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, kernel_spans, program_trace  # noqa: E402
from portbench import trace  # noqa: E402
from portbench.reference import judge, p2g_viterbi  # noqa: E402

CELL = "p2g.exh_locus"
COUNTERS = ("plan.diagonals", "plan.scan_diagonals", "plan.path_diagonals",
            "ring.diagonals", "ring.scan_diagonals", "ring.path_diagonals",
            "ring.smem_launches", "ring.global_launches")


def _attribution(summary) -> dict:
    """``plan_kernel``'s device seconds of a traced stretch by span, and
    the trace's counters."""
    from exonerate_tpu_torch import observe
    ctx = types.SimpleNamespace(trace=summary)
    by = kernel_spans.seconds_by_span(ctx, "plan_kernel", kernel_spans.EXH)
    total = summary.seconds(lambda n: "plan_kernel" in n)
    return {"plan_kernel_s": total, "exh.scan_s": by["exh.scan"],
            "exh.path_s": by["exh.path"], "outside_s": by[None],
            "attributed_pct": (100.0 * (by["exh.scan"] + by["exh.path"])
                               / total if total else None),
            "ring_kernel_s": summary.seconds(lambda n: "ring_kernel" in n),
            "ring_by_span_s": {
                str(k): v for k, v in kernel_spans.seconds_by_span(
                    ctx, "ring_kernel", kernel_spans.EXH).items()},
            "counters": {c: program_trace.counter(c) for c in COUNTERS},
            "engines_and_fallbacks": {
                c: v for c, v in observe.trace().counters.items()
                if c.startswith(("engine.", "fallback."))}}


def check_seed(seed: int, n_inv, traced: int, dev: str,
               overrides=None) -> dict:
    import torch
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.cli import exonerate as cli
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    card = dev == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    cell = harness.resolve(CELL)
    argv = cell.config["argv"]["exhaustive"]
    out = {"seed": seed, "pairs": 0, "mismatches": [], "score_err": 0,
           "cli_s": [], "reference_s": [], "engines": collections.Counter(),
           "fallbacks": collections.Counter()}
    rings = (cw.RING_SMEM.launches, cw.RING_GLOBAL.launches)
    with tempfile.TemporaryDirectory(prefix="p2g-exh-check-") as workdir:
        traffic = harness.make_traffic(cell, seed, workdir, overrides)
        invs = traffic.invocations[:n_inv]
        observe.clear_trace()
        prof = trace.start(card) if traced else None
        w0 = time.perf_counter()
        for k, inv in enumerate(invs):
            if prof is not None and k == traced:
                out["traced"] = _attribution(
                    trace.stop(prof, w0, time.perf_counter()))
                prof = None
            observe.reset()
            buf = io.StringIO()
            t = time.perf_counter()
            cli.main(argv + [inv.query_file, inv.target_file], out=buf)
            sync()
            out["cli_s"].append(time.perf_counter() - t)
            out["engines"].update(observe.engine_counts)
            out["fallbacks"].update(observe.fallback_counts)
            (qid, prot), = inv.queries.items()
            (tid, target), = inv.targets.items()
            found = judge.parse_vulgar(buf.getvalue())
            for a in found:
                want = judge.path_score("protein2genome", prot, target, a,
                                        200000)
                err = judge.INVALID if want is None else abs(a.score - want)
                out["score_err"] = max(out["score_err"], err)
            printed = max((a.score for a in found), default=None)
            t = time.perf_counter()
            best = p2g_viterbi.best(prot, target, device=dev)
            sync()
            out["reference_s"].append(time.perf_counter() - t)
            optimum = max(best["+"].score, best["-"].score)
            out["pairs"] += 1
            if printed != optimum:
                out["mismatches"].append(
                    {"invocation": k, "printed": printed,
                     "reference": {s: vars(e) for s, e in best.items()}})
        if prof is not None:
            out["traced"] = _attribution(
                trace.stop(prof, w0, time.perf_counter()))
    out["ring_launches"] = {"smem": cw.RING_SMEM.launches - rings[0],
                            "global": cw.RING_GLOBAL.launches - rings[1]}
    for key in ("cli_s", "reference_s"):
        v = out[key]
        out[key] = {"median": sorted(v)[len(v) // 2], "min": min(v),
                    "max": max(v)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--invocations", type=int, default=None,
                    help="the first K invocations of each seed (all)")
    ap.add_argument("--traced", type=int, default=0,
                    help="profile the first seed's first K invocations")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--overrides", type=json.loads, default=None,
                    help="traffic parameters replaced, as JSON")
    args = ap.parse_args(argv)
    os.environ["EXONERATE_TPU_NATIVE_DIR"] = harness.NATIVE_DIR
    if args.device == "cpu":
        os.environ["EXONERATE_TPU_TORCH_DEVICE"] = "cpu"
    else:
        import torch
        if not torch.cuda.is_available():
            sys.stderr.write("torch_p2g_exh_check: no CUDA card\n")
            return 2
    lines = []
    for n, seed in enumerate(args.seed):
        res = check_seed(seed, args.invocations, args.traced if n == 0 else 0,
                         args.device, args.overrides)
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    total = [json.loads(ln) for ln in lines]
    summary = {"seeds": len(total), "pairs": sum(r["pairs"] for r in total),
               "mismatches": sum(len(r["mismatches"]) for r in total),
               "score_err": max(r["score_err"] for r in total)}
    if args.device == "cuda":
        import torch
        summary["card"] = torch.cuda.get_device_name(0)
    lines.append(json.dumps(summary))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 1 if summary["mismatches"] or summary["score_err"] else 0


if __name__ == "__main__":
    sys.exit(main())
