"""The exhaustive route's share of its roofline: the least time on one
H100 of the DPs that Waterman-Eggert needs for the window's pairs, over
the device time of the wavefront kernels that ran them in the profiler's
trace (device trace).

The DPs are counted from the pairs and the alignments printed, not from
the launches: on each target strand, one dense scan of the whole
(query + 1) x (target + 1) grid per alignment found there and one more
that finds none above ``--score``, and one path DP over each alignment's
box; each cell an add and a compare per model transition
(``transitions_per_cell`` of the configuration), ``work/roofline.py``."""
from portbench.reference.judge import parse_vulgar
from portbench.work import roofline

KERNELS = ("plan_kernel", "ring_kernel", "walkback_kernel",
           "walk_segment_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.done:
        return None
    device = ctx.trace.seconds(lambda n: any(k in n for k in KERNELS))
    if device <= 0:
        return None
    per_cell = ctx.cell.config["transitions_per_cell"]
    least = 0.0
    for text, inv in ctx.done:
        found = parse_vulgar(text)
        for qid, q in inv.queries.items():
            for tid, t in inv.targets.items():
                for strand in "+-":
                    n = sum(1 for a in found if a.query == qid
                            and a.target == tid and a.t_strand == strand)
                    least += (n + 1) * roofline.bound_s(
                        *roofline.dp_work(len(q), len(t), per_cell))
        for a in found:
            least += roofline.bound_s(*roofline.dp_work(
                abs(a.q_end - a.q_start), abs(a.t_end - a.t_start),
                per_cell))
    return 100.0 * least / device
