"""Share of the card's idle time that no program span names: of the idle
gaps of the traced window, the part in which no span of the program but
its root ``run`` is open on any thread (device trace).  The reader of
``unnamed_idle_pct.<cells>``, one metric for each end-to-end metric it
moves.

It also hands the program's spans (all but ``run``) to the harness under
their own names, so that the printed breakdown names idle gaps by them."""
from portbench import program_trace


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx):
    spans = [s for s in program_trace.spans(ctx) if s.name != "run"]
    for name, runs in program_trace.runs(ctx).items():
        ctx.spans[name].extend(runs)
    if not spans or ctx.trace is None or not ctx.trace.ops:
        return None
    named = _union((s.start, s.end) for s in spans)
    idle = covered = 0.0
    k = 0
    for g0, d in ctx.trace.gaps():
        g1 = g0 + d
        idle += d
        while k < len(named) and named[k][1] <= g0:
            k += 1
        j = k
        while j < len(named) and named[j][0] < g1:
            covered += min(g1, named[j][1]) - max(g0, named[j][0])
            j += 1
    if idle <= 0:
        return None
    return 100.0 * (idle - covered) / idle
