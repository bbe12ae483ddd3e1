"""Device time of a kernel split by the program span that launched it,
for the metrics that read it: each of the kernel's operations in the
profiler's trace belongs to the innermost of the named spans (the
program's own, ``program_trace.spans``) open on the host clock at the
operation's midpoint, and to none where no such span is open.  The
program reads each result back before the span that launched it closes,
so the kernel runs inside it.  A program without the spans or the
counter gives nothing, and the metric then reads nothing."""
from __future__ import annotations

from portbench import program_trace

# the exhaustive route's spans (``optimal.find_path``): the region scans,
# the path DPs
EXH = ("exh.scan", "exh.path")


def seconds_by_span(ctx, kernel: str, names) -> dict:
    """Span name -> device seconds of the operations whose name holds
    ``kernel``, each given to the innermost span of ``names`` open at
    its midpoint; None -> the seconds of those in none of them."""
    runs = sorted((s.start, s.end, s.name) for s in program_trace.spans(ctx)
                  if s.name in names)
    out = dict.fromkeys(list(names) + [None], 0.0)
    if ctx.trace is None:
        return out
    off = ctx.trace.offset_s
    for name, s, e in ctx.trace.ops:
        if kernel not in name:
            continue
        mid = (s + e) / 2 + off
        inside = [(r1 - r0, n) for r0, r1, n in runs if r0 <= mid <= r1]
        out[min(inside)[1] if inside else None] += e - s
    return out


def device_us_in(ctx, kernel: str, span: str, diagonals: str,
                 names=EXH):
    """Device microseconds a diagonal of the kernel's operations inside
    ``span`` (of the spans ``names``), over the trace counter
    ``diagonals``; None where either is missing."""
    n = program_trace.counter(diagonals)
    if not n:
        return None
    device = seconds_by_span(ctx, kernel, names)[span]
    if device <= 0:
        return None
    return 1e6 * device / n
