"""The program's own spans and counters of a traced window, for the
metrics that read them: ``exonerate_tpu_torch.observe.trace()``, which the
program fills while the window's profiler records.  A program without
them gives nothing, and those metrics then read nothing.

The counters are the process's since the trace was last cleared; in a
benchmark run the profiler records only in the window, so they are the
window's.  The spans are those that started in the window."""
from __future__ import annotations

import collections


def _trace():
    from exonerate_tpu_torch import observe
    read = getattr(observe, "trace", None)
    return read() if read is not None else None


def spans(ctx) -> list:
    """The program's spans that started in the traced window."""
    t = _trace()
    if t is None or ctx.trace is None:
        return []
    w0, w1 = ctx.trace.w0, ctx.trace.w1
    return [s for s in t.spans if w0 <= s.start <= w1]


def counter(name: str):
    """The trace counter ``name``: None where the program has no trace,
    else its total (0 where nothing was added)."""
    t = _trace()
    return None if t is None else t.counters.get(name, 0)


def runs(ctx) -> dict:
    """Span name -> [(start, seconds)] of every span but the root ``run``,
    as the harness keeps its own."""
    out = collections.defaultdict(list)
    for s in spans(ctx):
        if s.name != "run":
            out[s.name].append((s.start, s.end - s.start))
    return out


def self_by_thread(ctx, names) -> dict:
    """Thread -> self seconds of the spans ``names`` on it."""
    out = collections.Counter()
    for s in spans(ctx):
        if s.name in names:
            out[s.thread] += s.self_s
    return out


def per_unit_ms(ctx, names):
    """Self milliseconds of the spans ``names``, summed over threads, a
    unit of the window (a query or a pair); None where none ran."""
    by_thread = self_by_thread(ctx, names)
    if not by_thread or not ctx.units:
        return None
    return 1e3 * sum(by_thread.values()) / ctx.units


def device_us_per(ctx, kernel: str, diagonals: str):
    """Device microseconds of the kernels whose name holds ``kernel``,
    over the trace counter ``diagonals``; None where either is missing."""
    n = counter(diagonals)
    if not n or ctx.trace is None:
        return None
    device = ctx.trace.seconds(lambda name: kernel in name)
    if device <= 0:
        return None
    return 1e6 * device / n
