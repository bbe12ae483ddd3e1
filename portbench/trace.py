"""The device trace of a traced window (``--trace 1``): ``torch.profiler``
over the whole window, reduced to the device's operations, its busy time
(the union of their intervals), and the idle gaps between them, named by
the host span that was open in each."""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass


@dataclass
class Summary:
    ops: list              # (name, start s, end s) on the device, trace time
    busy_s: float
    window_s: float
    offset_s: float        # host clock = trace time + offset_s
    w0: float              # the window on the host clock
    w1: float

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n))

    def gaps(self) -> list:
        """(host start, seconds) of each stretch of the window with no
        device operation running."""
        out, t = [], self.w0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = s + self.offset_s, e + self.offset_s
            if s > t:
                out.append((t, s - t))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1 - t))
        return out

    def breakdown(self, spans: dict) -> dict:
        by_op = collections.Counter()
        for n, s, e in self.ops:
            by_op[n] += e - s
        by_gap = collections.Counter()
        for t, d in self.gaps():
            mid = t + d / 2
            inside = [(dur, name) for name, runs in spans.items()
                      for s, dur in runs if s <= mid <= s + dur]
            by_gap[min(inside)[1] if inside else "other host work"] += d
        return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in by_gap.most_common(10)]}


def start(card: bool):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA if card
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def stop(prof, w0: float, w1: float) -> Summary:
    """Stop the profiler and reduce its events; ``w0``/``w1`` the
    window's host clock bounds."""
    from torch.autograd import DeviceType
    # the profiler stamps events in nanoseconds of the wall clock
    offset = time.perf_counter() - time.time_ns() / 1e9
    prof.__exit__(None, None, None)
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        s = ev.start_ns() / 1e9
        ops.append((ev.name(), s, s + ev.duration_ns() / 1e9))
    busy, t = 0.0, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if t is None or s > t:
            busy += e - s
            t = e
        elif e > t:
            busy += e - t
            t = e
    first = min((s for _, s, _ in ops), default=None)
    if first is not None and not w0 - 1 <= first + offset <= w1 + 1:
        # not the wall clock: align the first operation with the window
        offset = w0 - first
    return Summary(ops, busy, w1 - w0, offset, w0, w1)
