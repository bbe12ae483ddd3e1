"""Share of the traced window in which no operation ran on the card: one
minus the union of the profiler's device intervals over the window
(device trace).  The reader of ``device_idle_pct.<cells>``, one metric
for each end-to-end metric it moves."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
