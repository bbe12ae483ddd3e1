"""Device microseconds a ``plan_kernel`` launch (K1, K4) spends on a
diagonal: its device time in the profiler's trace over the program's
``plan.diagonals`` counter, the diagonals each launch's longest pair
sweeps (device trace)."""
from portbench import program_trace


def read(ctx):
    return program_trace.device_us_per(ctx, "plan_kernel", "plan.diagonals")
