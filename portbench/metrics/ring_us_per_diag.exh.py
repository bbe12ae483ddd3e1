"""Device microseconds a ``ring_kernel`` launch (K2, K3 and the masked
path DPs on a cluster) spends on a diagonal: its device time in the
profiler's trace over the program's ``ring.diagonals`` counter, the
diagonals of its span that each launch's longest pair sweeps (device
trace)."""
from portbench import program_trace


def read(ctx):
    return program_trace.device_us_per(ctx, "ring_kernel", "ring.diagonals")
