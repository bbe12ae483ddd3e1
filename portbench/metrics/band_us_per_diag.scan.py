"""Device microseconds a band-kernel launch spends on a diagonal: the
device time of ``band_kernel`` (K6 and K7) in the profiler's trace over
the program's ``band.diagonals`` counter, the diagonals each launch's
longest comparison sweeps (device trace)."""
from portbench import program_trace


def read(ctx):
    return program_trace.device_us_per(ctx, "band_kernel", "band.diagonals")
