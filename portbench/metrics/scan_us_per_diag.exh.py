"""Device microseconds a ``plan_kernel`` launch of the exhaustive route's
region scans (K1, and K3 off the cluster) spends on a diagonal: the
device time of the ``plan_kernel`` operations inside the program's
``exh.scan`` spans (each by its midpoint, ``kernel_spans.py``) over the
program's ``plan.scan_diagonals`` counter, the diagonals each score or
region launch's longest pair sweeps (device trace)."""
from portbench import kernel_spans


def read(ctx):
    return kernel_spans.device_us_in(ctx, "plan_kernel", "exh.scan",
                                     "plan.scan_diagonals")
