"""Device microseconds a ``plan_kernel`` launch of the exhaustive route's
path DPs (K4, which writes the traceback planes) spends on a diagonal:
the device time of the ``plan_kernel`` operations inside the program's
``exh.path`` spans (each by its midpoint, ``kernel_spans.py``) over the
program's ``plan.path_diagonals`` counter, the diagonals each path
launch's longest pair sweeps (device trace)."""
from portbench import kernel_spans


def read(ctx):
    return kernel_spans.device_us_in(ctx, "plan_kernel", "exh.path",
                                     "plan.path_diagonals")
