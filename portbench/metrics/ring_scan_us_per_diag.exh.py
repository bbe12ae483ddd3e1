"""Device microseconds a ``ring_kernel`` launch of the exhaustive route's
region scans (K2, and K3 on the cluster) spends on a diagonal: the
device time of the ``ring_kernel`` operations inside the program's
``exh.scan`` spans (each by its midpoint, ``kernel_spans.py``) over the
program's ``ring.scan_diagonals`` counter, the diagonals each score or
region launch's longest pair sweeps (device trace)."""
from portbench import kernel_spans


def read(ctx):
    return kernel_spans.device_us_in(ctx, "ring_kernel", "exh.scan",
                                     "ring.scan_diagonals")
