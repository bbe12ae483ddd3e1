"""Share of the exhaustive route's region-scan diagonals that the cluster
kernel swept: the program's ``ring.scan_diagonals`` counter over it plus
``plan.scan_diagonals`` (``plan_kernel``'s), in % (program counter).  It
says how often the route gives a scan to ``ring_kernel``.  A program
that does not count the cluster kernel's diagonals by mode has no
``ring.scan_diagonals``, and the metric then reads nothing."""
from portbench import program_trace


def read(ctx):
    ring = program_trace.counter("ring.scan_diagonals")
    if not ring:
        return None
    return 100.0 * ring / (ring + program_trace.counter("plan.scan_diagonals"))
