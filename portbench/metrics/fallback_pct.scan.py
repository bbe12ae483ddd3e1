"""The hybrid's wasted card work: comparisons redone on the host after a
``HybridFallback`` (the program's ``hybrid.fallbacks`` counter) over the
comparisons whose band scan the card ran (``hybrid.device_comparisons``),
in % (program counter)."""
from portbench import program_trace


def read(ctx):
    ran = program_trace.counter("hybrid.device_comparisons")
    if not ran:
        return None
    return 100.0 * program_trace.counter("hybrid.fallbacks") / ran
