"""Host milliseconds a query spends in the SDP hybrid's host re-runs: the
self time of the program's ``hybrid.resolve`` (a reporting locus re-run
by the native scheduler to check the card's score) and ``hybrid.path``
(its path) spans, summed over threads, per query (program span)."""
from portbench import program_trace


def read(ctx):
    return program_trace.per_unit_ms(ctx, {"hybrid.resolve", "hybrid.path"})
