"""Host milliseconds a query spends on the pool's host route: the self
time of the program's ``pool.host_route`` spans (a comparison the size
gates keep off the card, run by the native scheduler), summed over the
result loop's threads, per query (program span)."""
from portbench import program_trace


def read(ctx):
    return program_trace.per_unit_ms(ctx, {"pool.host_route"})
