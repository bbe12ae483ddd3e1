"""Host milliseconds a query spends copying band-scan batches to the card:
the program's ``band.copy`` spans (the pageable copies of
``cuda_sdp.to_band_inputs``, which wait for the kernels queued before
them), summed over the window, per query (program span)."""
from portbench import program_trace


def read(ctx):
    return program_trace.per_unit_ms(ctx, {"band.copy"})
