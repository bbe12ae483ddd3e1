"""Host milliseconds a query spends preparing band-scan batches for the
card: the host clock around ``cuda_sdp.band_inputs`` (the padded q-axis
and W-axis vectors, the seed layers, the plan tables), summed over the
window, per query (program span)."""

SPANS = {"band_prep": ["exonerate_tpu_torch.engine.cuda_sdp:band_inputs"]}


def read(ctx):
    runs = ctx.spans.get("band_prep")
    if not runs:
        return None
    return 1e3 * sum(d for _, d in runs) / ctx.units
