"""Share of the heuristic's band-scan comparisons that the default route
sent to the card (K6/K7): ``cuda-sdp`` over every band-scan engine of
``exonerate_tpu_torch.observe.engine_counts``, summed over the window's
invocations (program counter)."""

CARD = ("cuda-sdp", "cuda-sdp-xchip")
ALL = CARD + ("native-sdp", "torch-sdp", "torch-sdp-xchip", "sdp-rows")


def read(ctx):
    total = sum(ctx.engines[e] for e in ALL)
    if not total:
        return None
    return 100.0 * sum(ctx.engines[e] for e in CARD) / total
