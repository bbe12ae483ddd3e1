"""Host milliseconds a pair spends preparing the exhaustive route's
wavefront inputs: the host clock around ``wavefront.prepare_inputs``
(the q-axis and target vectors, the SubOpt mask plane of
``blocked_plane``) and ``cuda_wavefront.to_kernel_inputs`` (the plan and
tables on the card), summed over the window, per pair (program span)."""

SPANS = {"wave_prep": [
    "exonerate_tpu_torch.engine.wavefront:prepare_inputs",
    "exonerate_tpu_torch.engine.cuda_wavefront:to_kernel_inputs"]}


def read(ctx):
    runs = ctx.spans.get("wave_prep")
    if not runs:
        return None
    return 1e3 * sum(d for _, d in runs) / ctx.units
