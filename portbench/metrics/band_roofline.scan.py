"""The band scan's share of its roofline: the least time the window's
band DPs need on one H100 (``work/roofline.py``: two passes over each
comparison's (query + 1) x (band width + 1) cells, each cell an add and a
compare per model transition, ``transitions_per_cell`` of the
configuration), over the device time of the kernels that ran them in the
profiler's trace (device trace).  Of the program it takes only each
comparison's query length and band width, from the batches that
``cuda_sdp.band_inputs`` built."""
from portbench.work import roofline

SPANS = {"band_prep": ["exonerate_tpu_torch.engine.cuda_sdp:band_inputs"]}
KERNELS = ("band_kernel",)


def band_dims(bi):
    return bi.dims.tolist()


KEEP = {"band_prep": band_dims}              # kept as ctx.kept["band_dims"]


def read(ctx):
    batches = ctx.kept.get("band_dims")
    if not batches or ctx.trace is None:
        return None
    device = ctx.trace.seconds(lambda n: any(k in n for k in KERNELS))
    if device <= 0:
        return None
    per_cell = ctx.cell.config["transitions_per_cell"]
    least = sum(roofline.bound_s(*roofline.band_work(dims, per_cell))
                for dims in batches)
    return 100.0 * least / device
