"""The band kernels K6/K7 on a thread-block cluster, on a card.

``csrc/sdp_band.cu`` runs each comparison of a batch on a cluster of C
CTAs that split its query lanes, the carry ring in shared memory where
the .cu's fit rule says it fits.  These tests hold a batch of several
comparisons (B > 1) to the plain passes, exactly, and check that the
launches took the cluster with the shared ring; the split-codon batch
holds K9 inside K7 the same way.  They need an NVIDIA card and skip
without one (no JAX: the plain passes are the reference).
"""
import pytest
import torch

from exonerate_tpu_torch.engine import cuda_sdp
from exonerate_tpu_torch.engine import sdp_device as tsd
from torch_sdp_cases import case as _case

BATCHES = {
    "est2genome": ("single_exon", "two_exons_intron",
                   "seed_layers_same_column"),
    "split": ("p2g_split", "p2g_split_wide"),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _batch(names, dev):
    model, pair, plan = _case(names[0])
    jobs = [(pair, plan)] + [_case(n, model=model)[1:] for n in names[1:]]
    return cuda_sdp.band_inputs(model, jobs, pair.args.dropoff, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_band_batch_on_the_cluster_with_the_shared_ring(batch):
    dev = _need_card()
    bi = _batch(BATCHES[batch], dev)
    assert bi.batch == len(BATCHES[batch]) > 1
    before = (cuda_sdp.BAND_SMEM.launches, cuda_sdp.BAND_GLOBAL.launches)
    bits, live_r = cuda_sdp.band_reverse(bi)
    rev_fit = cuda_sdp.last_fit[False]
    colbest, live_f, xband = cuda_sdp.band_forward(bi, bits)
    fwd_fit = cuda_sdp.last_fit[True]
    torch.cuda.synchronize()
    # both passes on clusters of several CTAs, the ring in shared memory
    assert rev_fit[0] > 1 and fwd_fit[0] > 1, (rev_fit, fwd_fit)
    assert (cuda_sdp.BAND_SMEM.launches, cuda_sdp.BAND_GLOBAL.launches) \
        == (before[0] + 2, before[1])
    p_bits, p_live_r = tsd.plain_band_reverse(bi)
    p_col, p_live_f, p_xb = tsd.plain_band_forward(bi, p_bits)
    assert torch.equal(bits, p_bits) and torch.equal(live_r, p_live_r)
    assert torch.equal(colbest, p_col) and torch.equal(live_f, p_live_f)
    assert torch.equal(xband, p_xb)
