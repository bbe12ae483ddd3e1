"""K8, the cross-chip band scan: one comparison's W axis cut into chunks.

``cuda_sdp.run_kernel_cross_chip`` runs the band scan's reverse pass over
the chunks right to left and its forward pass left to right, each chunk
on its own device, handing the edge columns' carry values and the span
registers (``sdp_device.Halo``) from chunk to chunk.  On the CPU the
chunks run the plain passes (``plain_band_reverse`` /
``plain_band_forward`` with a halo); on a card the CROSS instantiation
of ``csrc/sdp_band.cu``.  Either way the result must equal, exactly:

- the JAX package's ``sdp_pallas.run_kernel_cross_chip`` in interpret
  mode, on ``tests/test_sdp_pallas.py``'s two-chip case;
- the port's single launch (``cuda_sdp.run_kernel``), with an intron
  span crossing the cut, on 3- and 4-chunk cuts and on a coding2genome
  comparison (kernel K9 inside a CROSS forward pass).

Tests marked ``gpu`` hold each CROSS launch to its plain version on a
card (the same chunk, the same halo in) and skip without one.
"""
import numpy as np
import pytest
import torch

import torch_sdp_cases as C
from exonerate_tpu_torch.engine import cuda_sdp
from exonerate_tpu_torch.engine import sdp_device as tsd

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _python_sdp(monkeypatch):
    monkeypatch.setenv("EXONERATE_TPU_SDP", "python")


def _job(name):
    return C.case(name)


def _same(got, want):
    assert got["live"] == want["live"]
    assert got["xband"] == want["xband"]
    np.testing.assert_array_equal(got["band_end"], want["band_end"])


def test_cross_chip_equals_jax_two_chips():
    """The port's chunk chain on the CPU, the JAX package's in Pallas
    interpret mode and the port's single launch agree on the two-chip
    case (``two_exons_intron`` is its recipe)."""
    from exonerate_tpu.engine import sdp_pallas
    jm, jpair, jplan = C.case("two_exons_intron", pkg="exonerate_tpu")
    want = sdp_pallas.run_kernel_cross_chip(jm, jpair, jplan,
                                            jpair.args.dropoff, 2,
                                            interpret=True)
    model, pair, plan = C.case("two_exons_intron")
    assert plan.W == jplan.W
    got = cuda_sdp.run_kernel_cross_chip(model, pair, plan,
                                         pair.args.dropoff, 2,
                                         devices=[CPU])
    n = len(plan.loci)
    assert got["live"] == want["live"] and got["xband"] == want["xband"]
    np.testing.assert_array_equal(got["band_end"][:n], want["band_end"][:n])
    _same(got, cuda_sdp.run_kernel(model, [(pair, plan)], pair.args.dropoff,
                                   CPU)[0])


@pytest.mark.parametrize("name,n_chips", [("span_cut", 2),
                                          ("single_exon", 3),
                                          ("two_exons_intron", 4),
                                          ("c2g_split", 2)])
def test_cross_chip_equals_single_launch(name, n_chips):
    model, pair, plan = _job(name)
    chunks = cuda_sdp.cross_chunks(model, pair, plan, pair.args.dropoff,
                                   n_chips, [CPU])
    assert len(chunks) == n_chips
    got = cuda_sdp.run_kernel_cross_chip(model, pair, plan,
                                         pair.args.dropoff, n_chips,
                                         devices=[CPU])
    _same(got, cuda_sdp.run_kernel(model, [(pair, plan)], pair.args.dropoff,
                                   CPU)[0])


def test_hybrid_routes_a_wide_band_across_devices(monkeypatch):
    """``EXONERATE_TPU_CROSS_CHIP=2`` with two devices and a band over
    ``EXONERATE_TPU_CROSS_CHIP_MIN_W``: the comparison leaves the batch
    for K8 (``torch-sdp-xchip`` on CPU devices); the others stay on the
    batch, which ``run_kernel(devices=...)`` also splits over devices."""
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.engine import sdp_hybrid as thy
    model, pair, plan = _job("two_exons_intron")
    jobs = [C.case(n, model)[1:] for n in ("single_exon", "two_exons_intron",
                                           "seed_layers_same_column")]
    want = cuda_sdp.run_kernel(model, jobs, pair.args.dropoff, CPU)
    split = cuda_sdp.run_kernel(model, jobs, pair.args.dropoff, CPU,
                                devices=[CPU, CPU])
    for got, w in zip(split, want):
        _same(got, w)
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP", "2")
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP_MIN_W", str(plan.W))
    monkeypatch.setattr(thy, "_devices", lambda device: [CPU, CPU])
    observe.reset()
    out = thy.run_device_batch(model, jobs, CPU)
    assert observe.engine_counts == {"torch-sdp-xchip": 1, "torch-sdp": 2}
    for got, w in zip(out, want):
        _same(got, w)


def test_hybrid_on_the_cpu_keeps_a_wide_band_off_the_cards(monkeypatch):
    """A caller on the CPU gets no cross-chip route, however many cards
    are visible: ``EXONERATE_TPU_CROSS_CHIP=2`` leaves the comparison on
    the CPU's batch."""
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.engine import sdp_hybrid as thy
    model, pair, plan = _job("two_exons_intron")
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP", "2")
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP_MIN_W", "1")
    monkeypatch.setattr(thy.torch.cuda, "device_count", lambda: 2)
    observe.reset()
    out = thy.run_device_batch(model, [(pair, plan)], CPU)
    assert observe.engine_counts == {"torch-sdp": 1}
    _same(out[0], cuda_sdp.run_kernel(model, [(pair, plan)],
                                      pair.args.dropoff, CPU)[0])


def test_cross_chunks_cut_the_band_with_context_columns():
    """Each chunk's W-axis rows hold its columns, then the MAXAT columns
    past its right end; ``tctx`` the MAXAT before its left end; the seed
    layers get no context."""
    model, pair, plan = _job("two_exons_intron")
    n_layers = cuda_sdp.count_seed_layers(pair, plan)
    Wg = cuda_sdp._pow2(max(plan.W, 1023))
    flat, kinds, meta = cuda_sdp.prepare_kernel_inputs(
        model, pair, plan, 256, Wg, n_layers)
    whole = cuda_sdp.to_band_inputs(model, [flat], kinds, [meta], 256, Wg,
                                    pair.args.dropoff, CPU)
    chunks = cuda_sdp.cross_chunks(model, pair, plan, pair.args.dropoff, 3,
                                   [CPU])
    maxat = chunks[0][2].maxat
    assert maxat == cuda_sdp._max_target_advance(model) >= 1
    seeds = set(range(whole.row_seedq, whole.row_seedq + n_layers)) | set(
        range(whole.row_seedv, whole.row_seedv + n_layers))
    for v0, v1, bi in chunks:
        wlen = v1 - v0
        assert bi.dims.tolist() == [[pair.region.query_length, wlen]]
        for r in range(whole.tvecs.shape[1]):
            g = whole.tvecs[0, r]
            row, ctx = bi.tvecs[0, r], bi.tctx[0, r]
            assert torch.equal(row[:wlen + 1], g[v0:v1 + 1])
            right = min(maxat, plan.W - v1) if r not in seeds else 0
            assert torch.equal(row[wlen + 1:wlen + 1 + right],
                               g[v1 + 1:v1 + 1 + right])
            assert not row[wlen + 1 + right:].any()
            for k in range(1, maxat + 1):
                want = g[v0 - k] if v0 - k >= 0 and r not in seeds else 0
                assert int(ctx[k - 1]) == int(want)
    assert chunks[-1][1] == plan.W


def test_cross_launches_check_their_halo():
    model, pair, plan = _job("single_exon")
    (_, _, bi), = cuda_sdp.cross_chunks(model, pair, plan, 50, 1, [CPU])
    halo = tsd.blank_halo(bi, False)
    n8 = cuda_sdp.K8.launches
    bad = tsd.Halo(halo.sc[:, :, :-1].contiguous(), halo.pm, None, None)
    with pytest.raises(ValueError):
        cuda_sdp.band_reverse_cross(bi, bad)
    whole = cuda_sdp.band_inputs(model, [(pair, plan)], 50, CPU)
    with pytest.raises(ValueError):
        cuda_sdp.band_reverse_cross(whole, halo)
    assert cuda_sdp.K8.launches == n8


# -- the kernels on a card ----------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


def _halo_equal(a, b):
    for name in ("sc", "pm", "ln", "span"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x.cpu(), y.cpu()), name


@pytest.mark.gpu
@pytest.mark.parametrize("name,n_chips", [("two_exons_intron", 2),
                                          ("span_cut", 2),
                                          ("single_exon", 3),
                                          ("ner_joint_span", 3),
                                          ("p2g_split", 2),
                                          ("c2g_split", 3)])
def test_k8_launches_equal_plain(name, n_chips):
    """Every CROSS launch of a chunk chain against its plain version on
    the same chunk and halo; the chain against the single launch."""
    dev = _need_card()
    model, pair, plan = _job(name)
    chunks = cuda_sdp.cross_chunks(model, pair, plan, pair.args.dropoff,
                                   n_chips, [dev])
    n8 = cuda_sdp.K8.launches
    bits = [None] * len(chunks)
    halo = tsd.blank_halo(chunks[-1][2], False)
    for cx in range(len(chunks) - 1, -1, -1):
        bi = chunks[cx][2]
        b, live, out = cuda_sdp.band_reverse_cross(bi, halo)
        torch.cuda.synchronize()
        pb, plive, pout = tsd.plain_band_reverse(bi, halo)
        assert torch.equal(b, pb) and torch.equal(live, plive)
        _halo_equal(out, pout)
        bits[cx], halo = b, out
    halo = tsd.blank_halo(chunks[0][2], True)
    cols = []
    for cx, (v0, v1, bi) in enumerate(chunks):
        col, live, xb, out = cuda_sdp.band_forward_cross(bi, bits[cx], halo)
        torch.cuda.synchronize()
        pcol, plive, pxb, pout = tsd.plain_band_forward(bi, bits[cx], halo)
        assert torch.equal(col, pcol) and torch.equal(live, plive)
        assert torch.equal(xb, pxb)
        _halo_equal(out, pout)
        cols.append(col[0, :v1 - v0 + 1].cpu().numpy())
        halo = out
    assert cuda_sdp.K8.launches == n8 + 2 * len(chunks)
    want = cuda_sdp.run_kernel(model, [(pair, plan)], pair.args.dropoff,
                               dev)[0]
    np.testing.assert_array_equal(
        cuda_sdp.locus_best(np.concatenate(cols), plan), want["band_end"])
    _same(cuda_sdp.run_kernel_cross_chip(model, pair, plan,
                                         pair.args.dropoff, n_chips,
                                         devices=[dev]), want)
