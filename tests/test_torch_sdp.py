"""The port's seeded band scan: host prep, the plain scan, the wrappers.

The plain PyTorch band scan (``exonerate_tpu_torch.engine.sdp_device``)
must equal, exactly, the JAX package's XLA scan (``sdp_device.get_fn``),
its Pallas kernel in interpret mode (``sdp_pallas.run_kernel``) and the
oracle scheduler's per-locus best end score, on the synthetic pairs of
``tests/test_sdp_pallas.py`` and on protein2genome, coding2genome and
cdna2genome pairs whose exons split codons of both phases (kernel K9,
the split-codon calc, inside K7).  Each case is built twice, from the
port's host layer and from the JAX package's (``torch_sdp_cases``).
Tests marked ``gpu`` hold the CUDA kernels K6/K7 to the plain version on
a card and skip without one.
"""
import os
import re

import numpy as np
import pytest
import torch

from exonerate_tpu_torch.alphabet import AlphabetType
from exonerate_tpu_torch.model.registry import ModelType, get_model
from exonerate_tpu_torch.engine import cuda_sdp
from exonerate_tpu_torch.engine import sdp_device as tsd
from exonerate_tpu_torch.engine import sdp_hybrid as thy
from torch_sdp_cases import CASES, SPLIT_CASES
from torch_sdp_cases import case as _case

DD = (AlphabetType.DNA, AlphabetType.DNA)

CPU = torch.device("cpu")
CSRC = os.path.join(os.path.dirname(cuda_sdp.__file__), os.pardir, "csrc")


@pytest.fixture(autouse=True)
def _python_sdp(monkeypatch):
    monkeypatch.setenv("EXONERATE_TPU_SDP", "python")


# -- host prep: copies of the JAX functions ------------------------------

def _eq(a, b):
    """Deep equality across the two packages: model objects (transitions,
    calcs, states) compare by name."""
    if hasattr(a, "name") and not isinstance(a, np.ndarray):
        assert a.name == b.name
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("name", ["two_exons_intron", "ner_joint_span",
                                  "affine_local", "p2g_split"])
def test_host_prep_equals_jax(name):
    from exonerate_tpu.engine import sdp_device, sdp_pallas
    model, pair, plan = _case(name)
    jmodel, jpair, jplan = _case(name, pkg="exonerate_tpu")
    assert tsd.supported(model) == sdp_device.supported(jmodel)
    for fwd in (False, True):
        _eq(tsd._plan_transitions(model, fwd),
            sdp_device._plan_transitions(jmodel, fwd))
        assert cuda_sdp._ring_plan(model, fwd) == \
            sdp_pallas._ring_plan(jmodel, fwd)
    _eq(tsd._span_plan(model), sdp_device._span_plan(jmodel))
    for pad in (None, (256, 1024)):
        _eq(tsd.prepare_inputs(model, pair, plan, pad_to=pad),
            sdp_device.prepare_inputs(jmodel, jpair, jplan, pad_to=pad))
    _eq(tsd.prepare_seeds(pair, plan, 8),
        sdp_device.prepare_seeds(jpair, jplan, 8))
    n = cuda_sdp.count_seed_layers(pair, plan)
    assert n == sdp_pallas.count_seed_layers(jpair, jplan)
    for layers in (1, 5):
        assert cuda_sdp.kernel_supported(model, pair.use_boundary, layers,
                                         pair) == \
            sdp_pallas.kernel_supported(jmodel, jpair.use_boundary, layers,
                                        jpair)
    _eq(cuda_sdp.prepare_kernel_inputs(model, pair, plan, 256, 1024, n),
        sdp_pallas.prepare_kernel_inputs(jmodel, jpair, jplan, 256, 1024,
                                         n))


# -- the plain scan against the XLA scan, the Pallas kernel, the oracle --

def _xla(model, pair, plan):
    from exonerate_tpu.engine import sdp_device
    inputs, kinds = sdp_device.prepare_inputs(model, pair, plan)
    inputs.update(sdp_device.prepare_seeds(pair, plan, len(pair.seeds)))
    fn = sdp_device.get_fn(model, pair.region.query_length, plan.W, kinds,
                           pair.use_boundary, len(pair.seeds),
                           len(plan.loci) + 1, pair.args.dropoff)
    return {k: np.asarray(v) for k, v in fn(inputs).items()}


def _oracle(pair, plan):
    exp = np.full(len(plan.loci), tsd.NEG, np.int64)
    for lx, lc in enumerate(plan.loci):
        for s in pair.seeds[lc.seed_lo:lc.seed_hi]:
            exp[lx] = max(exp[lx], s.max_end.score)
    return exp


_SINGLE: dict = {}


def _single(name):
    """run_kernel on the CPU for one case alone (cached per module)."""
    if name not in _SINGLE:
        model, pair, plan = _case(name)
        _SINGLE[name] = cuda_sdp.run_kernel(model, [(pair, plan)],
                                            pair.args.dropoff, CPU)[0]
    return _SINGLE[name]


def _check(name):
    from exonerate_tpu.engine import sdp_pallas
    model, pair, plan = _case(name)
    jmodel, jpair, jplan = _case(name, pkg="exonerate_tpu")
    assert cuda_sdp.unsupported_reason(model, pair, plan) is None
    got = _single(name)
    n = len(plan.loci)
    for want in (_xla(jmodel, jpair, jplan),
                 sdp_pallas.run_kernel(jmodel, [(jpair, jplan)],
                                       jpair.args.dropoff,
                                       interpret=True)[0]):
        assert got["live"] == bool(want["live"])
        assert got["xband"] == bool(want["xband"])
        np.testing.assert_array_equal(
            got["band_end"][:n], np.asarray(want["band_end"][:n], np.int64))
    if not got["live"]:
        np.testing.assert_array_equal(got["band_end"][:n],
                                      _oracle(pair, plan))
    return model, pair, plan, got


@pytest.mark.parametrize("name", sorted(CASES) + sorted(SPLIT_CASES))
def test_plain_scan_equals_xla_pallas_and_oracle(name):
    model, pair, plan, got = _check(name)
    if name in SPLIT_CASES:
        # K9 ran: the forward table holds a split-codon row of each phase
        bi = cuda_sdp.band_inputs(model, [(pair, plan)], pair.args.dropoff,
                                  CPU)
        rows = bi.fwd_plan.tolist()
        assert bi.split and sorted(r[tsd.BP_C2] for r in rows
                                   if r[tsd.BP_CALC] == tsd.K_SPLIT) == [1, 2]
        assert not got["live"]


@pytest.mark.slow
def test_plain_scan_two_distant_loci():
    _check("distant_loci")


def test_padding_never_changes_band_end():
    """The XLA tier pads W from 8 (``_pow2(max(W, 1024))``), the kernels
    from 1024 (``_pow2(max(W, 1023))``): no padding of W may change a
    locus's best end score or the flags."""
    name = "seed_layers_same_column"
    model, pair, plan = _case(name)
    n = cuda_sdp.count_seed_layers(pair, plan)
    flat, kinds, meta = cuda_sdp.prepare_kernel_inputs(
        model, pair, plan, 256, 2048, n)
    bi = cuda_sdp.to_band_inputs(model, [flat], kinds, [meta], 256, 2048,
                                 pair.args.dropoff, CPU)
    res = tsd.plain_band_scan(bi)
    want = _single(name)            # run_kernel pads this W to 1024
    np.testing.assert_array_equal(
        cuda_sdp.locus_best(res["colbest"][0].numpy(), plan),
        want["band_end"])
    assert (bool(res["live"][0]), bool(res["xband"][0])) == \
        (want["live"], want["xband"])


def test_ragged_batch_equals_single_runs():
    model = get_model(ModelType.EST2GENOME, *DD)
    jobs = [_case(n, model)[1:] for n in ("single_exon", "two_exons_intron",
                                          "seed_layers_same_column")]
    jobs.append(jobs[0])
    batch = cuda_sdp.run_kernel(model, jobs, 50, CPU)
    names = ["single_exon", "two_exons_intron", "seed_layers_same_column",
             "single_exon"]
    for name, got in zip(names, batch):
        want = _single(name)
        assert got["live"] == want["live"] and got["xband"] == want["xband"]
        np.testing.assert_array_equal(got["band_end"], want["band_end"])


# -- routing, wrappers, kernel source ------------------------------------

def test_unsupported_reason_names_the_missing_kernel():
    p2g = get_model(ModelType.PROTEIN2GENOME, AlphabetType.PROTEIN,
                    AlphabetType.DNA)
    assert cuda_sdp.unsupported_reason(p2g) is None
    for mt in ("CODING2GENOME", "CDNA2GENOME"):
        m = get_model(ModelType[mt], *DD)
        assert cuda_sdp.unsupported_reason(m) is None
    g2g = get_model(ModelType.GENOME2GENOME, *DD)
    assert "query-side or joint split codon" in \
        cuda_sdp.unsupported_reason(g2g)
    assert cuda_sdp.unsupported_reason(
        get_model(ModelType.EST2GENOME, *DD)) is None
    assert "non-boundary" in cuda_sdp.unsupported_reason(
        get_model(ModelType.AFFINE_LOCAL, *DD))
    model, pair, plan = _case("affine_local")
    out = thy.run_device_batch(model, [(pair, plan)], CPU)[0]
    assert "band kernel unsupported (non-boundary" in out["fallback"]


def test_device_tier_gates_and_refusals(monkeypatch):
    model, pair, plan = _case("two_exons_intron")
    assert not thy.device_worthwhile(plan, 180)
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")
    assert thy.device_worthwhile(plan, 180)
    monkeypatch.setattr(thy, "SCAN_DIAG_CAP", 100)
    out = thy.run_device_batch(model, [(pair, plan)], CPU)[0]
    assert out == {"fallback": "sdp device->host: kernel unavailable, "
                               "scan too long"}
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS", "1")
    with pytest.raises(RuntimeError, match="not ported"):
        thy.run_device_batch(model, [(pair, plan)], CPU)
    monkeypatch.delenv("EXONERATE_TPU_SDP_ROWS")
    # the cross-chip tier (K8): N devices, and a band of MIN_W columns
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP", "4")
    assert thy.unported_tier() is None
    assert thy._cross_chip_config(plan, CPU) == 0     # W under 1M
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP_MIN_W", "1")
    # a caller on the CPU gets no cards, however many are visible
    monkeypatch.setattr(thy.torch.cuda, "device_count", lambda: 4)
    assert thy._devices(CPU) == []
    assert thy._cross_chip_config(plan, CPU) == 0
    assert len(thy._devices(torch.device("cuda", 0))) == 4
    monkeypatch.setattr(thy, "_devices", lambda device: [CPU] * 3)
    assert thy._cross_chip_config(plan, CPU) == 0     # too few devices
    monkeypatch.setattr(thy, "_devices", lambda device: [CPU] * 4)
    assert thy._cross_chip_config(plan, CPU) == 4
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP_MIN_W", str(plan.W + 1))
    assert thy._cross_chip_config(plan, CPU) == 0


def test_cuda_source_declares_the_python_constants():
    with open(os.path.join(CSRC, "sdp_band.cu")) as fh:
        src = fh.read()
    consts = dict(re.findall(
        r"constexpr (?:int|int32_t) (\w+) = (-?\d+);", src))
    names = [n for n in consts
             if n.startswith(("BP_", "BF_", "K_", "SP_", "ST_"))]
    assert len(names) >= 40
    for name in names:
        assert int(consts[name]) == getattr(tsd, name), name
    assert int(consts["NEG"]) == tsd.NEG
    assert int(consts["POS"]) == tsd.POS
    assert int(consts["MAX_STARTS"]) == tsd.MAX_STARTS
    for name in ("MAX_S", "MAX_SH", "MAX_SPANS", "MAX_CAND",
                 "MAX_SEED_LAYERS"):
        assert int(consts[name]) == getattr(cuda_sdp, name), name
    assert 'extern "C" int sdp_band_reverse(' in src
    assert 'extern "C" int sdp_band_forward(' in src


def _band_inputs(name="seed_layers_same_column", device=CPU):
    model, pair, plan = _case(name)
    flat, kinds, meta = cuda_sdp.prepare_kernel_inputs(
        model, pair, plan, 256, 1024, cuda_sdp.count_seed_layers(pair, plan))
    return cuda_sdp.to_band_inputs(model, [flat], kinds, [meta], 256, 1024,
                                   pair.args.dropoff, device)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    before = (cuda_sdp.band_reverse.launches, cuda_sdp.band_forward.launches)
    bi = _band_inputs()
    bits, _ = cuda_sdp.band_reverse(bi)
    cuda_sdp.band_forward(bi, bits)
    with pytest.raises(ValueError):
        cuda_sdp.band_forward(bi, bits[:, :-1])
    with pytest.raises(ValueError):
        cuda_sdp.band_forward(bi, bits.long())
    bi.tvecs = bi.tvecs.long()
    with pytest.raises(ValueError):
        cuda_sdp.band_reverse(bi)
    bi = _band_inputs()
    bi.S = cuda_sdp.MAX_S + 1
    with pytest.raises(ValueError):
        cuda_sdp.band_reverse(bi)
    assert (cuda_sdp.band_reverse.launches,
            cuda_sdp.band_forward.launches) == before == (0, 0)


def test_max_batch_budget():
    model = get_model(ModelType.EST2GENOME, *DD)
    # the full-width scan's shape: Qp 1280, Wp 65536
    per = cuda_sdp.pair_bytes(model, 1280, 65536, 8 + 2 * len(model.calcs))
    assert 15 << 20 < per < 25 << 20
    assert cuda_sdp.max_batch(model, 1280, 65536, 22) >= 16


# -- the kernels on a card ----------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + sorted(SPLIT_CASES))
def test_k6_k7_equal_plain(name):
    dev = _need_card()
    model, pair, plan = _case(name)
    bi = cuda_sdp.band_inputs(model, [(pair, plan)], pair.args.dropoff, dev)
    n6, n7 = cuda_sdp.band_reverse.launches, cuda_sdp.band_forward.launches
    bits, live_r = cuda_sdp.band_reverse(bi)
    colbest, live_f, xband = cuda_sdp.band_forward(bi, bits)
    torch.cuda.synchronize()
    assert (cuda_sdp.band_reverse.launches,
            cuda_sdp.band_forward.launches) == (n6 + 1, n7 + 1)
    p_bits, p_live_r = tsd.plain_band_reverse(bi)
    p_col, p_live_f, p_xb = tsd.plain_band_forward(bi, p_bits)
    assert torch.equal(bits, p_bits) and torch.equal(live_r, p_live_r)
    assert torch.equal(colbest, p_col) and torch.equal(live_f, p_live_f)
    assert torch.equal(xband, p_xb)
