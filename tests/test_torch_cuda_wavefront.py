"""The CUDA wavefront's host side: plan table, storage plan, wrappers.

Tests marked ``gpu`` compare the hand-written kernels with their plain
PyTorch versions on a CUDA card; they decide inside the test body
whether a card is present and skip without one.  The other tests run
anywhere: on the CPU every wrapper runs its plain version and counts no
launch.  The JAX reference is imported inside the tests that need it, so
that on a machine without JAX the card tests run with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda_wavefront.py``.
"""
import os
import re

import pytest
import torch

from exonerate_tpu.alphabet import AlphabetType
from exonerate_tpu.engine.region import Region
from exonerate_tpu.model.affine import AffineModelType, affine_create
from exonerate_tpu.model.data import AlignData
from exonerate_tpu.model.est2genome import est2genome_create
from exonerate_tpu.model.registry import ModelType, get_model
from exonerate_tpu.seqio import Sequence, iter_fasta
import exonerate_tpu_torch
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import wavefront as twf

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")
CSRC = os.path.join(os.path.dirname(cw.__file__), os.pardir, "csrc")


def _calm():
    s = next(iter(iter_fasta(ALL4)))
    s.strand = "+"
    return s


def _models():
    return [est2genome_create(),
            affine_create(AffineModelType.LOCAL, AlphabetType.PROTEIN,
                          AlphabetType.PROTEIN),
            affine_create(AffineModelType.GLOBAL, AlphabetType.DNA,
                          AlphabetType.DNA),
            get_model(ModelType.CODING2CODING, AlphabetType.DNA,
                      AlphabetType.DNA)]


def _e2g_inputs(mode, jobs=((0, 0, 100, 160),), device=CPU):
    model = est2genome_create()
    calm = _calm()
    data = AlignData(calm, calm)
    per_pair = []
    for qs, ts, ql, tl in jobs:
        inputs, kinds = twf.prepare_inputs(
            model, Region(qs, ts, ql, tl), data, pad_to=(256, 256),
            for_pallas=True)
        per_pair.append(inputs)
    return model, cw.to_kernel_inputs(model, per_pair, kinds, device, mode)


@pytest.mark.parametrize("k", range(4))
def test_plan_table_follows_build_plan(k):
    from exonerate_tpu.engine import pallas_wavefront
    model = _models()[k]
    plan = pallas_wavefront._build_plan(model)
    assert [p["t"] for p in cw._build_plan(model)] == [p["t"] for p in plan]
    assert cw._plan_transitions(model) == \
        pallas_wavefront._plan_transitions(model)
    calm = _calm()
    q = Sequence("q", None, "MKVLAAGICAGW") \
        if model.name.startswith("affine:local:protein") else calm
    region = Region(0, 0, 10, 12)
    inputs, kinds = twf.prepare_inputs(model, region, AlignData(q, q),
                                       pad_to=(256, 256), for_pallas=True)
    ki = cw.to_kernel_inputs(model, inputs, kinds, CPU, "region")
    rows = ki.plan.tolist()
    start, end = model.start_state.state, model.end_state.state
    assert len(rows) == len(plan)
    for row, p in zip(rows, plan):
        t = p["t"]
        assert row[twf.P_AQ:twf.P_OUT + 1] == [
            t.advance_query, t.advance_target, t.input.id, t.output.id]
        assert bool(row[twf.P_FLAGS] & twf.F_FROM_START) == \
            (t.input is start)
        assert bool(row[twf.P_FLAGS] & twf.F_TO_END) == (t.output is end)
        assert (row[twf.P_CALC] == twf.C_NONE) == (t.calc is None)
    walk = ki.walk.tolist()
    assert walk[0][1:] == [t.advance_query for t in cw._plan_transitions(
        model)]


@pytest.mark.parametrize("mode", ["score", "region"])
def test_storage_plan_matches_pallas(mode):
    from exonerate_tpu.engine import pallas_wavefront
    model = est2genome_create()
    n = model.total_shadow_designations
    lanes = (n, n + 1) if mode == "region" else ()
    got = cw._storage_plan(model, cw._build_plan(model), lanes)
    want = pallas_wavefront._storage_plan(
        model, pallas_wavefront._build_plan(model), lanes)
    assert got == want
    _, ki = _e2g_inputs(mode)
    assert ki.NR == len(got[0]) and ki.NL == len(got[1])
    assert ki.L == n + (2 if mode == "region" else 0)


def test_cuda_source_declares_the_python_constants():
    with open(os.path.join(CSRC, "wavefront.cu")) as fh:
        src = fh.read()
    consts = dict(re.findall(
        r"constexpr (?:int|int32_t) (\w+) = (-?\d+);", src))
    names = [n for n in consts if n.startswith(("P_", "F_", "C_", "SCOPE_"))]
    assert len(names) >= 30
    for name in names:
        assert int(consts[name]) == getattr(twf, name), name
    assert int(consts["PLAN_COLS"]) == twf.PLAN_COLS
    assert int(consts["NEG"]) == twf.NEG
    assert int(consts["HIGH"]) == twf.IMPOSSIBLY_HIGH_SCORE
    assert int(consts["MAX_L"]) == cw.MAX_L


def test_launch_counters_stay_zero_on_cpu():
    before = (cw.wavefront_scan.launches, cw.wavefront_path.launches,
              cw.walkback.launches)
    model, ki = _e2g_inputs("region")
    cw.wavefront_scan(ki)
    _, ki = _e2g_inputs("path")
    stats, tb = cw.wavefront_path(ki)
    cw.walkback(tb, stats, ki.walk, ki.end_id, 600)
    calm = _calm()
    cw.find_path_batched(model, [(Region(5, 5, 60, 70),
                                  AlignData(calm, calm))], device=CPU)
    assert (cw.wavefront_scan.launches, cw.wavefront_path.launches,
            cw.walkback.launches) == before == (0, 0, 0)


def test_wrappers_check_their_inputs():
    _, ki = _e2g_inputs("region")
    with pytest.raises(ValueError):
        cw.wavefront_path(ki)
    ki.qvecs = ki.qvecs.long()
    with pytest.raises(ValueError):
        cw.wavefront_scan(ki)
    _, ki = _e2g_inputs("path")
    stats, tb = cw.wavefront_path(ki)
    with pytest.raises(ValueError):
        cw.walkback(tb.int(), stats, ki.walk, ki.end_id, 10)


def test_unsupported_models_name_the_missing_kernel():
    assert cw.unsupported_reason(est2genome_create()) is None
    p2g = get_model(ModelType.PROTEIN2GENOME, AlphabetType.PROTEIN,
                    AlphabetType.DNA)
    assert "K9" in cw.unsupported_reason(p2g)
    with pytest.raises(ValueError):
        calm = _calm()
        inputs, kinds = twf.prepare_inputs(
            est2genome_create(), Region(0, 0, 5, 5), AlignData(calm, calm))
        cw.to_kernel_inputs(est2genome_create(), inputs,
                            kinds + (("_blocked", "blocked"),), CPU)


def test_max_batch_budgets():
    model = est2genome_create()
    assert cw.max_batch(model, 2304, 2304, "region") >= 64
    assert cw.max_batch(model, 2304, 2304, "path") >= 1
    assert cw.max_batch(model, 1 << 16, 1 << 16, "path") == 0


def test_device_resolution(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    assert exonerate_tpu_torch.device() == CPU
    monkeypatch.delenv(exonerate_tpu_torch.DEVICE_ENV)
    if torch.cuda.is_available():
        assert exonerate_tpu_torch.device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            exonerate_tpu_torch.device()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["score", "region"])
def test_k1_kernel_equals_plain(mode):
    dev = _need_card()
    _, ki = _e2g_inputs(mode, ((0, 0, 100, 160), (40, 10, 80, 150),
                               (10, 30, 120, 90)), dev)
    n = cw.wavefront_scan.launches
    got = cw.wavefront_scan(ki)
    torch.cuda.synchronize()
    assert cw.wavefront_scan.launches == n + 1
    assert torch.equal(got, twf.plain_wavefront(ki)[0])


@pytest.mark.gpu
def test_k4_and_walkback_equal_plain():
    dev = _need_card()
    _, ki = _e2g_inputs("path", ((0, 0, 100, 160), (10, 30, 120, 90)), dev)
    stats, tb = cw.wavefront_path(ki)
    p_stats, p_tb = twf.plain_wavefront(ki)
    assert torch.equal(stats, p_stats)
    cap = ki.Qp + ki.Tp + 1 + cw.WALK_SLACK
    ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, cap)
    p_ops, p_res = twf.plain_walkback(p_tb, p_stats, ki.walk, ki.end_id, cap)
    assert torch.equal(res, p_res)
    for b in range(ki.batch):
        k = int(res[0, b])
        assert torch.equal(ops[b, :k], p_ops[b, :k])
