"""The CUDA wavefront's host side: plan table, storage plan, wrappers.

Tests marked ``gpu`` compare the hand-written kernels with their plain
PyTorch versions on a CUDA card; they decide inside the test body
whether a card is present and skip without one.  The other tests run
anywhere: on the CPU every wrapper runs its plain version and counts no
launch.  The models come from the port's own host layer; the JAX
package's planners are imported inside the tests that compare with
them, so that on a machine without JAX the card tests run with
``python -m pytest --noconftest -m gpu tests/test_torch_cuda_wavefront.py``.
"""
import os
import re

import pytest
import torch

import exonerate_tpu_torch
from exonerate_tpu_torch.alphabet import AlphabetType
from exonerate_tpu_torch.engine.region import Region
from exonerate_tpu_torch.model.affine import AffineModelType, affine_create
from exonerate_tpu_torch.model.data import AlignData
from exonerate_tpu_torch.model.est2genome import est2genome_create
from exonerate_tpu_torch.model.registry import (ModelType, get_model,
                                                translate_both)
from exonerate_tpu_torch.seqio import Annotation, Sequence, iter_fasta
from exonerate_tpu_torch.engine.subopt import SubOpt
import torch_split_cases as sc
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import wavefront as twf

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")
CSRC = os.path.join(os.path.dirname(cw.__file__), os.pardir, "csrc")


def _calm():
    s = next(iter(iter_fasta(ALL4)))
    s.strand = "+"
    return s


def _models(pkg="exonerate_tpu_torch"):
    """The models of the plan-table tests, from package ``pkg``."""
    import importlib
    reg = importlib.import_module(f"{pkg}.model.registry")
    aff = importlib.import_module(f"{pkg}.model.affine")
    A = importlib.import_module(f"{pkg}.alphabet").AlphabetType
    e2g = importlib.import_module(f"{pkg}.model.est2genome")
    return [e2g.est2genome_create(),
            aff.affine_create(aff.AffineModelType.LOCAL, A.PROTEIN,
                              A.PROTEIN),
            aff.affine_create(aff.AffineModelType.GLOBAL, A.DNA, A.DNA),
            reg.get_model(reg.ModelType.CODING2CODING, A.DNA, A.DNA),
            reg.get_model(reg.ModelType.PROTEIN2GENOME, A.PROTEIN, A.DNA),
            reg.get_model(reg.ModelType.CDNA2GENOME, A.DNA, A.DNA)]


def _names(ts):
    return [t.name for t in ts]


def _split_inputs(mtname, mode, device=CPU, n_jobs=2):
    """K1/K4 inputs of ``mtname`` on its small split pair (and a shifted
    sub-box of it), built from the port's host layer."""
    kind, cuts = {"PROTEIN2GENOME": ("protein", sc.CUTS),
                  "CODING2GENOME": ("cdna", sc.C2G_CUTS),
                  "CDNA2GENOME": ("cdna", sc.CUTS)}[mtname]
    q, t = sc.small_pair(kind, cuts=cuts)
    qs, ts = Sequence("q", None, q), Sequence("t", None, t)
    if mtname == "CDNA2GENOME":
        qs.annotation = Annotation(0, len(q))
    mt = ModelType[mtname]
    model = get_model(mt, AlphabetType.PROTEIN if kind == "protein"
                      else AlphabetType.DNA, AlphabetType.DNA)
    data = AlignData(qs, ts, translate_both(mt))
    boxes = [Region(0, 0, len(q), len(t)),
             Region(3, 5, len(q) - 3, len(t) - 20)][:n_jobs]
    pads = (twf._bucket(len(q)), twf._bucket(len(t)))
    per_pair = []
    for region in boxes:
        inputs, kinds = twf.prepare_inputs(model, region, data, pad_to=pads,
                                           for_pallas=True)
        per_pair.append(inputs)
    return model, cw.to_kernel_inputs(model, per_pair, kinds, device, mode)


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


@pytest.mark.parametrize("k", range(6))
def test_plan_table_follows_build_plan(k):
    from exonerate_tpu.engine import pallas_wavefront
    model = _models()[k]
    jmodel = _models("exonerate_tpu")[k]
    jplan = pallas_wavefront._build_plan(jmodel)
    plan = cw._build_plan(model)
    assert _names(p["t"] for p in plan) == _names(p["t"] for p in jplan)
    for p, jp in zip(plan, jplan):
        assert (p["key"], p["shkey"], p["pallas_ci"], p["dst_shadows"]) \
            == (jp["key"], jp["shkey"], jp["pallas_ci"], jp["dst_shadows"])
        assert p["start_lanes"] == jp["start_lanes"]
    assert _names(cw._plan_transitions(model)) == \
        _names(pallas_wavefront._plan_transitions(jmodel))
    n = model.total_shadow_designations
    assert cw._storage_plan(model, plan, (n, n + 1)) == \
        pallas_wavefront._storage_plan(jmodel, jplan, (n, n + 1))
    calm = _calm()
    protein = model.name.startswith(("affine:local:protein",
                                     "protein2genome"))
    q = Sequence("q", None, "MKVLAAGICAGW") if protein else calm
    region = Region(0, 0, 10, 12)
    inputs, kinds = twf.prepare_inputs(model, region, AlignData(q, calm),
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
    model, jmodel = _models()[0], _models("exonerate_tpu")[0]
    n = model.total_shadow_designations
    lanes = (n, n + 1) if mode == "region" else ()
    got = cw._storage_plan(model, cw._build_plan(model), lanes)
    want = pallas_wavefront._storage_plan(
        jmodel, pallas_wavefront._build_plan(jmodel), lanes)
    assert got == want
    _, ki = _e2g_inputs(mode)
    assert ki.NR == len(got[0]) and ki.NL == len(got[1])
    assert ki.L == n + (2 if mode == "region" else 0)


def test_cuda_source_declares_the_python_constants():
    with open(os.path.join(CSRC, "wavefront.cu")) as fh:
        src = fh.read()
    consts = dict(re.findall(
        r"constexpr (?:int|int32_t) (\w+) = (-?\d+);", src))
    names = [n for n in consts
             if n.startswith(("P_", "F_", "C_", "SCOPE_", "ST_"))]
    assert len(names) >= 36
    for name in names:
        assert int(consts[name]) == getattr(twf, name), name
    assert int(consts["PLAN_COLS"]) == twf.PLAN_COLS
    assert int(consts["NEG"]) == twf.NEG
    assert int(consts["HIGH"]) == twf.IMPOSSIBLY_HIGH_SCORE
    assert int(consts["MAX_L"]) == cw.MAX_L


def test_launch_counters_stay_zero_on_cpu():
    before = (cw.wavefront_scan.launches, cw.wavefront_path.launches,
              cw.walkback.launches, cw.K3.launches)
    model, ki = _e2g_inputs("region")
    cw.wavefront_scan(ki)
    _, ki = _e2g_inputs("path")
    stats, tb = cw.wavefront_path(ki)
    cw.walkback(tb, stats, ki.walk, ki.end_id, 600)
    calm = _calm()
    cw.find_path_batched(model, [(Region(5, 5, 60, 70),
                                  AlignData(calm, calm))], device=CPU)
    sub = SubOpt()
    sub.points.add((10, 12))
    sub.by_row[12] = {10}
    cw.find_batched(model, [(Region(0, 0, 60, 70), AlignData(calm, calm))],
                    device=CPU, subopt=sub)
    assert (cw.wavefront_scan.launches, cw.wavefront_path.launches,
            cw.walkback.launches, cw.K3.launches) == before == (0, 0, 0, 0)


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
    """The split-codon models run on the kernels (K9 is the C_SPLIT calc
    kind); genome2genome's query-side and joint split codons are shadow
    calcs with array inputs, off the kernels as in the JAX package."""
    assert cw.unsupported_reason(est2genome_create()) is None
    p2g = get_model(ModelType.PROTEIN2GENOME, AlphabetType.PROTEIN,
                    AlphabetType.DNA)
    assert cw.unsupported_reason(p2g) is None
    for mt in ("CODING2GENOME", "CDNA2GENOME"):
        assert cw.unsupported_reason(get_model(
            ModelType[mt], AlphabetType.DNA, AlphabetType.DNA)) is None
    g2g = get_model(ModelType.GENOME2GENOME, AlphabetType.DNA,
                    AlphabetType.DNA)
    assert "query-side or joint split codon" in cw.unsupported_reason(g2g)
    # a 2-D calc grid is off the kernels; the SubOpt mask plane (K3) is
    # not any more
    assert cw.unsupported_reason(
        est2genome_create(), (("_blocked", "blocked"),)) is None
    with pytest.raises(ValueError):
        calm = _calm()
        inputs, kinds = twf.prepare_inputs(
            est2genome_create(), Region(0, 0, 5, 5), AlignData(calm, calm))
        cw.to_kernel_inputs(est2genome_create(), inputs,
                            kinds + (("g9", "grid2d"),), CPU)


def test_lib_types_every_entry_point_of_a_library(monkeypatch):
    """_lib sets argtypes/restype per (library, entry point): the second
    entry point of a library gets its own, so 64-bit pointers are never
    passed as C int."""
    class Fn:
        argtypes = restype = None

    class Lib:
        first, second = Fn(), Fn()

    lib = Lib()
    monkeypatch.setattr(cw._cudabuild, "load", lambda stem: lib)
    monkeypatch.setattr(cw, "_typed", set())
    ptrs = [cw._P, cw._P, cw._I]
    assert cw._lib("fake", "first", ptrs) is lib.first
    assert cw._lib("fake", "second", [cw._I, cw._P]) is lib.second
    assert lib.first.argtypes == ptrs
    assert lib.second.argtypes == [cw._I, cw._P]
    assert lib.first.restype is lib.second.restype is cw.ctypes.c_int


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


@pytest.mark.gpu
@pytest.mark.parametrize("mtname", ["PROTEIN2GENOME", "CODING2GENOME",
                                    "CDNA2GENOME"])
def test_k1_k4_split_codon_equal_plain(mtname):
    """K9 inside K1 and K4: the split-codon plans on the card equal the
    plain version in region and path modes, and count as K9 launches."""
    dev = _need_card()
    _, ki = _split_inputs(mtname, "region", dev)
    n9 = cw.K9.launches
    assert torch.equal(cw.wavefront_scan(ki), twf.plain_wavefront(ki)[0])
    _, ki = _split_inputs(mtname, "path", dev)
    stats, tb = cw.wavefront_path(ki)
    p_stats, p_tb = twf.plain_wavefront(ki)
    torch.cuda.synchronize()
    # the cube's cells inside each pair's DP (the kernel leaves the others
    # unwritten): cell (i, d - i) with i <= qlen and d - i <= tlen
    qlen, tlen = (ki.dims[:, k].long()[:, None, None] for k in (2, 3))
    d = torch.arange(tb.shape[1], device=tb.device)[None, :, None]
    i = torch.arange(tb.shape[3], device=tb.device)[None, None, :]
    valid = ((d - i >= 0) & (d - i <= tlen) & (i <= qlen))[:, :, None, :]
    valid = valid.expand_as(tb)
    assert torch.equal(stats, p_stats)
    assert torch.equal(tb[valid], p_tb.to(tb.device)[valid])
    assert cw.K9.launches == n9 + 2


def _masked_inputs(mode, device, mtname=None):
    """A ragged masked batch: the first alignment of each job blocked
    (so the re-run must find another), est2genome on calm boxes or the
    split pair of ``mtname`` (a phase-1 and a phase-2 split codon); plus
    the same jobs mask-free."""
    from exonerate_tpu_torch.engine.optimal import _to_alignment
    if mtname is None:
        model = est2genome_create()
        calm = _calm()
        data = AlignData(calm, calm)
        boxes = [Region(0, 0, 100, 160), Region(40, 10, 80, 150),
                 Region(10, 30, 120, 90)]
        pads = (256, 256)
    else:
        q, t = sc.small_pair("protein")
        mt = ModelType[mtname]
        model = get_model(mt, AlphabetType.PROTEIN, AlphabetType.DNA)
        data = AlignData(Sequence("q", None, q), Sequence("t", None, t),
                         translate_both(mt))
        boxes = [Region(0, 0, len(q), len(t)),
                 Region(3, 5, len(q) - 3, len(t) - 20)]
        pads = (twf._bucket(len(q)), twf._bucket(len(t)))
    per_pair, free = [], []
    for region in boxes:
        sub = SubOpt()
        path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
        sub.add_alignment(_to_alignment(model, region, path))
        inputs, kinds = twf.prepare_inputs(model, region, data, subopt=sub,
                                           pad_to=pads, for_pallas=True)
        per_pair.append(inputs)
        f_inputs, f_kinds = twf.prepare_inputs(model, region, data,
                                               pad_to=pads, for_pallas=True)
        free.append(f_inputs)
    return (cw.to_kernel_inputs(model, per_pair, kinds, device, mode),
            cw.to_kernel_inputs(model, free, f_kinds, device, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mtname", [None, "PROTEIN2GENOME"])
def test_k3_in_k1_and_k4_equal_plain(mtname):
    """K3 inside K1 (score, region) and K4 (path + walk-back) on ragged
    masked batches, beside the same jobs mask-free: each equals the plain
    version, the masked scores differ from the mask-free ones, and only
    the masked launches count as K3."""
    dev = _need_card()
    for mode in ("score", "region", "path"):
        ki, free = _masked_inputs(mode, dev, mtname)
        assert ki.masked and not free.masked
        n3 = cw.K3.launches
        if mode == "path":
            stats, tb = cw.wavefront_path(ki)
            f_stats, _ = cw.wavefront_path(free)
            p_stats, p_tb = twf.plain_wavefront(ki)
            torch.cuda.synchronize()
            valid = _tb_valid(ki, tb)
            assert torch.equal(stats, p_stats)
            assert torch.equal(tb[valid], p_tb.to(tb.device)[valid])
            cap = ki.Qp + ki.Tp + 1 + cw.WALK_SLACK
            ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, cap)
            p_ops, p_res = twf.plain_walkback(p_tb, p_stats, ki.walk,
                                              ki.end_id, cap)
            assert torch.equal(res, p_res)
            for b in range(ki.batch):
                k = int(res[0, b])
                assert torch.equal(ops[b, :k], p_ops[b, :k])
        else:
            stats = cw.wavefront_scan(ki)
            f_stats = cw.wavefront_scan(free)
            assert torch.equal(stats, twf.plain_wavefront(ki)[0])
        assert torch.equal(f_stats, twf.plain_wavefront(free)[0])
        assert (stats[0] < f_stats[0]).all()
        assert cw.K3.launches == n3 + 1


def _tb_valid(ki, tb):
    qlen, tlen = (ki.dims[:, k].long()[:, None, None] for k in (2, 3))
    d = torch.arange(tb.shape[1], device=tb.device)[None, :, None]
    i = torch.arange(tb.shape[3], device=tb.device)[None, None, :]
    return ((d - i >= 0) & (d - i <= tlen)
            & (i <= qlen))[:, :, None, :].expand_as(tb)
