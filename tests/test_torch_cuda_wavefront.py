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


def _split_job(mtname):
    """(model, region, data) of ``mtname`` on its small split pair, from
    the port's host layer."""
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
    return (model, Region(0, 0, len(q), len(t)),
            AlignData(qs, ts, translate_both(mt)))


def _split_inputs(mtname, mode, device=CPU, n_jobs=2):
    """K1/K4 inputs of ``mtname`` on its small split pair (and a shifted
    sub-box of it), built from the port's host layer."""
    model, whole, data = _split_job(mtname)
    nq, nt = whole.query_length, whole.target_length
    boxes = [whole, Region(3, 5, nq - 3, nt - 20)][:n_jobs]
    pads = (twf._bucket(nq), twf._bucket(nt))
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
    assert int(consts["THREADS"]) == cw.THREADS
    assert int(consts["MAX_CLUSTER"]) == cw.MAX_CLUSTER
    assert int(consts["PORTABLE_CLUSTER"]) == cw.PORTABLE_CLUSTER


def test_launch_counters_stay_zero_on_cpu():
    before = (cw.wavefront_scan.launches, cw.wavefront_path.launches,
              cw.walkback.launches, cw.K3.launches, cw.K2.launches)
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
    cw.find_batched(model, [(Region(0, 0, 60, 70), AlignData(calm, calm))],
                    device=CPU, subopt=sub, stream=True)
    assert (cw.wavefront_scan.launches, cw.wavefront_path.launches,
            cw.walkback.launches, cw.K3.launches,
            cw.K2.launches) == before == (0, 0, 0, 0, 0)


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
    # K2 runs score/region
    with pytest.raises(ValueError):
        cw.wavefront_stream_scan(ki)


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
def test_walk_segment_equals_plain():
    """The walk-back kernel's segment entry point against the plain
    segment walk, from the end cells and from the cells a segment's walk
    left, over segments of the cube of 37 and 300 diagonals."""
    dev = _need_card()
    _, ki = _e2g_inputs("path", ((0, 0, 100, 160), (10, 30, 120, 90)), dev)
    stats, tb = cw.wavefront_path(ki)
    D = tb.shape[1]
    for seg in (37, 300):
        cell = torch.stack([stats[1], stats[2],
                            torch.full_like(stats[1], ki.end_id)])
        walking = torch.ones_like(stats[1], dtype=torch.bool)
        for _ in range(D // seg + 1):
            d0 = int((cell[0] + cell[1])[walking].max()) // seg * seg
            planes = tb[:, d0:d0 + seg].contiguous()
            n = cw.walkback.launches
            ops, res = cw.walk_segment(planes, d0, cell, ki.walk, 400)
            assert cw.walkback.launches == n + 1
            p_ops, p_res = twf.plain_walk_segment(planes, d0, cell, ki.walk,
                                                  400)
            assert torch.equal(res, p_res)
            for b in range(ki.batch):
                k = int(res[0, b])
                assert torch.equal(ops[b, :k], p_ops[b, :k])
            walking &= res[4] == twf.WALK_LEFT
            if not walking.any():
                break
            cell = res[1:4].contiguous()


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


def _k2_inputs(mode, device, masked=False):
    """A ragged est2genome batch at Qp 2304 (rows up to 2176: nine CTAs
    by K2's rule), with each job's first alignment masked when asked."""
    from exonerate_tpu_torch.engine.optimal import _to_alignment
    model = est2genome_create()
    calm = _calm()
    data = AlignData(calm, calm)
    boxes = [Region(0, 0, 2175, 160), Region(40, 10, 2000, 150),
             Region(10, 30, 1500, 90)]
    per_pair = []
    for region in boxes:
        sub = None
        if masked:
            sub = SubOpt()
            path = cw.find_path_batched(model, [(region, data)],
                                        device=device)[0]
            sub.add_alignment(_to_alignment(model, region, path))
        inputs, kinds = twf.prepare_inputs(model, region, data, subopt=sub,
                                           pad_to=(2304, 256),
                                           for_pallas=True)
        per_pair.append(inputs)
    return cw.to_kernel_inputs(model, per_pair, kinds, device, mode)


def _clusters(monkeypatch) -> list:
    """The CTAs per pair of every launch from here on (1 for K1/K4)."""
    used = []
    real = cw._launch

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        used.append(out[2])
        return out

    monkeypatch.setattr(cw, "_launch", spy)
    return used


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_k2_equals_plain_and_k1_at_every_cluster_size(masked, monkeypatch):
    """K2 at C = 1, 2, 8 (asked of the launcher) and by its rule (9 at
    these rows) equals the plain version exactly, and K1 on the same
    inputs, in score and region modes, masked (K3 inside K2) and
    mask-free."""
    dev = _need_card()
    used = _clusters(monkeypatch)
    for mode in ("score", "region"):
        ki = _k2_inputs(mode, dev, masked)
        assert ki.masked == masked
        want = twf.plain_wavefront(ki)[0]
        assert torch.equal(cw.wavefront_scan(ki), want)
        for cluster in (1, 2, 8):
            # a size asked of the launcher (uncounted)
            n2 = cw.K2.launches
            got, _, c = cw._launch(ki, cluster)
            torch.cuda.synchronize()
            assert c == cluster and cw.K2.launches == n2
            assert torch.equal(got, want), (mode, cluster)
        n2, n3 = cw.K2.launches, cw.K3.launches
        got = cw.wavefront_stream_scan(ki)
        torch.cuda.synchronize()
        # by the rule: ceil(2176 / 256) = 9 CTAs, 8 where only the
        # portable sizes launch
        assert used[-1] in (9, cw.PORTABLE_CLUSTER)
        assert torch.equal(got, want), mode
        assert cw.K2.launches == n2 + 1
        assert cw.K3.launches == n3 + masked


@pytest.mark.gpu
@pytest.mark.parametrize("mtname", [None, "PROTEIN2GENOME"])
def test_compiled_ring_kernel_equals_plan_kernel_and_plain(mtname,
                                                          monkeypatch):
    """The cluster kernel on the plan compiled in, byte-equal to K1/K4
    (``plan_kernel``) and to the plain version: out (5, B) and, in path
    mode, the planes of every valid cell; score, region and path modes,
    masked and mask-free; the ring in shared memory (where it fits) and
    in global memory, at the launcher's cluster size and at two CTAs a
    pair.  est2genome at 2176 rows (nine CTAs a pair, each halo crossing
    a CTA's edge), protein2genome on its split pairs (a FULL plan, K9).
    Then one segment of the checkpointed traceback: the forward pass on
    the cluster up to the middle diagonal leaves the rings, and a span
    from there in path mode (loading and storing the rings: ring_io)
    equals plan_kernel's planes over the span and the plain segment."""
    dev = _need_card()
    fits = cw.ring_in_smem
    for mode in ("score", "region", "path"):
        if mtname is None:
            kis = [_k2_inputs(mode, dev, masked) for masked in (False, True)]
        else:
            kis = list(_masked_inputs(mode, dev, mtname))
        assert [ki.masked for ki in kis] == (
            [False, True] if mtname is None else [True, False])
        for ki in kis:
            assert ki.split is (mtname is not None)
            p_out, p_tb = twf.plain_wavefront(ki)
            k_out, k_tb, _ = cw._launch(ki)
            torch.cuda.synchronize()
            assert torch.equal(k_out, p_out), (mode, ki.masked)
            valid = _tb_valid(ki, k_tb) if mode == "path" else None
            if mode == "path":
                assert torch.equal(k_tb[valid], p_tb.to(dev)[valid])
            for cluster in (0, 2):
                # the shared ring where it fits at this cluster size (at
                # two CTAs est2genome region's five rows a thread do not)
                for smem in ((True, False) if fits(ki, cluster)
                             else (False,)):
                    monkeypatch.setattr(cw, "ring_in_smem",
                                        lambda k, c=0, s=smem: s)
                    out, tb, _ = cw._launch(ki, cluster)
                    torch.cuda.synchronize()
                    where = (mode, ki.masked, smem, cluster)
                    assert torch.equal(out, k_out), where
                    if mode == "path":
                        assert torch.equal(tb[valid], k_tb[valid]), where
                    monkeypatch.setattr(cw, "ring_in_smem", fits)
            if mode != "path" or not ki.masked:
                continue
            D = ki.Qp + ki.Tp + 1
            span = (D // 2, D // 2 + 300)
            ring = cw.ring_buffers(ki)
            cw.wavefront_segment(cw.with_mode(ki, "score"), ring,
                                 (0, span[0]))
            p_ring = tuple(t.clone() for t in ring)
            _, tb = cw.wavefront_segment(ki, ring, span)
            _, seg_tb = twf.plain_wavefront(ki, span, p_ring)
            torch.cuda.synchronize()
            v = valid[:, span[0]:span[1]]
            assert torch.equal(tb[v], k_tb[:, span[0]:span[1]][v])
            assert torch.equal(tb[v], seg_tb.to(dev)[v])


@pytest.mark.gpu
def test_masked_chunks_run_on_the_cluster(monkeypatch):
    """A masked B=1 est2genome chunk, whose cluster fits the card, runs
    on the cluster kernel with its ring in shared memory, in region mode
    (K2) and in path mode over all its diagonals (K4 on a cluster), and
    equals K1 and K4, also with two pairs of one chunk under different
    masks; a masked protein2genome split pair in region mode (90 rows:
    one CTA a pair) stays on K1, and forced onto the cluster runs there
    with its ring in global memory.  Every launch is counted by its
    route."""
    from exonerate_tpu_torch.engine.optimal import _to_alignment
    dev = _need_card()
    model = est2genome_create()
    calm = _calm()
    data = AlignData(calm, calm)
    region = Region(0, 0, 600, 900)
    sub = SubOpt()
    path = cw.find_path_batched(model, [(region, data)], device=dev)[0]
    sub.add_alignment(_to_alignment(model, region, path))
    counters = (cw.wavefront_scan, cw.K2, cw.K3, cw.wavefront_path,
                cw.RING_SMEM, cw.RING_GLOBAL)

    def counts():
        return [c.launches for c in counters]

    n = counts()
    got = cw.find_batched(model, [(region, data)], device=dev, subopt=sub)
    p_got = cw.find_path_batched(model, [(region, data)], subopt=sub,
                                 device=dev)
    assert [a - b for a, b in zip(counts(), n)] == [0, 1, 2, 1, 2, 0]
    assert got == cw.find_batched(model, [(region, data)], device=dev,
                                  subopt=sub, stream=False)
    # two pairs of one chunk under different masks: each reads its own
    # plane on the cluster, as on K1
    other = SubOpt()
    other.points.add((10, 12))
    other.by_row[12] = {10}
    two = [(region, data)] * 2
    n = counts()
    got = cw.find_batched(model, two, device=dev, subopt=[other, sub])
    assert [a - b for a, b in zip(counts(), n)] == [0, 1, 1, 0, 1, 0]
    assert got[1] != got[0]
    assert got == cw.find_batched(model, two, device=dev,
                                  subopt=[other, sub], stream=False)
    real = cw.cluster_capacity
    monkeypatch.setattr(cw, "cluster_capacity", lambda ki: (real(ki)[0], 0))
    n = counts()
    want = cw.find_path_batched(model, [(region, data)], subopt=sub,
                                device=dev)
    assert [a - b for a, b in zip(counts(), n)] == [0, 0, 1, 1, 0, 0]
    assert [(r.score, r.query_start, r.target_start, r.query_end,
             r.target_end, r.path) for r in p_got] == [
        (r.score, r.query_start, r.target_start, r.query_end,
         r.target_end, r.path) for r in want]
    monkeypatch.setattr(cw, "cluster_capacity", real)
    p2g, whole, p_data = _split_job("PROTEIN2GENOME")
    p_sub = SubOpt()
    p_sub.add_alignment(_to_alignment(p2g, whole, cw.find_path_batched(
        p2g, [(whole, p_data)], device=dev)[0]))
    # one CTA a pair (C = 1): the masked split pair stays on K1, and on
    # the cluster, forced, its ring is in global memory
    n = counts()
    got = cw.find_batched(p2g, [(whole, p_data)], device=dev, subopt=p_sub)
    assert [a - b for a, b in zip(counts(), n)] == [1, 0, 1, 0, 0, 0]
    n = counts()
    assert got == cw.find_batched(p2g, [(whole, p_data)], device=dev,
                                  subopt=p_sub, stream=True)
    assert [a - b for a, b in zip(counts(), n)] == [0, 1, 1, 0, 0, 1]


@pytest.mark.gpu
def test_k2_largest_cluster_admitted(monkeypatch):
    """A pair whose diagonals are wider than MAX_CLUSTER x THREADS cells
    runs on the largest cluster the card admits (16, or the portable 8),
    equal to the plain version and to K1."""
    dev = _need_card()
    used = _clusters(monkeypatch)
    model = est2genome_create()
    cs = sc.calm()
    q = Sequence("q", None, cs + cs)
    data = AlignData(q, Sequence("t", None, cs))
    region = Region(0, 0, len(q), 120)
    inputs, kinds = twf.prepare_inputs(
        model, region, data, pad_to=(twf._bucket(len(q)), 256),
        for_pallas=True)
    ki = cw.to_kernel_inputs(model, inputs, kinds, dev, "region")
    assert len(q) + 1 > cw.MAX_CLUSTER * cw.THREADS
    got = cw.wavefront_stream_scan(ki)
    torch.cuda.synchronize()
    assert used[-1] in (cw.MAX_CLUSTER, cw.PORTABLE_CLUSTER)
    assert torch.equal(got, twf.plain_wavefront(ki)[0])
    assert torch.equal(got, cw.wavefront_scan(ki))


@pytest.mark.gpu
def test_k2_split_codon_full_equals_plain():
    """K9 inside K2 (the FULL instantiation): the protein2genome split
    pair in score and region modes, at C = 1 and 2."""
    dev = _need_card()
    for mode in ("score", "region"):
        _, ki = _split_inputs("PROTEIN2GENOME", mode, dev)
        assert ki.split
        want = twf.plain_wavefront(ki)[0]
        n9 = cw.K9.launches
        for cluster in (1, 2):
            assert torch.equal(cw._launch(ki, cluster)[0], want)
        assert torch.equal(cw.wavefront_stream_scan(ki), want)
        assert cw.K9.launches == n9 + 1


@pytest.mark.gpu
def test_k2_cluster_that_cannot_launch_raises():
    """A cluster size the kernel refuses raises from the launch; nothing
    falls back to K1 or to the plain version, and no launch is counted."""
    dev = _need_card()
    ki = _k2_inputs("region", dev)
    n1, n2 = cw.wavefront_scan.launches, cw.K2.launches
    with pytest.raises(RuntimeError, match="cluster kernel"):
        cw._launch(ki, cw.MAX_CLUSTER + 1)
    assert (cw.wavefront_scan.launches, cw.K2.launches) == (n1, n2)
    # the card is still usable
    assert torch.equal(cw._launch(ki, 2)[0], cw.wavefront_scan(ki))


@pytest.mark.gpu
def test_find_batched_routes_by_the_stream_gate(monkeypatch):
    """find_batched sends a B=1 chunk whose cluster fits the card to K2;
    stream=False forces K1, with the same results.  With no cluster
    resident a batch over STREAM_VMEM_BYTES goes to K2 and one under it
    to K1; stream=True/False force it."""
    dev = _need_card()
    model = est2genome_create()
    calm = _calm()
    jobs = [(Region(0, 0, 300, 400), AlignData(calm, calm))]
    n1, n2 = cw.wavefront_scan.launches, cw.K2.launches
    fits = cw.find_batched(model, jobs, device=dev)
    assert (cw.wavefront_scan.launches, cw.K2.launches) == (n1, n2 + 1)
    low = cw.find_batched(model, jobs, device=dev, stream=False)
    assert (cw.wavefront_scan.launches, cw.K2.launches) == (n1 + 1, n2 + 1)
    assert fits == low
    real = cw.cluster_capacity
    monkeypatch.setattr(cw, "cluster_capacity", lambda ki: (real(ki)[0], 0))
    assert cw.find_batched(model, jobs, device=dev) == low
    assert (cw.wavefront_scan.launches, cw.K2.launches) == (n1 + 2, n2 + 1)
    monkeypatch.setattr(cw, "STREAM_VMEM_BYTES", 0)
    assert cw.find_batched(model, jobs, device=dev) == low
    assert cw.K2.launches == n2 + 2
    assert cw.find_batched(model, jobs, device=dev, stream=False) == low
    assert cw.wavefront_scan.launches == n1 + 3
    assert low == cw.find_batched(model, jobs, device=CPU)


def _cell_pair(traffic, overrides, model, both, tmp_path):
    """The first pair of the benchmark's traffic ``traffic`` (seed 19),
    the target's forward strand whole, as the exhaustive route's first
    scan of it takes it."""
    from portbench.traffic import generate
    inv = generate.make(traffic, 19, str(tmp_path),
                        {"invocations": 1, **overrides}).invocations[0]
    (qid, q), = inv.queries.items()
    (tid, t), = inv.targets.items()
    qs, ts = Sequence(qid, None, q.upper()), Sequence(tid, None, t.upper())
    ts.strand = "+"
    return model, Region(0, 0, len(q), len(t)), AlignData(qs, ts, both)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["e2g.exh_locus", "p2g.exh_locus"])
def test_exhaustive_cells_route_equals_k1_k4(cell, tmp_path, monkeypatch):
    """At each exhaustive cell's shape (calm against a 30 kb window with
    two copies: Qp 2304 x Tp 30208; a 750 aa protein against its 80 kb
    locus: Qp 768 x Tp 92928) the default route runs the B=1 mask-free
    region scan and the path DP over its box on the cluster kernel, and
    gives the DPResults and paths of the forced K1/K4 route."""
    dev = _need_card()
    if cell == "e2g.exh_locus":
        model, region, data = _cell_pair("calm_locus30kb", {},
                                         est2genome_create(), False,
                                         tmp_path)
    else:
        mt = ModelType.PROTEIN2GENOME
        model, region, data = _cell_pair(
            "protein1_locus80kb", {"genome_bp": 80_000},
            get_model(mt, AlphabetType.PROTEIN, AlphabetType.DNA),
            translate_both(mt), tmp_path)
    jobs = [(region, data)]
    n1, n2 = cw.wavefront_scan.launches, cw.K2.launches
    got = cw.find_batched(model, jobs, "region", device=dev)
    assert (cw.wavefront_scan.launches, cw.K2.launches) == (n1, n2 + 1)
    want = cw.find_batched(model, jobs, "region", device=dev, stream=False)
    assert cw.wavefront_scan.launches == n1 + 1
    assert got == want and got[0].score > 0
    r = got[0]
    box = Region(r.query_start, r.target_start, r.query_end - r.query_start,
                 r.target_end - r.target_start)

    def launches():
        # K4's launches, and those of them on the cluster
        return (cw.wavefront_path.launches,
                cw.RING_SMEM.launches + cw.RING_GLOBAL.launches)

    n4, n_ring = launches()
    p_got = cw.find_path_batched(model, [(box, data)], device=dev)
    assert launches() == (n4 + 1, n_ring + 1)
    real = cw.cluster_capacity
    monkeypatch.setattr(cw, "cluster_capacity", lambda ki: (real(ki)[0], 0))
    p_want = cw.find_path_batched(model, [(box, data)], device=dev)
    assert launches() == (n4 + 2, n_ring + 1)

    def key(p):
        return (p.score, p.query_start, p.target_start, p.query_end,
                p.target_end, _names(p.path))

    assert key(p_got[0]) == key(p_want[0])
    assert p_got[0].score == r.score


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["est2genome masked", "protein2genome"])
def test_cluster_segments_equal_plain(kind):
    """The checkpointed traceback's segments on the cluster kernel: score
    mode (K2) over the rings the segment before left, and path mode (K4
    on a cluster) re-run from saved rings, equal the plain version's
    segments: best end cells, and the planes of every cell in the
    span."""
    dev = _need_card()
    if kind == "protein2genome":
        _, ki = _split_inputs("PROTEIN2GENOME", "path", dev)
        assert ki.split
    else:
        ki = _k2_inputs("path", dev, masked=True)
        assert ki.masked
    D = ki.Qp + ki.Tp + 1
    cut = [0, 5, D // 2, D // 2 + 1, D]
    spans = list(zip(cut, cut[1:]))
    fwd = cw.with_mode(ki, "score")
    ring, p_ring = cw.ring_buffers(ki), cw.ring_buffers(ki)
    saved = []
    n2, n4 = cw.K2.launches, cw.wavefront_path.launches
    for span in spans:
        saved.append(tuple(t.clone() for t in ring))
        out, _ = cw.wavefront_segment(fwd, ring, span)
        p_out, _ = twf.plain_wavefront(fwd, span, p_ring)
        assert torch.equal(out, p_out), span
    for span, rings in zip(spans, saved):
        _, tb = cw.wavefront_segment(ki, tuple(t.clone() for t in rings),
                                     span)
        _, p_tb = twf.plain_wavefront(ki, span, rings)
        full = torch.zeros((ki.batch, D, ki.S, ki.Qp + 1), dtype=torch.bool,
                           device=dev)
        full[:, span[0]:span[1]] = True
        valid = _tb_valid(ki, full.to(torch.uint8)) & full
        valid = valid[:, span[0]:span[1]]
        assert torch.equal(tb[valid], p_tb[valid]), span
    assert cw.K2.launches == n2 + len(spans)
    assert cw.wavefront_path.launches == n4 + len(spans)


@pytest.mark.gpu
def test_checkpointed_traceback_on_the_card_equals_k4(monkeypatch):
    """find_path_checkpointed on the card, at a budget of a few host
    chunks in segments of two, gives K4's path for a masked est2genome
    job and the protein2genome split pair."""
    from exonerate_tpu_torch.engine import optimal as topt
    dev = _need_card()
    monkeypatch.setattr(topt, "_segment_bytes", lambda dev, b: 2 * b)
    model = est2genome_create()
    calm = _calm()
    data = AlignData(calm, calm)
    region = Region(0, 0, 600, 500)
    first = cw.find_path_batched(model, [(region, data)], device=dev)[0]
    sub = SubOpt()
    sub.add_alignment(topt._to_alignment(model, region, first))
    cases = [(model, region, data, sub)]
    cases.append(_split_job("PROTEIN2GENOME") + (None,))
    for m, reg, dat, s in cases:
        want = cw.find_path_batched(m, [(reg, dat)], subopt=s,
                                    device=dev)[0]
        D = reg.query_length + reg.target_length + 1
        budget = (twf._bucket(reg.query_length) + 1) * len(m.states) \
            * (D // 4)
        n = cw.walkback.launches
        got = topt.find_path_checkpointed(m, reg, dat, s,
                                          budget_bytes=budget, device=dev)
        # the walk back runs on the card: a segment walk per segment
        assert cw.walkback.launches > n
        assert (got.score, got.query_start, got.target_start,
                got.query_end, got.target_end) == (
            want.score, want.query_start, want.target_start,
            want.query_end, want.target_end)
        assert [t.name for t in got.path] == [t.name for t in want.path]
