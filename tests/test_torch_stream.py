"""The streamed wavefront (kernel K2) in the port, against the JAX package.

The JAX package streams a batch's reversed target vectors from HBM
(``build_pallas_wavefront(..., stream=True)``) when their VMEM footprint
is over ``STREAM_VMEM_BYTES``: a chromosome-scale target at B=1.  The
port routes the same batches, by a copy of the same rule, to K2, the
cluster instantiation of its wavefront kernel; on the CPU the K2 wrapper
runs the plain wavefront, as every wrapper does.  These tests run on
the CPU:

- (a) the JAX package's ``test_streaming_window_parity`` through the
  port's ``find_batched(..., stream=True)``;
- (b) the stream gate against the JAX package's footprint rule, with
  ``n_rev`` read from ``pack_batched_inputs``' wire, on buckets either
  side of 24 MB;
- (c) the SubOpt mask plane written from the mask's points against the
  JAX route's dense grid, packed and padded by ``_pad_inputs``, bit for
  bit, with ``SubOpt.blocked_grid`` never called;
- (d, e) a small ``-E yes`` Waterman-Eggert run with the streaming bar
  lowered in both packages, byte-equal to the JAX CLI on its default CPU
  route and with its Pallas prescan in interpret mode (about 50 s).

Scores, cells and bits are int32 or discrete: the tolerance is 0.
"""
import io
import os

import numpy as np
import pytest
import torch

from exonerate_tpu.engine import optimal as jopt
from exonerate_tpu.engine import pallas_wavefront
from exonerate_tpu.engine import wavefront as jwf
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal as topt
from exonerate_tpu_torch.engine import wavefront as twf
from exonerate_tpu_torch.engine.subopt import SubOpt
from test_torch_subopt import JOBS
from test_torch_subopt_cli import _lower_cutovers, _run_port, _we_argv
from torch_twins import JAX, PORT, dp_key

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")
MB24 = 24 << 20


def _spy(monkeypatch, mod, name):
    """Record the first argument of every call of ``mod.<name>``."""
    calls = []
    real = getattr(mod, name)

    def spy(*args, **kwargs):
        calls.append(args[0] if args else None)
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, name, spy)
    return calls


def test_streaming_window_parity(monkeypatch):
    """(a) The two calm jobs of the JAX package's streaming test: the
    port's forced stream route equals the JAX Pallas kernel with
    stream=True in interpret mode and the XLA engine."""
    def jobs(X):
        calm = next(iter(X.iter_fasta(ALL4)))
        calm.strand = "+"
        data = X.AlignData(calm, calm)
        return (X.est2genome_create(),
                [(X.Region(0, 0, 100, 600), data),
                 (X.Region(30, 5, 90, 580), data)])

    k2 = _spy(monkeypatch, cw, "wavefront_stream_scan")
    k1 = _spy(monkeypatch, cw, "wavefront_scan")
    model, pjobs = jobs(PORT)
    jmodel, jjobs = jobs(JAX)
    got = cw.find_batched(model, pjobs, "region", device=CPU, stream=True)
    assert len(k2) == 1 and not k1
    ref = jwf.find_region_batched(jmodel, jjobs)
    want = pallas_wavefront.find_batched(jmodel, jjobs, "region",
                                         interpret=True, stream=True)
    assert [dp_key(r) for r in want] == [dp_key(r) for r in ref]
    assert [dp_key(r) for r in got] == [dp_key(r) for r in want]
    # stream=False takes K1 with the same result
    assert cw.find_batched(model, pjobs, "region", device=CPU,
                           stream=False) == got
    assert len(k1) == 1


def _gate_jobs(X, name):
    """A small job of each model the gate is held on, from namespace X."""
    calm = next(iter(X.iter_fasta(ALL4)))
    calm.strand = "+"
    if name == "est2genome":
        return (X.est2genome_create(), X.Region(0, 0, 60, 90),
                X.AlignData(calm, calm))
    if name == "affine_local":
        return JOBS["affine_local_protein"](X)
    return JOBS["protein2genome_split"](X)


def _pads(region):
    return twf._bucket(region.query_length), twf._bucket(region.target_length)


def _jax_streams(jmodel, jregion, jdata, B: int, Qp: int, Tp: int) -> bool:
    """The JAX package's rule (``find_batched``, ``:1437-1443``) for a
    chunk of ``B`` jobs, padded by its ``_chunk_pow2``: n_rev from the
    wire of ``pack_batched_inputs`` over the padded chunk of one pair
    (small, as n_rev does not depend on the shape)."""
    pads = _pads(jregion)
    per, kinds = jwf.prepare_inputs(jmodel, jregion, jdata, pad_to=pads,
                                    for_pallas=True)
    [(_chunk, per_pair)] = pallas_wavefront._chunk_pow2(
        [(n, per) for n in range(B)], 1 << 20)
    _, meta = pallas_wavefront.pack_batched_inputs(jmodel, per_pair, kinds,
                                                   *pads)
    n_rev = sum(1 for _n, (_enc, rev) in meta["wire"] if rev)
    vlen = 2 * pallas_wavefront._qv(Qp) + 128 + Tp + 1 + 264
    return (n_rev * len(per_pair) * vlen * 4
            > pallas_wavefront.STREAM_VMEM_BYTES)


@pytest.mark.parametrize("name", ["est2genome", "affine_local",
                                  "protein2genome"])
def test_stream_gate_follows_the_jax_rule(name):
    """(b) On the bucket rungs either side of the 24 MB cut (at B of 1, a
    padded 3 and 4), the port's gate decides as the JAX package's rule;
    the port's target-vector rows are the JAX package's reversed wire
    arrays."""
    assert cw.STREAM_VMEM_BYTES == pallas_wavefront.STREAM_VMEM_BYTES == MB24
    model, region, data = _gate_jobs(PORT, name)
    jmodel, jregion, jdata = _gate_jobs(JAX, name)
    inputs, kinds = twf.prepare_inputs(model, region, data,
                                       pad_to=_pads(region), for_pallas=True)
    ki = cw.to_kernel_inputs(model, inputs, kinds, CPU, "region")
    per, jkinds = jwf.prepare_inputs(jmodel, jregion, jdata,
                                     pad_to=_pads(jregion), for_pallas=True)
    _, meta = pallas_wavefront.pack_batched_inputs(jmodel, [per], jkinds,
                                                   *_pads(jregion))
    n_rev = sum(1 for _n, (_enc, rev) in meta["wire"] if rev)
    assert cw.n_rev(kinds) == n_rev == ki.tvecs.shape[1] >= 1
    sides = 0
    for B in (1, 3, 4):
        Bp = 1 << (B - 1).bit_length()
        for Qp in (256, 2304):
            per_rev = (2 * cw._qv(Qp) + 128 + 1 + 264) * 4 * n_rev * Bp
            # the rungs just below and just above the cut
            cut = (MB24 - per_rev) // (4 * n_rev * Bp)
            below = max(r for r in twf._LADDER if r <= cut)
            above = min(r for r in twf._LADDER if r > cut)
            for Tp in (below, above):
                want = _jax_streams(jmodel, jregion, jdata, B, Qp, Tp)
                assert cw.streams(kinds, B, Qp, Tp) == want, (B, Qp, Tp)
                sides += want
    assert sides == 6          # one rung of each pair streams


ZOO = ("AFFINE_GLOBAL", "AFFINE_BESTFIT", "AFFINE_OVERLAP", "NER",
       "CODING2CODING", "PROTEIN2DNA", "CODING2GENOME", "CDNA2GENOME")


@pytest.mark.parametrize("mtname", ZOO)
def test_n_rev_is_the_jax_wire_count_across_the_zoo(mtname):
    """Every other model the kernels serve: the gate's n_rev (from the
    kinds) is the count of reversed arrays on the JAX package's wire and
    the port's target-vector rows."""
    def job(X):
        calm = next(iter(X.iter_fasta(ALL4)))
        calm.strand = "+"
        q, t = calm.subseq(0, 90), calm.subseq(20, 140)
        if mtname == "PROTEIN2DNA":
            q = X.Sequence("p", None, "MADQLTEEQIAEFKEAFSLFDKDGDG")
        mt = X.ModelType[mtname]
        model = X.get_model(mt, q.alphabet.type, t.alphabet.type)
        return (model, X.Region(0, 0, len(q), len(t)),
                X.AlignData(q, t, X.translate_both(mt)))

    model, region, data = job(PORT)
    jmodel, jregion, jdata = job(JAX)
    inputs, kinds = twf.prepare_inputs(model, region, data,
                                       pad_to=_pads(region), for_pallas=True)
    per, jkinds = jwf.prepare_inputs(jmodel, jregion, jdata,
                                     pad_to=_pads(jregion), for_pallas=True)
    _, meta = pallas_wavefront.pack_batched_inputs(jmodel, [per], jkinds,
                                                   *_pads(jregion))
    n_rev = sum(1 for _n, (_enc, rev) in meta["wire"] if rev)
    assert cw.n_rev(kinds) == n_rev
    ki = cw.to_kernel_inputs(model, inputs, kinds, CPU, "region")
    assert ki.tvecs.shape[1] == max(n_rev, 1)


def _we_masks():
    """The SubOpt masks of test_torch_subopt's three Waterman-Eggert
    re-runs (est2genome, affine:local, protein2genome), after each of up
    to three alignments, on the port's plain K4."""
    out = []
    for name in sorted(JOBS):
        model, region, data = JOBS[name](PORT)
        sub = SubOpt()
        for _ in range(3):
            path = cw.find_path_batched(model, [(region, data)], subopt=sub,
                                        device=CPU)[0]
            alignment = topt._to_alignment(model, region, path)
            if alignment is None or not alignment.ops:
                break
            sub.add_alignment(alignment)
            pts = SubOpt()
            pts.points = set(sub.points)
            out.append((name, model, region, data, pts))
    return out


def test_mask_plane_from_points_equals_the_dense_route(monkeypatch):
    """(c) Over the masks of the three re-runs and a sub-region of each,
    padded to the bucket, padded by a few cells and unpadded, the plane
    written from the points equals np.packbits of the dense
    grid padded as the JAX package's _pad_inputs pads it, bit for bit;
    the port's route never builds the dense grid."""
    masks = _we_masks()
    assert len(masks) >= 6
    dense = []
    for _name, model, region, data, sub in masks:
        boxes = [region, PORT.Region(region.query_start + 3,
                                     region.target_start + 7,
                                     region.query_length - 3,
                                     region.target_length - 11)]
        for box in boxes:
            grid = sub.blocked_grid(box)
            for pads in ((twf._bucket(box.query_length),
                          twf._bucket(box.target_length)),
                         (box.query_length + 5, box.target_length + 7),
                         (box.query_length, box.target_length)):
                want = (jwf._pad_inputs(
                    {"_blocked": np.packbits(grid, axis=1)},
                    {"_blocked": "blocked"}, box.query_length,
                    box.target_length, *pads)["_blocked"]
                    if grid.any() else None)
                dense.append((model, box, data, sub, pads, want))
    assert sum(w is not None for *_, w in dense) >= 12

    def refuse(*_a, **_k):
        raise AssertionError("blocked_grid called on the port's route")

    monkeypatch.setattr(SubOpt, "blocked_grid", refuse)
    for model, box, data, sub, pads, want in dense:
        got = twf.blocked_plane(sub, box, *pads)
        if want is None:
            assert got is None
            continue
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)
        inputs, kinds = twf.prepare_inputs(model, box, data, subopt=sub,
                                           pad_to=pads, for_pallas=True)
        assert ("_blocked", "blocked") in kinds
        assert np.array_equal(inputs["_blocked"], want)
    # a batch's K1 inputs carry the plane as built
    model, box, data, sub, pads, want = next(x for x in dense
                                             if x[-1] is not None)
    inputs, kinds = twf.prepare_inputs(model, box, data, subopt=sub,
                                       pad_to=pads, for_pallas=True)
    ki = cw.to_kernel_inputs(model, [inputs, inputs], kinds, CPU, "region")
    assert np.array_equal(ki.blocked[1].numpy(), want)


def _lower_stream_bar(monkeypatch):
    """Every batch streams in both packages: the whole pair, the copies'
    boxes and the masked re-runs."""
    monkeypatch.setattr(cw, "STREAM_VMEM_BYTES", 0)
    monkeypatch.setattr(pallas_wavefront, "STREAM_VMEM_BYTES", 0)


def _run_port_streamed(argv, monkeypatch):
    """The port's CLI run of test_torch_subopt_cli with every region scan
    on the K2 wrapper (its plain version on the CPU), masked ones too."""
    k2 = _spy(monkeypatch, cw, "wavefront_stream_scan")
    k1 = _spy(monkeypatch, cw, "wavefront_scan")
    out = _run_port(argv, monkeypatch)
    assert k2 and not k1
    assert any(ki.masked for ki in k2) and any(not ki.masked for ki in k2)
    return out


def test_streamed_exhaustive_route_matches_jax_cli(monkeypatch, tmp_path):
    """(d) A small -E yes Waterman-Eggert run with the streaming bar and
    the native cut-overs lowered: every region scan, masked re-runs
    included, takes the K2 route, and the JAX CLI's default CPU route
    prints the same bytes."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    argv = _we_argv(tmp_path)
    _lower_cutovers(monkeypatch)
    _lower_stream_bar(monkeypatch)
    got = _run_port_streamed(argv, monkeypatch)
    want = io.StringIO()
    assert jax_main(list(argv), out=want) == 0
    assert got == want.getvalue()


def test_streamed_exhaustive_route_matches_jax_pallas_stream(monkeypatch,
                                                             tmp_path):
    """(e) The same run against the JAX CLI with its Pallas prescan
    forced in interpret mode: its region scans build the streamed kernel
    (stream=True), the TPU's K2 route."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    argv = _we_argv(tmp_path)
    _lower_cutovers(monkeypatch)
    _lower_stream_bar(monkeypatch)
    got = _run_port_streamed(argv, monkeypatch)
    monkeypatch.setattr(jopt, "_FORCE_PRESCAN", True)
    monkeypatch.setattr(jopt, "_PRESCAN_INTERPRET", True)
    builds = []
    real = pallas_wavefront.build_pallas_wavefront

    def spy(*args, **kwargs):
        builds.append((args[3], kwargs.get("stream")))
        return real(*args, **kwargs)

    monkeypatch.setattr(pallas_wavefront, "build_pallas_wavefront", spy)
    pallas_wavefront._CACHE.clear()
    want = io.StringIO()
    assert jax_main(list(argv), out=want) == 0
    assert got == want.getvalue()
    assert any(mode == "region" and stream for mode, stream in builds)
    assert all(stream for mode, stream in builds if mode != "path")


def test_exhaustive_loop_ends_before_a_sub_threshold_path_dp(monkeypatch,
                                                             tmp_path):
    """The -E yes enumeration hands its score threshold to find_path, so
    the iteration whose region scan scores under --score returns None
    before any path DP of its box: against a chromosome-scale target
    that box is a chain of short exons across the whole target, whose
    path DP is a checkpointed traceback across it.  The bytes are the
    JAX CLI's (test d)."""
    argv = _we_argv(tmp_path)
    _lower_cutovers(monkeypatch)
    calls = []
    real = topt.find_path

    def spy(model, region, data, subopt=None, threshold=None, device=None):
        res = real(model, region, data, subopt, threshold=threshold,
                   device=device)
        calls.append((region.query_start, region.target_start,
                      region.query_length, region.target_length,
                      threshold, res))
        return res

    monkeypatch.setattr(topt, "find_path", spy)
    out = _run_port(argv, monkeypatch)
    whole = [c for c in calls if c[:2] == (0, 0) and c[2] == 180]
    # both strands: two alignments on the forward one, then one scan
    # under the threshold on each strand (--score 500, raised by --bestn
    # once two alignments are kept)
    assert all(c[4] is not None and c[4] >= 500 for c in whole)
    assert [c[5] is None for c in whole].count(True) == 2
    assert sum(c[5] is not None for c in whole) == 2
    assert out.count("vulgar:") == 2
