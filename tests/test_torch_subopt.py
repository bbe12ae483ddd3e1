"""The SubOpt mask (kernel K3) in the port, against the JAX package.

A Waterman-Eggert re-run bars match transitions into the cells of the
alignments already found.  The port ships the mask as packed bits by
destination cell (``KernelInputs.blocked``) and its plain wavefront
drops a match row at a blocked cell; on the card the masked
instantiation of K1/K4 does the same.  These tests run on the CPU:

- three Waterman-Eggert iterations of est2genome on a 150 x 200 calm
  region (``test_pallas_blocked_mask_parity`` of the JAX package), an
  affine:local protein pair and a protein2genome pair whose best path
  crosses split codons of both phases: the port's plain region and path
  DPs equal the JAX package's XLA engine exactly at every iteration (a
  slow case adds its Pallas kernel in interpret mode);
- the mask plane's layout, and batches that mix masked and mask-free
  jobs.

The CLI routes are in ``test_torch_subopt_cli.py`` and
``test_torch_locus.py``.

Scores, cells and tracebacks are int32 or discrete: the tolerance is 0.
"""
import os

import numpy as np
import pytest
import torch

from exonerate_tpu.engine import optimal as jopt
from exonerate_tpu.engine import pallas_wavefront
from exonerate_tpu.engine import wavefront as jwf
from exonerate_tpu.engine.subopt import SubOpt as JSubOpt
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal as topt
from exonerate_tpu_torch.engine import wavefront as twf
from exonerate_tpu_torch.engine.subopt import SubOpt
from torch_twins import JAX, PORT, dp_key, split_job, split_phases

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")


def _calm_job(X):
    calm = next(iter(X.iter_fasta(ALL4)))
    calm.strand = "+"
    return (X.est2genome_create(), X.Region(0, 0, 150, 200),
            X.AlignData(calm, calm))


def _affine_job(X):
    a = X.Sequence("a", None, "MKVLAAGICAGWLLWKKMKVL" * 3)
    b = X.Sequence("b", None, "MKVLGAGICAWWLLAKKMK" * 3)
    model = X.affine_create(X.AffineModelType.LOCAL, X.AlphabetType.PROTEIN,
                            X.AlphabetType.PROTEIN)
    return model, X.Region(0, 0, len(a), len(b)), X.AlignData(a, b)


JOBS = {"est2genome_calm": _calm_job, "affine_local_protein": _affine_job,
        "protein2genome_split": lambda X: split_job(X, "PROTEIN2GENOME")}


def _we_loop(name: str, interpret: bool):
    """Three Waterman-Eggert iterations, the port's plain K1/K4 against
    the XLA engine (and the Pallas kernel in interpret mode when asked);
    returns the port's paths."""
    model, region, data = JOBS[name](PORT)
    jmodel, jregion, jdata = JOBS[name](JAX)
    sub, jsub = SubOpt(), JSubOpt()
    paths = []
    observe.reset()
    runs = 0
    for it in range(3):
        if it:
            _, kinds = twf.prepare_inputs(model, region, data, subopt=sub)
            assert ("_blocked", "blocked") in kinds
        got = cw.find_batched(model, [(region, data)], "region",
                              device=CPU, subopt=sub)[0]
        want = jwf.find_region(jmodel, jregion, jdata, jsub)
        assert dp_key(got)[:5] == dp_key(want)[:5], f"iteration {it}"
        path = cw.find_path_batched(model, [(region, data)], subopt=sub,
                                    device=CPU)[0]
        runs += 2
        ref = jwf.find_path(jmodel, jregion, jdata, jsub)
        assert dp_key(path) == dp_key(ref), f"iteration {it}"
        if interpret:
            assert dp_key(got)[:5] == dp_key(pallas_wavefront.find_batched(
                jmodel, [(jregion, jdata)], "region", subopt=jsub,
                interpret=True)[0])[:5], f"iteration {it}"
            assert dp_key(path) == dp_key(pallas_wavefront.find_path_batched(
                jmodel, [(jregion, jdata)], subopt=jsub,
                interpret=True)[0]), f"iteration {it}"
        alignment = topt._to_alignment(model, region, path)
        if alignment is None or not alignment.ops:
            break
        paths.append(path)
        sub.add_alignment(alignment)
        jsub.add_alignment(jopt._to_alignment(jmodel, jregion, ref))
    assert observe.engine_counts["torch-wavefront"] == runs
    assert not observe.fallback_counts
    return paths


@pytest.mark.parametrize("name", sorted(JOBS))
def test_blocked_mask_parity(name):
    paths = _we_loop(name, interpret=False)
    assert len(paths) >= 2
    # the re-runs find other alignments than the first
    assert len({dp_key(p)[:5] for p in paths}) == len(paths)
    if name == "protein2genome_split":
        assert split_phases(paths[0].path) == {1, 2}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(JOBS))
def test_blocked_mask_parity_pallas_interpret(name):
    _we_loop(name, interpret=True)


def test_mask_plane_layout(monkeypatch):
    """The plane is (B, Qp+1, ceil((Tp+1)/8)) uint8 in np.packbits order
    by destination cell, empty for a mask-free batch; the plan flags the
    match rows."""
    model, region, data = _calm_job(PORT)
    sub = SubOpt()
    path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
    sub.add_alignment(topt._to_alignment(model, region, path))
    inputs, kinds = twf.prepare_inputs(model, region, data, subopt=sub,
                                       pad_to=(256, 256), for_pallas=True)
    ki = cw.to_kernel_inputs(model, [inputs, inputs], kinds, CPU, "region")
    assert ki.masked and ki.blocked.dtype == torch.uint8
    assert tuple(ki.blocked.shape) == (2, 257, 33)
    bits = np.unpackbits(ki.blocked[0].numpy(), axis=1)[:, :257]
    grid = np.zeros((257, 257), bool)
    for q, t in sub.points:
        if q <= region.query_length and t <= region.target_length:
            grid[q, t] = True
    assert np.array_equal(bits.astype(bool), grid)
    match = [p["is_match"] for p in cw._build_plan(model)]
    assert [bool(r[twf.P_FLAGS] & twf.F_MATCH)
            for r in ki.plan.tolist()] == match and any(match)
    inputs, kinds = twf.prepare_inputs(model, region, data,
                                       pad_to=(256, 256), for_pallas=True)
    free = cw.to_kernel_inputs(model, inputs, kinds, CPU, "region")
    assert not free.masked and free.blocked.numel() == 0
    # a mask that blocks no cell of a job's region leaves it mask-free
    far = PORT.Region(160, 0, 10, 10)
    assert not cw.to_kernel_inputs(model, *twf.prepare_inputs(
        model, far, data, subopt=sub, pad_to=(256, 256), for_pallas=True),
        CPU, "region").masked
    # the plane counts against the path budget: a budget of exactly one
    # traceback cube holds one mask-free pair and no masked one
    cube = (256 + 256 + 1) * len(model.states) * 257
    monkeypatch.setattr(cw, "PATH_TB_BYTES", cube)
    assert cw.max_batch(model, 256, 256, "path") == 1
    assert cw.max_batch(model, 256, 256, "path", True) == 0


def test_mixed_batch_buckets_masked_and_free():
    """A per-job list of masks: masked and mask-free jobs bucket apart and
    each equals its own lone run."""
    model, _, data = _calm_job(PORT)
    region = PORT.Region(0, 0, 60, 80)
    sub = SubOpt()
    path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
    sub.add_alignment(topt._to_alignment(model, region, path))
    jobs = [(region, data), (PORT.Region(10, 5, 50, 70), data),
            (region, data)]
    subs = [sub, None, SubOpt()]
    observe.reset()
    got = cw.find_batched(model, jobs, "region", device=CPU, subopt=subs)
    assert observe.engine_counts["torch-wavefront"] == 3
    assert not observe.fallback_counts
    for job, s, g in zip(jobs, subs, got):
        assert g == cw.find_batched(model, [job], "region", device=CPU,
                                    subopt=s)[0]
    assert got[0].score < got[2].score
