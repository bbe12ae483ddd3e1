"""Optimal: the find-path facade of the port.

Counterpart of ``exonerate_tpu/engine/optimal.py`` (ref:
src/c4/optimal.{h,c}): reduced-space FIND_REGION over the full rectangle,
then a traceback DP restricted to the discovered alignment's box.  The
thresholds and the control flow are the JAX package's with its Pallas
prescan always on: the port's kernels are the prescan on any device, so
the CPU tests walk the same route as the card.  Routing is by cell count
and mask alone, on whatever device the caller passes:

- the native dense C++ Viterbi first for a DP of at most
  ``NATIVE_TPU_CELLS`` cells, or of at most ``NATIVE_DIRECT_CELLS``
  under a SubOpt mask (a Waterman-Eggert re-run), when its traceback
  plane fits ``_native_tb_budget()``;
- then, for a model the kernels serve, the region scan on K1 and the
  path on K4 + walk-back (``cuda_wavefront``), each with the SubOpt mask
  plane (kernel K3) when the job is masked;
- then the native DP within its budget; past it the checkpointed
  traceback (``find_path_checkpointed``) on the cluster kernel, as the
  JAX package runs its XLA one: a forward pass over diagonal segments
  saving the carry rings, then a walk back that re-runs in path mode
  only the segments the path crosses, one segment's traceback planes
  at a time.

A model the kernels refuse (``cuda_wavefront.unsupported_reason``:
genome2genome's query-side and joint split codons) skips the kernels'
region scan and, past the native budget, runs on the generic wavefront
(``generic_wavefront``, the JAX package's XLA engine as torch ops on the
same device): ``find_path`` while the traceback cube is within
``DP_MEMORY_LIMIT``, its checkpointed route above it.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from .. import observe
from ..align.alignment import Alignment
from . import reference
from .reference import DPResult
from .region import Region
from ..model.ir import Model

from . import cuda_wavefront
from . import generic_wavefront as gw
from . import wavefront as wf

# below this many cells the interpreter path is cheaper than a kernel
SMALL_DP_CELLS = 40_000

# --dpmemory budget for full-traceback planes (ref: viterbi.c:32-33)
DP_MEMORY_LIMIT = 32 << 20

# native dense-DP traceback plane budget (bytes); --dpmemory raises it
NATIVE_TB_BUDGET = 256 << 20

# up to this many cells the native dense DP runs jobs the kernels cannot
NATIVE_DIRECT_CELLS = int(os.environ.get(
    "EXONERATE_TPU_NATIVE_CELLS", 16_000_000))

# above this many cells a mask-free job runs on the wavefront kernels
NATIVE_TPU_CELLS = int(os.environ.get(
    "EXONERATE_TPU_NATIVE_CELLS_TPU", 1_000_000))


def _native_tb_budget() -> int:
    return max(NATIVE_TB_BUDGET, DP_MEMORY_LIMIT)


def _native_res(model: Model, region: Region, data, mode, subopt):
    """Dense C++ Viterbi (native/sdplib.cpp), or None to fall back."""
    if os.environ.get("EXONERATE_TPU_SDP") == "python":
        return None
    from . import sdp_native
    try:
        res = sdp_native.run_viterbi(model, region, data, mode, subopt)
        if res is not None:
            observe.count_engine("native")
        return res
    except AssertionError:
        raise
    except Exception as exc:
        observe.count_fallback(
            f"native->device: {type(exc).__name__} in dense Viterbi")
        return None


def _cells(region: Region) -> int:
    return (region.query_length + 1) * (region.target_length + 1)


def _prefer_native(region: Region, masked: bool = False) -> bool:
    """(``exonerate_tpu/engine/optimal.py:73-87`` with the prescan on)."""
    cells = _cells(region)
    if cells <= NATIVE_TPU_CELLS:
        return True
    return masked and cells <= NATIVE_DIRECT_CELLS


def _kernels_run(model: Model) -> bool:
    reason = cuda_wavefront.unsupported_reason(model)
    if reason is not None:
        observe.count_fallback(f"wavefront->native: {reason}")
    return reason is None


def find_path(model: Model, region: Region, data, subopt=None,
              threshold: Optional[int] = None,
              device: Optional[torch.device] = None
              ) -> Optional[Alignment]:
    """(ref: Optimal_find_path, optimal.c): region scan then path DP."""
    masked = subopt is not None and bool(subopt.points)
    cells = _cells(region)
    tb_bytes = cells * len(model.states) * 2
    if _prefer_native(region, masked) and tb_bytes <= _native_tb_budget():
        res = _native_res(model, region, data, "path", subopt)
        if res is not None:
            return _thresholded(model, region, res, threshold)
    if _is_small(region):
        observe.count_engine("oracle")
        res = reference.viterbi(model, region, data, "path", subopt)
        return _to_alignment(model, region, res)
    if cells > NATIVE_TPU_CELLS and _kernels_run(model):
        # reduced-space FIND_REGION on K1, then the traceback DP only on
        # the discovered alignment's bounding box.  The SubOpt mask rides
        # along as a plane (K3): without it the scan would keep finding
        # the masked best alignment's box and miss the next best
        with observe.span("exh.scan"):
            scan = cuda_wavefront.find_batched(model, [(region, data)],
                                               "region", device=device,
                                               subopt=subopt)[0]
        if threshold is not None and scan.score < threshold:
            return None
        sub = Region(region.query_start + scan.query_start,
                     region.target_start + scan.target_start,
                     scan.query_end - scan.query_start,
                     scan.target_end - scan.target_start)
        if (sub.query_length < region.query_length
                or sub.target_length < region.target_length):
            return find_path(model, sub, data, subopt,
                             threshold=threshold, device=device)
        # traceback DP on K4 with the walk-back on the card; None when
        # the cube is over budget or the path over the walk cap
        with observe.span("exh.path"):
            res = cuda_wavefront.find_path_batched(
                model, [(region, data)], subopt=subopt, device=device)[0]
        if res is not None:
            return _thresholded(model, region, res, threshold)
    if tb_bytes <= _native_tb_budget():
        res = _native_res(model, region, data, "path", subopt)
        if res is not None:
            return _thresholded(model, region, res, threshold)
    D = region.query_length + region.target_length + 1
    cube = D * (region.query_length + 1) * len(model.states)
    if cube > DP_MEMORY_LIMIT:
        observe.note(2, f"path DP checkpointed: tb cube {cube >> 20} MB "
                        f"over --dpmemory {DP_MEMORY_LIMIT >> 20} MB")
    if cuda_wavefront.unsupported_reason(model) is not None:
        # the generic engine, as the JAX package runs its XLA one: the
        # whole cube within --dpmemory, checkpointed above it
        dev = device if device is not None else cuda_wavefront.default_device()
        observe.count_engine(gw.engine_name(dev))
        if cube > DP_MEMORY_LIMIT:
            res = gw.find_path_checkpointed(model, region, data, subopt,
                                            budget_bytes=DP_MEMORY_LIMIT,
                                            device=dev)
        else:
            res = gw.find_path(model, region, data, subopt, device=dev)
        return _thresholded(model, region, res, threshold)
    with observe.span("exh.path"):
        res = find_path_checkpointed(model, region, data, subopt,
                                     budget_bytes=DP_MEMORY_LIMIT,
                                     device=device)
    return _thresholded(model, region, res, threshold)


def _better(a: list, b: list) -> bool:
    """End cell ``a`` = (score, i, j) beats ``b``: score desc, j asc, i asc
    (the kernels' key)."""
    return a[0] > b[0] or (a[0] == b[0] and (a[2] < b[2]
                                             or (a[2] == b[2] and a[1] < b[1])))


def _segment_bytes(dev: torch.device, budget_bytes: int) -> int:
    """Traceback planes per segment of the checkpointed traceback: on a
    card the budget of K4's cube, so that a path across a
    chromosome-scale target takes a few launches, not hundreds; on the
    host ``--dpmemory``'s."""
    return (cuda_wavefront.PATH_TB_BYTES if dev.type == "cuda"
            else budget_bytes)


def find_path_checkpointed(model: Model, region: Region, data, subopt=None,
                           budget_bytes: int = DP_MEMORY_LIMIT,
                           device: Optional[torch.device] = None
                           ) -> DPResult:
    """Full-path DP under a traceback-memory budget
    (``exonerate_tpu/engine/wavefront.py:700``; ref: viterbi.c:128-152,
    537-633, Hughey checkpointing), on the cluster kernel.

    A forward pass over segments of traceback planes (K2, score mode)
    saves the carry rings before each segment; the walk back from the
    best end cell re-runs, from its saved rings, only the segments the
    path crosses, in path mode (K4 on a cluster), and walks each one's
    planes where they lie (``cuda_wavefront.walk_segment``: the walk-back
    kernel on a card); a segment holds ``_segment_bytes`` of planes, a
    multiple of ``budget_bytes``' diagonals.  The path is the full
    cube's: the same cells and the same first-max choices."""
    dev = device if device is not None else cuda_wavefront.default_device()
    Q, T = region.query_length, region.target_length
    D = Q + T + 1
    Qp, Tp = wf._bucket(Q), wf._bucket(T)
    inputs, kinds = wf.prepare_inputs(model, region, data, subopt=subopt,
                                      pad_to=(Qp, Tp), for_pallas=True)
    ki = cuda_wavefront.to_kernel_inputs(model, inputs, kinds, dev, "path")
    per_diag = (Qp + 1) * ki.S
    chunk = max(16, min(D, budget_bytes // per_diag))
    seg = max(chunk, min(D, _segment_bytes(dev, budget_bytes) // per_diag)
              // chunk * chunk)
    spans = [(d0, min(d0 + seg, D)) for d0 in range(0, D, seg)]
    observe.count_engine(cuda_wavefront.engine_name(dev))

    # forward: the carry rings before each segment, and each one's best
    fwd = cuda_wavefront.with_mode(ki, "score")
    ring = cuda_wavefront.ring_buffers(ki)
    saved, bests = [], []
    for span in spans:
        saved.append(tuple(t.clone() for t in ring))
        out, _ = cuda_wavefront.wavefront_segment(fwd, ring, span)
        bests.append(out[:3, 0])
    best = [cuda_wavefront.NEG, 0, 0]
    for cand in torch.stack(bests).tolist():
        if _better(cand, best):
            best = cand
    score, bi, bj = best
    if score <= cuda_wavefront.NEG:
        res = DPResult(score=cuda_wavefront.NEG, query_end=0, target_end=0,
                       query_start=0, target_start=0)
        res.path = []
        return res

    # walk back (ref: Viterbi_Data_create_Alignment, viterbi.c:342-392):
    # each segment the path crosses, from the last, re-run in path mode
    # from its saved rings and walked on the planes' device from the
    # cell and state the segment after it left; only that exit comes to
    # the host per segment, the ops once at the end
    plan_ts = cuda_wavefront._plan_transitions(model)
    cell = torch.tensor([[bi], [bj], [ki.end_id]], dtype=torch.int32,
                        device=dev)
    k = (bi + bj) // seg
    parts = []
    while True:
        ring = tuple(t.clone() for t in saved[k])
        _, planes = cuda_wavefront.wavefront_segment(ki, ring, spans[k])
        cap = spans[k][1] - spans[k][0] + cuda_wavefront.WALK_SLACK
        while True:
            ops, res = cuda_wavefront.walk_segment(planes, spans[k][0], cell,
                                                   ki.walk, cap)
            n, i, j, _state, status = res[:, 0].tolist()
            parts.append(ops[0, :n])
            cell = res[1:4].clone()
            if status != wf.WALK_CAP:
                break
        del planes
        if status == wf.WALK_BAD:
            raise RuntimeError(f"checkpointed traceback: not a plan id at "
                               f"({i}, {j})")
        if status != wf.WALK_LEFT:
            break
        k = (i + j) // seg
    ops = torch.cat(parts).tolist()
    res = DPResult(score=score, query_end=bi, target_end=bj,
                   query_start=i, target_start=j)
    res.path = [plan_ts[tid - 1] for tid in reversed(ops)]
    return res


def _thresholded(model: Model, region: Region, res: DPResult,
                 threshold: Optional[int]) -> Optional[Alignment]:
    if threshold is not None and res.score < threshold:
        return None
    return _to_alignment(model, region, res)


def _is_small(region: Region) -> bool:
    return _cells(region) <= SMALL_DP_CELLS


def _to_alignment(model: Model, region: Region,
                  res: DPResult) -> Optional[Alignment]:
    if res.path is None:
        return None
    al_region = Region(region.query_start + res.query_start,
                       region.target_start + res.target_start,
                       res.query_end - res.query_start,
                       res.target_end - res.target_start)
    return Alignment.from_path(model, al_region, res.score, res.path)
