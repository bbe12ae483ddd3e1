"""Optimal: the find-path facade of the port.

Counterpart of ``exonerate_tpu/engine/optimal.py`` (ref:
src/c4/optimal.{h,c}): reduced-space FIND_REGION over the full rectangle,
then a traceback DP restricted to the discovered alignment's box.  The
thresholds are the JAX package's.  Routing is by cell count alone, on
whatever device the caller passes: a mask-free DP over
``NATIVE_TPU_CELLS`` cells whose model the kernels serve runs the region
scan on K1 and the path on K4 + walk-back (``cuda_wavefront``), so the
CPU tests walk the same route as the card; everything else runs on the
shared host engines (the dense C++ Viterbi, or the NumPy oracle for
small regions).  SubOpt-masked jobs stay on the host until K3 is ported.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from exonerate_tpu import observe
from exonerate_tpu.align.alignment import Alignment
from exonerate_tpu.engine import reference
from exonerate_tpu.engine.reference import DPResult
from exonerate_tpu.engine.region import Region
from exonerate_tpu.model.ir import Model

from . import cuda_wavefront

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
    from exonerate_tpu.engine import sdp_native
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
    kernels = cells > NATIVE_TPU_CELLS and not masked \
        and _kernels_run(model)
    if cells <= NATIVE_TPU_CELLS \
            or (not kernels and cells <= NATIVE_DIRECT_CELLS):
        if tb_bytes <= _native_tb_budget():
            res = _native_res(model, region, data, "path", subopt)
            if res is not None:
                return _thresholded(model, region, res, threshold)
    if _is_small(region):
        observe.count_engine("oracle")
        res = reference.viterbi(model, region, data, "path", subopt)
        return _to_alignment(model, region, res)
    if kernels:
        # reduced-space FIND_REGION on K1, then the traceback DP only on
        # the discovered alignment's bounding box
        scan = cuda_wavefront.find_batched(model, [(region, data)],
                                           "region", device=device)[0]
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
        res = cuda_wavefront.find_path_batched(
            model, [(region, data)], device=device)[0]
        if res is not None:
            return _thresholded(model, region, res, threshold)
    if tb_bytes <= _native_tb_budget():
        res = _native_res(model, region, data, "path", subopt)
        if res is not None:
            return _thresholded(model, region, res, threshold)
    raise NotImplementedError(
        f"exonerate_tpu_torch: a {region.query_length}x"
        f"{region.target_length} path DP for {model.name} needs the "
        f"checkpointed traceback (find_path_checkpointed), which is not "
        f"ported yet")


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
