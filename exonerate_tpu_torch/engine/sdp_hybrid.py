"""Hybrid SDP executor: band-kernel scores + lazy host band re-runs.

Counterpart of ``exonerate_tpu/engine/sdp_hybrid.py``, which imports the
JAX band scan.  Per comparison, the band kernels K6/K7
(``cuda_sdp.run_kernel``; their plain PyTorch versions on the CPU)
compute every locus's best end score; the next_path stream then resolves
only the loci that can report by re-running the host native scheduler on
that locus's target window, and cross-checks each device score against
it.  Any disagreement, or an edge-liveness / cross-locus flag, raises
``HybridFallback`` and the caller redoes the comparison on the host
global path, so the output bytes never depend on the device.

Routing is the JAX package's: the same size gates (``DEVICE_MIN_*``),
and ``EXONERATE_TPU_SDP=device`` forces the device tier.  On the CPU the
forced tier runs the plain scan under ``SCAN_DIAG_CAP``, as the JAX
package's XLA scan does.  The non-boundary models (ungapped, affine,
protein2dna, coding2coding) run on the forced tier too, on K6/K7's
``TRACK_SID`` instantiation (the JAX package's XLA scan with
``track_sid``); by default they stay on the host, as the JAX package's
default device tier needs its Pallas kernel, which refuses them
(``hub/gam.py`` ``sdp_device_active``).  A job the kernels cannot serve
raises ``HybridFallback`` for its comparison with the missing piece
named.  With ``EXONERATE_TPU_CROSS_CHIP=N`` and N cards visible, a
boundary model's comparison of at least
``EXONERATE_TPU_CROSS_CHIP_MIN_W`` compressed columns runs alone across
them on K8 (``cuda_sdp.run_kernel_cross_chip``); with fewer cards the
knob is ignored, as in the JAX package.  With
``EXONERATE_TPU_SDP_ROWS=1`` (or ``all``) a comparison the row-scan tier
can express runs there first (``sdp_rows.py``, torch ops on the caller's
device), as in the JAX package, where the tier is opt-in too; an
unconverged row fixpoint falls back to the host like edge liveness.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import observe
from ..align.alignment import Alignment
from . import sdp_bands
from .region import Region
from .sdp import NEG, SDPPair, SdpArgs, model_uses_boundary
from ..model.ir import Model

from .. import device as default_device
from . import cuda_sdp
from . import sdp_device as sd
from . import sdp_rows
from .wavefront import _bucket

# margin of dense band around seed extents; extension escaping it trips
# edge liveness and falls back to the host engine
BAND_MARGIN = 1024

# default-routing gates of the JAX package (sdp_hybrid.py:223-239),
# unchanged so that the port routes exactly as it does
DEVICE_MIN_W = 16384
DEVICE_MIN_CELLS = 16_000_000
DEVICE_MIN_Q = 512

# the plain scan's limit on the CPU (the JAX XLA tier's, :363)
SCAN_DIAG_CAP = 8192


class HybridFallback(Exception):
    """Device result unusable for this comparison; redo on host."""


def _devices(device: torch.device) -> list:
    """The devices a cross-chip scan may use for a caller on ``device``:
    the cards PyTorch sees when it is a card, none on the CPU."""
    if device.type != "cuda":
        return []
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _cross_chip_config(plan, device: torch.device,
                       model: Optional[Model] = None,
                       devices: Optional[list] = None) -> int:
    """Cross-chip routing (``exonerate_tpu/engine/sdp_hybrid.py:366-389``):
    with ``EXONERATE_TPU_CROSS_CHIP=N`` (N >= 2), a comparison whose
    compressed band has at least ``EXONERATE_TPU_CROSS_CHIP_MIN_W``
    (default 1M) columns runs across N of ``_devices(device)`` when there
    are N.  A non-boundary ``model`` never does: the JAX package reaches
    its cross-chip route only through its Pallas kernel, which refuses
    such models (``sdp_hybrid.py:366-389``, ``sdp_pallas.py:77``).
    ``devices`` replaces ``_devices(device)``.  Returns N, or 0 for the
    single-device path."""
    n = int(os.environ.get("EXONERATE_TPU_CROSS_CHIP", "0") or 0)
    if n < 2 or plan is None:
        return 0
    if model is not None and not model_uses_boundary(model):
        return 0
    min_w = int(os.environ.get("EXONERATE_TPU_CROSS_CHIP_MIN_W",
                               str(1 << 20)))
    if devices is None:
        devices = _devices(device)
    if plan.W < min_w or len(devices) < n:
        return 0
    return n


def eligible(model: Model, args: SdpArgs, subopt) -> bool:
    """Single-pass, empty subopt at pass time, band-scan-expressible
    model."""
    if not args.single_pass:
        return False
    if subopt is not None and getattr(subopt, "points", None):
        return False
    return sd.supported(model)


class HybridSDPPair:
    """Drop-in replacement for SDPPair.next_path on the device path."""

    def __init__(self, model: Model, comparison, data, subopt,
                 args: Optional[SdpArgs] = None,
                 device_out=None, plan=None, gpair=None,
                 device: Optional[torch.device] = None):
        self.model = model
        self.comparison = comparison
        self.data = data
        self.subopt = subopt
        self.args = args or SdpArgs()
        self.device = device if device is not None else default_device()
        # the global pair provides seeds, grids and the fallback path
        self.gpair = gpair if gpair is not None else SDPPair(
            model, comparison, data, subopt, self.args)
        self.plan = plan
        self.device_out = device_out
        self._locus_scores = None
        self._resolved: dict[int, SDPPair] = {}
        self._ran = False

    # -- device pass ---------------------------------------------------

    def _run_device(self):
        pair = self.gpair
        # the scan's query/joint-span thaw only enforces the q-window
        # upper bound when it can never bind (max_query >= query length)
        if any(sp.max_target > 0
               and 0 < sp.max_query < pair.region.query_length
               for sp in self.model.spans):
            observe.count_fallback(
                "sdp device->host: narrow query-span window")
            raise HybridFallback()
        if not pair.seeds:
            self._locus_scores = np.empty(0, np.int64)
            self.plan = sdp_bands.BandPlan([], -1, np.empty(0, np.int64),
                                           np.empty(0, np.int32),
                                           np.empty(0, np.int64), [],
                                           np.empty(0, np.int32))
            return
        if self.plan is None or self.device_out is None:
            plan = (self.plan if self.plan is not None
                    else make_plan(self.model, pair))
            if not device_worthwhile(
                    plan, pair.region.query_length,
                    rows_ok=rows_usable(self.model, pair, plan)):
                observe.count_fallback(
                    "sdp device->host: below device size floor")
                raise HybridFallback()
            out = run_device(self.model, pair, plan, self.device)
            self.plan, self.device_out = plan, out
        out = self.device_out
        if "fallback" in out:
            observe.count_fallback(out["fallback"])
            raise HybridFallback()
        if out["live"] or out["xband"] or out.get("unconverged", False):
            observe.count_fallback(
                "sdp device->host: band edge liveness" if out["live"]
                else ("sdp device->host: cross-locus thaw"
                      if out["xband"]
                      else "sdp device->host: row fixpoint unconverged"))
            raise HybridFallback()
        self._locus_scores = np.asarray(
            out["band_end"][:len(self.plan.loci)], np.int64)

    # -- lazy locus resolution ------------------------------------------

    def _resolve(self, lx: int) -> SDPPair:
        bp = self._resolved.get(lx)
        if bp is not None:
            return bp
        lc = self.plan.loci[lx]
        pair = self.gpair
        seeds = pair.seeds[lc.seed_lo:lc.seed_hi]
        region = Region(0, lc.t0, pair.region.query_length,
                        lc.t1 - lc.t0)
        bp = SDPPair(self.model, self.comparison, self.data,
                     self.subopt, self.args, region=region,
                     seeds_override=[(s.q_cobs, s.t_cobs, s.hsp_score,
                                      s.hsp) for s in seeds])
        bp._find_starts()
        bp._find_ends()
        best = max((s.max_end.score for s in bp.seeds), default=NEG)
        if best != int(self._locus_scores[lx]):
            observe.count_fallback(
                "sdp device->host: locus score mismatch "
                f"({best} != {int(self._locus_scores[lx])})")
            raise HybridFallback()
        self._resolved[lx] = bp
        return bp

    def next_path(self, threshold: int) -> Optional[Alignment]:
        """(ref: SDP_Pair_next_path single-pass walk, sdp.c:743-814)."""
        if not self._ran:
            self._run_device()
            self._ran = True
            self._emitted: set = set()
        plan = self.plan
        while True:
            # resolve every locus that could still top the stream
            best_seed = None   # (key, global_ix, locus SDPPair, seed)
            for lx, bp in self._resolved.items():
                lc = plan.loci[lx]
                for k, s in enumerate(bp.seeds):
                    gix = lc.seed_lo + k
                    if gix in self._emitted:
                        continue
                    key = (-s.max_end.score, gix)
                    if best_seed is None or key < best_seed[0]:
                        best_seed = (key, gix, bp, s)
            need = None
            for lx in range(len(plan.loci)):
                if lx in self._resolved:
                    continue
                sc = int(self._locus_scores[lx])
                if sc < threshold:
                    continue
                if best_seed is None or sc >= -best_seed[0][0]:
                    if need is None or sc > int(self._locus_scores[need]):
                        need = lx
            if need is not None:
                self._resolve(need)
                continue
            if best_seed is None:
                return None
            _key, gix, bp, seed = best_seed
            if seed.max_end.score < threshold:
                # ordered walk stops at the first below-threshold seed
                # (ref: sdp.c:796-800)
                return None
            self._emitted.add(gix)
            alignment = bp._find_path(seed)
            alignment = _shift_alignment(alignment, bp.region)
            if self.gpair._overlaps(alignment):
                continue
            return alignment


def _shift_alignment(a: Alignment, region: Region) -> Alignment:
    """Band-local alignment -> absolute coordinates."""
    if region.target_start == 0 and region.query_start == 0:
        return a
    shifted = Alignment(
        a.model,
        Region(a.region.query_start + region.query_start,
               a.region.target_start + region.target_start,
               a.region.query_length, a.region.target_length),
        a.score)
    shifted.ops = a.ops
    return shifted


def make_plan(model: Model, pair: SDPPair) -> sdp_bands.BandPlan:
    extents = [s.t_extent for s in pair.seeds]
    sw = max((sp.max_target for sp in model.spans), default=0)
    return sdp_bands.plan_bands(
        extents, pair.region.query_length, pair.region.target_length,
        margin=BAND_MARGIN,
        span_window=sw + 2 * BAND_MARGIN)


def device_worthwhile(plan, query_length: int = None,
                      rows_ok: bool = False) -> bool:
    """Size/shape gate of the default routing: tiny comparisons and
    lane-starved shapes stay on the host scheduler
    (``EXONERATE_TPU_SDP=device`` lifts it).  ``rows_ok`` lifts the
    short-query gate: the row scan is the shape the band kernels starve
    on (``exonerate_tpu/engine/sdp_hybrid.py:242-259``)."""
    if os.environ.get("EXONERATE_TPU_SDP", "") == "device":
        return True
    if plan is None or plan.W < DEVICE_MIN_W:
        return False
    if query_length is not None:
        if (query_length + 1) * (plan.W + 1) < DEVICE_MIN_CELLS:
            return False
        if query_length < DEVICE_MIN_Q and not rows_ok:
            return False
    return True


def rows_usable(model: Model, pair: SDPPair, plan=None) -> bool:
    """Route through the q-major row-scan tier (``sdp_rows.py``)?  Opt-in
    only (``EXONERATE_TPU_SDP_ROWS=1`` or ``=all``), as in the JAX
    package (``sdp_hybrid.py:262-283``), for a model and pair the row
    scan can express."""
    if os.environ.get("EXONERATE_TPU_SDP_ROWS", "") not in ("1", "all"):
        return False
    if not sdp_rows.supported(model):
        return False
    try:
        sdp_rows.chain_ext_values(model, pair)
    except sdp_rows.RowUnsupported:
        return False
    return True


def _rows_preferred(model: Model, pair: SDPPair, plan) -> bool:
    """Among the device tiers, the row scan only when forced (see
    ``rows_usable``)."""
    return rows_usable(model, pair, plan)


def _pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


def run_rows_batch(model: Model, jobs: list,
                   device: torch.device) -> list[dict]:
    """Batched row-scan passes on ``device``: one call of the row pass
    per (shape, kinds, exts) bucket, bucketed as the JAX package's
    ``run_rows_batch`` (``sdp_hybrid.py:292-336``)."""
    out: list = [None] * len(jobs)
    shape_max: dict = {}
    for pair, plan in jobs:
        gkey = (pair.use_boundary, pair.args.dropoff)
        cur = shape_max.get(gkey, (0, 0, 0))
        shape_max[gkey] = (max(cur[0], pair.region.query_length),
                           max(cur[1], len(pair.seeds)),
                           max(cur[2], len(plan.loci) + 1))
    buckets: dict = {}
    for ix, (pair, plan) in enumerate(jobs):
        mq, ms, mg = shape_max[(pair.use_boundary, pair.args.dropoff)]
        Qp = _bucket(mq)
        Wp = _pow2(max(plan.W, 1024))
        n_seed_pad, n_seg_pad = _pow2(ms), _pow2(mg)
        inputs, kinds = sd.prepare_inputs(model, pair, plan,
                                          pad_to=(Qp, Wp))
        inputs.update(sd.prepare_seeds(pair, plan, n_seed_pad))
        exts = sdp_rows.chain_ext_values(model, pair)
        key = (Qp, Wp, kinds, pair.use_boundary, n_seed_pad, n_seg_pad,
               pair.args.dropoff, exts)
        buckets.setdefault(key, []).append((ix, inputs))
    for (Qp, Wp, kinds, ub, nsp, ngp, dropoff, exts), items \
            in buckets.items():
        fn = sdp_rows.get_fn(model, Qp, Wp, kinds, ub, nsp, ngp,
                             dropoff, exts, batched=True)
        observe.count_engine("sdp-rows", len(items))
        res = fn(_stack([inp for _, inp in items]), device=device)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        for b, (ix, _) in enumerate(items):
            out[ix] = {k: v[b] for k, v in res.items()}
    return out


def _stack(items: list):
    """Per-pair input trees stacked along a leading batch axis."""
    if isinstance(items[0], dict):
        return {k: _stack([d[k] for d in items]) for k in items[0]}
    return np.stack([np.asarray(x) for x in items])


def run_device(model: Model, pair: SDPPair, plan: sdp_bands.BandPlan,
               device: torch.device, devices: Optional[list] = None
               ) -> dict:
    """Single-comparison device call (the pooled path batches many)."""
    return run_device_batch(model, [(pair, plan)], device, devices)[0]


def run_device_batch(model: Model, jobs: list, device: torch.device,
                     devices: Optional[list] = None) -> list[dict]:
    """Batched band scans of many comparisons' (pair, plan) jobs on
    ``device``: one K6 + K7 launch pair per (Qp, Wp) bucket.  A job the
    device tier cannot serve gets ``{"fallback": reason}``, which its
    HybridSDPPair counts and turns into a HybridFallback.  ``devices``
    are those a cross-chip scan may use (default: the visible cards,
    ``_devices``).  The row-scan
    tier takes its jobs first, as in the JAX package
    (``sdp_hybrid.py:444-457``)."""
    out: list = [None] * len(jobs)
    rows = [ix for ix, (pair, plan) in enumerate(jobs)
            if _rows_preferred(model, pair, plan)]
    if rows:
        for ix, r in zip(rows, run_rows_batch(
                model, [jobs[ix] for ix in rows], device)):
            out[ix] = r
    by_drop: dict = {}
    for ix, (pair, plan) in enumerate(jobs):
        if out[ix] is not None:
            continue
        reason = cuda_sdp.unsupported_reason(model, pair, plan)
        n_chips = (_cross_chip_config(plan, device, model, devices)
                   if reason is None else 0)
        if reason is not None:
            out[ix] = {"fallback": "sdp device->host: band kernel "
                                   f"unsupported ({reason})"}
        elif n_chips:
            # a chromosome-scale comparison alone across the devices
            devs = (devices if devices is not None
                    else _devices(device))[:n_chips]
            observe.count_engine(cuda_sdp.engine_name(devs[0]) + "-xchip")
            out[ix] = cuda_sdp.run_kernel_cross_chip(
                model, pair, plan, pair.args.dropoff, n_chips, devices=devs)
        elif device.type == "cpu" and \
                pair.region.query_length + plan.W + 1 > SCAN_DIAG_CAP:
            out[ix] = {"fallback": "sdp device->host: kernel unavailable, "
                                   "scan too long"}
        else:
            by_drop.setdefault(pair.args.dropoff, []).append(ix)
    for dropoff, ixs in by_drop.items():
        observe.count_engine(cuda_sdp.engine_name(device), len(ixs))
        res = cuda_sdp.run_kernel(model, [jobs[ix] for ix in ixs], dropoff,
                                  device)
        for ix, r in zip(ixs, res):
            out[ix] = r
    return out
