"""GAM: the gapped alignment manager / result machinery.

Counterpart of ``exonerate_tpu/hub/gam.py`` (ref: src/hub/gam.{h,c}):
owns the model and engines, converts comparisons into alignments
(ungapped shortcut, heuristic DP, exhaustive suboptimal enumeration),
applies score/percent/bestn thresholds and dispatches every enabled
output format.  The reference's tmpfile-backed bestn machinery
(gam.c:172-219) is replaced by an in-memory store with identical
final-set semantics: an alignment is reported iff fewer than best_n
strictly better alignments exist for the query, ranked 1..N in
descending score order.

The GAM holds the port's device.  The exhaustive enumeration and the
refinement call the port's ``optimal.find_path`` on it (the enumeration
with its score threshold, so that a sub-threshold last iteration runs no
path DP); the seeded
heuristic's device tier (``sdp_device_active``, ``run_sdp_pool``,
``_make_sdp_pair``) runs the port's SDP hybrid on it: the band kernels
K6/K7 on a card, their plain PyTorch versions on the CPU when
``EXONERATE_TPU_SDP=device`` forces the tier there, and the row-scan tier
(``engine/sdp_rows.py``) first under ``EXONERATE_TPU_SDP_ROWS``.  The pooled locus
heuristic (``EXONERATE_TPU_HEURISTIC=locus``, ``result_heuristic_pooled``)
runs its generation-batched Waterman-Eggert on the wavefront kernels on
the GAM's device: each generation one SubOpt-masked region batch (K1
with K3) and one masked path batch (K4 with K3), on the plain versions
on the CPU.  With two or more cards visible (``_scan_devices``) the first
generation's mask-free scan runs data-parallel over them
(``cuda_wavefront.find_batched_sharded``, K5), as the JAX package's
runs over its ``_scan_mesh``.  Under ``--cores N`` the Analysis calls the
GAM from worker threads and sets ``devices``: the locus heuristic then
takes the JAX package's per-locus route, each locus's path DPs on the
next device in turn, and the band scan's device tier runs per
comparison.
"""
from __future__ import annotations

import enum
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import observe
from ..align.alignment import Alignment, AlignmentArgs
from ..align import formats
from ..engine.region import Region
from ..engine.sdp import SDPPair, SdpArgs
from ..engine.subopt import SubOpt
from ..model.ir import Label, Model
from ..model.registry import ModelType, has_genomic_target
from ..model.data import AlignData
from ..seeds.hsp import Comparison, HSP, HspSet
from ..seqio import Sequence


class Refinement(enum.Enum):
    NONE = "none"
    FULL = "full"
    REGION = "region"


@dataclass
class GamArgs:
    """(ref: GAM_ArgumentSet, gam.c:93-155)."""
    model_type: ModelType = ModelType.UNGAPPED
    threshold: int = 100
    percent_threshold: float = 0.0
    show_alignment: bool = True
    show_sugar: bool = False
    show_cigar: bool = False
    show_vulgar: bool = True
    show_query_gff: bool = False
    show_target_gff: bool = False
    ryo: Optional[str] = None
    best_n: int = 0
    use_subopt: bool = True
    use_gapped_extension: bool = True
    refinement: Refinement = Refinement.NONE
    refinement_boundary: int = 32
    # SDP options (ref: SDP_ArgumentSet, sdp.c:28-32)
    extension_threshold: int = 50
    single_pass: bool = True
    # Heuristic/BSDP/SAR options (ref: heuristic.c:78-96, bsdp.c:25-26,
    # sar.c:26-27)
    terminal_range_internal: int = 12
    terminal_range_external: int = 12
    join_range_internal: int = 12
    join_range_external: int = 12
    span_range_internal: int = 12
    span_range_external: int = 12
    join_filter: int = 0
    hsp_quality: float = 0.0


@dataclass
class _Stored:
    score: int
    text: str
    order: int


class GAM:
    """(ref: GAM, gam.h:91-154)."""

    def __init__(self, model: Model, gas: GamArgs,
                 make_data, align_args: Optional[AlignmentArgs] = None,
                 out=None, *, device: torch.device):
        self.model = model
        self.gas = gas
        self.make_data = make_data      # (query, target) -> AlignData
        self.align_args = align_args or AlignmentArgs()
        self.out = out or sys.stdout
        self.device = device
        # query_id -> list of stored results (bestn mode)
        self.bestn_store: dict[str, list[_Stored]] = {}
        self._order = 0
        # --multihost: suppress the local bestn replay so that the stores
        # can merge across processes first (parallel/multihost.py)
        self.defer_report = False
        self.geneseed_threshold = 0
        # --cores N: the devices the locus route's path DPs take in turn
        # (exonerate_tpu/hub/gam.py:97-101), set by the Analysis's pool;
        # the turn is taken under a lock by the pool's worker threads
        self.devices: list = []
        self._dev_rr = 0
        self._dev_lock = threading.Lock()

    def _sdp_args(self) -> SdpArgs:
        return SdpArgs(self.gas.extension_threshold, self.gas.single_pass)

    # -- thresholds (ref: GAM_get_query_threshold, gam.c:677-705) ---------

    # The reference's advance-3 self-score loop overruns the final
    # window when len % 3 != 0 (gam.c:477-478 steps j by advance while
    # j < len, reading seq[len]/seq[len+1]); the terminator translates
    # to '-' and Submat_lookup('-','-') reads past the packed matrix —
    # a huge heap-dependent garbage term (observed 1,952,539,695 with
    # blosum62, 1,836,277,605 with pam250 in the shim build).  The
    # observable contract: the per-query threshold explodes, the gint
    # *= gfloat conversion overflows to INT_MIN for any realistic
    # --percent, and the threshold falls back to --score.  We add one
    # fixed huge term to reproduce that contract (the exact constant
    # only matters for --percent <= ~1.1, where both sides already
    # report nothing).
    _SELF_OVERRUN_GARBAGE = 1952539695

    def _percent_matches(self, data: AlignData) -> list:
        """Unique matches of the model's MATCH transitions in first-
        encounter order (ref: GAM_build_match_list, gam.c:369-391),
        resolved through AlignData so user submats apply."""
        types = []
        for t in self.model.transitions:
            if t.label == Label.MATCH and t.label_data is not None:
                mt = getattr(t.label_data, "type", None)
                if mt is not None and mt not in types:
                    types.append(mt)
        if not types:
            return [data.match()]
        return [data.match(mt) for mt in types]

    def query_threshold(self, query: Sequence, data: AlignData) -> int:
        if self.gas.best_n:
            stored = self.bestn_store.get(query.id)
            if stored and len(stored) >= self.gas.best_n:
                return min(s.score for s in stored)
        if self.gas.percent_threshold:
            import math
            th = 0
            for match in self._percent_matches(data):
                t = match.self_score(query)
                if match.advance_query == 3 and len(query) % 3:
                    t += self._SELF_OVERRUN_GARBAGE
                th = max(th, t)
            # gint *= gfloat: float32 product, out-of-range conversion
            # lands on INT_MIN (x86 cvttss2si); then C integer division
            # truncates toward zero (ref: gam.c:482-485)
            v = float(np.float32(np.float32(th)
                                 * np.float32(self.gas.percent_threshold)))
            th = (-(1 << 31) if not (-(2.0 ** 31) <= v < 2.0 ** 31)
                  else int(v))
            th = math.trunc(th / 100)
            if th < self.gas.threshold:
                th = self.gas.threshold
            return th
        return self.gas.threshold

    # -- result creation ---------------------------------------------------

    def result_ungapped(self, comparison: Comparison
                        ) -> list[tuple[Alignment, AlignData]]:
        """(ref: GAM_Result_ungapped_create, gam.c:736-763)."""
        if not comparison.has_hsps:
            return []
        data = self.make_data(comparison.query, comparison.target)
        subopt = (SubOpt() if self.gas.refinement != Refinement.NONE
                  else None)
        out = []
        for hspset in comparison.hspsets():
            hspset.filter_ungapped()
            threshold = self.query_threshold(comparison.query, data)
            for hsp in hspset.hsps:
                if hsp.score >= threshold:
                    alignment = self._hsp_alignment(hspset, hsp)
                    alignment = self._refine(alignment, data, subopt)
                    out.append((alignment, data))
                    if subopt is not None:
                        subopt.add_alignment(alignment)
        out.sort(key=lambda ad: -ad[0].score)
        return out

    def _refine(self, alignment: Alignment, data: AlignData,
                subopt) -> Alignment:
        """(ref: GAM_Result_refine_alignment, gam.c:605-655): re-DP over
        the full rectangle or the boundary-padded alignment region; keep
        the refined alignment only if it scores at least as well."""
        from ..engine import optimal
        if self.gas.refinement == Refinement.NONE:
            return alignment
        q, t = data.query, data.target
        if self.gas.refinement == Refinement.FULL:
            region = Region(0, 0, len(q), len(t))
        else:
            b = self.gas.refinement_boundary
            qs = max(0, alignment.region.query_start - b)
            ts = max(0, alignment.region.target_start - b)
            region = Region(
                qs, ts,
                min(len(q), alignment.region.query_end + b) - qs,
                min(len(t), alignment.region.target_end + b) - ts)
        refined = optimal.find_path(self.model, region, data, subopt,
                                    device=self.device)
        if refined is not None and refined.score >= alignment.score:
            return refined
        return alignment

    def _hsp_alignment(self, hspset: HspSet, hsp: HSP) -> Alignment:
        """(ref: Ungapped_Alignment_create, ungapped.c:168-198)."""
        model = self.model
        start2match = match2match = match2end = None
        for t in model.transitions:
            if t.input is model.start_state.state:
                start2match = t
            elif t.output is model.end_state.state:
                match2end = t
            else:
                match2match = t
        region = Region(hsp.query_start, hsp.target_start,
                        hsp.query_end(hspset.qadv) - hsp.query_start,
                        hsp.target_end(hspset.tadv) - hsp.target_start)
        a = Alignment(model, region, hsp.score)
        a.add(start2match, 1)
        a.add(match2match, hsp.length)
        a.add(match2end, 1)
        return a

    def result_heuristic(self, comparison: Comparison
                         ) -> list[tuple[Alignment, AlignData]]:
        """Heuristic gapped path (ref: GAM_Result_heuristic_create,
        gam.c:1107-1180): seeded DP with reference-exact semantics
        (ref: GAM_Result_SDP_create, gam.c:852-888)."""
        from ..engine import sdp_hybrid
        if not comparison.has_hsps:
            return []
        if self.geneseed_threshold:
            # (ref: GAM_Result_heuristic_create, gam.c:1112-1121):
            # geneseed raises the report threshold too, so low-scoring
            # subopt alignments never emit
            if self.gas.threshold < self.geneseed_threshold:
                self.gas.threshold = self.geneseed_threshold
            self._geneseed_filter(comparison)
            if not comparison.has_hsps:
                return []
        query, target = comparison.query, comparison.target
        data = self.make_data(query, target)
        if not self.gas.use_gapped_extension:
            return self._result_bsdp(comparison, data)
        if os.environ.get("EXONERATE_TPU_HEURISTIC") == "locus":
            return self._result_heuristic_locus(comparison, data)
        sdp_pair = self._make_sdp_pair(comparison, data)
        try:
            return self._run_sdp_loop(sdp_pair, query, data)
        except sdp_hybrid.HybridFallback:
            # device result unusable: redo the whole comparison on the
            # host global path (nothing was submitted yet)
            return self._fallback(comparison, data)

    def _fallback(self, comparison, data):
        """The whole comparison on the host global path, after a
        HybridFallback."""
        observe.add("hybrid.fallbacks")
        with observe.span("hybrid.fallback"):
            pair = SDPPair(self.model, comparison, data, SubOpt(),
                           self._sdp_args())
            return self._run_sdp_loop(pair, comparison.query, data)

    def sdp_device_active(self) -> bool:
        """True when the heuristic's SDP passes run on the device tier
        (``exonerate_tpu/hub/gam.py:270-304``): by default when the GAM's
        device is a CUDA card, the model uses the boundary protocol (the
        JAX package's default tier needs its Pallas kernel, which refuses
        the non-boundary models) and the band kernels serve it, or
        ``EXONERATE_TPU_SDP_ROWS`` is set and the row scan serves the
        model (``exonerate_tpu/hub/gam.py:297-302``);
        ``EXONERATE_TPU_SDP=device`` forces the tier (the plain scan on
        the CPU), for the non-boundary models too; ``=native`` /
        ``=python`` force the host engines."""
        from ..engine import cuda_sdp, sdp_hybrid, sdp_rows
        from ..engine.sdp import model_uses_boundary
        env = os.environ.get("EXONERATE_TPU_SDP", "")
        if env in ("native", "python"):
            return False
        if env != "device":
            if self.device.type != "cuda":
                return False
            rows_on = os.environ.get("EXONERATE_TPU_SDP_ROWS", "") in \
                ("1", "all")
            if not ((model_uses_boundary(self.model)
                     and cuda_sdp.unsupported_reason(self.model) is None)
                    or (rows_on and sdp_rows.supported(self.model))):
                return False
        return sdp_hybrid.eligible(self.model, self._sdp_args(), None)

    def _pool_meta(self, comp, args):
        """One comparison of ``run_sdp_pool``: None when it has no HSPs,
        else (comparison, data, global pair, route): its band plan for the
        device batch, ``"host"`` for the host scheduler directly, or None
        when it has no seeds."""
        from ..engine import sdp_hybrid
        if not comp.has_hsps:
            return None
        if self.geneseed_threshold:
            if self.gas.threshold < self.geneseed_threshold:
                self.gas.threshold = self.geneseed_threshold
            self._geneseed_filter(comp)
            if not comp.has_hsps:
                return None
        data = self.make_data(comp.query, comp.target)
        gpair = SDPPair(self.model, comp, data, SubOpt(), args)
        plan = (sdp_hybrid.make_plan(self.model, gpair)
                if gpair.seeds else None)
        if plan is not None and not sdp_hybrid.device_worthwhile(
                plan, gpair.region.query_length,
                rows_ok=sdp_hybrid.rows_usable(self.model, gpair, plan)):
            # small comparison: host scheduler directly
            return comp, data, gpair, "host"
        return comp, data, gpair, plan

    @observe.traced("pool")
    def run_sdp_pool(self, comparisons: list):
        """Pooled device SDP over many deferred comparisons: every pass
        batches into a few K6/K7 launches, then each comparison's result
        loop runs (and submits) in original order, so output bytes match
        the per-comparison path exactly."""
        from ..engine import sdp_hybrid
        args = self._sdp_args()
        metas = []
        jobs = []
        for comp in comparisons:
            with observe.span("pool.plan"):
                meta = self._pool_meta(comp, args)
            metas.append(meta)
            if meta is not None and meta[3] not in ("host", None):
                jobs.append(meta[2:4])

        def device_batch():
            with observe.span("pool.device"):
                return sdp_hybrid.run_device_batch(self.model, jobs,
                                                   self.device)

        # the device batch runs on a worker so that the host-route
        # comparisons overlap it; submission order is unchanged
        dev_fut = None
        if jobs:
            pool = ThreadPoolExecutor(max_workers=1)
            dev_fut = pool.submit(observe.carry(device_batch))
            pool.shutdown(wait=False)
        job_of_meta = {}
        for mx, meta in enumerate(metas):
            if meta is not None and meta[3] not in ("host", None):
                job_of_meta[mx] = len(job_of_meta)

        def result_loop(mx_meta):
            mx, meta = mx_meta
            if meta is None:
                return []
            comp, data, gpair, plan = meta[:4]
            if plan == "host":
                with observe.span("pool.host_route"):
                    return self._run_sdp_loop(gpair, comp.query, data)
            out = None
            if mx in job_of_meta:
                with observe.span("pool.wait"):
                    out = dev_fut.result()[job_of_meta[mx]]
            hp = sdp_hybrid.HybridSDPPair(
                self.model, comp, data, gpair.subopt, args,
                device_out=out, plan=plan, gpair=gpair, device=self.device)
            try:
                return self._run_sdp_loop(hp, comp.query, data)
            except sdp_hybrid.HybridFallback:
                return self._fallback(comp, data)

        # host-route metas first: they overlap the device batch;
        # submission order is restored below
        metas = list(enumerate(metas))
        order = sorted(
            range(len(metas)),
            key=lambda mx: 0 if (metas[mx][1] is not None
                                 and metas[mx][1][3] == "host") else 1)
        # the per-comparison walks are independent and their host locus
        # resolutions release the GIL in ctypes calls, so a small thread
        # pool overlaps them; submission stays in original order
        n_workers = int(os.environ.get(
            "EXONERATE_TPU_RESOLVE_THREADS",
            str(min(4, os.cpu_count() or 1))))
        if n_workers > 1 and sum(m is not None for _, m in metas) > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                ordered = list(ex.map(observe.carry(result_loop),
                                      [metas[mx] for mx in order]))
            all_results = [None] * len(metas)
            for mx, res in zip(order, ordered):
                all_results[mx] = res
        else:
            all_results = [result_loop(m) for m in metas]
        for results in all_results:
            self.submit(results)

    def _geneseed_filter(self, comparison):
        """HSP reachability filter (ref: GAM_Result_geneseed_filter,
        gam.c:1044-1105): starting from every geneseed HSP (score >=
        geneseed threshold), flood rectangle searches over the HSP
        cobs points forward and backward; an HSP survives if marked in
        EITHER direction.  Search ranges grow with the visited HSP's
        extent past its cobs plus the global max-cobs HSP's leading
        extent, padded by the model's span windows (gam.c:444-450).
        The mark set is search-order independent, so a flat worklist
        replaces the reference's recursive RangeTree walk; the tree's
        first-point-wins dedup (same-cobs-point HSPs are unreachable
        through the tree) is mirrored."""
        entries = []                    # (hspset, hsp, q_cobs, t_cobs)
        points: dict = {}
        max_cobs = None
        for hs in comparison.hspsets():
            for h in hs.hsps:
                qc = h.query_start + h.cobs * hs.qadv
                tc = h.target_start + h.cobs * hs.tadv
                hid = len(entries)
                entries.append((hs, h, qc, tc))
                if (qc, tc) not in points:
                    points[(qc, tc)] = hid
                if max_cobs is None \
                        or entries[max_cobs][1].cobs < h.cobs:
                    max_cobs = hid
        if not entries:
            return
        mq = max((sp.max_query for sp in self.model.spans), default=0)
        mt = max((sp.max_target for sp in self.model.spans), default=0)
        _mh_hs, mh, mh_qc, mh_tc = entries[max_cobs]
        mq_off = mh_qc - mh.query_start
        mt_off = mh_tc - mh.target_start
        tree_ids = np.array(sorted(points.values()), np.int64)
        tqc = np.array([entries[i][2] for i in tree_ids], np.int64)
        ttc = np.array([entries[i][3] for i in tree_ids], np.int64)
        fwd = [False] * len(entries)
        rev = [False] * len(entries)
        work = [(i, d)
                for i, (hs, h, _q, _t) in enumerate(entries)
                if h.score >= self.geneseed_threshold
                for d in (True, False)]
        while work:
            hid, is_fwd = work.pop()
            mark = fwd if is_fwd else rev
            if mark[hid]:
                continue
            mark[hid] = True
            hs, h, qc, tc = entries[hid]
            qr = mq + ((h.query_start + h.length * hs.qadv - qc)
                       + mq_off) * 2
            tr = mt + ((h.target_start + h.length * hs.tadv - tc)
                       + mt_off) * 2
            if is_fwd:
                sel = ((tqc >= qc) & (tqc < qc + qr)
                       & (ttc >= tc) & (ttc < tc + tr))
            else:
                sel = ((tqc >= qc - qr) & (tqc < qc)
                       & (ttc >= tc - tr) & (ttc < tc))
            for j in tree_ids[np.nonzero(sel)[0]]:
                if not (fwd if is_fwd else rev)[j]:
                    work.append((int(j), is_fwd))
        hid = 0
        for hs in comparison.hspsets():
            keep = []
            for h in hs.hsps:
                if fwd[hid] or rev[hid]:
                    keep.append(h)
                hid += 1
            hs.hsps = keep

    def _make_sdp_pair(self, comparison, data):
        """The device-hybrid pair when the device tier is active and the
        comparison passes the default routing's size gates
        (``sdp_hybrid.device_worthwhile``), else the host pair (native C++
        scheduler).  A comparison under the gates goes to the host
        directly, as ``run_sdp_pool`` sends it, and counts no fallback:
        this is the route of every comparison under ``--cores``."""
        from ..engine import sdp_hybrid
        if self.sdp_device_active():
            gpair = SDPPair(self.model, comparison, data, SubOpt(),
                            self._sdp_args())
            plan = (sdp_hybrid.make_plan(self.model, gpair)
                    if gpair.seeds else None)
            if plan is not None and not sdp_hybrid.device_worthwhile(
                    plan, gpair.region.query_length,
                    rows_ok=sdp_hybrid.rows_usable(self.model, gpair,
                                                   plan)):
                return gpair
            return sdp_hybrid.HybridSDPPair(
                self.model, comparison, data, gpair.subopt,
                self._sdp_args(), plan=plan, gpair=gpair, device=self.device)
        if os.environ.get("EXONERATE_TPU_SDP", "") == "device":
            observe.count_fallback(
                "sdp device->host: model unsupported on device")
        return SDPPair(self.model, comparison, data, SubOpt(),
                       self._sdp_args())

    def _run_sdp_loop(self, sdp_pair, query, data):
        out: list[tuple[Alignment, AlignData]] = []
        while True:
            threshold = self.query_threshold(query, data)
            alignment = sdp_pair.next_path(threshold)
            if alignment is None:
                break
            if self.gas.refinement != Refinement.NONE:
                refined = self._refine(alignment, data,
                                       sdp_pair.subopt)
                if refined is not None and \
                        refined.score >= alignment.score:
                    alignment = refined
            out.append((alignment, data))
            sdp_pair.subopt.add_alignment(alignment)
            # (ref: GAM_Result_is_full, gam.c:779-793)
            if self.gas.best_n and len(out) >= self.gas.best_n \
                    and len(out) > 1 \
                    and out[-2][0].score != out[-1][0].score:
                break
            if not self.gas.use_subopt:
                break
        return out

    def _find_portal(self, hspset):
        """First portal whose advances match the HSP class
        (ref: GAM_Pair_find_portal, gam.c:560-581)."""
        for portal in self.model.portals:
            if portal.transitions \
                    and portal.transitions[0].advance_query == hspset.qadv \
                    and portal.transitions[0].advance_target == hspset.tadv:
                return portal
        raise ValueError("No compatible portal found for hspset")

    def _get_heuristic(self, data: AlignData):
        """Per-model Heuristic (derived sub-models + bound matrices),
        built once like the reference's GAM-owned Heuristic
        (ref: gam.c:392-456)."""
        import threading
        if getattr(self, "_heuristic_lock", None) is None:
            self._heuristic_lock = threading.Lock()
        with self._heuristic_lock:
            return self._get_heuristic_locked(data)

    def _get_heuristic_locked(self, data: AlignData):
        if getattr(self, "_heuristic", None) is None:
            from .bsdp import Heuristic, HeuristicArgs
            has = HeuristicArgs(
                terminal_range_internal=self.gas.terminal_range_internal,
                terminal_range_external=self.gas.terminal_range_external,
                join_range_internal=self.gas.join_range_internal,
                join_range_external=self.gas.join_range_external,
                span_range_internal=self.gas.span_range_internal,
                span_range_external=self.gas.span_range_external,
                join_filter=self.gas.join_filter,
                hsp_quality=self.gas.hsp_quality)
            self._heuristic = Heuristic(self.model, has, data)
        return self._heuristic

    def _result_bsdp(self, comparison: Comparison, data: AlignData
                     ) -> list[tuple[Alignment, AlignData]]:
        """--gappedextension no: the BSDP HSP-graph heuristic
        (ref: GAM_Result_BSDP_create, gam.c:797-850)."""
        from .bsdp import HPair
        query, target = comparison.query, comparison.target
        heuristic = self._get_heuristic(data)
        subopt = SubOpt()
        hpair = HPair(heuristic, subopt, len(query), len(target), data)
        for hspset in comparison.hspsets():
            hpair.add_hspset(self._find_portal(hspset), hspset)
        threshold = self.query_threshold(query, data)
        hpair.finalise(threshold)
        out: list[tuple[Alignment, AlignData]] = []
        while True:
            threshold = self.query_threshold(query, data)
            alignment = hpair.next_path(threshold)
            if alignment is None:
                break
            if self.gas.refinement != Refinement.NONE:
                refined = self._refine(alignment, data, subopt)
                if refined is not None and \
                        refined.score >= alignment.score:
                    alignment = refined
            out.append((alignment, data))
            subopt.add_alignment(alignment)
            # (ref: GAM_Result_is_full, gam.c:779-793)
            if self.gas.best_n and len(out) >= self.gas.best_n \
                    and len(out) > 1 \
                    and out[-2][0].score != out[-1][0].score:
                break
            if not self.gas.use_subopt:
                break
        return out

    def _result_heuristic_locus(self, comparison: Comparison,
                                data: AlignData
                                ) -> list[tuple[Alignment, AlignData]]:
        """Batched locus-region fallback (dense kernel Waterman-Eggert;
        not byte-parity with the reference SDP).  The port's kernels are
        the prescan on any device, so a comparison takes the JAX package's
        pooled route (``_locus_pool_run``), or under ``--cores`` its
        per-locus route (``_locus_per_device``)."""
        grp = self._locus_regions(comparison, data)
        if grp is None:
            return []
        if self.devices:
            return self._locus_per_device(grp)
        return self._locus_pool_run([grp])[0]

    def _next_device(self) -> torch.device:
        """The next device of ``devices`` in turn."""
        with self._dev_lock:
            dev = self.devices[self._dev_rr % len(self.devices)]
            self._dev_rr += 1
        return dev

    def _locus_per_device(self, grp: dict) -> list:
        """The locus heuristic of one comparison under ``--cores``
        (``exonerate_tpu/hub/gam.py:586-650``): one region scan of every
        cluster region (K1, or K5 over two or more cards) drops the loci
        under the threshold before any path DP; then each locus runs its
        Waterman-Eggert loop of path DPs on the next device of
        ``devices`` (no batched first path DP under the round-robin)."""
        from ..engine import cuda_wavefront, optimal
        data, regions, subopt = grp["data"], grp["regions"], grp["subopt"]
        threshold = self.query_threshold(grp["query"], data)
        if self.model.is_local:
            threshold = max(threshold, 1)
        if len(regions) > 1:
            jobs = [(r, data) for r in regions]
            devices = self._scan_devices()
            if devices is not None and len(jobs) >= len(devices):
                scans = cuda_wavefront.find_batched_sharded(
                    self.model, jobs, devices, "region")
            else:
                scans = cuda_wavefront.find_batched(
                    self.model, jobs, "region", device=self.device)
            # filter only: the whole locus region stays for the
            # Waterman-Eggert re-runs (find_path shrinks each iteration)
            regions = [r for r, scan in zip(regions, scans)
                       if scan.score >= threshold]
        out = []
        for region in regions:
            device = self._next_device()
            while True:
                alignment = optimal.find_path(self.model, region, data,
                                              subopt=subopt, device=device)
                if alignment is None or alignment.score < threshold:
                    break
                out.append((alignment, data))
                if subopt is None or not self.model.is_local:
                    break
                subopt.add_alignment(alignment)
                if self.gas.best_n and len(out) >= max(
                        self.gas.best_n * 4, 16):
                    break
        out.sort(key=lambda ad: -ad[0].score)
        return out

    def _locus_regions(self, comparison: Comparison,
                       data: AlignData) -> Optional[dict]:
        """Clustered + geneseed-filtered cluster regions of one
        comparison, with a fresh SubOpt and the data bundle; None without
        regions."""
        from .heuristic import cluster_hsps, cluster_regions
        genomic = has_genomic_target(self.gas.model_type)
        t_join = (data.intron.max_intron if genomic
                  else max(data.ner.max_ner, 10000))
        clusters = cluster_hsps(comparison, t_join, 10000)
        # geneseed gating (ref: GAM geneseed reachability filter,
        # gam.c:1044-1105): only loci anchored by a strong seed survive
        if self.geneseed_threshold:
            clusters = [c for c in clusters
                        if c.score >= self.geneseed_threshold]
        regions = cluster_regions(comparison, clusters,
                                  target_margin=1000, query_margin=1000)
        if not regions:
            return None
        return dict(data=data, query=comparison.query, regions=regions,
                    subopt=SubOpt() if self.gas.use_subopt else None)

    def _locus_group(self, comparison: Comparison) -> Optional[dict]:
        """Locus jobs for one comparison (the prologue of the locus
        heuristic)."""
        if not comparison.has_hsps:
            return None
        data = self.make_data(comparison.query, comparison.target)
        return self._locus_regions(comparison, data)

    def result_heuristic_pooled(self, comparisons: list
                                ) -> list[list]:
        """Locus heuristic over MANY comparisons at once: all loci of
        all pending comparisons share each generation's kernel batches
        (the analysis layer defers locus-mode comparisons and flushes
        them through here so batch sizes reflect the whole scan, not
        one query)."""
        outs_all: list[list] = [[] for _ in comparisons]
        groups, idx = [], []
        for ci, comparison in enumerate(comparisons):
            grp = self._locus_group(comparison)
            if grp is not None:
                groups.append(grp)
                idx.append(ci)
        if groups:
            for ci, o in zip(idx, self._locus_pool_run(groups)):
                outs_all[ci] = o
        return outs_all

    def _scan_devices(self) -> Optional[list]:
        """The cards of the data-parallel first scan: every visible card
        when there are at least two and the GAM's device is a card; None
        otherwise (the JAX package's ``_scan_mesh``, a mesh over
        ``jax.devices()``, is None on a single chip)."""
        if self.device.type != "cuda" or torch.cuda.device_count() < 2:
            return None
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]

    def _locus_pool_run(self, groups: list) -> list[list]:
        """Generation-based batched Waterman-Eggert over every locus of
        every group: each generation runs ONE masked region-scan batch
        (K1) and ONE masked path-DP batch (K4) on the GAM's device.
        Masks are per-pair DATA (packed bit planes, kernel K3), so one
        kernel instantiation serves all loci, comparisons and
        generations.  Each comparison keeps its own SubOpt; a comparison
        stops (reference stop rule, ref: GAM_Result_is_full,
        gam.c:779-793) when bestn is reached and the score strictly
        dropped."""
        from ..engine import cuda_wavefront, optimal
        outs: list[list] = [[] for _ in groups]

        def full(g: int) -> bool:
            o = outs[g]
            return bool(self.gas.best_n and len(o) >= self.gas.best_n
                        and len(o) > 1
                        and o[-2][0].score != o[-1][0].score)

        def thr(g: int) -> int:
            t = self.query_threshold(groups[g]["query"],
                                     groups[g]["data"])
            return max(t, 1) if self.model.is_local else t

        live = [(g, r) for g, grp in enumerate(groups)
                for r in grp["regions"]]
        gen = 0
        while live and gen < 256:       # runaway guard
            jobs = [(r, groups[g]["data"]) for g, r in live]
            subs = [groups[g]["subopt"] for g, _r in live]
            devices = self._scan_devices()
            if gen == 0 and devices is not None \
                    and len(jobs) >= len(devices):
                # the mask-free first scan, data-parallel over the cards
                scans = cuda_wavefront.find_batched_sharded(
                    self.model, jobs, devices, "region")
            else:
                scans = cuda_wavefront.find_batched(
                    self.model, jobs, "region", device=self.device,
                    subopt=subs)
            kept, boxes = [], []
            for (g, r), scan in zip(live, scans):
                if full(g) or scan.score < thr(g):
                    continue
                kept.append((g, r))
                boxes.append(Region(r.query_start + scan.query_start,
                                    r.target_start + scan.target_start,
                                    scan.query_end - scan.query_start,
                                    scan.target_end - scan.target_start))
            if not kept:
                break
            paths = cuda_wavefront.find_path_batched(
                self.model,
                [(b, groups[g]["data"]) for (g, _r), b in zip(kept,
                                                              boxes)],
                subopt=[groups[g]["subopt"] for g, _r in kept],
                device=self.device)
            live = []
            for (g, r), box, res in zip(kept, boxes, paths):
                if full(g):
                    continue
                grp = groups[g]
                if res is not None:
                    alignment = optimal._to_alignment(self.model, box,
                                                      res)
                else:   # kernel couldn't serve the job: lone fallback
                    alignment = optimal.find_path(self.model, r,
                                                  grp["data"],
                                                  subopt=grp["subopt"],
                                                  device=self.device)
                if alignment is None or alignment.score < thr(g):
                    continue
                outs[g].append((alignment, grp["data"]))
                if grp["subopt"] is None or not self.model.is_local:
                    continue
                grp["subopt"].add_alignment(alignment)
                if not full(g):
                    live.append((g, r))
            gen += 1
        for o in outs:
            o.sort(key=lambda ad: -ad[0].score)
        return outs

    @observe.traced("exh.pair")
    def result_exhaustive(self, query: Sequence, target: Sequence
                          ) -> list[tuple[Alignment, AlignData]]:
        """Exhaustive suboptimal enumeration (ref: OPair +
        GAM_Result_exhaustive_create, gam.c:1140-1180)."""
        from ..engine import optimal
        data = self.make_data(query, target)
        region = Region(0, 0, len(query), len(target))
        threshold = max(self.query_threshold(query, data), 1) \
            if self.model.is_local else self.query_threshold(query, data)
        subopt = SubOpt() if self.gas.use_subopt else None
        out = []
        while True:
            # the threshold goes to find_path (Optimal_find_path's
            # threshold), so an iteration whose region scan scores under
            # it ends the loop before its path DP: on a chromosome-scale
            # target that last, discarded alignment can be a chain of
            # short exons across most of the target, whose path DP is a
            # checkpointed traceback across it.  The output is the same:
            # the path DP scores what the scan scores.
            alignment = optimal.find_path(self.model, region, data,
                                          subopt=subopt, threshold=threshold,
                                          device=self.device)
            if alignment is None or alignment.score < threshold:
                break
            out.append((alignment, data))
            if subopt is None or not self.model.is_local:
                break
            subopt.add_alignment(alignment)
            if self.gas.best_n and len(out) >= max(self.gas.best_n * 4, 16):
                break
        return out

    # -- submission (ref: GAM_Result_submit, gam.c:1252-1275) -------------

    @observe.traced("report")
    def submit(self, results: list[tuple[Alignment, AlignData]]):
        if not results:
            return
        # result_id is 1-based within this result batch
        # (ref: GAM_Result_display, gam.c:1240-1251)
        if self.gas.best_n:
            for i, (alignment, data) in enumerate(results, 1):
                self._bestn_submit(alignment, data, i)
        else:
            for i, (alignment, data) in enumerate(results, 1):
                self.out.write(self._render(alignment, data, rank=-1,
                                            result_id=i))

    def _bestn_submit(self, alignment: Alignment, data: AlignData,
                      result_id: int):
        qid = data.query.id
        store = self.bestn_store.setdefault(qid, [])
        n = self.gas.best_n
        better = sum(1 for s in store if s.score > alignment.score)
        if better >= n:
            return
        self._order += 1
        # bestn tmpfile path renders with result_id=0 (ref: gam.c:178-181:
        # GAM_display_alignment(..., 0, -1, ...)), so GFF gene_id /
        # alignment_id are 0 under --bestn
        store.append(_Stored(alignment.score,
                             self._render(alignment, data, rank=None,
                                          result_id=0),
                             self._order))
        # evict: keep only entries with fewer than n strictly better
        scores = sorted((s.score for s in store), reverse=True)
        store[:] = [s for s in store
                    if sum(1 for sc in scores if sc > s.score) < n]

    @observe.traced("report")
    def report(self):
        """Final bestn replay (ref: GAM_report, gam.c:550-556): per query
        in id-sorted order, descending score, ranks 1..N."""
        if not self.gas.best_n or self.defer_report:
            return
        for qid in sorted(self.bestn_store):
            store = self.bestn_store[qid]
            store.sort(key=lambda s: (-s.score, s.order))
            for rank, s in enumerate(store, 1):
                self.out.write(s.text.replace("%_EXONERATE_BESTN_RANK_%",
                                              str(rank)))

    # -- rendering (ref: GAM_display_alignment, gam.c:1210-1237) ----------

    def _render(self, alignment: Alignment, data: AlignData,
                rank, result_id: int = 0) -> str:
        gas = self.gas
        q, t = data.query, data.target
        parts = []
        if gas.show_alignment:
            parts.append(formats.display_human(alignment, q, t, data,
                                               self.align_args))
        if gas.show_sugar:
            parts.append(formats.display_sugar(alignment, q, t,
                                               self.align_args))
        if gas.show_cigar:
            parts.append(formats.display_cigar(alignment, q, t,
                                               self.align_args))
        if gas.show_vulgar:
            parts.append(formats.display_vulgar(alignment, q, t,
                                                self.align_args))
        if gas.show_query_gff or gas.show_target_gff:
            from ..align import gff
            if gas.show_query_gff:
                parts.append(gff.display_gff(alignment, q, t, data, True,
                                             False, self.align_args,
                                             result_id=result_id))
            if gas.show_target_gff:
                parts.append(gff.display_gff(
                    alignment, q, t, data, False,
                    has_genomic_target(gas.model_type), self.align_args,
                    result_id=result_id))
        if gas.ryo:
            from ..align import ryo
            parts.append(ryo.display_ryo(alignment, q, t, data, gas.ryo,
                                         rank, self.align_args))
        return "".join(parts)
