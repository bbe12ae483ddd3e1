"""GAM of the port: the JAX package's GAM with the port's engines.

Counterpart of ``exonerate_tpu/hub/gam.py``.  Only the methods that reach
a JAX engine are overridden:

- the exhaustive enumeration and refinement call the port's
  ``optimal.find_path`` on the GAM's device;
- the seeded heuristic's device tier (``sdp_device_active``,
  ``run_sdp_pool``, ``_make_sdp_pair``, ``result_heuristic``) runs the
  port's SDP hybrid on the GAM's device: the band kernels K6/K7 on a
  card, their plain PyTorch versions on the CPU when
  ``EXONERATE_TPU_SDP=device`` forces the tier there.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from exonerate_tpu import observe
from exonerate_tpu.engine.region import Region
from exonerate_tpu.engine.sdp import SDPPair, SdpArgs
from exonerate_tpu.engine.subopt import SubOpt
from exonerate_tpu.hub import gam as jax_gam
from exonerate_tpu.hub.gam import Refinement

from ..engine import cuda_sdp, optimal, sdp_hybrid


class GAM(jax_gam.GAM):
    def __init__(self, *args, device: torch.device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device

    def _sdp_args(self) -> SdpArgs:
        return SdpArgs(self.gas.extension_threshold, self.gas.single_pass)

    def sdp_device_active(self) -> bool:
        """True when the heuristic's SDP passes run on the device tier
        (``gam.py:270-304``): by default when the GAM's device is a CUDA
        card and the band kernels serve the model;
        ``EXONERATE_TPU_SDP=device`` forces the tier (the plain scan on
        the CPU), ``=native`` / ``=python`` force the host engines."""
        env = os.environ.get("EXONERATE_TPU_SDP", "")
        if env in ("native", "python"):
            return False
        if env != "device" and (
                self.device.type != "cuda"
                or cuda_sdp.unsupported_reason(self.model) is not None):
            return False
        return sdp_hybrid.eligible(self.model, self._sdp_args(), None)

    def result_heuristic(self, comparison):
        """Heuristic gapped path (``gam.py:228-268``), catching the port's
        HybridFallback."""
        if not comparison.has_hsps:
            return []
        if self.geneseed_threshold:
            if self.gas.threshold < self.geneseed_threshold:
                self.gas.threshold = self.geneseed_threshold
            self._geneseed_filter(comparison)
            if not comparison.has_hsps:
                return []
        query, target = comparison.query, comparison.target
        data = self.make_data(query, target)
        if not self.gas.use_gapped_extension:
            return self._result_bsdp(comparison, data)
        sdp_pair = self._make_sdp_pair(comparison, data)
        try:
            return self._run_sdp_loop(sdp_pair, query, data)
        except sdp_hybrid.HybridFallback:
            # device result unusable: redo the whole comparison on the
            # host global path (nothing was submitted yet)
            sdp_pair = SDPPair(self.model, comparison, data, SubOpt(),
                               self._sdp_args())
            return self._run_sdp_loop(sdp_pair, query, data)

    def run_sdp_pool(self, comparisons: list):
        """Pooled device SDP over many deferred comparisons
        (``gam.py:306-415``): every pass batches into a few K6/K7
        launches, then each comparison's result loop runs and submits in
        original order, so the output bytes equal the per-comparison
        path's."""
        args = self._sdp_args()
        metas = []
        jobs = []
        for comp in comparisons:
            if not comp.has_hsps:
                metas.append(None)
                continue
            if self.geneseed_threshold:
                if self.gas.threshold < self.geneseed_threshold:
                    self.gas.threshold = self.geneseed_threshold
                self._geneseed_filter(comp)
                if not comp.has_hsps:
                    metas.append(None)
                    continue
            data = self.make_data(comp.query, comp.target)
            gpair = SDPPair(self.model, comp, data, SubOpt(), args)
            plan = (sdp_hybrid.make_plan(self.model, gpair)
                    if gpair.seeds else None)
            if plan is not None and not sdp_hybrid.device_worthwhile(
                    plan, gpair.region.query_length):
                # small comparison: host scheduler directly
                metas.append((comp, data, gpair, "host"))
                continue
            metas.append((comp, data, gpair, plan))
            if plan is not None:
                jobs.append((gpair, plan))
        # the device batch runs on a worker so that the host-route
        # comparisons overlap it; submission order is unchanged
        dev_fut = None
        if jobs:
            pool = ThreadPoolExecutor(max_workers=1)
            dev_fut = pool.submit(sdp_hybrid.run_device_batch, self.model,
                                  jobs, self.device)
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
                return self._run_sdp_loop(gpair, comp.query, data)
            out = (dev_fut.result()[job_of_meta[mx]]
                   if mx in job_of_meta else None)
            hp = sdp_hybrid.HybridSDPPair(
                self.model, comp, data, gpair.subopt, args,
                device_out=out, plan=plan, gpair=gpair, device=self.device)
            try:
                return self._run_sdp_loop(hp, comp.query, data)
            except sdp_hybrid.HybridFallback:
                pair = SDPPair(self.model, comp, data, SubOpt(), args)
                return self._run_sdp_loop(pair, comp.query, data)

        # host-route metas first: they overlap the device batch
        metas = list(enumerate(metas))
        order = sorted(
            range(len(metas)),
            key=lambda mx: 0 if (metas[mx][1] is not None
                                 and metas[mx][1][3] == "host") else 1)
        n_workers = int(os.environ.get(
            "EXONERATE_TPU_RESOLVE_THREADS",
            str(min(4, os.cpu_count() or 1))))
        if n_workers > 1 and sum(m is not None for _, m in metas) > 1:
            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                ordered = list(ex.map(result_loop,
                                      [metas[mx] for mx in order]))
            all_results = [None] * len(metas)
            for mx, res in zip(order, ordered):
                all_results[mx] = res
        else:
            all_results = [result_loop(m) for m in metas]
        for results in all_results:
            self.submit(results)

    def _make_sdp_pair(self, comparison, data):
        """The device-hybrid pair when the device tier is active, else
        the host pair (native C++ scheduler)."""
        if self.sdp_device_active():
            return sdp_hybrid.HybridSDPPair(
                self.model, comparison, data, SubOpt(), self._sdp_args(),
                device=self.device)
        if os.environ.get("EXONERATE_TPU_SDP", "") == "device":
            observe.count_fallback(
                "sdp device->host: model unsupported on device")
        return SDPPair(self.model, comparison, data, SubOpt(),
                       self._sdp_args())

    def _refine(self, alignment, data, subopt):
        """(ref: GAM_Result_refine_alignment, gam.c:605-655)."""
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

    def result_exhaustive(self, query, target):
        """Exhaustive suboptimal enumeration (ref: OPair +
        GAM_Result_exhaustive_create, gam.c:1140-1180)."""
        data = self.make_data(query, target)
        region = Region(0, 0, len(query), len(target))
        threshold = max(self.query_threshold(query, data), 1) \
            if self.model.is_local else self.query_threshold(query, data)
        subopt = SubOpt() if self.gas.use_subopt else None
        out = []
        while True:
            alignment = optimal.find_path(self.model, region, data,
                                          subopt=subopt, device=self.device)
            if alignment is None or alignment.score < threshold:
                break
            out.append((alignment, data))
            if subopt is None or not self.model.is_local:
                break
            subopt.add_alignment(alignment)
            if self.gas.best_n and len(out) >= max(self.gas.best_n * 4, 16):
                break
        return out
