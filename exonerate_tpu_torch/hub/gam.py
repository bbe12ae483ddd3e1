"""GAM of the port: the JAX package's GAM with the port's optimal.

Counterpart of ``exonerate_tpu/hub/gam.py``.  Only the methods that reach
a JAX engine are overridden: the exhaustive enumeration and refinement
call the port's ``optimal.find_path`` on the GAM's device, and the
device SDP pool stays off until the band kernels (K6/K7) are ported, so
the seeded heuristic runs on the host native engines.
"""
from __future__ import annotations

import torch

from exonerate_tpu.engine.region import Region
from exonerate_tpu.engine.subopt import SubOpt
from exonerate_tpu.hub import gam as jax_gam
from exonerate_tpu.hub.gam import Refinement

from ..engine import optimal


class GAM(jax_gam.GAM):
    def __init__(self, *args, device: torch.device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device

    def sdp_device_active(self) -> bool:
        """The SDP band kernels are not ported: the heuristic's passes
        run on the host engines."""
        return False

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
