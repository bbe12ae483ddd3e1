"""Analysis of the port: the JAX package's Analysis with the port's GAM.

Counterpart of ``exonerate_tpu/hub/analysis.py``.  Everything but the
GAM is inherited.  Two routes of the JAX Analysis reach JAX and are not
ported yet, so they are refused with a clear error: ``--cores N`` with
N > 1 (one device per worker, ``analysis.py:114-116``) and the pooled
locus heuristic ``EXONERATE_TPU_HEURISTIC=locus`` (``analysis.py:426``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from exonerate_tpu.hub import analysis as jax_analysis

from .. import device as default_device
from .gam import GAM


class Analysis(jax_analysis.Analysis):
    def __init__(self, *args, device: Optional[torch.device] = None,
                 **kwargs):
        aas = kwargs.get("aas")
        if aas is not None and aas.cores > 1:
            raise SystemExit("exonerate: --cores > 1 is not ported to "
                             "exonerate_tpu_torch yet")
        if os.environ.get("EXONERATE_TPU_HEURISTIC") == "locus":
            raise SystemExit("exonerate: EXONERATE_TPU_HEURISTIC=locus is "
                             "not ported to exonerate_tpu_torch yet")
        dev = device if device is not None else default_device()
        super().__init__(*args, **kwargs)
        jax_gam = self.gam
        self.gam = GAM(self.model, self.gas, self._make_data,
                       out=jax_gam.out, device=dev)
        self.gam.geneseed_threshold = jax_gam.geneseed_threshold
