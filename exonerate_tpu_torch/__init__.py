"""exonerate_tpu_torch — exonerate_tpu on PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``exonerate_tpu`` that imports nothing of it.
The host layer (sequences, matrices, the model IR and models, seeding,
the NumPy oracles, the native C++ engines ``sdplib.cpp`` / ``seedlib.cpp``
and the output formats) is the port's own copy, under the same relative
paths and names; ``tests/test_torch_vendored.py`` holds every copy's
text equal to its JAX-package module so that the two cannot drift.  The
modules that reach JAX there (the engines, ``hub/gam.py``,
``hub/analysis.py``, ``cli/exonerate.py``) have counterparts here.  The
exhaustive anti-diagonal Viterbi and the seeded heuristic's band scan
run on hand-written CUDA kernels (``csrc/``), with a plain PyTorch
version of each kernel beside it for CPU tensors.

The device is explicit: ``device()`` resolves it once and callers pass
the ``torch.device`` down.  There is no silent fall-back to the CPU.
"""
from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

IMPOSSIBLY_LOW_SCORE = -987654321   # ref: src/c4/c4.h:29
IMPOSSIBLY_HIGH_SCORE = 987654321   # ref: src/c4/c4.h:30

DEVICE_ENV = "EXONERATE_TPU_TORCH_DEVICE"


def device(name: str | None = None) -> torch.device:
    """The port's compute device: ``name``, else $EXONERATE_TPU_TORCH_DEVICE,
    else ``cuda``.  Asking for CUDA where PyTorch sees no card raises."""
    name = name or os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"exonerate_tpu_torch: device {name!r} requested but "
            f"torch.cuda.is_available() is False (set {DEVICE_ENV}=cpu "
            f"to run the plain PyTorch engines on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"exonerate_tpu_torch: unsupported device {name!r}")
    return dev
