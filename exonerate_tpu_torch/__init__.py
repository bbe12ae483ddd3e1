"""exonerate_tpu_torch — exonerate_tpu on PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``exonerate_tpu``: the host layer (sequences,
models, seeding, native engines, output) is shared by import, and every
module of the JAX package that reaches JAX has a counterpart here under
the same name.  The exhaustive anti-diagonal Viterbi runs on
hand-written CUDA kernels (``csrc/``), with a plain PyTorch version of
each kernel beside it for CPU tensors.

The device is explicit: ``device()`` resolves it once and callers pass
the ``torch.device`` down.  There is no silent fall-back to the CPU.
"""
from __future__ import annotations

import os

import torch

__version__ = "0.1.0"

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
