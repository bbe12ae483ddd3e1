"""Builds the port's CUDA sources into shared libraries with a plain C ABI.

Counterpart of ``exonerate_tpu/_nativebuild.py``.  Each ``csrc/<stem>.cu``
is compiled by ``nvcc`` for Hopper (``sm_90a``) at first use into
``build/cuda/lib<stem>-<sha>.so`` beside the package, keyed by the
content of the source and of every ``csrc/*.cuh`` header, and loaded
with ``ctypes``.  No PyTorch headers are included, so a build takes
seconds.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    path: str
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output, including the -Xptxas -v lines


_lock = threading.Lock()            # guards _stem_locks
_stem_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
builds: dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed (set CUDA_HOME)")


def build(stem: str) -> Built:
    """Compile csrc/<stem>.cu unless a build of the same content exists."""
    src = os.path.join(CSRC, stem + ".cu")
    h = hashlib.sha1()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return Built(so, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return Built(so, time.perf_counter() - t0, proc.stdout + proc.stderr)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for csrc/<stem>.cu, built on first use.  Safe to
    call from several threads: each source has its own lock, so different
    sources build at once."""
    with _lock:
        stem_lock = _stem_locks.setdefault(stem, threading.Lock())
    with stem_lock:
        lib = _loaded.get(stem)
        if lib is None:
            built = build(stem)
            builds[stem] = built
            lib = _loaded[stem] = ctypes.CDLL(built.path)
        return lib
