"""Builds the port's CUDA sources into shared libraries with a plain C ABI.

Counterpart of ``exonerate_tpu/_nativebuild.py``.  Each ``csrc/<stem>.cu``
is compiled by ``nvcc`` for Hopper (``sm_90a``) at first use into
``build/cuda/lib<stem>-<sha>.so`` beside the package, keyed by the
content of the source and of every ``csrc/*.cuh`` header, and loaded
with ``ctypes``.  A kernel that runs a model's plan compiled in
(``engine/plan_cuda.py``) is built once per plan: the generated header
is written to ``build/cuda/plan-<stem>-<sha>/plan.h``, the source
compiled with ``-DCOMPILED_PLAN`` and that directory on its include
path, and the key covers the header's text too.  No PyTorch headers are
included, so a build takes seconds.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional

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


_lock = threading.Lock()            # guards _stem_locks (one per library)
_stem_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
builds: dict[str, Built] = {}
_keys: dict = {}


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


def key(stem: str, header: Optional[str] = None) -> str:
    """The build key of csrc/<stem>.cu (with a compiled plan's header):
    a hash of the source, every csrc/*.cuh and the header's text
    (cached: the sources do not change under a running process)."""
    got = _keys.get((stem, header))
    if got is not None:
        return got
    h = hashlib.sha1()
    for path in [os.path.join(CSRC, stem + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    if header is not None:
        h.update(b"\0plan\0" + header.encode())
    got = _keys[(stem, header)] = h.hexdigest()[:16]
    return got


def build(stem: str, header: Optional[str] = None) -> Built:
    """Compile csrc/<stem>.cu (with ``header`` as its compiled plan)
    unless a build of the same content exists."""
    src = os.path.join(CSRC, stem + ".cu")
    sha = key(stem, header)
    so = os.path.join(BUILD_DIR, f"lib{stem}-{sha}.so")
    if os.path.exists(so):
        return Built(so, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    extra = []
    if header is not None:
        inc = os.path.join(BUILD_DIR, f"plan-{stem}-{sha}")
        os.makedirs(inc, exist_ok=True)
        tmp_h = os.path.join(inc, f"plan.h.tmp{os.getpid()}")
        with open(tmp_h, "w") as fh:
            fh.write(header)
        os.replace(tmp_h, os.path.join(inc, "plan.h"))
        extra = ["-DCOMPILED_PLAN", "-I", inc]
    tmp = f"{so}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC, *extra, "-o",
                           tmp, src],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return Built(so, time.perf_counter() - t0, proc.stdout + proc.stderr)


def name(stem: str, header: Optional[str] = None) -> str:
    """The name of a library in ``builds``: the stem, or for a compiled
    plan ``<stem>-<key>``."""
    return stem if header is None else f"{stem}-{key(stem, header)}"


def load(stem: str, header: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library for csrc/<stem>.cu (compiled with the plan
    ``header``), built on first use.  Safe to call from several threads:
    each library has its own lock, so different ones build at once."""
    lib_name = name(stem, header)
    with _lock:
        lib_lock = _stem_locks.setdefault(lib_name, threading.Lock())
    with lib_lock:
        lib = _loaded.get(lib_name)
        if lib is None:
            built = build(stem, header)
            builds[lib_name] = built
            lib = _loaded[lib_name] = ctypes.CDLL(built.path)
        return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_TEMPLATE = re.compile(r"\d([a-z]+_kernel)I((?:L[bi]\d+E)+)E")


def ptxas_report(log: str) -> list:
    """One line per kernel of a build's ``-Xptxas -v`` log: its name with
    its template arguments, registers, stack frame and spill bytes."""
    out, name = [], None
    frame = ""
    for ln in log.splitlines():
        m = _ENTRY.search(ln)
        if m:
            t = _TEMPLATE.search(m.group(1))
            name = (f"{t.group(1)}<"
                    + ", ".join(re.findall(r"L[bi](\d+)E", t.group(2)))
                    + ">") if t else m.group(1)
            frame = ""
        elif name and "stack frame" in ln:
            frame = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {frame}")
            name = None
    return out
