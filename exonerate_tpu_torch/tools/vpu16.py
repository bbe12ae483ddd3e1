"""T1, the elementwise-throughput probe, on the card.

Counterpart of ``tools/vpu16.py`` (``build:29``, ``pl.pallas_call`` at
``:60``), which times the TPU's vector unit on the wavefront's op mix
(add, compare, select, max) per dtype, to learn whether narrowing the
score planes from int32 would buy anything.  Here the kernel is
``csrc/vpu16.cu``: ``LANES`` elements per thread in one 32-bit register
(two for bfloat16, four for int8; one for int16, whose ops the card has
no packed form of), the accumulator in a register, ``steps * iters``
rounds of the mix with ``b = x``; ``plain`` is the same loop of torch
ops, for the CPU tests and the check on the card.

    python -m exonerate_tpu_torch.tools.vpu16 [--sass]

prints, on the card, each case's best of five runs (CUDA events), its
rate and its bound: the counted element operations over the card's
peak for the instruction the case issues, at 132 SMs and 1.98 GHz.  The
peaks, in results per SM per clock, from the CUDA C++ Programming
Guide's arithmetic-instruction throughput table for compute capability
9.0, times ``LANES``, the lanes each issued instruction computes:
- 32-bit integer add (the row "32-bit integer add, extended-precision
  add, subtract"): 64 on the integer pipe (IADD3) and 64 on the
  multiply-add pipe, where ptxas issues the other adds as IMAD.IADD, so
  128 instructions a clock; int32 one lane, int16 one (its ops are
  unpacked: the card has no .s16x2 add, sub or compare;
  ``tools/torch_vpu16_forms.py`` times the packed candidates), int8 four
  (its add is a 32-bit add over four byte lanes), so 128 / 128 / 512;
- float32 ("32-bit floating-point add, multiply, multiply-add"): 128;
- bfloat16 ("16-bit floating-point add, multiply, multiply-add", bf16x2
  counted as two results): 256.
``--sass`` also prints each instantiation's instructions from
``cuobjdump -sass`` of the build.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from collections import Counter
from typing import Optional

import numpy as np
import torch

from .. import _cudabuild
from ..engine.cuda_wavefront import _lib, count

B, W = 64, 2304
STEPS = 4352
ITERS = 16
UNROLL = 64          # csrc/vpu16.cu's rounds per loop pass: steps * iters % 64 == 0
REPS = 5             # timed runs of each case (the JAX tool's best of 5)

CASES = ((torch.int32, "add"), (torch.int32, "mix"),
         (torch.int16, "add"), (torch.int16, "mix16"),
         (torch.float32, "add"), (torch.float32, "mix"),
         (torch.bfloat16, "add"), (torch.bfloat16, "mix"),
         (torch.int8, "add"))
OPS_PER_ITER = {"add": 1, "mix": 6, "mix16": 6}
_DTYPE_CODE = {torch.int32: 0, torch.int16: 1, torch.float32: 2,
               torch.bfloat16: 3, torch.int8: 4}
_MIX_CODE = {"add": 0, "mix": 1, "mix16": 2}

# elements per thread, the lanes of its 32-bit register (csrc/vpu16.cu's
# Lanes): each instruction a case issues computes all of them
LANES = {torch.int32: 1, torch.int16: 1, torch.float32: 1,
         torch.bfloat16: 2, torch.int8: 4}
# the card's peak for the instruction each dtype's case issues, results
# (lanes) per SM per clock: 128 instructions a clock x LANES
PEAK_PER_SM_CLOCK = {d: 128 * n for d, n in LANES.items()}
SMS, CLOCK_HZ = 132, 1.98e9


def peak_ops_s(dtype: torch.dtype) -> float:
    return PEAK_PER_SM_CLOCK[dtype] * SMS * CLOCK_HZ


def n_ops(mix: str, n: int = B * W, steps: int = STEPS,
          iters: int = ITERS) -> int:
    """The counted operations of one run (the JAX tool's count)."""
    return n * steps * iters * OPS_PER_ITER[mix]


def bound_ms(dtype: torch.dtype, mix: str, n: int = B * W,
             steps: int = STEPS, iters: int = ITERS) -> float:
    """The least time the card could take: the counted element operations
    over the dtype's peak (one read of x and one write are negligible)."""
    return n_ops(mix, n, steps, iters) / peak_ops_s(dtype) * 1e3


def _check_case(dtype: torch.dtype, mix: str) -> None:
    if (dtype, mix) not in CASES:
        raise ValueError(f"vpu16: no case ({dtype}, {mix!r}); the cases "
                         f"are {CASES}")


def plain(x: torch.Tensor, mix: str, steps: int = STEPS,
          iters: int = ITERS) -> torch.Tensor:
    """The plain PyTorch version: the TPU kernel's loop as torch ops in
    x's dtype (each op wraps or rounds in the dtype, as there)."""
    _check_case(x.dtype, mix)
    a, b = x.clone(), x
    for _ in range(steps * iters):
        if mix == "add":
            a = a + b
        elif mix == "mix":
            a = a + b
            a = torch.maximum(a, b)
            a = torch.where(a > b, a - b, a)
            a = a - 1
        else:
            a = a + b
            a = torch.where(a > b, a, b)
            a = torch.where(a > b, a - b, a)
    return a


def vpu16(x: torch.Tensor, mix: str, steps: int = STEPS,
          iters: int = ITERS) -> torch.Tensor:
    """T1 on x: the kernel on a card, the plain version for a CPU tensor.
    Returns the accumulator after ``steps * iters`` rounds."""
    _check_case(x.dtype, mix)
    rounds = steps * iters
    if rounds % UNROLL:
        raise ValueError(f"vpu16: steps * iters = {rounds} is not a "
                         f"multiple of {UNROLL}")
    if not x.is_contiguous():
        raise ValueError("vpu16: x must be contiguous")
    if x.numel() % LANES[x.dtype]:
        raise ValueError(f"vpu16: {x.numel()} elements of {x.dtype} do not "
                         f"fill registers of {LANES[x.dtype]}")
    if x.device.type == "cpu":
        return plain(x, mix, steps, iters)
    if x.device.type != "cuda":
        raise ValueError(f"vpu16: no kernel for device {x.device}")
    fn = _lib("vpu16", "vpu16_launch",
              [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(_DTYPE_CODE[x.dtype], _MIX_CODE[mix], x.data_ptr(),
                out.data_ptr(), x.numel(), rounds, stream)
    if rc != 0:
        raise RuntimeError(f"vpu16 kernel launch failed: CUDA error {rc}")
    count(vpu16)
    return out


vpu16.launches = 0


def build(dtype: torch.dtype, mix: str):
    """(fn, ops_per_iter), as the JAX tool's ``build``: fn(x) runs the
    kernel over x on the card for STEPS steps of ITERS rounds.  Builds
    the kernel at first use; raises where there is no card."""
    _check_case(dtype, mix)
    if not torch.cuda.is_available():
        raise RuntimeError("vpu16: the kernel runs on a CUDA card; "
                           "torch.cuda.is_available() is False")
    _cudabuild.load("vpu16")

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda" or x.dtype != dtype:
            raise ValueError(f"vpu16: want {dtype} on a card, got "
                             f"{x.dtype} on {x.device}")
        return vpu16(x, mix)

    return fn, OPS_PER_ITER[mix]


def case_name(dtype: torch.dtype, mix: str) -> str:
    return f"{str(dtype).split('.')[-1]:9s} {mix:6s}"


def inputs(dtype: torch.dtype, seed: int = 0,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """x of the tool's shape: integers 1-49 from ``seed``, in ``dtype``."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(1, 50, (B, W)), dtype=dtype,
                        device=device)


def time_case(dtype: torch.dtype, mix: str, x: torch.Tensor,
              reps: int = REPS) -> tuple:
    """(best ms of ``reps`` runs by CUDA events, the output) of one case,
    after one run to warm up."""
    fn, _ = build(dtype, mix)
    out = fn(x)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), out


def run(seed: int = 0) -> list:
    """Every case at the tool's shape, timed: [dict(dtype, mix, name, ms,
    ops, rate (op/s), peak (op/s), bound_ms, out)], printing the JAX
    tool's line for each with its bound."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for dtype, mix in CASES:
        ms, out = time_case(dtype, mix, inputs(dtype, seed, dev))
        ops = n_ops(mix)
        row = dict(dtype=dtype, mix=mix, name=case_name(dtype, mix), ms=ms,
                   ops=ops, rate=ops / ms * 1e3, peak=peak_ops_s(dtype),
                   bound_ms=bound_ms(dtype, mix), out=out)
        rows.append(row)
        over = "  OVER THE PEAK" if row["rate"] > row["peak"] else ""
        print(f"{row['name']} {ms:8.3f} ms  {row['rate'] / 1e12:6.2f} T "
              f"op/s  bound {row['bound_ms']:.3f} ms "
              f"({row['peak'] / 1e12:.2f} T op/s){over}", flush=True)
    return rows


def sass() -> dict:
    """Opcode counts of each kernel instantiation in ``cuobjdump -sass``
    of the build: {function: Counter(opcode)}."""
    lib = _cudabuild.load("vpu16")
    del lib
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", _cudabuild.builds["vpu16"].path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out: dict = {}
    fn = None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = out.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     ln)
        if m and fn is not None:
            fn[m.group(1)] += 1
    return out


def issued(counts: dict, dtype: torch.dtype, mix: str) -> int:
    """The element slots the case's instantiation in ``sass()``'s counts
    issues: its instructions (NOPs aside; its loop of UNROLL rounds and a
    few dozen of set-up) times ``LANES[dtype]``, the lanes each one
    computes.  Under ``counted(dtype, mix)`` the build issues fewer
    instructions than the ops it counts (rounds folded or merged)."""
    tag = f"ILi{_DTYPE_CODE[dtype]}ELi{_MIX_CODE[mix]}E"
    found = [c for fn, c in counts.items() if tag in fn]
    if len(found) != 1:
        raise RuntimeError(f"vpu16: {len(found)} instantiations of "
                           f"{case_name(dtype, mix)} in the SASS")
    return LANES[dtype] * sum(n for op, n in found[0].items()
                              if op != "NOP")


def counted(dtype: torch.dtype, mix: str) -> int:
    """The element ops of UNROLL rounds of one register's LANES elements,
    which ``issued`` must reach."""
    return OPS_PER_ITER[mix] * UNROLL * LANES[dtype]


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(f"device: {torch.cuda.get_device_name(0)}")
    run()
    if "--sass" in argv:
        for fn, ops in sass().items():
            print(f"{fn}: " + ", ".join(f"{k} {v}" for k, v in
                                        ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
