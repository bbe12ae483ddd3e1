#!/usr/bin/env python3
"""Which instructions T1's narrow dtypes can issue on one card.

    python3 tools/torch_vpu16_forms.py [--out FILE]

T1 (``csrc/vpu16.cu``) counts one instruction per counted op and lane; a
packed case is only worth its lanes where the card issues the op over
them in fewer instructions than the unpacked form.  This script builds
candidate forms of the int16, int8 and bfloat16 cases (the PTX of each
round guarded by the two run-time-true predicates, as in T1), prints the
SASS opcode counts of each (``cuobjdump -sass``), holds each to
``exonerate_tpu_torch.tools.vpu16.plain`` at 64 rounds exactly, and
times each at T1's shape (B x W elements, 4352 x 16 rounds, CUDA
events, best of 3):

- int16 add: ``add.s16`` one element a thread (T1's form), two halves of
  a register a thread, ``vadd2``, and the masked 32-bit add (the low 15
  bits' sum, the sign bits put back by xor);
- int16 mix16: one element a thread (T1's form), and ``vadd2`` /
  ``vset2`` / ``vsub2`` with a lop3 select on a two-half register;
- int8 add: the masked 32-bit add over four byte lanes (T1's form: the
  low seven bits' sum, the sign bits put back by xor), the same with the
  sign bits' (a ^ b) & 0x80.. as one lop3, ``vadd4``;
- bfloat16 add: ``add.rn.bf16x2`` (T1's form), ``fma.rn.bf16x2`` with
  a register of ones, and ``add.rn.bf16x2`` without the guards (what
  the guards cost: ptxas computes a guarded bf16x2 op unconditionally and
  moves it into place under the predicate, an extra MOV on the chain).

Prints one JSON line per form and the card's name and power limit, and
writes the lines to ``--out`` when given.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
#define X2(s) s s
#define X4(s) X2(X2(s))
#define X16(s) X4(X4(s))
#define X32(s) X2(X16(s))
#define LOOP(TYPE, DECL, INIT, BODY, FINI)                                 \
    "{\n\t.reg .pred p, q, g, more;\n\t.reg .b32 n, z;\n\t.reg " TYPE      \
    " B;\n\t" DECL "mov" TYPE " B, %1;\n\tmov.b32 z, 0;\n\t"               \
    "setp.ne.s32 p, %2, 0;\n\tsetp.ne.s32 q, %3, 0;\n\tmov.b32 n, %4;\n\t" \
    INIT "L0:\n\t" BODY "sub.s32 n, n, 64;\n\tsetp.gt.s32 more, n, 0;\n\t" \
    "@more bra L0;\n\t" FINI "}"
#define K(NAME, REG, CON, TYPE, DECL, INIT, BODY, FINI)                    \
    __global__ void NAME(const REG* x, REG* o, int n, int r, int on0,      \
                         int on1) {                                        \
        int i = blockIdx.x * 256 + threadIdx.x;                            \
        if (i >= n) return;                                                \
        REG b = x[i], a = b;                                               \
        asm volatile(LOOP(TYPE, DECL, INIT, BODY, FINI) : "+" CON(a)       \
                     : CON(b), "r"(on0), "r"(on1), "r"(r));                \
        o[i] = a;                                                          \
    }
// int16 add
#define ADD16(P) "@" P " add.s16 %0, %0, B;\n\t"
#define PAIR16(P) "@" P " add.s16 a0, a0, b0;\n\t@" P " add.s16 a1, a1, b1;\n\t"
#define VADD2(P) "@" P " vadd2.s32.s32.s32 %0, %0, B, z;\n\t"
#define MASK16(P)                                                          \
    "@" P " and.b32 t, %0, 0x7fff7fff;\n\t@" P " add.s32 t, t, L;\n\t"     \
    "@" P " xor.b32 u, %0, B;\n\t@" P " and.b32 u, u, 0x80008000;\n\t"    \
    "@" P " xor.b32 %0, t, u;\n\t"
K(i16_add_one, uint16_t, "h", ".b16", "", "", X32(ADD16("p") ADD16("q")), "")
K(i16_add_pair, uint32_t, "r", ".b32",
  ".reg .b16 a0, a1, b0, b1;\n\t",
  "mov.b32 {a0, a1}, %0;\n\tmov.b32 {b0, b1}, B;\n\t",
  X32(PAIR16("p") PAIR16("q")), "mov.b32 %0, {a0, a1};\n\t")
K(i16_add_vadd2, uint32_t, "r", ".b32", "", "", X32(VADD2("p") VADD2("q")),
  "")
K(i16_add_mask, uint32_t, "r", ".b32", ".reg .b32 t, u, L;\n\t",
  "and.b32 L, B, 0x7fff7fff;\n\t", X32(MASK16("p") MASK16("q")), "")
// int16 mix16
#define MIX16                                                              \
    "@p add.s16 %0, %0, B;\n\t@q setp.gt.s16 g, %0, B;\n\t"                \
    "@p selp.b16 %0, %0, B, g;\n\t@q setp.gt.s16 g, %0, B;\n\t"            \
    "@p sub.s16 d, %0, B;\n\t@q selp.b16 %0, d, %0, g;\n\t"
#define MIXV(P, Q)                                                         \
    "@" P " vadd2.s32.s32.s32 %0, %0, B, z;\n\t"                          \
    "@" Q " vset2.s32.s32.gt m, %0, B, z;\n\t"                             \
    "@" Q " vsub2.s32.s32.s32 m, z, m, z;\n\t"                             \
    "@" P " lop3.b32 %0, %0, B, m, 0xe4;\n\t"                             \
    "@" Q " vset2.s32.s32.gt m, %0, B, z;\n\t"                             \
    "@" Q " vsub2.s32.s32.s32 m, z, m, z;\n\t"                             \
    "@" P " vsub2.s32.s32.s32 d, %0, B, z;\n\t"                           \
    "@" Q " lop3.b32 %0, d, %0, m, 0xe4;\n\t"
K(i16_mix16_one, uint16_t, "h", ".b16", ".reg .b16 d;\n\t", "",
  X32(MIX16 MIX16), "")
K(i16_mix16_video, uint32_t, "r", ".b32", ".reg .b32 m, d;\n\t", "",
  X32(MIXV("p", "q") MIXV("q", "p")), "")
// int8 add
#define MASK8(P)                                                           \
    "@" P " and.b32 t, %0, 0x7f7f7f7f;\n\t@" P " add.s32 t, t, L;\n\t"     \
    "@" P " xor.b32 u, %0, B;\n\t@" P " and.b32 u, u, 0x80808080;\n\t"    \
    "@" P " xor.b32 %0, t, u;\n\t"
#define LOP8(P)                                                            \
    "@" P " and.b32 t, %0, 0x7f7f7f7f;\n\t@" P " add.s32 t, t, L;\n\t"     \
    "@" P " lop3.b32 u, %0, B, 0x80808080, 0x28;\n\t"                       \
    "@" P " xor.b32 %0, t, u;\n\t"
#define VADD4(P) "@" P " vadd4.s32.s32.s32 %0, %0, B, z;\n\t"
K(i8_add_mask, uint32_t, "r", ".b32", ".reg .b32 t, u, L;\n\t",
  "and.b32 L, B, 0x7f7f7f7f;\n\t", X32(MASK8("p") MASK8("q")), "")
K(i8_add_lop3, uint32_t, "r", ".b32", ".reg .b32 t, u, L;\n\t",
  "and.b32 L, B, 0x7f7f7f7f;\n\t", X32(LOP8("p") LOP8("q")), "")
K(i8_add_vadd4, uint32_t, "r", ".b32", "", "", X32(VADD4("p") VADD4("q")),
  "")
// bfloat16 add
#define BADD(P) "@" P " add.rn.bf16x2 %0, %0, B;\n\t"
#define BFMA(P) "@" P " fma.rn.bf16x2 %0, %0, one, B;\n\t"
K(bf16_add_add, uint32_t, "r", ".b32", "", "", X32(BADD("p") BADD("q")), "")
K(bf16_add_fma, uint32_t, "r", ".b32", ".reg .b32 one;\n\t",
  "mov.b32 one, 0x3f803f80;\n\t", X32(BFMA("p") BFMA("q")), "")
// unguarded, for the guards' cost only: T1 keeps its guards
K(bf16_add_unguarded, uint32_t, "r", ".b32", "", "",
  X32("add.rn.bf16x2 %0, %0, B;\n\tadd.rn.bf16x2 %0, %0, B;\n\t"), "")

typedef void (*Fn)(const void*, void*, int, int, int, int);
static Fn fns[] = {
    (Fn)i16_add_one, (Fn)i16_add_pair, (Fn)i16_add_vadd2, (Fn)i16_add_mask,
    (Fn)i16_mix16_one, (Fn)i16_mix16_video, (Fn)i8_add_mask,
    (Fn)i8_add_lop3, (Fn)i8_add_vadd4, (Fn)bf16_add_add, (Fn)bf16_add_fma,
    (Fn)bf16_add_unguarded};
extern "C" int forms_launch(int which, const void* x, void* o, int n, int r,
                            void* s) {
    fns[which]<<<(n + 255) / 256, 256, 0, (cudaStream_t)s>>>(x, o, n, r, 1,
                                                             1);
    return (int)cudaGetLastError();
}
'''

# (kernel, dtype, mix, lanes a thread): the order of fns[] above
FORMS = (("i16_add_one", torch.int16, "add", 1),
         ("i16_add_pair", torch.int16, "add", 2),
         ("i16_add_vadd2", torch.int16, "add", 2),
         ("i16_add_mask", torch.int16, "add", 2),
         ("i16_mix16_one", torch.int16, "mix16", 1),
         ("i16_mix16_video", torch.int16, "mix16", 2),
         ("i8_add_mask", torch.int8, "add", 4),
         ("i8_add_lop3", torch.int8, "add", 4),
         ("i8_add_vadd4", torch.int8, "add", 4),
         ("bf16_add_add", torch.bfloat16, "add", 2),
         ("bf16_add_fma", torch.bfloat16, "add", 2),
         ("bf16_add_unguarded", torch.bfloat16, "add", 2))


def _sass(path: str) -> dict:
    tool = "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = out.setdefault(m.group(1), Counter())
            continue
        m = re.match(
            r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and fn is not None and m.group(1) != "NOP":
            fn[m.group(1)] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    from exonerate_tpu_torch import _cudabuild
    from exonerate_tpu_torch.tools import vpu16 as t1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    os.makedirs(_cudabuild.BUILD_DIR, exist_ok=True)
    src = os.path.join(_cudabuild.BUILD_DIR, "vpu16_forms.cu")
    lib_path = os.path.join(_cudabuild.BUILD_DIR, "libvpu16_forms.so")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    subprocess.run([_cudabuild._nvcc(), *_cudabuild.NVCC_FLAGS, "-o",
                    lib_path, src], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.forms_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    sass = _sass(lib_path)
    dev = torch.device("cuda", 0)
    rounds = t1.STEPS * t1.ITERS
    lines = []
    for w, (name, dtype, mix, lanes) in enumerate(FORMS):
        x = t1.inputs(dtype, 0, dev)
        slots = x.numel() // lanes

        def run(r, out):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.forms_launch(w, x.data_ptr(), out.data_ptr(), slots, r,
                                  stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return out

        got = run(64, torch.empty_like(x))
        exact = torch.equal(got, t1.plain(x, mix, 64 // t1.ITERS))
        out = torch.empty_like(x)
        run(rounds, out)
        times = []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            run(rounds, out)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        ops = [c for fn, c in sass.items() if name in fn]
        line = {"form": name, "dtype": str(dtype).split(".")[-1], "mix": mix,
                "lanes": lanes, "exact": exact, "ms": min(times),
                "sass_per_64_rounds": dict(ops[0].most_common()) if ops
                else None, "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(json.dumps(ln) for ln in lines) + "\n")
    return 0 if all(ln["exact"] for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
