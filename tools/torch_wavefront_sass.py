#!/usr/bin/env python3
"""Compares the SASS of K2's cluster kernel (``ring_kernel``, every
instantiation) between two checkouts' ``exonerate_tpu_torch/csrc/
wavefront.cu``.  K1/K4 run the model's plan compiled in (the source
built with ``COMPILED_PLAN``); the build without a plan holds
``ring_kernel`` alone, which must keep its code when K1/K4 change.

    python3 tools/torch_wavefront_sass.py OLD_CHECKOUT NEW_CHECKOUT

Each source is compiled with the port's own nvcc flags
(``_cudabuild.NVCC_FLAGS``), without a plan, into a temporary directory
and dumped with ``cuobjdump -sass``; each (mode, full, masked,
smem_ring) instantiation's instructions are compared with their
addresses and encodings stripped.  Prints one line per instantiation
and a JSON summary, and exits 1 when any differs.  Needs the CUDA
toolkit (no card).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from exonerate_tpu_torch import _cudabuild  # noqa: E402

# ring_kernel<MODE, FULL, MASKED, SMEM_RING> in a mangled name
KERNEL = re.compile(r"11ring_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)EE")
INSTR = re.compile(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;")


def ring_sass(checkout: str, tmp: str) -> dict:
    """{(mode, full, masked, smem_ring): [instruction, ...]} of
    ring_kernel in the build of ``checkout``'s wavefront.cu."""
    src = os.path.join(checkout, "exonerate_tpu_torch", "csrc",
                       "wavefront.cu")
    lib = os.path.join(tmp, f"lib{abs(hash(checkout))}.so")
    flags = [f for f in _cudabuild.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_cudabuild._nvcc(), *flags, "-o", lib, src],
                   check=True, capture_output=True, timeout=900)
    cuobjdump = os.path.join(os.path.dirname(_cudabuild._nvcc()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", dump)[1:]:
        name, body = block.split("\n", 1)
        m = KERNEL.search(name)
        if m:
            out[m.groups()] = INSTR.findall(body)
    return out


def main() -> int:
    old_dir, new_dir = sys.argv[1:3]
    with tempfile.TemporaryDirectory() as tmp:
        old = ring_sass(old_dir, tmp)
        new = ring_sass(new_dir, tmp)
    same = 0
    for key in sorted(old):
        a, b = old[key], new.get(key, [])
        ok = a == b
        same += ok
        print(f"ring_kernel<mode {key[0]}, full {key[1]}, masked {key[2]}, "
              f"smem_ring {key[3]}>: {len(a)} / {len(b)} instructions, "
              f"{'identical' if ok else 'DIFFERENT'}")
        if not ok and b:
            # where they part: the positions that differ, whether the
            # same instructions were only reordered, and the first few
            at = [n for n, (x, y) in enumerate(zip(a, b)) if x != y]
            print(f"  {len(at)} positions differ; the same instructions "
                  f"reordered: {sorted(a) == sorted(b)}")
            for n in at[:4]:
                print(f"  {n}: {a[n]!r} -> {b[n]!r}")
    print(json.dumps({"instantiations": len(old), "identical": same,
                      "new_has": len(new)}))
    return 0 if old and same == len(old) == len(new) else 1


if __name__ == "__main__":
    sys.exit(main())
