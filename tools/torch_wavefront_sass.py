#!/usr/bin/env python3
"""Compares the SASS of K1/K4 (``plan_kernel``) between two checkouts'
``exonerate_tpu_torch/csrc/wavefront.cu``, each built on the same
compiled plans, and reports every kernel's registers and spills in the
second checkout's builds.

    python3 tools/torch_wavefront_sass.py OLD_CHECKOUT NEW_CHECKOUT

The plans are this checkout's headers (``plan_cuda.wave_header``, from
small CPU inputs) of est2genome in score, region and path modes and of
protein2genome in region mode (a FULL plan: K9 and six lanes).  Each
source is compiled with the port's own nvcc flags
(``_cudabuild.NVCC_FLAGS``) and ``-DCOMPILED_PLAN`` into a temporary
directory and dumped with ``cuobjdump -sass``; each plan's
``plan_kernel<MASKED>`` instructions are compared with their addresses
and encodings stripped, exactly and with the kernel parameters' offsets
in the constant bank masked (a change of the parameter struct moves
them).  Prints one line per instantiation, the ``-Xptxas -v`` line of
every kernel of the second checkout (and of the first's
``plan_kernel``), and a JSON summary; exits 1 when an
instantiation differs beyond its parameter offsets.  Needs the CUDA
toolkit (no card).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

from exonerate_tpu_torch import _cudabuild  # noqa: E402

# plan_kernel<MASKED> in a mangled name
KERNEL = re.compile(r"11plan_kernelILb(\d)EE")
INSTR = re.compile(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;")
PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def headers() -> dict:
    """{label: header text} of the compared plans."""
    import torch_split_cases as sc
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import wavefront as wf
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.model import registry
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.model.est2genome import est2genome_create
    from exonerate_tpu_torch.seqio import Sequence, iter_fasta
    cpu = torch.device("cpu")
    calm = next(iter(iter_fasta(os.path.join(ROOT, "tests", "golden",
                                             "data", "all4.fa"))))
    q, t = sc.small_pair("protein", cuts=sc.CUTS)
    p2g = registry.get_model(registry.ModelType.PROTEIN2GENOME,
                             registry.AlphabetType.PROTEIN,
                             registry.AlphabetType.DNA)
    jobs = [(est2genome_create(), Region(0, 0, 60, 80),
             AlignData(calm, calm), ("score", "region", "path")),
            (p2g, Region(0, 0, len(q), len(t)),
             AlignData(Sequence("q", None, q), Sequence("t", None, t),
                       False), ("region",))]
    out = {}
    for model, region, data, modes in jobs:
        pads = (wf._bucket(region.query_length),
                wf._bucket(region.target_length))
        inputs, kinds = wf.prepare_inputs(model, region, data, pad_to=pads,
                                          for_pallas=True)
        for mode in modes:
            out[f"{model.name} {mode}"] = cw.to_kernel_inputs(
                model, inputs, kinds, cpu, mode).header
    return out


def build(checkout: str, header: str, tmp: str, tag: str) -> tuple:
    """({masked: [instruction, ...]} of plan_kernel, the ptxas lines) of
    ``checkout``'s wavefront.cu built on ``header``."""
    src = os.path.join(checkout, "exonerate_tpu_torch", "csrc",
                       "wavefront.cu")
    inc = os.path.join(tmp, f"inc-{tag}")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "plan.h"), "w") as fh:
        fh.write(header)
    lib = os.path.join(tmp, f"lib-{tag}.so")
    proc = subprocess.run([_cudabuild._nvcc(), *_cudabuild.NVCC_FLAGS,
                           "-DCOMPILED_PLAN", "-I", inc, "-o", lib, src],
                          check=True, capture_output=True, text=True,
                          timeout=900)
    cuobjdump = os.path.join(os.path.dirname(_cudabuild._nvcc()),
                             "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", dump)[1:]:
        name, body = block.split("\n", 1)
        m = KERNEL.search(name)
        if m:
            out[m.group(1)] = INSTR.findall(body)
    return out, _cudabuild.ptxas_report(proc.stdout + proc.stderr)


def main() -> int:
    old_dir, new_dir = sys.argv[1:3]
    rows, identical, offsets_only, differ = [], 0, 0, 0
    plans = list(headers().items())
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            os.cpu_count() or 4) as ex:
        # every build at once, one nvcc each
        builds = [(ex.submit(build, old_dir, header, tmp, f"old{n}"),
                   ex.submit(build, new_dir, header, tmp, f"new{n}"))
                  for n, (_label, header) in enumerate(plans)]
        for (label, _header), (old_f, new_f) in zip(plans, builds):
            old, old_ptxas = old_f.result()
            new, ptxas = new_f.result()
            for ln in old_ptxas:
                if ln.startswith("plan_kernel"):
                    print(f"{label}, first checkout: {ln}")
            for ln in ptxas:
                print(f"{label}: {ln}")
            for masked in sorted(old):
                a, b = old[masked], new.get(masked, [])
                same = a == b
                masked_same = [PARAM.sub("c[0x0][_]", x) for x in a] == [
                    PARAM.sub("c[0x0][_]", x) for x in b]
                verdict = ("identical" if same else "identical but for "
                           "parameter offsets" if masked_same
                           else "DIFFERENT")
                identical += same
                offsets_only += masked_same and not same
                differ += not masked_same
                print(f"plan_kernel<masked {masked}> on {label}: {len(a)} / "
                      f"{len(b)} instructions, {verdict}")
                if not masked_same and b:
                    at = [k for k, (x, y) in enumerate(zip(a, b)) if x != y]
                    print(f"  {len(at)} positions differ; the same "
                          f"instructions reordered: {sorted(a) == sorted(b)}")
                    for k in at[:4]:
                        print(f"  {k}: {a[k]!r} -> {b[k]!r}")
                rows.append((label, masked, len(a), len(b), verdict))
    print(json.dumps({"instantiations": len(rows), "identical": identical,
                      "offsets_only": offsets_only, "different": differ}))
    return 0 if rows and not differ else 1


if __name__ == "__main__":
    sys.exit(main())
