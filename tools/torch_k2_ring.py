#!/usr/bin/env python3
"""Where K2's time per diagonal goes, on one card.

    python3 tools/torch_k2_ring.py [--out FILE]

chip_smoke.py's step 9e span: calm (record 1 of
``tests/golden/data/all4.fa``, Qp 2304) against the 1.2 Mb
``chromosome_locus`` target, masked by the first copy's alignment
(region mode, K3 inside K2), run on the cluster kernel over diagonals
[0, 302000) and then, timed by CUDA events (best of 3), over the 1,200
diagonals from 302000 from the same carry rings, in variants that take
parts of the work away (their scores differ; only the time is read):

- ``full``: the plan as it is (24 rows);
- ``no calc``: every row's calc kind set to none (no query, target,
  table or scalar loads);
- ``no calc, no shadow``: also no intron-window checks;
- ``empty plan``: no rows: the cluster barrier, the cell state's set-up,
  the ring writes and the halo copy alone;

each with the ring in shared memory (``ring_kernel``) and in global
memory (``ring_kernel`` without SMEM_RING), and the
same span of a 255-row pair (its cluster is one CTA), full and empty.
Prints one JSON line per measurement (microseconds per diagonal) and
the card's name and power limit, and writes the lines to ``--out`` when
given.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch_split_cases as sc  # noqa: E402
from exonerate_tpu_torch.engine import cuda_wavefront as cw  # noqa: E402
from exonerate_tpu_torch.engine import wavefront as wf  # noqa: E402
from exonerate_tpu_torch.engine.optimal import _to_alignment  # noqa: E402
from exonerate_tpu_torch.engine.region import Region  # noqa: E402
from exonerate_tpu_torch.engine.subopt import SubOpt  # noqa: E402
from exonerate_tpu_torch.model.data import AlignData  # noqa: E402
from exonerate_tpu_torch.model.est2genome import est2genome_create  # noqa: E402,E501
from exonerate_tpu_torch.seqio import Sequence  # noqa: E402

SPAN = (302_000, 303_200)        # chip_smoke.py's CH_SPAN_AT, CH_SPAN_DIAGS


@contextlib.contextmanager
def _ring(smem: bool):
    """The cluster kernel's ring route forced to shared (True) or global
    memory."""
    real = cw.ring_in_smem
    cw.ring_in_smem = lambda ki, cluster=0: smem and real(ki, cluster)
    try:
        yield
    finally:
        cw.ring_in_smem = real


def _best_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def _variants(ki):
    plan = ki.plan.clone()
    plan[:, wf.P_CALC] = wf.C_NONE
    no_calc = dataclasses.replace(ki, plan=plan)
    plan = plan.clone()
    plan[:, wf.P_FLAGS] &= ~(wf.F_SH_Q | wf.F_SH_T)
    return {"full": ki, "no calc": no_calc,
            "no calc, no shadow": dataclasses.replace(ki, plan=plan),
            "empty plan": dataclasses.replace(
                ki, plan=ki.plan[:0].contiguous())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    model = est2genome_create()
    calm_s = sc.calm()
    chrom = sc.chromosome_locus(calm_s)
    data = AlignData(Sequence("calm", None, calm_s),
                     Sequence("chromosome", None, chrom))
    box = Region(0, 300_000, len(calm_s), 8425)
    sub = SubOpt()
    sub.add_alignment(_to_alignment(model, box, cw.find_path_batched(
        model, [(box, data)], device=dev)[0]))
    lines = []
    for qlen in (len(calm_s), 255):
        (key, items), = cw._buckets(
            model, [(Region(0, 0, qlen, len(chrom)), data)], sub).items()
        ki = cw.to_kernel_inputs(model, [items[0][1]], key[2], dev,
                                 "region")
        for smem in ((True, False) if qlen == len(calm_s) else (True,)):
            with _ring(smem):
                ring = cw.ring_buffers(ki)
                cw._launch(ki, 0, (0, SPAN[0]), ring)
                torch.cuda.synchronize()
                for name, k in _variants(ki).items():
                    if qlen != len(calm_s) and name not in (
                            "full", "empty plan"):
                        continue
                    ms = _best_ms(lambda: cw._launch(
                        k, 0, SPAN, tuple(t.clone() for t in ring)))
                    row = {"rows": qlen + 1, "C": cw._launch(
                               k, 0, SPAN, tuple(t.clone() for t in ring))[2],
                           "ring": "shared" if smem else "global",
                           "variant": name, "ms": ms,
                           "us_per_diagonal": ms * 1e3 / (SPAN[1] - SPAN[0]),
                           "card": card}
                    lines.append(json.dumps(row))
                    print(lines[-1], flush=True)
    print(card)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
