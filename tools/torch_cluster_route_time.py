#!/usr/bin/env python3
"""Times one mask-free pair (B=1) of the exhaustive route on both
wavefront kernels of a plan's library, in one process on one card:
``plan_kernel`` (K1/K4, one CTA a pair) and ``ring_kernel`` (the cluster
kernel, C CTAs a pair at the launcher's cluster size), the table that
decides which of them the route gives a chunk whose clusters fit.

    python3 tools/torch_cluster_route_time.py [--reps N] [--seed N] \
        [--out FILE]

Shapes: est2genome and protein2genome; queries of 250, 750 and 2175
residues (Qp 256, 768 and 2304: C = 1, 3 and 9); targets of 30 kb and
80 kb (Tp 30208 and 92928), random sequences from ``--seed``.  Region
mode at every shape, path mode at the 30 kb target.  Each launch is
timed alone between CUDA events on an otherwise idle stream, ``--reps``
times after one untimed launch of each kernel of the library; the two
kernels' outputs (and, in path mode, their planes at every cell the DP
writes) must be equal.
Prints one JSON line a shape (each kernel's median ms and us a diagonal,
C, the clusters resident, the ring's home), then the card's name and
power limit; ``--out`` gets the same lines.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QUERY_LENGTHS = (250, 750, 2175)
TARGET_LENGTHS = (30_000, 80_000)
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def _jobs(seed: int) -> list:
    """(model name, mode, query length, target length, model, region,
    data) of every shape."""
    from exonerate_tpu_torch.alphabet import AlphabetType
    from exonerate_tpu_torch.engine.region import Region
    from exonerate_tpu_torch.model.data import AlignData
    from exonerate_tpu_torch.model.est2genome import est2genome_create
    from exonerate_tpu_torch.model.registry import (ModelType, get_model,
                                                    translate_both)
    from exonerate_tpu_torch.seqio import Sequence
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), max(TARGET_LENGTHS)))
    models = {
        "est2genome": (est2genome_create(), "ACGT", False),
        "protein2genome": (get_model(ModelType.PROTEIN2GENOME,
                                     AlphabetType.PROTEIN, AlphabetType.DNA),
                           AMINO, translate_both(ModelType.PROTEIN2GENOME))}
    out = []
    for name, (model, letters, both) in models.items():
        for qlen in QUERY_LENGTHS:
            q = Sequence("q", None, "".join(rng.choice(list(letters), qlen)))
            for tlen in TARGET_LENGTHS:
                t = Sequence("t", None, genome[:tlen])
                t.strand = "+"
                data = AlignData(q, t, both)
                modes = ("region", "path") if tlen == TARGET_LENGTHS[0] \
                    else ("region",)
                for mode in modes:
                    out.append((name, mode, qlen, tlen, model,
                                Region(0, 0, qlen, tlen), data))
    return out


def _inputs(cw, wf, model, region, data, mode, dev):
    pads = (wf._bucket(region.query_length), wf._bucket(region.target_length))
    inputs, kinds = wf.prepare_inputs(model, region, data, pad_to=pads,
                                      for_pallas=True)
    return cw.to_kernel_inputs(model, [inputs], kinds, dev, mode)


def _valid(ki, tb):
    """The cells of the planes ``tb`` that the DP writes: each pair's
    (i, j) with i <= its query length and j <= its target length (the
    rest of the planes is left unset)."""
    import torch
    qlen, tlen = (ki.dims[:, k].long()[:, None, None] for k in (2, 3))
    d = torch.arange(tb.shape[1], device=tb.device)[None, :, None]
    i = torch.arange(tb.shape[3], device=tb.device)[None, None, :]
    return ((d - i >= 0) & (d - i <= tlen)
            & (i <= qlen))[:, :, None, :].expand_as(tb)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2719000001)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    from exonerate_tpu_torch import _cudabuild
    from exonerate_tpu_torch.engine import cuda_wavefront as cw
    from exonerate_tpu_torch.engine import wavefront as wf
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    jobs = _jobs(args.seed)
    # every plan's library, built on the host's cores at once
    headers = {}
    for name, mode, _q, _t, model, region, data in jobs:
        if (name, mode) not in headers:
            headers[name, mode] = _inputs(cw, wf, model, region, data, mode,
                                          cpu).header
    with concurrent.futures.ThreadPoolExecutor(len(headers)) as pool:
        built = dict(zip(headers, pool.map(
            lambda h: _cudabuild.build("wavefront", h).seconds,
            headers.values())))
    print(json.dumps({"build_s": {f"{n}/{m}": s
                                  for (n, m), s in built.items()}}),
          flush=True)
    stream = torch.cuda.Stream(dev)
    warmed = set()
    lines = []

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        res = fn()
        end.record(stream)
        end.synchronize()
        return res, start.elapsed_time(end)

    with torch.cuda.stream(stream):
        for name, mode, qlen, tlen, model, region, data in jobs:
            ki = _inputs(cw, wf, model, region, data, mode, dev)
            if (name, mode) not in warmed:
                # a kernel's first launch loads its module: once each
                cw._launch(ki)
                cw._launch(ki, 0)
                stream.synchronize()
                warmed.add((name, mode))
            C, resident = cw.cluster_capacity(ki)
            plan_ms, ring_ms = [], []
            for _ in range(args.reps):
                (p_out, p_tb, _), ms = timed(lambda: cw._launch(ki))
                plan_ms.append(ms)
                (r_out, r_tb, used), ms = timed(lambda: cw._launch(ki, 0))
                ring_ms.append(ms)
                if not torch.equal(p_out, r_out) or (
                        mode == "path" and not torch.equal(
                            p_tb[_valid(ki, p_tb)], r_tb[_valid(ki, r_tb)])):
                    raise RuntimeError(f"{name} {mode} {qlen} x {tlen}: "
                                       f"ring_kernel != plan_kernel")
                del p_tb, r_tb
            diags = ki.Qp + ki.Tp + 1 if not ki.n_diag else ki.n_diag
            p, r = statistics.median(plan_ms), statistics.median(ring_ms)
            line = {"model": name, "mode": mode, "qlen": qlen, "tlen": tlen,
                    "Qp": ki.Qp, "Tp": ki.Tp, "C": used,
                    "C_rule": C, "resident": resident,
                    "smem_ring": cw.ring_in_smem(ki, C),
                    "plan_threads": cw.plan_threads(ki),
                    "plan_ms": p, "ring_ms": r,
                    "plan_us_per_diag": 1e3 * p / diags,
                    "ring_us_per_diag": 1e3 * r / diags,
                    "plan_over_ring": p / r,
                    "plan_ms_all": plan_ms, "ring_ms_all": ring_ms,
                    "score": int(p_out[0, 0])}
            lines.append(line)
            print(json.dumps(line), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    lines.append({"card": card})
    print(json.dumps(lines[-1]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            for line in lines:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
