"""Multi-device dry run: every multi-device route of the port on a list
of devices, each held to its single-device result.

Counterpart of ``__graft_entry__.dryrun_multichip`` (which builds a JAX
mesh), with the same checks over a list of devices of this process:

- the sharded ungapped scan (``ungapped_scan.make_sharded_scan``, a
  dp x sp grid) against the single-device scan;
- K5 (``cuda_wavefront.find_batched_sharded``, K1 per device shard)
  against ``find_batched`` on one device;
- the sharded pair and the target-tiled pair (``sharded_pair``) against
  the single-device region DP;
- the band batch over the devices (``cuda_sdp.run_kernel(devices=)``,
  K6/K7 per shard) against one device;
- K8 (``cuda_sdp.run_kernel_cross_chip``) against the single-device scan;
- ``sdp_hybrid.run_device`` under ``EXONERATE_TPU_CROSS_CHIP`` taking K8,
  shown by its engine counter.

On a card the kernels run; on the CPU their plain versions.  Run it as
``python -m exonerate_tpu_torch.parallel.dryrun N`` (N devices: the
visible cards in turn, or N CPU devices with
``EXONERATE_TPU_TORCH_DEVICE=cpu``).
"""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import torch


def _region_key(r) -> tuple:
    return (r.score, r.query_start, r.target_start, r.query_end,
            r.target_end)


def _check(name: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"dryrun {name}: {got} != {want}")


def _ungapped(devices: list) -> dict:
    from ..submat import SYMBOL_INDEX, Submat
    from .ungapped_scan import make_sharded_scan, single_device_scan
    n = len(devices)
    sp = 2 if n % 2 == 0 else 1
    dp = n // sp
    grid = [devices[r * sp:(r + 1) * sp] for r in range(dp)]
    B, Q, S, Tt = max(dp * 2, 4), 32, sp * 2, 64
    T = S * Tt
    rng = np.random.default_rng(0)
    acgt = np.array([SYMBOL_INDEX[ord(c)] for c in "ACGT"])
    q_codes = acgt[rng.integers(0, 4, (B, Q))].astype(np.int32)
    t_tiles = acgt[rng.integers(0, 4, (S, Tt))].astype(np.int32)
    tile_starts = (np.arange(S) * Tt).astype(np.int32)
    sub = Submat.create("nucleic")
    fn = make_sharded_scan(grid, B, Q, T, S, sub.matrix)
    best, top = fn(q_codes, t_tiles, tile_starts)
    best, top = best.cpu().tolist(), top.cpu().tolist()
    if len(best) != B or min(best) < 0:
        raise AssertionError(f"dryrun ungapped scan: best {best}")
    one = single_device_scan(sub.matrix, devices[0])(
        q_codes, t_tiles, tile_starts).cpu().tolist()
    _check("ungapped scan", best, one)
    _check("ungapped top-k", top, sorted(best, reverse=True)[:len(top)])
    return {"dp": dp, "sp": sp, "best": best, "top": top}


def _e2g():
    from ..alphabet import Alphabet, AlphabetType
    from ..model.data import AlignData, IntronArgs
    from ..model.est2genome import est2genome_create
    from ..seqio import Sequence
    rng = np.random.default_rng(1)
    dna = Alphabet(AlphabetType.DNA)
    q = Sequence("q", None, "".join(rng.choice(list("ACGT"), 48)), dna)
    t = Sequence("t", None, "".join(rng.choice(list("ACGT"), 160)), dna)
    intron = IntronArgs(min_intron=20, max_intron=1000)
    model = est2genome_create(intron)
    data = AlignData(q, t)
    data.intron = intron
    return model, data, q, t


def _band_jobs(model, data, q, t) -> list:
    from ..engine import sdp_bands
    from ..engine.sdp import SDPPair, SdpArgs
    jobs = []
    for off in range(2):
        hl = [SimpleNamespace(query_start=8, target_start=40 + off,
                              length=24, score=40, cobs=12)]
        hs = SimpleNamespace(qadv=1, tadv=1, hsps=hl)
        comp = SimpleNamespace(query=q, target=t, hspsets=lambda h=hs: [h])
        pair = SDPPair(model, comp, data, None, SdpArgs())
        pair._find_starts()
        pair._find_ends()
        extents = [(s.hsp.target_start, s.hsp.target_start + s.hsp.length)
                   for s in pair.seeds]
        sw = max((sp.max_target for sp in model.spans), default=0)
        plan = sdp_bands.plan_bands(extents, len(q), len(t), margin=48,
                                    span_window=sw + 96)
        jobs.append((pair, plan))
    return jobs


def _band_key(r: dict) -> tuple:
    return (bool(r["live"]), bool(r["xband"]),
            [int(x) for x in r["band_end"]])


def dryrun_multichip(devices: list) -> dict:
    """Run every check on ``devices`` (a list of torch devices; repeats
    allowed).  Raises AssertionError on the first disagreement; returns
    what each check computed."""
    from .. import observe
    from ..engine import cuda_sdp, cuda_wavefront, sdp_hybrid
    from ..engine.region import Region
    from .sharded_pair import (find_region_sharded_pair,
                               find_region_target_tiled)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    out = {"devices": [str(d) for d in devices]}
    out["ungapped"] = _ungapped(devices)

    model, data, q, t = _e2g()
    # K5: the batch data-parallel over the devices
    jobs = [(Region(0, i, len(q), 120), data) for i in range(n)]
    sharded = cuda_wavefront.find_batched_sharded(model, jobs, devices,
                                                  "region")
    single = cuda_wavefront.find_batched(model, jobs, "region",
                                         device=devices[0])
    _check("K5", [_region_key(r) for r in sharded],
           [_region_key(r) for r in single])
    out["k5_scores"] = [r.score for r in sharded]

    # ONE pair's region DP across the devices: query slabs, target tiles
    pr = Region(0, 0, len(q), len(t))
    one = _region_key(cuda_wavefront.find_batched(
        model, [(pr, data)], "region", device=devices[0])[0])
    _check("sharded pair", _region_key(
        find_region_sharded_pair(model, pr, data, devices)), one)
    _check("target-tiled pair", _region_key(
        find_region_target_tiled(model, pr, data, devices)), one)
    out["pair"] = one

    # the band batch over the devices, and K8 across them
    kjobs = _band_jobs(model, data, q, t)
    k_single = cuda_sdp.run_kernel(model, kjobs, 50, devices[0])
    k_multi = cuda_sdp.run_kernel(model, kjobs, 50, devices[0],
                                  devices=devices)
    _check("band batch", [_band_key(r) for r in k_multi],
           [_band_key(r) for r in k_single])
    xpair, xplan = kjobs[0]
    n_chips = min(n, 3)
    x_cross = cuda_sdp.run_kernel_cross_chip(model, xpair, xplan, 50,
                                             n_chips, devices=devices)
    _check("K8", _band_key(x_cross), _band_key(k_single[0]))

    # ... and the production entry point routes through it
    knobs = {"EXONERATE_TPU_CROSS_CHIP": str(n_chips),
             "EXONERATE_TPU_CROSS_CHIP_MIN_W": "1"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        xchip = cuda_sdp.engine_name(devices[0]) + "-xchip"
        before = observe.engine_counts.get(xchip, 0)
        x_prod = sdp_hybrid.run_device(model, xpair, xplan, devices[0],
                                       devices=devices)
        if observe.engine_counts.get(xchip, 0) <= before:
            raise AssertionError(f"dryrun: run_device took no {xchip}: "
                                 f"{dict(observe.engine_counts)}")
        _check("run_device across devices", _band_key(x_prod),
               _band_key(k_single[0]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["band_end"] = [int(x) for x in x_prod["band_end"]]
    return out


def _devices_for(n: int) -> list:
    from .. import device
    dev = device()
    if dev.type == "cuda":
        return [torch.device("cuda", k % torch.cuda.device_count())
                for k in range(n)]
    return [dev] * n


if __name__ == "__main__":
    n_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    res = dryrun_multichip(_devices_for(n_dev))
    print(f"dryrun_multichip OK: {res}")
