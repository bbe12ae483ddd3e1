"""One gapped pair's region DP across devices.

Counterpart of ``exonerate_tpu/parallel/sharded_pair.py``, which pins
the XLA wavefront's arrays to a mesh axis under ``jit``.  Here the pair
runs the plain wavefront's cell step (``engine/wavefront.py``
``cell_step``) on a list of devices in one process:

- ``find_region_sharded_pair``: the per-diagonal state vectors (a score
  plane and shadow lanes per model state, along the query) are cut into
  equal query slabs, one per device.  The only cross-slab dataflow of the
  recurrence is the advance-query shift of the previous diagonals, so
  after each diagonal the top K halo rows of every slab (K the model's
  largest query advance) are copied to the next device: the counterpart
  of the JAX package's collective permutes.
- ``find_region_target_tiled``: the DP state stays on the first device
  and the O(T) input vectors (the target-side calc vectors, reversed and
  padded as the cell step reads them) live tiled over the devices; each
  diagonal's window is read from the tiles that own it.

Both return exactly the single-device result (score, both ends, both
starts).
"""
from __future__ import annotations

import torch

from ..engine import wavefront as wf
from ..engine.cuda_wavefront import to_kernel_inputs
from ..engine.reference import DPResult
from ..engine.region import Region
from ..model.ir import Model

NEG = wf.NEG


def _pad_to_multiple(n: int, k: int) -> int:
    """The padded length whose n + 1 positions split into k equal runs."""
    return ((n + 1 + k - 1) // k) * k - 1


def _kernel_inputs(model: Model, region: Region, data, Qp: int, Tp: int):
    inputs, kinds = wf.prepare_inputs(model, region, data, pad_to=(Qp, Tp),
                                      for_pallas=True)
    return to_kernel_inputs(model, inputs, kinds, torch.device("cpu"),
                            "region")


def _result(out: torch.Tensor) -> DPResult:
    score, qe, te, qs, ts = (int(x) for x in out[:, 0].tolist())
    return DPResult(score=score, query_end=qe, target_end=te,
                    query_start=qs, target_start=ts)


def _run(ki: wf.KernelInputs, slabs: list) -> torch.Tensor:
    """The region DP over ``slabs`` (``wf.Lanes``, lanes in order, each on
    its device); returns the (5, B) winner on the first slab's device."""
    S, L, K = ki.S, ki.L, ki.K
    kq = max([row[wf.P_AQ] for row in slabs[0].plan] + [1])
    dev0 = slabs[0].dev
    B = ki.batch

    def blank(c):
        return ([c.neg] * S, [[c.zero] * L for _ in range(S)])

    def fill(c):
        neg = torch.full((B, kq), NEG, dtype=torch.int32, device=c.dev)
        zero = torch.zeros((B, kq), dtype=torch.int32, device=c.dev)
        return ([neg] * S, [[zero] * L for _ in range(S)])

    prev = [[blank(c)] * K for c in slabs]     # prev[k][a]: diagonal d-1-a
    halo = [[fill(c)] * K for c in slabs]      # the kq lanes below slab k
    ends = [wf.EndCells(c) for c in slabs]

    def fetcher(k):
        c = slabs[k]

        def cut(h, x, aq):
            return torch.cat([h, x], dim=1)[:, kq - aq:kq - aq + c.n]

        def fetch(inp, adv, aq):
            p_sc, p_ln = prev[k][adv - 1]
            if not aq:
                return p_sc[inp], list(p_ln[inp])
            h_sc, h_ln = halo[k][adv - 1]
            return (cut(h_sc[inp], p_sc[inp], aq),
                    [cut(h, x, aq) for h, x in zip(h_ln[inp], p_ln[inp])])
        return fetch

    fetchers = [fetcher(k) for k in range(len(slabs))]
    for d in range(ki.Qp + ki.Tp + 1):
        new = []
        for k, c in enumerate(slabs):
            scores, lanes, _tbv = wf.cell_step(c, d, fetchers[k])
            ends[k].update(c, d, scores, lanes)
            new.append(([v if v is not None else c.neg for v in scores],
                        [[v if v is not None else c.zero for v in lanes[s]]
                         for s in range(S)]))
        # the halo rows of the new diagonal cross to the next device
        new_halo = [fill(slabs[0])]
        for k in range(1, len(slabs)):
            (h_sc, h_ln), (x_sc, x_ln) = new_halo[k - 1], new[k - 1]
            dev = slabs[k].dev
            new_halo.append((
                [torch.cat([h, x], 1)[:, -kq:].to(dev)
                 for h, x in zip(h_sc, x_sc)],
                [[torch.cat([h, x], 1)[:, -kq:].to(dev)
                  for h, x in zip(hl, xl)] for hl, xl in zip(h_ln, x_ln)]))
        for k in range(len(slabs)):
            prev[k] = [new[k]] + prev[k][:-1]
            halo[k] = [new_halo[k]] + halo[k][:-1]
    cat = [torch.cat([getattr(e, f).to(dev0) for e in ends], dim=1)
           for f in ("sc", "j", "qs", "ts")]
    i = torch.cat([c.i.to(dev0) for c in slabs])
    return wf.end_winner(*cat, i)


def find_region_sharded_pair(model: Model, region: Region, data,
                             devices: list) -> DPResult:
    """FIND_REGION for ONE pair with its DP state cut into query slabs, one
    per device of ``devices`` (``sharded_pair.py:66``).  Scores are
    exactly the single-device wavefront's."""
    n = max(len(devices), 1)
    Qp = _pad_to_multiple(region.query_length, n)
    ki = _kernel_inputs(model, region, data, Qp, region.target_length)
    w = (Qp + 1) // n
    slabs = [wf.Lanes(ki, k * w, w, torch.device(dev))
             for k, dev in enumerate(devices)]
    return _result(_run(ki, slabs))


def find_region_target_tiled(model: Model, region: Region, data,
                             devices: list) -> DPResult:
    """FIND_REGION for ONE pair with its target vectors tiled over
    ``devices`` (``sharded_pair.py:88``): the reversed, padded target
    vectors are cut into one contiguous tile per device, the DP state
    runs on the first device, and each diagonal's window is gathered from
    the tiles that hold it.  The result is exactly the single-device
    wavefront's."""
    devs = [torch.device(dev) for dev in devices]
    n = max(len(devs), 1)
    Tp = _pad_to_multiple(region.target_length, n)
    ki = _kernel_inputs(model, region, data, region.query_length, Tp)
    trev = wf.reversed_targets(ki)
    X = trev.shape[2]
    cuts = [k * X // n for k in range(n + 1)]
    tiles = [(cuts[k], cuts[k + 1], trev[:, :, cuts[k]:cuts[k + 1]].to(dev))
             for k, dev in enumerate(devs)]
    W = ki.Qp + 1

    def twin(c: int, st: int) -> torch.Tensor:
        parts = [t[:, c, max(st, lo) - lo:min(st + W, hi) - lo].to(devs[0])
                 for lo, hi, t in tiles if lo < st + W and st < hi]
        return torch.cat(parts, dim=1)

    return _result(_run(ki, [wf.Lanes(ki, 0, W, devs[0], twin=twin)]))
