"""Multi-device ungapped genome scanning.

Counterpart of ``exonerate_tpu/parallel/ungapped_scan.py`` (``lax.scan``
and ``shard_map`` collectives there), as torch ops over a grid of
devices in one process.  The best ungapped local alignment on each
diagonal is a maximum-subarray problem over that diagonal's match
scores, and max-subarray combination is an associative monoid (sum,
best prefix, best suffix, best), so:

- all diagonals of a (query x target-tile) block fold in one loop over
  the query axis, each step a contiguous placement plus elementwise
  combines (``tile_diagonal_monoid``);
- a long target splits into tiles, each tile's per-diagonal monoid vector
  slots into the global diagonal axis at its tile offset
  (``place_global``), and the tiles combine left to right
  (``_fold_tiles``);
- ``make_sharded_scan`` runs pair batches data-parallel over the grid's
  rows (``dp``) and target tiles over its columns (``sp``): each row's
  partial monoids are copied to the row's first device and combined in
  column order (the JAX package's ``all_gather`` over ``sp``), and the
  per-pair bests are gathered to the first device, where ``torch.topk``
  takes the global top values (its ``all_gather`` over ``dp`` and
  ``top_k``).

Every function takes a leading batch axis on the query codes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG = -(1 << 30)


def monoid_identity(shape, device=None):
    z = torch.zeros(shape, dtype=torch.int32, device=device)
    return z, z, z, z


def monoid_single(v, present):
    """Singleton monoid element per lane; absent lanes are identity."""
    vp = torch.clamp(v, min=0)
    zero = torch.zeros_like(v)
    return (torch.where(present, v, zero),
            torch.where(present, vp, zero),
            torch.where(present, vp, zero),
            torch.where(present, vp, zero))


def monoid_combine(a, b):
    asum, apre, asuf, abest = a
    bsum, bpre, bsuf, bbest = b
    return (asum + bsum,
            torch.maximum(apre, asum + bpre),
            torch.maximum(bsuf, bsum + asuf),
            torch.maximum(torch.maximum(abest, bbest), asuf + bpre))


def tile_diagonal_monoid(q_idx, t_idx, submat):
    """Fold one (query x target-tile) block into a monoid element per
    *local* diagonal, for each query of the batch ``q_idx`` (B, Q).
    Local diagonal axis g = j - i + (Q-1), size Q + Tt - 1 (padded to
    Q + Tt).  Row i of the block covers the contiguous band
    [Q-1-i, Q-1-i+Tt)."""
    B, Q = q_idx.shape
    Tt = t_idx.shape[0]
    nd = Q + Tt
    lanes = torch.arange(nd, device=q_idx.device)
    out = monoid_identity((B, nd), q_idx.device)
    for i in range(Q):
        row = submat[q_idx[:, i].long()][:, t_idx.long()]     # (B, Tt)
        off = Q - 1 - i
        vals = F.pad(row, (off, nd - off - Tt))
        present = (lanes >= off) & (lanes < off + Tt)
        out = monoid_combine(out, monoid_single(vals, present))
    return out


def place_global(m_local, Q: int, n_diags: int, tile_start: int):
    """Slot a tile's local diagonal monoid vectors into the global
    diagonal axis at its tile offset (global g = local g + tile_start)."""
    nd = m_local[0].shape[-1]
    start = min(max(int(tile_start), 0), n_diags - nd)
    return tuple(F.pad(x, (start, n_diags - start - nd)) for x in m_local)


def _fold_tiles(q_idx, t_tiles, tile_starts, submat, n_diags, Q):
    m = monoid_identity((q_idx.shape[0], n_diags), q_idx.device)
    for s in range(t_tiles.shape[0]):
        loc = tile_diagonal_monoid(q_idx, t_tiles[s], submat)
        m = monoid_combine(m, place_global(loc, Q, n_diags,
                                           int(tile_starts[s])))
    return m


def _tensor(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32).to(device) \
        if not torch.is_tensor(x) else x.to(device=device,
                                            dtype=torch.int32)


def make_sharded_scan(grid: list, B: int, Q: int, T: int, S: int,
                      submat: np.ndarray, topk: int = 8):
    """The scan over ``grid``, a dp x sp list of rows of devices.

    The returned fn takes q_codes (B, Q) (rows of pairs split over dp),
    t_tiles (S, T//S) and tile_starts (S,) (tiles split over sp), and
    returns (best (B,) per-pair best score, top (min(topk, B),) the
    global best values), on the grid's first device."""
    n_diags = Q + T
    dp, sp = len(grid), len(grid[0])
    if B % dp or S % sp:
        raise ValueError(f"B={B} and S={S} must split over a {dp} x {sp} "
                         "grid")
    subs = {dev: _tensor(submat, dev) for row in grid for dev in row}

    def step(q_codes, t_tiles, tile_starts):
        starts = [int(s) for s in np.asarray(
            tile_starts.cpu() if torch.is_tensor(tile_starts)
            else tile_starts)]
        b, s = B // dp, S // sp
        bests = []
        for r, row in enumerate(grid):
            parts = []
            for c, dev in enumerate(row):
                q = _tensor(q_codes[r * b:(r + 1) * b], dev)
                t = _tensor(t_tiles[c * s:(c + 1) * s], dev)
                parts.append(_fold_tiles(q, t, starts[c * s:(c + 1) * s],
                                         subs[dev], n_diags, Q))
            # the sp partials to the row's first device, combined in order
            acc = parts[0]
            for part in parts[1:]:
                acc = monoid_combine(acc, tuple(x.to(row[0]) for x in part))
            bests.append(acc[3].max(dim=-1).values)
        best = torch.cat([x.to(grid[0][0]) for x in bests])
        top = torch.topk(best, min(topk, B)).values
        return best, top

    return step


def single_device_scan(submat: np.ndarray, device=None):
    """Single-device batched scan: fn(q_codes [B,Q], t_tiles [S,Tt],
    tile_starts [S]) -> best [B]."""
    if device is None:
        from .. import device as default_device
        device = default_device()
    dev = torch.device(device)
    sub = _tensor(submat, dev)

    def step(q_codes, t_tiles, tile_starts):
        q = _tensor(q_codes, dev)
        t = _tensor(t_tiles, dev)
        B, Q = q.shape
        S, Tt = t.shape
        starts = [int(s) for s in np.asarray(
            tile_starts.cpu() if torch.is_tensor(tile_starts)
            else tile_starts)]
        m = _fold_tiles(q, t, starts, sub, Q + S * Tt, Q)
        return m[3].max(dim=-1).values

    return step
