"""Band planning for the device-resident SDP heuristic.

The sparse SDP scheduler (ref: src/sdp/scheduler.c) touches only cells
reachable from HSP seeds within the dropoff; on TPU the equivalent is a
*dense band* decomposition: seeds cluster into target windows (full query
height), and each comparison's bands concatenate into one **compressed
target** so a single anti-diagonal scan covers every band.  Span
(intron/NER) freeze-thaw teleports across the removed gaps exactly,
because span window checks use absolute target positions
(ref: scheduler.h:111-129 span history; Scheduler_SpanData window
arithmetic) and span interiors are never walked cell-by-cell.

Cells outside the bands are provably dead only if no live cell reaches a
band edge; every scan therefore reports an edge-liveness flag, and a trip
falls the comparison back to the host native scheduler (byte parity is
never at risk — the device path is an accelerator with an exactness
check, not an approximation).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Band:
    """One target window [t0, t1] (inclusive DP columns), with its seed
    index range into the comparison's global (t_cobs, q_cobs)-sorted
    seed list."""
    t0: int
    t1: int
    seed_lo: int
    seed_hi: int  # exclusive


@dataclass
class Locus:
    """A group of segments joined within the span window: any legal span
    (intron/NER) interchange stays inside one locus, because a span seed
    frozen in locus A expires before any thaw in locus B
    (t_entry + max_target < t_pos when loci are > max_target apart)."""
    seg_lo: int
    seg_hi: int               # exclusive band range
    seed_lo: int
    seed_hi: int
    t0: int
    t1: int


@dataclass
class BandPlan:
    bands: list
    W: int                    # compressed width (DP columns 0..W)
    abs_t: np.ndarray         # [W+1] absolute target DP-column per v
    seg_id: np.ndarray        # [W+1] band index per v
    v_of_band: np.ndarray     # [n_bands] compressed col of each band's t0
    loci: list = None         # list[Locus]
    locus_of_v: np.ndarray = None   # [W+1] locus index per column

    def to_v(self, band_ix: int, t: int) -> int:
        """Absolute target DP column -> compressed column."""
        b = self.bands[band_ix]
        return int(self.v_of_band[band_ix]) + (t - b.t0)


def plan_bands(seed_extents: list, Q: int, T: int,
               margin: int = 1024, span_window: int = 0) -> BandPlan:
    """seed_extents: [(t_start, t_end)] per seed in global seed order
    (sorted by (t_cobs, q_cobs)); HSP target extents, absolute.

    Bands merge seeds whose margin-padded extents overlap.  The margin
    bounds how far dropoff-pruned extension can drift past a seed chain;
    the edge-liveness check (sdp_device) catches the rare case where it
    does not.  Span teleports between bands are handled by the compressed
    scan itself, so the margin — not the 200 kb max-intron — sets the
    join distance, keeping dense work proportional to cluster extents.
    """
    assert seed_extents
    n = len(seed_extents)
    lo = np.empty(n, np.int64)
    hi = np.empty(n, np.int64)
    for k, (ts, te) in enumerate(seed_extents):
        lo[k] = max(0, ts - margin)
        hi[k] = min(T, te + margin)
    # seeds are sorted by t_cobs, but extents may not be: sweep in lo
    # order, carrying the seed-order invariant via contiguous index
    # ranges (global seed order is (t_cobs, q_cobs); overlapping extents
    # merge, so each band covers a contiguous range of the sorted list)
    order = np.argsort(lo, kind="stable")
    bands: list[Band] = []
    cur_lo = cur_hi = None
    members: list[int] = []

    def flush():
        if members:
            bands.append(Band(int(cur_lo), int(cur_hi),
                              min(members), max(members) + 1))

    for k in order:
        if cur_hi is None or lo[k] > cur_hi:
            flush()
            cur_lo, cur_hi = lo[k], hi[k]
            members = [int(k)]
        else:
            cur_hi = max(cur_hi, hi[k])
            cur_lo = min(cur_lo, lo[k])
            members.append(int(k))
    flush()
    bands.sort(key=lambda b: b.t0)
    # seed ranges must be contiguous and ordered for the per-band
    # lazy-resolution merge; enforce by widening to cover stragglers
    # (correct though slightly conservative when cobs order and extent
    # order disagree)
    fixed: list[Band] = []
    for b in bands:
        if fixed and b.seed_lo < fixed[-1].seed_hi:
            prev = fixed.pop()
            b = Band(prev.t0, max(prev.t1, b.t1),
                     min(prev.seed_lo, b.seed_lo),
                     max(prev.seed_hi, b.seed_hi))
        fixed.append(b)
    bands = fixed

    # each band contributes (t1-t0+1) DP columns; the compressed axis is
    # their concatenation
    W = int(sum(b.t1 - b.t0 + 1 for b in bands)) - 1
    abs_t = np.empty(W + 1, np.int64)
    seg_id = np.empty(W + 1, np.int32)
    v_of_band = np.empty(len(bands), np.int64)
    v = 0
    for bi, b in enumerate(bands):
        n_cols = b.t1 - b.t0 + 1
        v_of_band[bi] = v
        abs_t[v:v + n_cols] = np.arange(b.t0, b.t1 + 1)
        seg_id[v:v + n_cols] = bi
        v += n_cols
    assert v == W + 1

    # group segments into loci: consecutive segments closer than the
    # span window can exchange span seeds (intron crossings); segments
    # further apart are provably independent
    loci: list[Locus] = []
    for bi, b in enumerate(bands):
        if loci and b.t0 - bands[loci[-1].seg_hi - 1].t1 <= span_window:
            lc = loci[-1]
            loci[-1] = Locus(lc.seg_lo, bi + 1,
                             min(lc.seed_lo, b.seed_lo),
                             max(lc.seed_hi, b.seed_hi),
                             lc.t0, max(lc.t1, b.t1))
        else:
            loci.append(Locus(bi, bi + 1, b.seed_lo, b.seed_hi,
                              b.t0, b.t1))
    seg_to_locus = np.empty(len(bands), np.int32)
    for lx, lc in enumerate(loci):
        seg_to_locus[lc.seg_lo:lc.seg_hi] = lx
    locus_of_v = seg_to_locus[seg_id]
    return BandPlan(bands, W, abs_t, seg_id, v_of_band, loci,
                    locus_of_v)


def contig_mask(abs_t: np.ndarray, at: int) -> np.ndarray:
    """[W+1] bool: column v has a valid in-segment source at v-at."""
    W = len(abs_t) - 1
    ok = np.zeros(W + 1, dtype=bool)
    if at == 0:
        ok[:] = True
        return ok
    if W + 1 > at:
        ok[at:] = (abs_t[at:] - abs_t[:-at]) == at
    return ok


def edge_cols(seg_id: np.ndarray, abs_t: np.ndarray, T: int,
              width: int = 1) -> np.ndarray:
    """[W+1] bool: band-edge columns that are NOT genuine region edges
    (t=0 / t=T); liveness there means the band may have been too small.
    `width` covers multi-column advances (a 5'ss jumping 2 columns can
    escape a segment from width-2 inside), so pass the model's
    max_target_advance."""
    W = len(seg_id) - 1
    first = np.ones(W + 1, dtype=bool)
    first[1:] = seg_id[1:] != seg_id[:-1]
    last = np.ones(W + 1, dtype=bool)
    last[:-1] = seg_id[:-1] != seg_id[1:]
    edge = first | last
    for k in range(1, max(width, 1)):
        edge[k:] |= first[:-k]          # first k columns of a segment
        edge[:-k] |= last[k:]           # last k columns of a segment
    # genuine region edges are not escapes
    genuine = np.zeros(W + 1, dtype=bool)
    genuine |= first & (abs_t == 0)
    genuine_last = last & (abs_t == T)
    # a genuine edge clears only its own stripe
    for k in range(max(width, 1)):
        if k:
            genuine[k:] |= (first & (abs_t == 0))[:-k]
            genuine[:-k] |= genuine_last[k:]
        else:
            genuine |= genuine_last
    return edge & ~genuine
