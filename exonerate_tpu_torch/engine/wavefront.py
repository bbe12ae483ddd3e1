"""Anti-diagonal wavefront DP: host prep and the plain PyTorch engine.

Counterpart of ``exonerate_tpu/engine/wavefront.py``.  Two parts:

- Host prep (``prepare_inputs``, ``_pad_inputs``, ``_grid_key``,
  ``_bucket_ladder``, ``_bucket``): NumPy copies of the JAX module's
  functions, so the port needs no JAX to prepare a pair.  One change:
  the SubOpt mask plane is written from the mask's points at the padded
  width (``blocked_plane``), with the bits the JAX module's dense grid,
  packed and re-packed by ``_pad_inputs``, gives.
- ``plain_wavefront`` / ``plain_walkback`` / ``plain_walk_segment``: the
  plain PyTorch version of the hand-written kernels in
  ``csrc/wavefront.cu`` (K1 score/region, K4 path) and
  ``csrc/walkback.cu`` (its two entry points).  It interprets the same
  plan table (built by ``cuda_wavefront.to_kernel_inputs``) with a
  Python loop over
  anti-diagonals and torch ops on ``(B, Qp+1)`` int32 planes, in the
  guarded cell semantics of the Pallas body
  (``pallas_wavefront.py:832-1040``): per-transition source masks,
  silent transitions in plan order, start/end scope masks, shadow lanes,
  strict ``>`` replacement (first max wins) and one lexicographic
  (score desc, j asc, i asc) reduce of per-lane best planes.  With a
  SubOpt mask (kernel K3) a match transition into a blocked cell is
  dropped, as in the Pallas body (``pallas_wavefront.py:909-910``,
  ``:991-992``) and the XLA engine (``wavefront.py:311-312``).  On CPU
  tensors it is the port's engine; on the card it is what the kernels
  are held against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import observe
from .region import Region
from ..model.ir import IMPOSSIBLY_HIGH_SCORE, IMPOSSIBLY_LOW_SCORE, Model

NEG = IMPOSSIBLY_LOW_SCORE


# ---------------------------------------------------------------------------
# input preparation (host side, NumPy) — copies of the JAX module's
# ---------------------------------------------------------------------------

def _grid_key(model: Model, t) -> str:
    return f"g{model.calcs.index(t.calc)}_{t.advance_query}_{t.advance_target}"


@observe.traced("wave.prep")
def prepare_inputs(model: Model, region: Region, data,
                   subopt=None, pad_to=None,
                   for_pallas: bool = False) -> tuple[dict[str, Any], tuple]:
    """Materialize per-pair arrays in compact forms: factored match calcs
    ship O(Q+T) index vectors + a small table; 1-D calcs ship vectors; only
    genuinely 2-D grids ship whole planes (skewed on device).  Returns
    (inputs, kinds) where kinds is the static classification used to trace
    the engine (part of the jit cache key).

    subopt: optional SubOpt mask; blocked cells ship as a boolean plane so
    re-running with a grown mask reuses the jit cache."""
    Q, T = region.query_length, region.target_length
    Qp, Tp = pad_to if pad_to is not None else (Q, T)
    assert Qp >= Q and Tp >= T
    i_idx = np.arange(Q + 1)
    inputs: dict[str, Any] = {}
    kinds: dict[str, str] = {}
    # blocked-cell plane, addressed by DESTINATION cell
    # (ref: viterbi.c:701-704 SubOpt blocking of match transitions);
    # omitted entirely when empty and bit-packed otherwise to keep
    # host->device transfer tiny.  Built from the mask's points at the
    # padded width, never as a dense grid (_pad_inputs keeps it as is)
    blocked = (None if subopt is None
               else blocked_plane(subopt, region, Qp, Tp))
    if blocked is not None:
        inputs["_blocked"] = blocked
        kinds["_blocked"] = "blocked"
    done = set()
    for t in model.transitions:
        if t.calc is None:
            continue
        key = _grid_key(model, t)
        if key in done:
            continue
        done.add(key)
        aq, at = t.advance_query, t.advance_target
        si = np.clip(i_idx - aq, 0, Q)
        if t.calc.factored_fn is not None:
            f = t.calc.factored_fn(region, data)
            inputs[key] = {
                "q_idx_s": f["q_idx"][si].astype(np.int32),
                "t_idx": f["t_idx"].astype(np.int32),
                "table": f["table"].astype(np.int32),
                "q_override_s": f.get(
                    "q_override",
                    np.zeros(Q + 1, np.int32))[si].astype(np.int32),
            }
            kinds[key] = "factored"
            continue
        g = np.asarray(t.calc.materialize(region, data))
        if g.ndim == 0:
            inputs[key] = g.astype(np.int32)
            kinds[key] = "scalar"
            continue
        qdep = g.shape[0] > 1
        tdep = g.ndim > 1 and g.shape[1] > 1
        if qdep and not tdep:
            v = g[:, 0] if g.ndim > 1 else g
            inputs[key] = v[si].astype(np.int32)          # [Q+1]
            kinds[key] = "qvec"
        elif tdep and not qdep:
            v = g[0] if g.ndim > 1 else g
            inputs[key] = v.astype(np.int32)              # [T+1]
            kinds[key] = "tvec"
        else:
            inputs[key] = g.astype(np.int32)              # [Q+1, T+1]
            kinds[key] = "grid2d"
    for c in model.calcs:
        if c.shadow_inputs_fn is not None:
            inputs[f"sh{model.calcs.index(c)}"] = c.shadow_inputs_fn(region,
                                                                     data)
    if for_pallas:
        # gather-free kernel data: shadow start vectors and per-calc
        # kernel inputs (see model/phase.py packed split-codon lanes)
        for ix, sh in enumerate(model.shadows):
            if sh.start_vec_fn is not None:
                assert sh.start == "target_pos", sh
                inputs[f"shv{ix}"] = np.asarray(
                    sh.start_vec_fn(region, data), np.int32)
                kinds[f"shv{ix}"] = "tvec"
        for ci, c in enumerate(model.calcs):
            if c.kernel_inputs_fn is not None:
                tr = next(t for t in model.transitions if t.calc is c)
                si = np.clip(i_idx - tr.advance_query, 0, Q)
                for nm, (kind, arr) in c.kernel_inputs_fn(region,
                                                          data).items():
                    key = f"kc{ci}:{nm}"
                    kinds[key] = kind
                    arr = np.asarray(arr, np.int32)
                    inputs[key] = arr[si] if kind == "qvec" else arr
    inputs["_qstart"] = np.int32(region.query_start)
    inputs["_tstart"] = np.int32(region.target_start)
    inputs["_qlen"] = np.int32(Q)
    inputs["_tlen"] = np.int32(T)
    if pad_to is not None:
        inputs = _pad_inputs(inputs, kinds, Q, T, Qp, Tp)
    return inputs, tuple(sorted(kinds.items()))


def blocked_plane(subopt, region: Region, Qp: int, Tp: int):
    """The SubOpt mask's bits over ``region``'s cells as a packed
    (Qp+1, ceil((Tp+1)/8)) uint8 plane, written straight from the mask's
    points: cell (i, j) of the region is bit ``7 - j % 8`` of byte
    ``j // 8`` in row i, the ``np.packbits(axis=1)`` order of
    ``SubOpt.blocked_grid(region)`` padded with zeros to (Qp+1, Tp+1), as
    the JAX package's ``_pad_inputs`` pads it.  None when no point falls
    in the region.  Costs O(points) and one plane, never a dense grid
    (2.6 GB of bools at a 2 kb cDNA x 1.2 Mb target)."""
    Q, T = region.query_length, region.target_length
    if not subopt.points:
        return None
    pts = np.array(list(subopt.points), np.int64).reshape(-1, 2)
    lq = pts[:, 0] - region.query_start
    lt = pts[:, 1] - region.target_start
    ok = (lq >= 0) & (lq <= Q) & (lt >= 0) & (lt <= T)
    if not ok.any():
        return None
    lq, lt = lq[ok], lt[ok]
    plane = np.zeros((Qp + 1, (Tp + 8) // 8), np.uint8)
    np.bitwise_or.at(plane, (lq, lt >> 3),
                     (0x80 >> (lt & 7)).astype(np.uint8))
    return plane


def _pad_inputs(inputs, kinds, Q, T, Qp, Tp):
    """Pad per-pair arrays to a bucket shape (catch-all submat index 24
    for factored vectors; zeros elsewhere)."""
    out = {}
    for k, v in inputs.items():
        kind = kinds.get(k)
        if kind == "factored":
            out[k] = {
                "q_idx_s": np.pad(v["q_idx_s"], (0, Qp - Q),
                                  constant_values=24),
                "t_idx": np.pad(v["t_idx"], (0, Tp - T),
                                constant_values=24),
                "table": v["table"],
                "q_override_s": np.pad(v["q_override_s"], (0, Qp - Q)),
            }
        elif kind == "qvec":
            out[k] = np.pad(v, (0, Qp - Q))
        elif kind == "tvec":
            out[k] = np.pad(v, (0, Tp - T))
        elif kind == "grid2d":
            out[k] = np.pad(v, ((0, Qp - Q), (0, Tp - T)))
        else:
            # scalars, shadow inputs and the mask plane (blocked_plane
            # builds it at the padded width)
            out[k] = v
    return out


def _bucket_ladder(max_n: int = 1 << 24, step: int = 256,
                   ratio: float = 1.25) -> list[int]:
    """Geometric ladder of padded lengths: each rung is at most `ratio`
    above the previous, so padding wastes <= ratio while the number of
    distinct compiled kernel shapes stays logarithmic (each fresh
    (Qp, Tp) bucket costs a multi-minute Pallas compile — a linear
    256-step grid causes a compile storm on real locus workloads)."""
    rungs = [step]
    while rungs[-1] < max_n:
        nxt = max(rungs[-1] + step,
                  ((int(rungs[-1] * ratio) + step - 1) // step) * step)
        rungs.append(nxt)
    return rungs


_LADDER = _bucket_ladder()


def _bucket(n: int, step: int = 256) -> int:
    for r in _LADDER:
        if n <= r:
            return r
    return _LADDER[-1]


# ---------------------------------------------------------------------------
# the plan table: one int32 row per transition of _build_plan(model), in
# model order (csrc/wavefront.cu declares the same column and code numbers)
# ---------------------------------------------------------------------------

(P_AQ, P_AT, P_IN, P_OUT, P_FLAGS, P_CALC, P_C0, P_C1, P_C2, P_C3, P_C4,
 P_SH_LANE_Q, P_SH_LANE_T, P_SH_MIN, P_SH_MAX, P_C5, P_C6, P_NSTART,
 P_ST_DES0, P_ST_SRC0) = range(20)
MAX_START_LANES = 4
# start k at P_ST_DES0 + 2k; the row is padded to a multiple of 4
# columns, 16 bytes, so that the kernel reads it in aligned vectors
PLAN_COLS = (P_ST_DES0 + 2 * MAX_START_LANES + 3) // 4 * 4

# P_ST_SRC codes of a start lane: the source cell's target or query
# position, or ST_TVEC + r: tvecs[r] at the source column (a shadow start
# vector, ``Shadow.start_vec_fn``)
ST_TARGET = 0
ST_QUERY = 1
ST_TVEC = 2

# P_FLAGS bits
F_FROM_START = 1      # the input is the START state
F_TO_END = 2          # the output is the END state
F_P_UNDER = 4         # Protect.UNDERFLOW: clamp to NEG
F_P_OVER = 8          # Protect.OVERFLOW: clamp to IMPOSSIBLY_HIGH_SCORE
F_SH_Q = 16           # intron window on the query lane P_SH_LANE_Q
F_SH_T = 32           # intron window on the target lane P_SH_LANE_T
F_MATCH = 64          # a match transition: barred at SubOpt-blocked cells

# P_CALC kinds and their operands
C_NONE = 0            # calc 0
C_SCALAR = 1          # scalars[C0]
C_QVEC = 2            # qvecs[C0][i] (shifted by aq on the host)
C_TVEC = 3            # tvecs[C0][j - at]
C_FACTORED = 4        # qvecs[C4][i] if != 0, else
#                       tables[C2 + qvecs[C0][i] * C3 + tvecs[C1][j - at]]
C_SPLIT = 5           # the split codon (kernel K9, model/phase.py:305):
#   C0 = qvecs row of R0 (R0..R24 follow), C1 = tvecs row of E1p0 (phase
#   1; E1p1, E1p2 follow) or N4 (phase 2), C2 = phase, C3 = lane of the
#   "target intron" shadow, C4 = lane of "split c1" (phase 1) or
#   "split p2k0" (phase 2), C5 / C6 = lanes of "split p2k1" / "p2k2"

# Scope codes of the start/end terminals
SCOPE_ANYWHERE, SCOPE_EDGE, SCOPE_QUERY, SCOPE_TARGET, SCOPE_CORNER = range(5)


@dataclass
class KernelInputs:
    """One batch of pairs, padded to (Qp, Tp), in the kernels' layout.

    All tensors live on one device; the kernels read them in place."""
    plan: torch.Tensor       # (P, PLAN_COLS) int32
    ring_row: torch.Tensor   # (S,) int32: carry-ring row, -1 = none
    lane_row: torch.Tensor   # (S, max(L, 1)) int32: lane-ring row, -1 = dead
    dims: torch.Tensor       # (B, 4) int32: qstart, tstart, qlen, tlen
    qvecs: torch.Tensor      # (B, NQ, Qp+1) int32
    tvecs: torch.Tensor      # (B, NT, Tp+1) int32
    tables: torch.Tensor     # (B, NTAB) int32, flattened factored tables
    scalars: torch.Tensor    # (B, NSC) int32
    walk: torch.Tensor       # (4, P+1) int32: AQ, AT, IN, FROM_START per id
    blocked: torch.Tensor    # (B, Qp+1, ceil((Tp+1)/8)) uint8: the SubOpt
    #                          mask's bits (np.packbits order) by destination
    #                          cell; empty when no pair of the batch is masked
    Qp: int
    Tp: int
    S: int                   # states
    L: int                   # lanes: shadow designations (+2 in region mode)
    n_shadow: int
    K: int                   # largest advance; the ring holds K+1 diagonals
    NR: int                  # carry-ring rows (states read across diagonals)
    NL: int                  # live lane-ring rows
    start_id: int
    end_id: int
    start_scope: int
    end_scope: int
    mode: str                # "score" | "region" | "path"
    split: bool = False      # the plan holds K9: a split-codon row or a
    #                          start lane read from a tvec
    qmax: int = 0            # the largest qlen of the batch, known on the
    #                          host (0: read it from dims)
    header: str = ""         # the plan compiled into K1/K4
    #                          (plan_cuda.wave_header)
    n_diag: int = 0          # the diagonals of the batch's longest pair,
    #                          qlen + tlen + 1 (0: Qp + Tp + 1)

    @property
    def batch(self) -> int:
        return int(self.dims.shape[0])

    @property
    def masked(self) -> bool:
        """The batch carries a SubOpt mask plane (kernel K3)."""
        return self.blocked.numel() > 0


def _scope_start(scope: int, si, sj):
    if scope == SCOPE_ANYWHERE:
        return None
    if scope == SCOPE_EDGE:
        return (si == 0) | (sj == 0)
    if scope == SCOPE_QUERY:
        return si == 0
    if scope == SCOPE_TARGET:
        return sj == 0
    return (si == 0) & (sj == 0)


def _scope_end(scope: int, i, j, qlen, tlen):
    if scope == SCOPE_ANYWHERE:
        return None
    if scope == SCOPE_EDGE:
        return (i == qlen) | (j == tlen)
    if scope == SCOPE_QUERY:
        return i == qlen
    if scope == SCOPE_TARGET:
        return j == tlen
    return (i == qlen) & (j == tlen)


def split_codon(phase: int, tin, sel, cand, rows):
    """Kernel K9's plain version (``_make_split_pallas_fn``,
    ``exonerate_tpu/model/phase.py:305-327``) on (B, W) int32 planes.

    ``tin`` is the "target intron" lane (the intron's absolute start);
    ``sel`` selects one of the three ``cand`` planes by ``sel // 6`` and
    a 5-bit amino-acid index in it by ``sel % 6`` (phase 1: sel is the
    "split c1" lane, cand the E1p0..2 columns; phase 2: sel is the N4
    column, cand the "split p2k0..2" lanes); ``rows`` (B, 25, W) are the
    query rows R0..R24.  The score is R_aa, 0 for aa >= 25 and NEG where
    ``tin < phase``.  Division and modulo floor, as ``jnp``'s do."""
    k = torch.div(sel, 6, rounding_mode="floor")
    sub = torch.zeros_like(sel)
    for kk in range(3):
        sub = torch.where(k == kk, cand[kk], sub)
    aa = (sub >> (5 * (sel - 6 * k))) & 31
    score = torch.gather(rows, 1, aa.clamp(max=24).long()[:, None])[:, 0]
    score = torch.where(aa < 25, score, 0)
    return torch.where(tin >= phase, score, NEG)


class Lanes:
    """A run of query lanes ``[lo, lo + n)`` of a batch's diagonals on one
    device: what the cell step (``cell_step``) reads.  ``plain_wavefront``
    runs one over every lane; ``parallel/sharded_pair.py`` runs one per
    device, a query slab each, or reads the target vectors from the
    devices that hold their tiles (``twin``)."""

    def __init__(self, ki: KernelInputs, lo: int = 0, n: int = None,
                 device: torch.device = None, twin=None):
        dev = device if device is not None else ki.dims.device
        n = ki.Qp + 1 - lo if n is None else n
        self.ki, self.lo, self.n, self.dev = ki, lo, n, dev
        self.B = ki.batch
        self.plan = ki.plan.tolist()
        self.i = torch.arange(lo, lo + n, dtype=torch.int32, device=dev)
        self.i_long = self.i.long()
        dims = ki.dims.to(dev)
        self.qstart, self.tstart, self.qlen, self.tlen = (
            dims[:, c:c + 1] for c in range(4))
        self.neg = torch.full((self.B, n), NEG, dtype=torch.int32,
                              device=dev)
        self.zero = torch.zeros((self.B, n), dtype=torch.int32, device=dev)
        self.qv = ki.qvecs[:, :, lo:lo + n].to(dev)
        self.tabs = ki.tables.to(dev)
        self.scal = ki.scalars.to(dev)
        self.blocked = ki.blocked.to(dev) if ki.masked else None
        if twin is None:
            trev = reversed_targets(ki).to(dev)

            def twin(c, st):
                return trev[:, c, st + lo:st + lo + n]
        self.twin = twin


def reversed_targets(ki: KernelInputs) -> torch.Tensor:
    """The (B, NT, 2 W + Tp + 1 + K) reversed, padded target vectors whose
    slice from ``W + Tp - d + at`` holds diagonal d's values for the lanes
    0..W-1 (W = Qp + 1), as ``Lanes`` builds them."""
    W = ki.Qp + 1
    return F.pad(torch.flip(ki.tvecs, dims=(2,)), (W, W + ki.K))


def cell_step(c: Lanes, d: int, fetch) -> tuple:
    """The cells of diagonal ``d`` on the lanes ``c``: every plan row in
    order, for one diagonal.  ``fetch(inp, adv, aq)`` returns the source
    state's score plane and lane planes of diagonal ``d - adv``, shifted
    down ``aq`` lanes (the fill below lane 0 is NEG and 0).  Returns
    (scores, lanes, tbv): per state a (B, n) plane or None where nothing
    reached it, its lanes, and its winning plan ids (path mode)."""
    ki = c.ki
    want_region = ki.mode == "region"
    want_path = ki.mode == "path"
    S, L = ki.S, ki.L
    rs_q, rs_t = ki.n_shadow, ki.n_shadow + 1
    i, W, dev = c.i, c.n, c.dev
    zero, neg = c.zero, c.neg
    qv, tabs, scal = c.qv, c.tabs, c.scal
    qstart, tstart, qlen, tlen = c.qstart, c.tstart, c.qlen, c.tlen
    j = d - i
    cell_ok = (j >= 0) & (j <= tlen) & (i <= qlen)           # (B, n)
    masks: dict = {}
    reads: dict = {}
    calcs: dict = {}
    scores: list = [None] * S
    lanes: list = [[None] * L for _ in range(S)]
    tbv: list = [None] * S
    if c.blocked is not None:
        # the blocked destination cells (i, d - i) of this diagonal:
        # their bits of the packed plane, np.packbits order
        i_long = c.i_long
        jd = (d - i_long).clamp(0, ki.Tp)
        byte = c.blocked[:, i_long, jd >> 3]
        blk = (((byte >> (7 - (jd & 7)).to(torch.uint8)) & 1) != 0) \
            & (d - i_long >= 0) & (d - i_long <= ki.Tp)
    for pid, row in enumerate(c.plan):
        aq, at = row[P_AQ], row[P_AT]
        inp, out, flags = row[P_IN], row[P_OUT], row[P_FLAGS]
        adv = aq + at
        si, sj = i - aq, j - at
        ok = masks.get((aq, at))
        if ok is None:
            ok = masks[(aq, at)] = cell_ok & (i >= aq) & (j >= at)
        if flags & F_FROM_START:
            sm = _scope_start(ki.start_scope, si, sj)
            if sm is not None:
                ok = ok & sm
            base = 0
            src_l = [zero] * L
        elif adv == 0:
            if scores[inp] is None:
                continue             # nothing reached this state yet
            base = scores[inp]
            src_l = [v if v is not None else zero for v in lanes[inp]]
        else:
            hit = reads.get((inp, adv, aq))
            if hit is None:
                hit = reads[(inp, adv, aq)] = fetch(inp, adv, aq)
            base, src_l = hit
        if flags & F_TO_END:
            em = _scope_end(ki.end_scope, i, j, qlen, tlen)
            if em is not None:
                ok = ok & em
        kind = row[P_CALC]
        st = ki.Qp + 1 + ki.Tp - d + at
        ckey = (kind, row[P_C0], row[P_C1], at)
        calc = calcs.get(ckey) if kind != C_SPLIT else None
        if kind == C_SPLIT:
            # reads the source cell's lanes: never shared
            if row[P_C2] == 1:
                sel = src_l[row[P_C4]]
                cand = [c.twin(row[P_C1] + k, st) for k in range(3)]
            else:
                sel = c.twin(row[P_C1], st)
                cand = [src_l[row[x]] for x in (P_C4, P_C5, P_C6)]
            calc = split_codon(row[P_C2], src_l[row[P_C3]], sel, cand,
                               qv[:, row[P_C0]:row[P_C0] + 25])
        elif calc is None:
            if kind == C_NONE:
                calc = 0
            elif kind == C_SCALAR:
                calc = scal[:, row[P_C0]:row[P_C0] + 1]
            elif kind == C_QVEC:
                calc = qv[:, row[P_C0]]
            elif kind == C_TVEC:
                calc = c.twin(row[P_C0], st)
            else:                    # C_FACTORED
                idx = (qv[:, row[P_C0]] * row[P_C3]
                       + c.twin(row[P_C1], st) + row[P_C2])
                g = torch.gather(tabs, 1, idx.long())
                ov = qv[:, row[P_C4]]
                calc = torch.where(ov != 0, ov, g)
            calcs[ckey] = calc
        if flags & (F_SH_Q | F_SH_T):
            # intron length window (model/intron.py:140-149) on the
            # SOURCE position and the source cell's shadow lane
            lo = scal[:, row[P_SH_MIN]:row[P_SH_MIN] + 1]
            hi = scal[:, row[P_SH_MAX]:row[P_SH_MAX] + 1]
            bad = None
            for flag, pos, lane in ((F_SH_Q, si + qstart, P_SH_LANE_Q),
                                    (F_SH_T, sj + tstart, P_SH_LANE_T)):
                if flags & flag:
                    length = pos - src_l[row[lane]] + 2
                    b = (length < lo) | (length > hi)
                    bad = b if bad is None else bad | b
            calc = torch.where(bad, NEG, torch.as_tensor(
                calc, dtype=torch.int32, device=dev))
        val = base + calc            # int32, wraps like the reference
        if not torch.is_tensor(val):
            val = torch.full((c.B, W), val, dtype=torch.int32, device=dev)
        if flags & F_P_UNDER:
            val = torch.clamp(val, min=NEG)
        if flags & F_P_OVER:
            val = torch.clamp(val, max=IMPOSSIBLY_HIGH_SCORE)
        val = torch.clamp(val, min=NEG)
        keep = ok if flags & F_FROM_START else ok & (base > NEG)
        if c.blocked is not None and flags & F_MATCH:
            keep = keep & ~blk
        val = torch.where(keep, val, NEG)
        cur = scores[out] if scores[out] is not None else neg
        take = val > cur             # strict: first max wins
        scores[out] = torch.where(take, val, cur)
        if want_path:
            old = tbv[out] if tbv[out] is not None else zero
            tbv[out] = torch.where(take, pid + 1, old)
        if L:
            new_l = list(src_l)
            for k in range(row[P_NSTART]):
                des, src = row[P_ST_DES0 + 2 * k], row[P_ST_SRC0 + 2 * k]
                if src == ST_TARGET:
                    new_l[des] = sj + tstart
                elif src == ST_QUERY:
                    new_l[des] = si + qstart
                else:
                    new_l[des] = c.twin(src - ST_TVEC, st)
            if want_region and flags & F_FROM_START:
                new_l[rs_q], new_l[rs_t] = si, sj
            for ln in range(L):
                old = lanes[out][ln]
                lanes[out][ln] = torch.where(
                    take, new_l[ln], old if old is not None else zero)
    return scores, lanes, tbv


class EndCells:
    """Per-lane best end cells of a run of lanes (score, j and, in region
    mode, the region's start lanes): per lane (fixed i) j grows with d,
    so strict > keeps the smallest-j end cell of each score."""

    def __init__(self, c: Lanes):
        self.sc, self.j, self.qs, self.ts = c.neg, c.zero, c.zero, c.zero

    def update(self, c: Lanes, d: int, scores: list, lanes: list) -> None:
        ki = c.ki
        es = scores[ki.end_id]
        if es is None:
            return
        take_e = es > self.sc
        self.sc = torch.where(take_e, es, self.sc)
        self.j = torch.where(take_e, d - c.i, self.j)
        if ki.mode == "region":
            e_ln = lanes[ki.end_id]
            self.qs = torch.where(take_e, e_ln[ki.n_shadow], self.qs)
            self.ts = torch.where(take_e, e_ln[ki.n_shadow + 1], self.ts)


def end_winner(b_sc, b_j, b_qs, b_ts, i) -> torch.Tensor:
    """The (5, B) lexicographic winner of per-lane best planes: max score,
    then min j, then min i; NEG, 0, 0, 0, 0 where no cell scored."""
    big = 1 << 30
    m = b_sc.max(dim=1).values
    tie = b_sc == m[:, None]
    jmin = torch.where(tie, b_j, big).min(dim=1).values
    tie2 = tie & (b_j == jmin[:, None])
    imin = torch.where(tie2, i, big).min(dim=1).values
    sel = tie2 & (i == imin[:, None])
    qs = torch.where(sel, b_qs, 0).sum(dim=1)
    ts = torch.where(sel, b_ts, 0).sum(dim=1)
    found = m > NEG
    return torch.stack([torch.where(found, x, dead).to(torch.int32)
                        for x, dead in ((m, NEG), (imin, 0), (jmin, 0),
                                        (qs, 0), (ts, 0))])


def plain_wavefront(ki: KernelInputs, span=None, ring=None):
    """The whole wavefront for a batch, in plain PyTorch.

    Returns ``(out, tb)``: ``out`` is a (5, B) int32 tensor of score,
    query_end, target_end, query_start, target_start (the starts are 0
    outside region mode; a pair with no alignment reports NEG, 0, 0, 0,
    0), and ``tb`` the (B, Qp+Tp+1, S, Qp+1) uint8 cube of winning plan
    ids (``plan row + 1``, 0 = unset) in path mode, else None.

    A segment of the checkpointed traceback runs only the diagonals
    ``span = (d0, d1)``: ``ring`` is the kernels' (ring, lring) pair of
    (B, K+1, rows, Qp+1) int32 carry rings, read at d0 (the diagonals
    before it, as the launch over [0, d0) left them) and written with
    the span's last diagonals; ``out`` is the best end cell within the
    span, and ``tb`` holds its d1 - d0 diagonals."""
    want_path = ki.mode == "path"
    c = Lanes(ki)
    dev = c.dev
    B, W, D = ki.batch, ki.Qp + 1, ki.Qp + ki.Tp + 1
    d0, d1 = span if span is not None else (0, D)
    S, L, K = ki.S, ki.L, ki.K
    neg, zero = c.neg, c.zero
    ends = EndCells(c)
    tb = (torch.zeros((B, d1 - d0, S, W), dtype=torch.uint8, device=dev)
          if want_path else None)
    blank = ([neg] * S, [[zero] * L for _ in range(S)])
    prev = [blank] * K                # prev[k]: diagonal d-1-k
    ring_row = ki.ring_row.tolist()
    lane_row = ki.lane_row.tolist()
    if ring is not None:
        # the carry of the diagonals before d0, from the kernels' rings
        # (a state or lane without a ring row is never read across one)
        for k in range(min(K, d0)):
            slot = (d0 - 1 - k) % (K + 1)
            prev[k] = (
                [ring[0][:, slot, r] if r >= 0 else neg for r in ring_row],
                [[ring[1][:, slot, lr] if lr >= 0 else zero
                  for lr in lane_row[s][:L]] for s in range(S)])

    def shift(x, aq, fill):
        return F.pad(x[:, :W - aq], (aq, 0), value=fill) if aq else x

    def fetch(inp, adv, aq):
        p_sc, p_ln = prev[adv - 1]
        return (shift(p_sc[inp], aq, NEG),
                [shift(v, aq, 0) for v in p_ln[inp]])

    for d in range(d0, d1):
        scores, lanes, tbv = cell_step(c, d, fetch)
        ends.update(c, d, scores, lanes)
        if want_path:
            tb[:, d - d0] = torch.stack([v if v is not None else zero
                                         for v in tbv], dim=1).to(torch.uint8)
        new_diag = ([v if v is not None else neg for v in scores],
                    [[v if v is not None else zero for v in lanes[s]]
                     for s in range(S)])
        prev = [new_diag] + prev[:-1]
    if ring is not None:
        # the span's last K diagonals into their ring slots
        for k in range(min(K, d1)):
            slot = (d1 - 1 - k) % (K + 1)
            p_sc, p_ln = prev[k]
            for s, r in enumerate(ring_row):
                if r >= 0:
                    ring[0][:, slot, r] = p_sc[s]
                for ln, lr in enumerate(lane_row[s][:L]):
                    if lr >= 0:
                        ring[1][:, slot, lr] = p_ln[s][ln]
    out = end_winner(ends.sc, ends.j, ends.qs, ends.ts, c.i)
    return out, tb


# why a walk stopped (``plain_walk_segment``'s status, ``csrc/walkback.cu``)
WALK_END = 0       # id 0: no transition into the cell
WALK_START = 1     # after a transition from START
WALK_CAP = 2       # ``cap`` steps taken
WALK_LEFT = 3      # the next cell's diagonal is below the segment's first
WALK_BAD = 4       # not a plan id

# csrc/walkback.cu's tiles: query columns, the bytes of one buffer (rows
# of TC / 16 + 1 16-byte blocks, a row's first byte anywhere in its 16),
# and the diagonals and columns a tile in flight reaches past the walk's
# course
WALK_TC = 64
WALK_ROW_BYTES = 16 * (WALK_TC // 16 + 1)
WALK_TILE_BYTES = 112 * 1024
WALK_MARGIN = 4


def walk_tile(walk: torch.Tensor, S: int) -> tuple:
    """(TD, TC): the diagonals and query columns of the walk-back kernel's
    tiles for the id table ``walk`` and S states (``load_table`` in
    ``csrc/walkback.cu``): TD = TC x the most diagonals a step spends per
    query column, capped to the rows a buffer holds."""
    aq, at = walk[0].tolist(), walk[1].tolist()
    r = max([1] + [-(-(a + t) // a) for a, t in zip(aq[1:], at[1:])
                   if a > 0])
    rows = WALK_TILE_BYTES // WALK_ROW_BYTES
    return max(1, min(WALK_TC * r, rows // S)), WALK_TC


def _walk(tbn: np.ndarray, d0: int, segment: bool, i: int, j: int, s: int,
          cap: int, tables: tuple, ops: np.ndarray) -> tuple:
    """One walk over the (D, S, W) planes ``tbn`` of diagonals [d0, d0 +
    D) from cell (i, j) in state s, its ids written to ``ops``; d and i
    are clamped into the planes, and with ``segment`` a cell whose
    diagonal is below d0 stops the walk (WALK_LEFT).  Returns (n_ops, i,
    j, s, status)."""
    D, _, W = tbn.shape
    aq_t, at_t, in_t, fs_t = tables
    k = 0
    while True:
        d = i + j
        if segment and d < d0:
            return k, i, j, s, WALK_LEFT
        tid = int(tbn[min(max(d - d0, 0), D - 1), s, min(max(i, 0), W - 1)])
        if tid == 0:
            return k, i, j, s, WALK_END
        if k >= cap:
            return k, i, j, s, WALK_CAP
        if tid >= len(aq_t):
            return k, i, j, s, WALK_BAD
        ops[k] = tid
        k += 1
        i -= aq_t[tid]
        j -= at_t[tid]
        s = in_t[tid]
        if fs_t[tid]:
            return k, i, j, s, WALK_START


def plain_walkback(tb: torch.Tensor, stats: torch.Tensor,
                   walk: torch.Tensor, end_id: int, cap: int):
    """Walk the traceback cube back from each pair's best end cell
    (``pallas_wavefront._build_walkback:1564-1587``).

    ``tb`` is (B, D, S, W) uint8, ``stats`` the (5, B) wavefront output
    (rows 1, 2 are the end cell), ``walk`` the (4, P+1) id table.
    Returns ``(ops, res)``: (B, cap) int32 plan ids end->start, and
    (3, B) int32 rows n_ops, query_start, target_start.  A walk stops on
    id 0 or at ``cap`` steps (n_ops == cap marks it unusable, as does an
    id that is not a plan id), and ends after a transition from START."""
    B = tb.shape[0]
    tbn = tb.cpu().numpy()
    qe, te = stats[1].tolist(), stats[2].tolist()
    tables = tuple(walk.tolist())
    ops = np.zeros((B, cap), np.int32)
    res = np.zeros((3, B), np.int32)
    for b in range(B):
        k, i, j, _s, status = _walk(tbn[b], 0, False, qe[b], te[b], end_id,
                                    cap, tables, ops[b])
        res[:, b] = (cap if status == WALK_BAD else k, i, j)
    return (torch.from_numpy(ops).to(tb.device),
            torch.from_numpy(res).to(tb.device))


def plain_walk_segment(planes: torch.Tensor, d0: int, cell: torch.Tensor,
                       walk: torch.Tensor, cap: int):
    """Walk each pair's segment of traceback planes back from a given cell
    and state: the plain version of ``csrc/walkback.cu``'s segment entry
    point, which walks the checkpointed traceback's segments on the card.

    ``planes`` is (B, D, S, W) uint8, the planes of diagonals [d0, d0 +
    D) (``cuda_wavefront.wavefront_segment``'s); ``cell`` (3, B) int32
    rows i, j, state.  A walk stops on id 0 (WALK_END), after a
    transition from START (WALK_START), at ``cap`` steps (WALK_CAP), when
    the next cell's diagonal falls below d0 (WALK_LEFT) or on an id that
    is not a plan id (WALK_BAD).  Returns ``(ops, res)``: (B, cap) int32
    plan ids end->start, and (5, B) int32 rows n_ops, i, j, state,
    status: the cell and state it stopped at."""
    B = planes.shape[0]
    tbn = planes.cpu().numpy()
    start = cell.tolist()
    tables = tuple(walk.tolist())
    ops = np.zeros((B, cap), np.int32)
    res = np.zeros((5, B), np.int32)
    for b in range(B):
        res[:, b] = _walk(tbn[b], d0, True, start[0][b], start[1][b],
                          start[2][b], cap, tables, ops[b])
    return (torch.from_numpy(ops).to(planes.device),
            torch.from_numpy(res).to(planes.device))
