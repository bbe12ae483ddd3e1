"""The seeded band scan: host prep and the plain PyTorch engine.

Counterpart of ``exonerate_tpu/engine/sdp_device.py``, which imports JAX.
Two parts:

- Host prep (``supported``, ``prepare_inputs``, ``prepare_seeds``,
  ``_plan_transitions``, ``_span_plan``): NumPy copies of the JAX
  module's functions, unchanged.
- ``plain_band_reverse`` / ``plain_band_forward`` (together
  ``plain_band_scan``): the plain PyTorch version of the hand-written
  band kernels K6 and K7 in ``csrc/sdp_band.cu``.  They are the torch
  twin of ``build_pass`` (``sdp_device.py:297``) in boundary mode,
  batched over B and vectorised over the query lanes i in [0, Qp], one
  Python loop step per compressed diagonal, and interpret the same int32
  candidate tables as the kernels (built by ``cuda_sdp.to_band_inputs``).

The semantics are those of ``sdp_device.py:1-37`` as the Pallas kernel
(``sdp_pallas.make_kernel``) evaluates them: candidate order
``(-at, -aq, rix)`` with strict ``>`` replacement; the span phase, then
the silent sweep, after the advancing merge; pmax lanes and dropoff;
the forward kill of negatives and the protect clamps; span freeze/thaw
with per-column stored/curr registers (the curr plane shifted one lane
per diagonal for joint spans); the reverse pass scoring shadowed
transitions as 0 and emitting boundary flags; ``live`` on ``_edge``
columns, and ``xband``.  A W-axis vector read outside [0, Wp] gives 0,
as the Pallas kernel's zero-padded frame does.  Only the diagonals
``d <= qlen + wlen`` that hold a valid cell of some pair are walked:
the others cannot change an output.

On CPU tensors this is the port's band-scan engine; on the card it is
what the kernels are held against.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .sdp_bands import BandPlan, edge_cols
from .wavefront import split_codon
from ..model.ir import (IMPOSSIBLY_HIGH_SCORE, IMPOSSIBLY_LOW_SCORE,
                        Model, Protect)

NEG = IMPOSSIBLY_LOW_SCORE
POS = IMPOSSIBLY_HIGH_SCORE


# ---------------------------------------------------------------------------
# host prep — copies of the JAX module's functions
# ---------------------------------------------------------------------------

def supported(model: Model) -> bool:
    """Can the band scan express this model exactly?  (``sdp_device.py:61``:
    shadow start vectors only for target positions, and every cross-cell
    read sees the final post-silent value in both pass directions.)"""
    for sh in model.shadows:
        if sh.start_vec_fn is not None and sh.start != "target_pos":
            return False
    rev = list(model.transitions)[::-1]
    for s in model.states:
        for direction in ("fwd", "rev"):
            if direction == "fwd":
                writes = [i for i, t in enumerate(rev)
                          if t.output is s and t.is_silent]
                reads = [i for i, t in enumerate(rev)
                         if t.input is s and not t.is_silent]
            else:
                writes = [i for i, t in enumerate(rev)
                          if t.input is s and t.is_silent]
                reads = [i for i, t in enumerate(rev)
                         if t.output is s and not t.is_silent]
            if writes and reads:
                full = len(writes)
                for r in reads:
                    if sum(1 for w in writes if w < r) != full:
                        return False
    return True


def prepare_inputs(model: Model, pair, plan: BandPlan,
                   pad_to=None) -> tuple[dict, tuple]:
    """Compressed-target arrays from an SDPPair's materialized calc forms.
    Returns (inputs, kinds)."""
    Q = pair.region.query_length
    W = plan.W
    Qp, Wp = pad_to if pad_to is not None else (Q, W)
    abs_t = plan.abs_t
    inputs: dict = {}
    kinds: dict = {}

    def pad_q(v, fill=0):
        v = np.asarray(v)
        out = np.full((Qp + 1,) + v.shape[1:], fill, v.dtype)
        out[:Q + 1] = v
        return out

    def pad_w(v, fill=0):
        v = np.asarray(v)
        out = np.full((Wp + 1,) + v.shape[1:], fill, v.dtype)
        out[:W + 1] = v
        return out

    for ci, c in enumerate(model.calcs):
        key = f"c{ci}"
        if id(c) in pair.qt:
            qv, tv = pair.qt[id(c)]
            inputs[key] = {"q": pad_q(qv.astype(np.int32)),
                           "t": pad_w(tv[abs_t].astype(np.int32))}
            kinds[key] = "qt"
        elif id(c) in pair.factored:
            table, q_idx, t_idx, q_over = pair.factored[id(c)]
            inputs[key] = {
                "table": table.astype(np.int32),
                "q_idx": pad_q(q_idx.astype(np.int32),
                               fill=table.shape[0] - 1),
                "t_idx": pad_w(t_idx[abs_t].astype(np.int32),
                               fill=table.shape[1] - 1),
                "q_over": pad_q((q_over if q_over is not None
                                 else np.zeros(Q + 1)).astype(np.int32)),
            }
            kinds[key] = "factored"
        elif id(c) in pair.grids:
            g = pair.grids[id(c)]
            if g.ndim == 0:
                inputs[key] = np.int32(g)
                kinds[key] = "scalar"
            elif g.ndim == 2 and g.shape[0] > 1 and g.shape[1] > 1:
                raise ValueError("true 2-D grid unsupported on device")
            elif g.ndim == 2 and g.shape[0] > 1:
                inputs[key] = pad_q(g[:, 0].astype(np.int32))
                kinds[key] = "qvec"
            elif g.ndim == 2:
                inputs[key] = pad_w(g[0, abs_t].astype(np.int32))
                kinds[key] = "tvec"
            elif g.shape[0] == Q + 1:
                inputs[key] = pad_q(g.astype(np.int32))
                kinds[key] = "qvec"
            else:
                inputs[key] = pad_w(g[abs_t].astype(np.int32))
                kinds[key] = "tvec"
        if c.shadow_inputs_fn is not None:
            inputs[f"sh{ci}"] = pair.shadow_inputs[id(c)]
    for sx, sh in enumerate(model.shadows):
        if sh.start_vec_fn is not None:
            vec = np.asarray(sh.start_vec_fn(pair.region, pair.data))
            inputs[f"shv{sx}"] = pad_w(vec[abs_t].astype(np.int32))
    inputs["_abs_t"] = pad_w(abs_t.astype(np.int32), fill=-(10 ** 9))
    inputs["_edge"] = pad_w(
        edge_cols(plan.seg_id, plan.abs_t,
                  pair.region.target_length,
                  width=max(model.max_target_advance, 1)
                  ).astype(np.bool_))
    inputs["_seg"] = pad_w(plan.locus_of_v.astype(np.int32))
    inputs["_qlen"] = np.int32(Q)
    inputs["_wlen"] = np.int32(W)
    return inputs, tuple(sorted(kinds.items()))


def prepare_seeds(pair, plan: BandPlan, n_seed_pad: int) -> dict:
    """Seed arrays in compressed coordinates (global seed order)."""
    seeds = pair.seeds
    n = len(seeds)
    assert n <= n_seed_pad
    d_k = np.full(n_seed_pad, -1, np.int32)
    q_k = np.zeros(n_seed_pad, np.int32)
    half_k = np.zeros(n_seed_pad, np.int32)
    band_ix = 0
    for k, s in enumerate(seeds):
        while not (plan.bands[band_ix].t0 <= s.t_cobs
                   <= plan.bands[band_ix].t1):
            band_ix += 1
        v = plan.to_v(band_ix, s.t_cobs)
        d_k[k] = s.q_cobs + v
        q_k[k] = s.q_cobs
        half_k[k] = s.hsp_score >> 1
    return {"_seed_d": d_k, "_seed_q": q_k, "_seed_half": half_k,
            "_nseed": np.int32(n)}


def _plan_transitions(model: Model, is_forward: bool):
    """Candidate plans of a pass: (advancing, sorted by push order;
    silent, in reverse-model order).  Forward reads t.input and writes
    t.output; reverse the opposite."""
    rev = list(model.transitions)[::-1]
    adv, silent = [], []
    span_states = {sp.span_state.id for sp in model.spans}
    start_id = model.start_state.state.id
    end_id = model.end_state.state.id
    for rix, t in enumerate(rev):
        is_loop = (t.input is t.output and t.calc is None
                   and not t.is_silent)
        if is_loop and t.input.id in span_states:
            continue                      # span loops never walk cells
        e = dict(
            t=t, rix=rix, aq=t.advance_query, at=t.advance_target,
            read=(t.input.id if is_forward else t.output.id),
            write=(t.output.id if is_forward else t.input.id),
            calc=t.calc,
            p_under=(t.calc is not None
                     and bool(t.calc.protect & Protect.UNDERFLOW)),
            p_over=(t.calc is not None
                    and bool(t.calc.protect & Protect.OVERFLOW)),
            rev_shadowed=(not is_forward and bool(t.dst_shadows)),
            event=(is_forward and t.output.id == end_id)
                  or (not is_forward and t.input.id == start_id),
            shadow_starts=[(sh.designation, sh.start,
                            (None if sh.start_vec_fn is None
                             else model.shadows.index(sh)))
                           for sh in model.src_shadows(t.input)]
            if is_forward else [],
            dst_shadows=[(sh.name, sh.designation)
                         for sh in t.dst_shadows],
        )
        if t.is_silent:
            silent.append(e)
        else:
            adv.append(e)
    adv.sort(key=lambda e: (-e["at"], -e["aq"], e["rix"]))
    silent.sort(key=lambda e: e["rix"])
    return adv, silent


def _span_plan(model: Model):
    """Per span: state id, max_target/max_query windows, and whether the
    loop's submit reads the post-thaw value."""
    rev = list(model.transitions)[::-1]
    plans = []
    for sp in model.spans:
        st = sp.span_state
        loop_pos = max(i for i, t in enumerate(rev)
                       if t.input is st and t.output is st
                       and t.calc is None)
        thaw_pos = min((i for i, t in enumerate(rev)
                        if t.input is st
                        and not (t.input is t.output and t.calc is None)),
                       default=10 ** 9)
        plans.append(dict(state=st.id, max_target=sp.max_target,
                          max_query=sp.max_query,
                          submit_post_thaw=thaw_pos < loop_pos))
    return plans


# ---------------------------------------------------------------------------
# the candidate tables (csrc/sdp_band.cu declares the same numbers)
# ---------------------------------------------------------------------------

(BP_AQ, BP_AT, BP_READ, BP_WRITE, BP_FLAGS, BP_CALC, BP_C0, BP_C1, BP_C2,
 BP_C3, BP_CONTIG, BP_SH_LANE_Q, BP_SH_LANE_T, BP_SH_MIN, BP_SH_MAX,
 BP_C4, BP_C5, BP_C6, BP_NSTART, BP_ST_DES0, BP_ST_SRC0) = range(21)
MAX_STARTS = 4
BP_COLS = BP_ST_DES0 + 2 * MAX_STARTS      # start k at BP_ST_DES0 + 2k

# BP_ST_SRC codes of a forward start lane: _abs_t or the query lane of the
# source cell, or ST_TVEC + r: tvecs[r] at the source column (a shadow
# start vector, ``Shadow.start_vec_fn``)
ST_TARGET = 0
ST_QUERY = 1
ST_TVEC = 2

# BP_FLAGS bits
BF_P_UNDER = 1        # Protect.UNDERFLOW: clamp to NEG
BF_P_OVER = 2         # Protect.OVERFLOW: clamp to POS
BF_EVENT = 4          # forward: the write is the END state
BF_SH_Q = 8           # intron window on the query lane BP_SH_LANE_Q
BF_SH_T = 16          # intron window on the target lane BP_SH_LANE_T

# BP_CALC kinds: the calc at (i - aq, j - at) forward, (i, j) reverse;
# q rows index qvecs, t rows tvecs, read at the calc lane / column
K_NONE = 0            # 0 (no calc, or a shadowed transition in reverse)
K_QT = 1              # qvecs[C0][qi] + tvecs[C1][tj]
K_FACTORED = 2        # qvecs[C2][qi] if C2 >= 0 and != 0, else
#                       qvecs[C0 + c][qi] with c = tvecs[C1][tj] in [0, C3)
K_SCALAR = 3          # scalars[C0]
K_QVEC = 4            # qvecs[C0][qi]
K_TVEC = 5            # tvecs[C1][tj]
K_SPLIT = 6           # forward only: the split codon (kernel K9,
#   model/phase.py:305), as wavefront.C_SPLIT: C0 = qvecs row of R0
#   (R0..R24 follow, read at lane i), C1 = tvecs row of E1p0 (E1p1, E1p2
#   follow) or N4, read at tj, C2 = phase, C3 = "target intron" lane, C4 =
#   "split c1" or "split p2k0" lane, C5 / C6 = "split p2k1" / "p2k2"

# span table columns
SP_STATE, SP_MAX_T, SP_MAX_Q, SP_POST_THAW = range(4)
SP_COLS = 4


@dataclass
class BandInputs:
    """One batch of comparisons padded to (Qp, Wp), in the kernels' layout.

    All tensors live on one device; the kernels read them in place."""
    rev_plan: torch.Tensor   # (n_rev, BP_COLS) int32: advancing, then silent
    fwd_plan: torch.Tensor   # (n_fwd, BP_COLS) int32
    spans: torch.Tensor      # (max(n_spans, 1), SP_COLS) int32
    rev_ring: torch.Tensor   # (S,) int32: ring row of a state read across
    fwd_ring: torch.Tensor   #   diagonals in that pass, -1 = none
    dims: torch.Tensor       # (B, 2) int32: qlen, wlen
    qvecs: torch.Tensor      # (B, NQ, Qp+1) int32
    tvecs: torch.Tensor      # (B, NT, Wp+1) int32
    scalars: torch.Tensor    # (B, NS) int32
    n_adv_rev: int
    n_adv_fwd: int
    n_spans: int
    Qp: int
    Wp: int
    S: int
    n_sh: int                # shadow designations (forward lanes per state)
    K: int                   # largest advance; the ring holds K+1 diagonals
    NR_rev: int
    NR_fwd: int
    start_id: int
    end_id: int
    dropoff: int
    row_abs_t: int           # tvecs rows of _abs_t, _edge, _seg
    row_edge: int
    row_seg: int
    row_seedq: int           # first of n_layers _seedq rows, then _seedv
    row_seedv: int
    n_layers: int
    split: bool = False      # the forward table holds a split-codon row (K9)

    @property
    def batch(self) -> int:
        return int(self.dims.shape[0])

    @property
    def n_words(self) -> int:
        return (self.Qp + 32) // 32

    @property
    def Dp(self) -> int:
        return self.Qp + self.Wp + 1


# ---------------------------------------------------------------------------
# the plain PyTorch passes
# ---------------------------------------------------------------------------

class _Frame:
    """Per-batch reads shared by both passes: W-axis vectors at column
    j + s of every lane (0 outside [0, Wp]) and lane-shifted q vectors."""

    def __init__(self, bi: BandInputs):
        self.bi = bi
        B, Qp, Wp = bi.batch, bi.Qp, bi.Wp
        self.W = Qp + 1
        dev = bi.dims.device
        self.i = torch.arange(self.W, dtype=torch.int32, device=dev)
        self.qlen = bi.dims[:, 0:1]
        self.wlen = bi.dims[:, 1:2]
        # flipped and zero-padded: lane i of column d + s - i sits at
        # position pad + Wp - d - s + i
        self.pad = Qp + bi.K + 2
        self.trev = F.pad(torch.flip(bi.tvecs, dims=(2,)),
                          (self.pad, self.pad))
        self.qmemo: dict = {}
        self.tmemo: dict = {}
        self.d = 0

    def at(self, d: int) -> None:
        self.d = d
        self.tmemo = {}

    def t(self, row: int, s: int) -> torch.Tensor:
        key = (row, s)
        v = self.tmemo.get(key)
        if v is None:
            st = self.pad + self.bi.Wp - self.d - s
            v = self.tmemo[key] = self.trev[:, row, st:st + self.W]
        return v

    def q(self, row: int, sq: int) -> torch.Tensor:
        key = (row, sq)
        v = self.qmemo.get(key)
        if v is None:
            v = self.qmemo[key] = _shift(self.bi.qvecs[:, row], sq, 0)
        return v


def _shift(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Lane i of the result is lane i - k of ``x`` (k < 0: i + |k|),
    ``fill`` where that lane is outside the plane."""
    if k == 0:
        return x
    n = x.shape[-1]
    if k > 0:
        return F.pad(x[..., :n - k], (k, 0), value=fill)
    return F.pad(x[..., -k:], (0, -k), value=fill)


def _calc(fr: _Frame, row, forward: bool):
    """The calc plane of a candidate row, or None for no calc."""
    kind = row[BP_CALC]
    if kind == K_NONE:
        return None
    sq = row[BP_AQ] if forward else 0
    st = -row[BP_AT] if forward else 0
    if kind == K_SCALAR:
        c0 = row[BP_C0]
        return fr.bi.scalars[:, c0:c0 + 1]
    if kind == K_QVEC:
        return fr.q(row[BP_C0], sq)
    if kind == K_TVEC:
        return fr.t(row[BP_C1], st)
    if kind == K_QT:
        return fr.q(row[BP_C0], sq) + fr.t(row[BP_C1], st)
    # K_FACTORED: a class per column, a query plane per class
    n_cls = row[BP_C3]
    cls = fr.t(row[BP_C1], st)
    key = ("planes", row[BP_C0], n_cls, sq)
    planes = fr.qmemo.get(key)
    if planes is None:
        planes = fr.qmemo[key] = torch.stack(
            [fr.q(row[BP_C0] + c, sq) for c in range(n_cls)], dim=1)
    ok = (cls >= 0) & (cls < n_cls)
    v = torch.gather(planes, 1, cls.clamp(0, n_cls - 1).long()[:, None])
    v = torch.where(ok, v[:, 0], 0)
    if row[BP_C2] >= 0:
        ov = fr.q(row[BP_C2], sq)
        v = torch.where(ov != 0, ov, v)
    return v


def _run_pass(bi: BandInputs, forward: bool, bits_in=None):
    """One pass over the diagonals.  Reverse: returns (bits (B, Dp, NW)
    int32, live (B,) bool).  Forward: (colbest (B, Wp+1) int32, live,
    xband)."""
    fr = _Frame(bi)
    B, W, S, n_sh, K = bi.batch, fr.W, bi.S, bi.n_sh, bi.K
    dev = bi.dims.device
    plan = (bi.fwd_plan if forward else bi.rev_plan).tolist()
    n_adv = bi.n_adv_fwd if forward else bi.n_adv_rev
    ring = (bi.fwd_ring if forward else bi.rev_ring).tolist()
    spans = bi.spans.tolist()[:bi.n_spans] if forward else []
    lanes = forward and n_sh > 0
    i, qlen, wlen = fr.i, fr.qlen, fr.wlen
    neg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
    no_ln = [zero] * n_sh
    blank = ([neg] * S, [neg] * S, [no_ln] * S)
    prev = [blank] * K                 # prev[k]: diagonal d -/+ (k + 1)
    live = torch.zeros(B, dtype=torch.bool, device=dev)
    xband = torch.zeros(B, dtype=torch.bool, device=dev)
    NW = bi.n_words
    if forward:
        colbest = torch.full((B, bi.Wp + 1), NEG, dtype=torch.int32,
                             device=dev)
        # span registers: st sc, pm, te, sg, ln..; cu sc, pm, te, sg, ln..
        regs = [[neg, zero, zero, zero] + [zero] * n_sh
                + [neg, zero, zero, zero] + [zero] * n_sh
                for _ in spans]
        bit_ix = torch.arange(32, dtype=torch.int32, device=dev)
    else:
        bits = torch.zeros((B, bi.Dp, NW), dtype=torch.int32, device=dev)
        weights = (torch.ones(32, dtype=torch.int64, device=dev)
                   << torch.arange(32, device=dev))
    d_hi = int((bi.dims[:, 0] + bi.dims[:, 1]).max())
    order = range(d_hi + 1) if forward else range(d_hi, -1, -1)
    for d in order:
        fr.at(d)
        j = d - i
        cell_ok = (j >= 0) & (j <= wlen) & (i <= qlen)
        sc = [neg] * S
        pm = [neg] * S
        ln = [no_ln] * S
        thaw = None
        if forward:
            word = bits_in[:, d, :]
            b = ((word[:, :, None] >> bit_ix) & 1).reshape(B, -1)[:, :W]
            thaw = (b != 0) & cell_ok
            sc[bi.start_id] = pm[bi.start_id] = torch.where(thaw, zero, neg)
        else:
            row_sc = neg
            for lx in range(bi.n_layers):
                hit = ((fr.t(bi.row_seedq + lx, 0) - 1) == i) & cell_ok
                row_sc = torch.where(
                    hit, torch.maximum(row_sc, fr.t(bi.row_seedv + lx, 0)),
                    row_sc)
            sc[bi.end_id] = pm[bi.end_id] = row_sc
        ev_row = neg
        reads: dict = {}
        masks: dict = {}

        def evaluate(row):
            nonlocal ev_row
            aq, at = row[BP_AQ], row[BP_AT]
            adv, r = aq + at, row[BP_READ]
            if adv == 0:
                s_sc, s_pm, s_ln = sc[r], pm[r], ln[r]
            else:
                key = (r, adv, aq)
                got = reads.get(key)
                if got is None:
                    p_sc, p_pm, p_ln = prev[adv - 1]
                    k = aq if forward else -aq
                    got = reads[key] = (
                        _shift(p_sc[r], k, NEG), _shift(p_pm[r], k, NEG),
                        [_shift(v, k, 0) for v in p_ln[r]] if lanes
                        else no_ln)
                s_sc, s_pm, s_ln = got
            src_ok = masks.get((aq, at))
            if src_ok is None:
                si, sj = (i - aq, j - at) if forward else (i + aq, j + at)
                src_ok = (cell_ok & (si >= 0) & (si <= qlen) & (sj >= 0)
                          & (sj <= wlen))
                if at:
                    src_ok = src_ok & (fr.t(row[BP_CONTIG],
                                            0 if forward else at) != 0)
                masks[(aq, at)] = src_ok
            if row[BP_CALC] == K_SPLIT:
                tj = -at
                if row[BP_C2] == 1:
                    sel = s_ln[row[BP_C4]]
                    cand = [fr.t(row[BP_C1] + k, tj) for k in range(3)]
                else:
                    sel = fr.t(row[BP_C1], tj)
                    cand = [s_ln[row[c]] for c in (BP_C4, BP_C5, BP_C6)]
                tsc = split_codon(row[BP_C2], s_ln[row[BP_C3]], sel, cand,
                                  bi.qvecs[:, row[BP_C0]:row[BP_C0] + 25])
            else:
                tsc = _calc(fr, row, forward)
            flags = row[BP_FLAGS]
            if flags & (BF_SH_Q | BF_SH_T):
                lo = bi.scalars[:, row[BP_SH_MIN]:row[BP_SH_MIN] + 1]
                hi = bi.scalars[:, row[BP_SH_MAX]:row[BP_SH_MAX] + 1]
                bad = torch.zeros_like(cell_ok)
                if flags & BF_SH_Q:
                    length = (i - aq) - s_ln[row[BP_SH_LANE_Q]] + 2
                    bad = bad | (length < lo) | (length > hi)
                if flags & BF_SH_T:
                    length = (fr.t(bi.row_abs_t, -at)
                              - s_ln[row[BP_SH_LANE_T]] + 2)
                    bad = bad | (length < lo) | (length > hi)
                tsc = torch.where(bad, NEG, tsc)
            val = s_sc if tsc is None else s_sc + tsc
            if flags & BF_P_UNDER:
                val = torch.clamp(val, min=NEG)
            if flags & BF_P_OVER:
                val = torch.clamp(val, max=POS)
            ok = src_ok & (s_sc > NEG)
            if forward:
                ok = ok & (val >= 0)
            ok = ok & ((s_pm - val) <= bi.dropoff)
            w = row[BP_WRITE]
            take = ok & (val > sc[w])
            sc[w] = torch.where(take, val, sc[w])
            pm[w] = torch.where(take, torch.maximum(s_pm, val), pm[w])
            if lanes:
                new_l = list(s_ln)
                for k in range(row[BP_NSTART]):
                    src = row[BP_ST_SRC0 + 2 * k]
                    new_l[row[BP_ST_DES0 + 2 * k]] = (
                        fr.t(bi.row_abs_t, -at) if src == ST_TARGET
                        else (i - aq).expand(B, W) if src == ST_QUERY
                        else fr.t(src - ST_TVEC, -at))
                ln[w] = [torch.where(take, a, o)
                         for a, o in zip(new_l, ln[w])]
            if flags & BF_EVENT:
                ev_row = torch.where(take & (val >= s_pm), val, ev_row)

        for row in plan[:n_adv]:
            evaluate(row)
        if spans:
            abs_tv = fr.t(bi.row_abs_t, 0)
            seg_row = fr.t(bi.row_seg, 0)
            for spx, sp in enumerate(spans):
                if sp[SP_MAX_T] == 0:
                    continue          # query-only span: submit is a no-op
                xb = _span_step(regs[spx], sp, sc, pm, ln, thaw, cell_ok,
                                abs_tv, seg_row, n_sh)
                xband = xband | xb.any(dim=1)
        for row in plan[n_adv:]:
            evaluate(row)
        any_live = torch.zeros_like(cell_ok)
        for s in range(S):
            sc[s] = torch.where(cell_ok, sc[s], NEG)
            any_live = any_live | (sc[s] > NEG)
        edge = fr.t(bi.row_edge, 0) != 0
        live = live | (any_live & edge & cell_ok).any(dim=1)
        if forward:
            ev = ev_row > NEG
            if bool(ev.any()):
                bb, ii = torch.nonzero(ev, as_tuple=True)
                jj = (d - ii).long()
                colbest[bb, jj] = torch.maximum(colbest[bb, jj],
                                                ev_row[bb, ii])
        else:
            flag = sc[bi.start_id] >= 0
            for sp in bi.spans.tolist()[:bi.n_spans]:
                flag = flag | (sc[sp[SP_STATE]] > 0)
            flag = F.pad(flag & cell_ok, (0, NW * 32 - W))
            word = (flag.reshape(B, NW, 32).long() * weights).sum(dim=2)
            bits[:, d] = (word - ((word >> 31) << 32)).to(torch.int32)
        prev = [(sc, pm, ln)] + prev[:-1]
    if forward:
        return colbest, live, xband
    return bits, live


def _span_step(reg, sp, sc, pm, ln, thaw, cell_ok, abs_tv, seg_row, n_sh):
    """Span thaw + submit of one span at one diagonal (before the silent
    sweep).  Updates ``reg`` and the running planes in place; returns the
    cross-locus thaw plane."""
    st, max_t = sp[SP_STATE], sp[SP_MAX_T]
    st_sc, st_pm, st_te, st_sg = reg[0:4]
    st_ln = reg[4:4 + n_sh]
    cu_sc, cu_pm, cu_te, cu_sg = reg[4 + n_sh:8 + n_sh]
    cu_ln = reg[8 + n_sh:]
    if sp[SP_MAX_Q] > 0:
        # joint span: the curr register walks the target row, one lane
        # per diagonal; pickup only at thaw cells
        cu_sc, cu_pm = _shift(cu_sc, 1, NEG), _shift(cu_pm, 1, 0)
        cu_te, cu_sg = _shift(cu_te, 1, 0), _shift(cu_sg, 1, 0)
        cu_ln = [_shift(v, 1, 0) for v in cu_ln]
        r_ok = (cu_sc > NEG) & ((cu_te + max_t) >= abs_tv)
        st_ok = (st_sc > NEG) & ((st_te + max_t) >= abs_tv)
        upd = thaw & st_ok & (~r_ok | (cu_sc < st_sc))
        cu_sc = torch.where(upd, st_sc, torch.where(r_ok, cu_sc, NEG))
    else:
        # target-only span: expire stored at thaw cells, refresh curr
        in_w = (st_te + max_t) >= abs_tv
        st_sc = torch.where(thaw & (st_sc > NEG) & ~in_w, NEG, st_sc)
        cu_ok = (cu_sc > NEG) & ((cu_te + max_t) >= abs_tv)
        upd = thaw & (st_sc > NEG) & in_w & (~cu_ok | (cu_sc < st_sc))
        cu_sc = torch.where(thaw & ~cu_ok & ~upd, NEG,
                            torch.where(upd, st_sc, cu_sc))
    cu_pm = torch.where(upd, st_pm, cu_pm)
    cu_te = torch.where(upd, st_te, cu_te)
    cu_sg = torch.where(upd, st_sg, cu_sg)
    cu_ln = [torch.where(upd, a, b) for a, b in zip(st_ln, cu_ln)]
    th = thaw & (cu_sc > NEG) & (sc[st] < cu_sc)
    xb = th & (cu_sg != seg_row)
    pre = (sc[st], pm[st], ln[st])
    sc[st] = torch.where(th, cu_sc, sc[st])
    pm[st] = torch.where(th, cu_pm, pm[st])
    if n_sh:
        ln[st] = [torch.where(th, a, b) for a, b in zip(cu_ln, ln[st])]
    sub_sc, sub_pm, sub_ln = ((sc[st], pm[st], ln[st])
                              if sp[SP_POST_THAW] else pre)
    rep = cell_ok & (sub_sc >= 0) & (sub_sc >= st_sc)
    reg[:] = ([torch.where(rep, sub_sc, st_sc),
               torch.where(rep, sub_pm, st_pm),
               torch.where(rep, abs_tv, st_te),
               torch.where(rep, seg_row, st_sg)]
              + [torch.where(rep, a, b) for a, b in zip(sub_ln, st_ln)]
              + [cu_sc, cu_pm, cu_te, cu_sg] + cu_ln)
    return xb


def plain_band_reverse(bi: BandInputs):
    """K6's plain version: the reverse pass.  Returns (bits (B, Dp, NW)
    int32 with bit i & 31 of word i >> 5 set where lane i of diagonal d is
    a boundary cell, live (B,) bool)."""
    return _run_pass(bi, forward=False)


def plain_band_forward(bi: BandInputs, bits: torch.Tensor):
    """K7's plain version: the forward pass from the reverse pass's
    boundary bits.  Returns (colbest (B, Wp+1) int32, the best end score
    per compressed column, NEG where none; live (B,) bool; xband (B,)
    bool)."""
    return _run_pass(bi, forward=True, bits_in=bits)


def plain_band_scan(bi: BandInputs) -> dict:
    """Both passes in plain PyTorch: {"colbest", "live", "xband"} per pair
    of the batch (``live`` from either pass, ``xband`` from the forward
    pass).  ``cuda_sdp.locus_best`` reduces ``colbest`` to each locus's
    best end score."""
    bits, live_r = plain_band_reverse(bi)
    colbest, live_f, xband = plain_band_forward(bi, bits)
    return {"colbest": colbest, "live": live_r | live_f, "xband": xband}
