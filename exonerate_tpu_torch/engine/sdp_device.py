"""The seeded band scan: host prep and the plain PyTorch engine.

Counterpart of ``exonerate_tpu/engine/sdp_device.py``, which imports JAX.
Two parts:

- Host prep (``supported``, ``prepare_inputs``, ``prepare_seeds``,
  ``_plan_transitions``, ``_span_plan``): NumPy copies of the JAX
  module's functions, unchanged.
- ``plain_band_reverse`` / ``plain_band_forward`` (together
  ``plain_band_scan``): the plain PyTorch version of the hand-written
  band kernels K6 and K7 in ``csrc/sdp_band.cu``.  They are the torch
  twin of ``build_pass`` (``sdp_device.py:297``), batched over B and
  vectorised over the query lanes i in [0, Qp], one Python loop step per
  compressed diagonal, and interpret the int32 candidate tables that the
  kernels compile in (built by ``cuda_sdp.to_band_inputs``).  A boundary
  model's reverse pass emits the boundary bits that seed the forward
  pass; a non-boundary model's (``use_boundary=False``, ``track_sid``
  in ``build_pass``) carries a seed id per state and cell and hands the
  forward pass each seed's best start score instead
  (``sdp_device.py:384-413``, ``:470``, ``:486-490``, ``:701-705``).
  Given a ``Halo`` they are the plain version of K8, the cross-chip band
  scan, on one chunk of a comparison (``cuda_sdp.cross_chunks``).

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
from typing import Optional

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
    # non-boundary models: per seed layer, the largest seed index of the
    # seeds at the cell (_seedi rows) and that seed's half score (_seedh
    # rows); n_seed the width of the per-seed start scores (B, n_seed)
    use_boundary: bool = True
    row_seedi: int = -1
    row_seedh: int = -1
    n_seed: int = 0
    split: bool = False      # the forward table holds a split-codon row (K9)
    # K8 (one chunk of one comparison): the W-axis rows at columns -1 ..
    # -maxat, (B, NT, maxat), and which spans are joint (query and target)
    tctx: Optional[torch.Tensor] = None
    maxat: int = 0
    span_joint: tuple = ()
    qmax: int = 0            # the largest qlen of the batch, known on the
    #                          host (0: Qp)
    header: str = ""         # both passes' tables compiled into the
    #                          kernels (plan_cuda.band_header)
    n_diag: int = 0          # the diagonals of the batch's longest
    #                          comparison, qlen + wlen + 1 (0: Qp + Wp + 1)

    @property
    def batch(self) -> int:
        return int(self.dims.shape[0])

    @property
    def track_sid(self) -> bool:
        """The reverse pass attributes start scores to seeds
        (``build_pass``'s ``track_sid``)."""
        return not self.use_boundary

    @property
    def n_words(self) -> int:
        return (self.Qp + 32) // 32

    @property
    def Dp(self) -> int:
        return self.Qp + self.Wp + 1


@dataclass
class Halo:
    """What one chunk of K8 (the cross-chip band scan) hands the next: per
    ring state of the pass, the values of the chunk's edge columns
    (forward: column wlen + 1 - k, reverse: column k - 1, in plane k - 1
    of ``maxat``), indexed by query lane; and, forward, the span
    registers (n_spans, 2, 4 + n_sh, Qp+1), stored then curr, each sc,
    pm, te, sg, lanes."""
    sc: torch.Tensor              # (NR, maxat, Qp+1) int32
    pm: torch.Tensor
    ln: Optional[torch.Tensor]    # (NR * n_sh, maxat, Qp+1), forward
    span: Optional[torch.Tensor]

    def to(self, device: torch.device) -> "Halo":
        return Halo(*(None if t is None else t.to(device)
                      for t in (self.sc, self.pm, self.ln, self.span)))


def blank_halo(bi: BandInputs, forward: bool) -> Halo:
    """The halo no chunk has written: NEG scores, zero lanes, the span
    registers' start values (sc rows NEG, the rest 0)."""
    W, n_sh = bi.Qp + 1, bi.n_sh
    NR = max(bi.NR_fwd if forward else bi.NR_rev, 1)
    i32 = dict(dtype=torch.int32, device=bi.dims.device)
    ln = span = None
    if forward and n_sh:
        ln = torch.zeros((NR * n_sh, bi.maxat, W), **i32)
    if forward and bi.n_spans:
        span = torch.zeros((bi.n_spans, 2, 4 + n_sh, W), **i32)
        span[:, :, 0] = NEG
    return Halo(torch.full((NR, bi.maxat, W), NEG, **i32),
                torch.full((NR, bi.maxat, W), NEG, **i32), ln, span)


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
        # position pad + Wp - d - s + i (K8's context columns -1 .. -maxat
        # follow column 0)
        rows = bi.tvecs
        if bi.tctx is not None:
            rows = torch.cat([torch.flip(bi.tctx, dims=(2,)), rows], dim=2)
        self.pad = Qp + bi.K + 2
        self.trev = F.pad(torch.flip(rows, dims=(2,)), (self.pad, self.pad))
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


def _run_pass(bi: BandInputs, forward: bool, bits_in=None, halo=None,
              lane_split=None):
    """One pass over the diagonals.  Reverse: returns (bits (B, Dp, NW)
    int32, live (B,) bool), or for a non-boundary model (start (B,
    n_seed) int32, each seed's best start score, NEG where none, live).
    Forward: (colbest (B, Wp+1) int32, live, xband), from ``bits_in``,
    the reverse pass's first output.  With ``halo`` (K8, a batch of one
    chunk of a boundary model) the sources up to ``bi.maxat`` columns
    past the chunk's edge read the neighbour's edge planes, the spans
    start from its registers, and the outgoing Halo is returned last.
    ``lane_split`` (tests only, boundary models) replaces the
    whole-diagonal reads of the carry ring and of the joint spans' curr
    registers by an emulation of the kernels' lane split:
    ``lane_split.start(d)`` at each diagonal, ``.source(d, adv, r,
    shift)`` for a ring source, ``.shift_curr(plane, fill)`` for a joint
    span, and ``.store(d, sc, pm, ln)`` after each diagonal."""
    if bi.track_sid and (halo is not None or lane_split is not None):
        raise ValueError("the cross-chip band scan and the lane-split "
                         "emulation take boundary models only")
    fr = _Frame(bi)
    B, W, S, n_sh, K = bi.batch, fr.W, bi.S, bi.n_sh, bi.K
    dev = bi.dims.device
    plan = (bi.fwd_plan if forward else bi.rev_plan).tolist()
    n_adv = bi.n_adv_fwd if forward else bi.n_adv_rev
    ring = (bi.fwd_ring if forward else bi.rev_ring).tolist()
    spans = bi.spans.tolist()[:bi.n_spans] if forward else []
    lanes = forward and n_sh > 0
    # the reverse pass of a non-boundary model: a seed id per state
    track = bi.track_sid and not forward
    i, qlen, wlen = fr.i, fr.qlen, fr.wlen
    neg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
    no_ln = [zero] * n_sh
    no_sd = [zero] * S if track else None
    blank = ([neg] * S, [neg] * S, [no_ln] * S, no_sd)
    prev = [blank] * K                 # prev[k]: diagonal d -/+ (k + 1)
    live = torch.zeros(B, dtype=torch.bool, device=dev)
    xband = torch.zeros(B, dtype=torch.bool, device=dev)
    NW = bi.n_words
    maxat = bi.maxat if halo is not None else 0
    if halo is not None:
        out_sc, out_pm = torch.full_like(halo.sc, NEG), \
            torch.full_like(halo.pm, NEG)
        out_ln = torch.zeros_like(halo.ln) if lanes else None
    if forward:
        colbest = torch.full((B, bi.Wp + 1), NEG, dtype=torch.int32,
                             device=dev)
        # span registers: st sc, pm, te, sg, ln..; cu sc, pm, te, sg, ln..
        regs = [[neg, zero, zero, zero] + [zero] * n_sh
                + [neg, zero, zero, zero] + [zero] * n_sh
                for _ in spans]
        if halo is not None and spans:
            regs = [[v[None] for v in halo.span[spx].reshape(-1, W)]
                    for spx in range(len(spans))]
        bit_ix = torch.arange(32, dtype=torch.int32, device=dev)
    elif track:
        start = torch.full((B, bi.n_seed), NEG, dtype=torch.int32,
                           device=dev)
    else:
        bits = torch.zeros((B, bi.Dp, NW), dtype=torch.int32, device=dev)
        weights = (torch.ones(32, dtype=torch.int64, device=dev)
                   << torch.arange(32, device=dev))
    d_hi = int((bi.dims[:, 0] + bi.dims[:, 1]).max())
    order = range(d_hi + 1) if forward else range(d_hi, -1, -1)
    for d in order:
        fr.at(d)
        if lane_split is not None:
            lane_split.start(d)
        j = d - i
        cell_ok = (j >= 0) & (j <= wlen) & (i <= qlen)
        sc = [neg] * S
        pm = [neg] * S
        ln = [no_ln] * S
        sd = list(no_sd) if track else None
        thaw = None
        if forward and bi.track_sid:
            # each seed's start score less its half score, at its cell
            # (the largest of the seeds there whose start score is set)
            row_sc = neg
            for lx in range(bi.n_layers):
                hit = ((fr.t(bi.row_seedq + lx, 0) - 1) == i) & cell_ok
                sid = fr.t(bi.row_seedi + lx, 0).clamp(0, bi.n_seed - 1)
                got = torch.gather(bits_in, 1, sid.long())
                val = torch.where(hit & (got > NEG),
                                  got - fr.t(bi.row_seedh + lx, 0), NEG)
                row_sc = torch.maximum(row_sc, val)
            sc[bi.start_id] = pm[bi.start_id] = row_sc
        elif forward:
            word = bits_in[:, d, :]
            b = ((word[:, :, None] >> bit_ix) & 1).reshape(B, -1)[:, :W]
            thaw = (b != 0) & cell_ok
            sc[bi.start_id] = pm[bi.start_id] = torch.where(thaw, zero, neg)
        else:
            row_sc = neg
            row_sd = zero
            for lx in range(bi.n_layers):
                hit = ((fr.t(bi.row_seedq + lx, 0) - 1) == i) & cell_ok
                row_sc = torch.where(
                    hit, torch.maximum(row_sc, fr.t(bi.row_seedv + lx, 0)),
                    row_sc)
                if track:
                    # the largest seed index of the cell's seeds, whatever
                    # their half scores (``sdp_device.py:408-413``)
                    row_sd = torch.where(
                        hit, torch.maximum(row_sd,
                                           fr.t(bi.row_seedi + lx, 0)),
                        row_sd)
            sc[bi.end_id] = pm[bi.end_id] = row_sc
            if track:
                sd[bi.end_id] = row_sd
        ev_row = neg
        ev_sd = zero
        reads: dict = {}
        masks: dict = {}

        def evaluate(row):
            nonlocal ev_row, ev_sd
            aq, at = row[BP_AQ], row[BP_AT]
            adv, r = aq + at, row[BP_READ]
            if adv == 0:
                s_sc, s_pm, s_ln = sc[r], pm[r], ln[r]
                s_sd = sd[r] if track else None
            else:
                key = (r, adv, aq)
                got = reads.get(key)
                if got is None:
                    p_sc, p_pm, p_ln, p_sd = prev[adv - 1]
                    k = aq if forward else -aq
                    if lane_split is not None:
                        got = lane_split.source(d, adv, r, k)
                    else:
                        got = (_shift(p_sc[r], k, NEG),
                               _shift(p_pm[r], k, NEG),
                               [_shift(v, k, 0) for v in p_ln[r]] if lanes
                               else no_ln)
                    if maxat and adv > aq:
                        got = _halo_read(got, halo, ring[r], adv - aq, aq,
                                         j, wlen, forward, n_sh, maxat)
                    got = tuple(got) + ((_shift(p_sd[r], k, 0) if track
                                         else None),)
                    reads[key] = got
                s_sc, s_pm, s_ln, s_sd = got
            src_ok = masks.get((aq, at))
            if src_ok is None:
                si, sj = (i - aq, j - at) if forward else (i + aq, j + at)
                # K8: sources up to maxat columns into the neighbour
                src_ok = (cell_ok & (si >= 0) & (si <= qlen)
                          & (sj >= (-maxat if forward else 0))
                          & (sj <= (wlen if forward else wlen + maxat)))
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
            if track:
                sd[w] = torch.where(take, s_sd, sd[w])
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
                # the cell's event, overwritten in candidate order
                ev = take & (val >= s_pm)
                ev_row = torch.where(ev, val, ev_row)
                if track:
                    ev_sd = torch.where(ev, s_sd, ev_sd)

        for row in plan[:n_adv]:
            evaluate(row)
        if spans:
            abs_tv = fr.t(bi.row_abs_t, 0)
            seg_row = fr.t(bi.row_seg, 0)
            for spx, sp in enumerate(spans):
                if sp[SP_MAX_T] == 0:
                    continue          # query-only span: submit is a no-op
                xb = _span_step(regs[spx], sp, sc, pm, ln, thaw, cell_ok,
                                abs_tv, seg_row, n_sh,
                                None if lane_split is None
                                else lane_split.shift_curr)
                xband = xband | xb.any(dim=1)
        for row in plan[n_adv:]:
            evaluate(row)
        any_live = torch.zeros_like(cell_ok)
        for s in range(S):
            sc[s] = torch.where(cell_ok, sc[s], NEG)
            any_live = any_live | (sc[s] > NEG)
        edge = fr.t(bi.row_edge, 0) != 0
        live = live | (any_live & edge & cell_ok).any(dim=1)
        if halo is not None:
            for k in range(1, maxat + 1):
                exp = (j == ((wlen + 1 - k) if forward else (k - 1)))
                exp = (exp & cell_ok)[0]
                for s in range(S):
                    if ring[s] < 0:
                        continue
                    rr = ring[s]
                    out_sc[rr, k - 1] = torch.where(exp, sc[s][0],
                                                    out_sc[rr, k - 1])
                    out_pm[rr, k - 1] = torch.where(exp, pm[s][0],
                                                    out_pm[rr, k - 1])
                    for lx in range(n_sh if lanes else 0):
                        row = rr * n_sh + lx
                        out_ln[row, k - 1] = torch.where(
                            exp, ln[s][lx][0], out_ln[row, k - 1])
        if forward:
            ev = ev_row > NEG
            if bool(ev.any()):
                bb, ii = torch.nonzero(ev, as_tuple=True)
                jj = (d - ii).long()
                colbest[bb, jj] = torch.maximum(colbest[bb, jj],
                                                ev_row[bb, ii])
        elif track:
            # each seed's best start score (``sdp_device.py:701-705``)
            ev = ev_row > NEG
            start.scatter_reduce_(
                1, torch.where(ev, ev_sd, 0).long(),
                torch.where(ev, ev_row, NEG), "amax")
        else:
            flag = sc[bi.start_id] >= 0
            for sp in bi.spans.tolist()[:bi.n_spans]:
                flag = flag | (sc[sp[SP_STATE]] > 0)
            flag = F.pad(flag & cell_ok, (0, NW * 32 - W))
            word = (flag.reshape(B, NW, 32).long() * weights).sum(dim=2)
            bits[:, d] = (word - ((word >> 31) << 32)).to(torch.int32)
        prev = [(sc, pm, ln, sd)] + prev[:-1]
        if lane_split is not None:
            lane_split.store(d, sc, pm, ln)
    if halo is not None:
        span = None
        if forward and spans:
            span = torch.stack([torch.cat(r) for r in regs]).reshape(
                len(spans), 2, 4 + n_sh, W)
            span = _unjoint(span, bi.span_joint)
        out = Halo(out_sc, out_pm, out_ln, span)
        return ((colbest, live, xband, out) if forward
                else (bits, live, out))
    if forward:
        return colbest, live, xband
    return (start if track else bits), live


def _halo_read(got, halo: Halo, rr: int, at: int, aq: int, j, wlen,
               forward: bool, n_sh: int, maxat: int):
    """K8: the source planes of an advancing candidate with the lanes
    whose source column lies k = 1..maxat columns past the chunk's edge
    read from the neighbour's edge plane k - 1 (shifted by aq as the ring
    read is)."""
    s_sc, s_pm, s_ln = got
    sh = aq if forward else -aq
    for k in range(1, maxat + 1):
        zone = (j - at == -k) if forward else (j + at == wlen + k)
        s_sc = torch.where(zone, _shift(halo.sc[rr, k - 1][None], sh, NEG),
                           s_sc)
        s_pm = torch.where(zone, _shift(halo.pm[rr, k - 1][None], sh, NEG),
                           s_pm)
        if forward and n_sh:
            s_ln = [torch.where(zone, _shift(
                halo.ln[rr * n_sh + lx, k - 1][None], sh, 0), v)
                for lx, v in enumerate(s_ln)]
    return s_sc, s_pm, s_ln


def _unjoint(span: torch.Tensor, joint: tuple) -> torch.Tensor:
    """The span registers a chunk hands on, with the curr registers of
    joint spans at their start values: a joint curr register walks a
    column from lane 0 and so never carries into the next chunk (the
    kernel and this version leave different values there)."""
    span = span.clone()
    for spx, jt in enumerate(joint):
        if jt:
            span[spx, 1] = 0
            span[spx, 1, 0] = NEG
    return span


def _span_step(reg, sp, sc, pm, ln, thaw, cell_ok, abs_tv, seg_row, n_sh,
               shift_curr=None):
    """Span thaw + submit of one span at one diagonal (before the silent
    sweep).  Updates ``reg`` and the running planes in place; returns the
    cross-locus thaw plane.  ``shift_curr(plane, fill)`` moves a joint
    span's curr register one lane (default: the whole plane)."""
    if shift_curr is None:
        def shift_curr(x, fill):
            return _shift(x, 1, fill)
    st, max_t = sp[SP_STATE], sp[SP_MAX_T]
    st_sc, st_pm, st_te, st_sg = reg[0:4]
    st_ln = reg[4:4 + n_sh]
    cu_sc, cu_pm, cu_te, cu_sg = reg[4 + n_sh:8 + n_sh]
    cu_ln = reg[8 + n_sh:]
    if sp[SP_MAX_Q] > 0:
        # joint span: the curr register walks the target row, one lane
        # per diagonal; pickup only at thaw cells
        cu_sc, cu_pm = shift_curr(cu_sc, NEG), shift_curr(cu_pm, 0)
        cu_te, cu_sg = shift_curr(cu_te, 0), shift_curr(cu_sg, 0)
        cu_ln = [shift_curr(v, 0) for v in cu_ln]
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


def plain_band_reverse(bi: BandInputs, halo: Optional[Halo] = None,
                       lane_split=None):
    """K6's plain version: the reverse pass.  Returns (bits (B, Dp, NW)
    int32 with bit i & 31 of word i >> 5 set where lane i of diagonal d is
    a boundary cell, live (B,) bool); for a non-boundary model (start (B,
    n_seed) int32, each seed's best start score, live); with ``halo``,
    K8's reverse pass on one chunk, and the outgoing Halo last."""
    return _run_pass(bi, forward=False, halo=halo, lane_split=lane_split)


def plain_band_forward(bi: BandInputs, bits: torch.Tensor,
                       halo: Optional[Halo] = None, lane_split=None):
    """K7's plain version: the forward pass from the reverse pass's
    boundary bits (a non-boundary model: its start scores).  Returns
    (colbest (B, Wp+1) int32, the best end score per compressed column,
    NEG where none; live (B,) bool; xband (B,) bool); with ``halo``, K8's
    forward pass on one chunk, and the outgoing Halo last."""
    return _run_pass(bi, forward=True, bits_in=bits, halo=halo,
                     lane_split=lane_split)


def plain_band_scan(bi: BandInputs) -> dict:
    """Both passes in plain PyTorch: {"colbest", "live", "xband"} per pair
    of the batch (``live`` from either pass, ``xband`` from the forward
    pass), and for a non-boundary model "start_scores" (B, n_seed).
    ``cuda_sdp.locus_best`` reduces ``colbest`` to each locus's best end
    score."""
    carry, live_r = plain_band_reverse(bi)
    colbest, live_f, xband = plain_band_forward(bi, carry)
    out = {"colbest": colbest, "live": live_r | live_f, "xband": xband}
    if bi.track_sid:
        out["start_scores"] = carry
    return out
