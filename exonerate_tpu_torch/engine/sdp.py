"""Seeded DP (the reference's default gapped heuristic), exact semantics.

This reproduces the observable behaviour of the reference SDP/Scheduler
stack (ref: src/sdp/sdp.c, src/sdp/scheduler.c) so heuristic alignments
are byte-identical to reference exonerate:

- seeds = the comparison's HSPs, cobs-sorted in forward DP order and
  deduped (ref: SDP_Pair_create_seed_list, sdp.c:439-494);
- a *reverse* sparse extension pass from the seed cobs points finds the
  best start per seed (or, for models with spans/shadows, the boundary
  of reachable start cells; ref: SDP_Pair_find_start_points);
- a *forward* pass from those starts finds the best end per seed, with
  per-path maximum tracking and dropoff pruning
  (ref: Scheduler_Cell_process, scheduler.c:860-1070);
- spans (introns, NERs) cross the DP through freeze/thaw of "span
  seeds" rather than cell-by-cell loops (ref: Scheduler_SpanData_submit
  / _get_curr, scheduler.c:567-645);
- paths are extracted per seed, best-first; in single-pass mode a path
  overlapping an already-reported alignment is discarded outright
  (ref: SDP_Pair_next_path, sdp.c:743-814).

Tie-breaking is order-faithful: rows ascend, cells within a row ascend,
transitions are evaluated in reverse model order, and a destination
keeps its existing value on ties (first writer wins; ref:
scheduler.c:887-888, 1048-1051).  Start/end registration happens only
when the assigned score is the running maximum of its own path (ref:
Scheduler_Cell_assign, scheduler.c:804-830).

This module is the semantic oracle; the vectorized JAX/Pallas execution
of the same recurrence plugs in underneath (engine/wavefront.py lanes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import IMPOSSIBLY_LOW_SCORE
from ..align.alignment import Alignment
from ..model.ir import Label, Model, Protect, Transition
from .region import Region

NEG = IMPOSSIBLY_LOW_SCORE

# EXONERATE_TPU_SDP_TRACE=1 prints every accepted cell assignment in the
# same shape as the reference's (commented-out) Scheduler_Cell_assign
# g_message, for side-by-side parity debugging against a tracing build
# of the reference scheduler.
import os as _os
_TRACE_ASSIGN = bool(_os.environ.get("EXONERATE_TPU_SDP_TRACE"))


@dataclass
class SdpArgs:
    """(ref: SDP_ArgumentSet, sdp.c:28-32)."""
    dropoff: int = 50          # -x / --extensionthreshold
    single_pass: bool = True   # --singlepass


class _TB:
    """Sparse traceback cell (ref: STraceback_Cell, straceback.h:31-44)."""
    __slots__ = ("transition", "length", "prev")

    def __init__(self, transition, length, prev):
        self.transition = transition
        self.length = length
        self.prev = prev


class _ArenaTB:
    """Lazy traceback head into a native arena: the per-seed chains
    are only ever walked for EMITTED seeds, so rebuilding every arena
    entry into _TB objects per pass (~17k nodes/run on the p2g scan)
    is deferred to _tb_ops."""
    __slots__ = ("transitions", "arena", "idx")

    def __init__(self, transitions, arena, idx: int):
        self.transitions = transitions
        self.arena = arena
        self.idx = idx

    def ops(self) -> list[tuple[Transition, int]]:
        tb_trans, tb_len, tb_prev = self.arena
        ops = []
        i = self.idx
        while i >= 0:
            ops.append((self.transitions[int(tb_trans[i])],
                        int(tb_len[i])))
            i = int(tb_prev[i])
        ops.reverse()
        return ops


def _tb_ops(tb) -> list[tuple[Transition, int]]:
    """Chain -> [(transition, length)] ordered far-to-near reversed, i.e.
    earliest op first (ref: STraceback_List_create)."""
    if isinstance(tb, _ArenaTB):
        return tb.ops()
    ops = []
    while tb is not None:
        ops.append((tb.transition, tb.length))
        tb = tb.prev
    ops.reverse()
    return ops


class _Cell:
    __slots__ = ("score", "pmax", "seed", "shadow", "tb", "thaw")

    def __init__(self, n_states: int, n_shadow: int, thaw: bool):
        self.score = [NEG] * n_states
        # the reference memsets cells then writes only score[.][0]=NEG:
        # an unset state's path-max (score[1]) and seed id (score[2])
        # read as ZERO (scheduler.c:690,710-711) — visible when a
        # wrap-resurrected path (see can_wrap) passes the dropoff test
        # against max=0 and credits seed 0
        self.pmax = [0] * n_states
        self.seed = [0] * n_states
        self.shadow = ([[0] * n_shadow for _ in range(n_states)]
                       if n_shadow else None)
        self.tb: list = [None] * n_states
        self.thaw = thaw


class _SpanSeed:
    __slots__ = ("score", "pmax", "seed", "shadow", "tb",
                 "q_entry", "t_entry")

    def __init__(self, score, pmax, seed, shadow, tb, q_entry, t_entry):
        self.score = score
        self.pmax = pmax
        self.seed = seed
        self.shadow = list(shadow) if shadow is not None else None
        self.tb = tb
        self.q_entry = q_entry
        self.t_entry = t_entry


@dataclass
class _Terminal:
    """(ref: SDP_Terminal)."""
    score: int = NEG
    qpos: int = 0
    tpos: int = 0
    tb: Optional[_TB] = None


class _Seed:
    __slots__ = ("seed_id", "hsp", "q_cobs", "t_cobs", "hsp_score",
                 "max_start", "max_end", "t_extent")

    def __init__(self, seed_id, hsp, q_cobs, t_cobs, hsp_score,
                 t_extent=None):
        self.seed_id = seed_id
        self.hsp = hsp
        self.q_cobs = q_cobs
        self.t_cobs = t_cobs
        self.hsp_score = hsp_score
        self.max_start = _Terminal()
        self.max_end = _Terminal()
        # absolute target extent of the source HSP (band planning)
        self.t_extent = t_extent


def model_uses_boundary(model: Model) -> bool:
    """(ref: SDP_create, sdp.c:299-321): bidirectional (no-boundary)
    SDP only for models with no shadows, no spans and a single portal
    with a single transition."""
    if model.shadows or model.spans:
        return True
    if len(model.portals) != 1:
        return True
    portal = model.portals[0]
    ntrans = sum(1 for t in model.transitions
                 if t.calc is portal.calc and t.label == Label.MATCH)
    return ntrans != 1


def _grid_at(grid, i, j):
    if grid.ndim == 0:
        return int(grid)
    return int(grid[i if grid.shape[0] > 1 else 0,
                    j if grid.shape[1] > 1 else 0])


class _Pass:
    """One scheduler pass (forward or reverse) over a pair.

    Works in *processing coordinates*: forward pass pq=q, pt=t; reverse
    pass pq=-q, pt=-t, so rows/cells always ascend and dst = src +
    advance (mirroring scheduler.c:880-886)."""

    def __init__(self, model: Model, region: Region, grids, shadow_inputs,
                 data, *, is_forward: bool, use_boundary: bool,
                 dropoff: int, subopt, n_shadow: int, factored=None,
                 qt=None):
        self.model = model
        self.region = region
        self.grids = grids
        self.shadow_inputs = shadow_inputs
        self.data = data
        self.is_forward = is_forward
        self.use_boundary = use_boundary
        self.dropoff = dropoff
        self.subopt = subopt
        self.n_shadow = n_shadow
        # the boundary-producing reverse pass never walks its traceback
        # (ref: sdp.c creates the reverse Scheduler without traceback
        # when spans force the boundary protocol)
        self.has_traceback = is_forward or not use_boundary
        self.start_func = None
        self.end_func = None
        self.rows: dict[int, dict[int, _Cell]] = {}
        # span machinery (forward + boundary only)
        self.span_by_state = {s.span_state.id: s for s in model.spans}
        self.span_loops = {}
        for span in model.spans:
            qloop = tloop = None
            for t in model.transitions:
                if t.input is t.output is span.span_state and t.calc is None:
                    if t.advance_query:
                        qloop = t
                    if t.advance_target:
                        tloop = t
            self.span_loops[span.id] = (qloop, tloop)
        self.span_cache: dict[tuple[int, int], _SpanSeed] = {}
        self.span_curr: dict[int, Optional[_SpanSeed]] = {
            s.id: None for s in model.spans}
        # reverse-id transition order (ref: scheduler.c:887-888)
        self.trans_rev = list(model.transitions)[::-1]
        self.start_state = model.start_state.state
        self.end_state = model.end_state.state
        # hot-loop metadata: plain tuples per transition, avoiding enum
        # ops / dict lookups / per-call attribute walks in _process_cell
        self.tinfo = []
        for t in self.trans_rev:
            is_span_loop = t.input is t.output and t.calc is None
            grid = None
            gmode = 0
            gval = 0
            if t.calc is not None:
                if qt and id(t.calc) in qt:
                    gmode, grid = 6, qt[id(t.calc)]
                elif factored and id(t.calc) in factored:
                    gmode, grid = 4, factored[id(t.calc)]
                else:
                    g = grids[id(t.calc)]
                    if g.ndim == 0:
                        gmode, gval = 0, int(g)
                    elif g.shape[0] > 1 and g.shape[1] > 1:
                        gmode, grid = 3, g
                    elif g.shape[0] > 1:
                        gmode, grid = 1, g
                    else:
                        gmode, grid = 2, g
            # The reference never skips IMPOSSIBLY_LOW source states —
            # normally the dropoff prunes them, but a calc stacking two
            # splice penalties (joint introns under --forcegtag) makes
            # NEG + calc wrap past INT32_MIN into a large POSITIVE gint,
            # resurrecting the path (scheduler.c:1019 has no skip).  Our
            # fast path skips NEG sources, so flag the transitions whose
            # minimum calc value can wrap and process NEG sources there.
            from .sdp_native import _min_memo
            if gmode == 6:
                _min_calc = _min_memo(grid[0]) + _min_memo(grid[1])
            elif gmode == 4:
                _min_calc = _min_memo(grid[0])
            elif gmode == 0:
                _min_calc = gval
            elif grid is not None:
                _min_calc = _min_memo(grid)
            else:
                _min_calc = 0
            can_wrap = _min_calc < (-(1 << 31) - NEG)
            self.tinfo.append((
                t, t.advance_query, t.advance_target, is_span_loop,
                t.input.id, t.output.id, t.calc,
                gmode, gval, grid,
                t.calc is not None and t.calc.shadow_fn is not None,
                t.calc is not None
                and bool(t.calc.protect & Protect.UNDERFLOW),
                t.calc is not None
                and bool(t.calc.protect & Protect.OVERFLOW),
                t.label == Label.MATCH,
                bool(t.dst_shadows) if not is_forward else False,
                can_wrap,
            ))
        # per-transition shadow starts, resolved for the assign path:
        # (designation, starts_on_query, start_vec_fn, shadow)
        self.tstarts = {}
        for t in model.transitions:
            self.tstarts[id(t)] = [
                (sh.designation, sh.start == "query_pos",
                 sh.start_vec_fn, sh)
                for sh in model.src_shadows(t.input)]
        # boundary output (reverse + boundary): {t: [(q, seed_id)]}
        self.boundary_rows: dict[int, list[tuple[int, int]]] = {}

    # -- coordinates -------------------------------------------------------

    def _orig(self, pq, pt):
        return (pq, pt) if self.is_forward else (-pq, -pt)

    # -- cells -------------------------------------------------------------

    def _get_row(self, pt):
        row = self.rows.get(pt)
        if row is None:
            row = self.rows[pt] = {}
        return row

    def _cell(self, row, pq, thaw=False):
        cell = row.get(pq)
        if cell is None:
            cell = row[pq] = _Cell(len(self.model.states), self.n_shadow,
                                   thaw)
        return cell

    def seed_cell(self, pq, pt, seed_id, start_score, thaw=False):
        """(ref: Scheduler_Cell_seed / Scheduler_Row_add_seed)."""
        row = self._get_row(pt)
        cell = self._cell(row, pq, thaw)
        if thaw:
            cell.thaw = True
        state_id = (self.start_state.id if self.is_forward
                    else self.end_state.id)
        cell.score[state_id] = start_score
        cell.pmax[state_id] = start_score
        cell.seed[state_id] = seed_id
        cell.tb[state_id] = None
        if cell.shadow is not None:
            cell.shadow[state_id] = [0] * self.n_shadow

    # -- main loop ---------------------------------------------------------

    def run(self, seeds: list[tuple[int, int, int, int]]):
        """seeds: [(pt, pq, seed_id, start_score)] sorted by (pt, pq);
        injected when the row window reaches them (within
        max_target_advance rows; ref: Scheduler_Pair_calculate)."""
        mta = max(self.model.max_target_advance, 1)
        si = 0
        boundary_thaw = self.is_forward and self.use_boundary
        while True:
            if not self.rows:
                if si >= len(seeds):
                    break
                pt0 = seeds[si][0]
            else:
                pt0 = min(self.rows)
                if si < len(seeds):
                    pt0 = min(pt0, seeds[si][0])
            while si < len(seeds) and seeds[si][0] - pt0 <= mta:
                st, sq, sid, sscore = seeds[si]
                self.seed_cell(sq, st, sid, sscore, thaw=boundary_thaw)
                si += 1
            row = self.rows.get(pt0)
            if row is not None:
                self._process_row(pt0, row)
                self._retire_row(pt0, row)
                del self.rows[pt0]

    def _retire_row(self, pt, row):
        """Collect boundary points at row retirement (ref:
        Scheduler_Row_traverse_cell_destroy, scheduler.c:965-1000)."""
        if self.is_forward or not self.use_boundary:
            return
        pts = []
        start_id = self.start_state.id
        for pq in sorted(row):
            cell = row[pq]
            if cell.score[start_id] >= 0:
                pts.append((-pq, cell.seed[start_id]))
            else:
                for span in self.model.spans:
                    sid = span.span_state.id
                    if cell.score[sid] > 0:
                        pts.append((-pq, cell.seed[sid]))
                        break
        if pts:
            # original coords: row at -pt, query positions ascend
            self.boundary_rows[-pt] = pts[::-1]

    def _process_row(self, pt, row):
        if self.subopt is not None:
            jorig = pt if self.is_forward else -pt
            blocked = self.subopt.by_row.get(
                self.region.target_start + jorig)
        else:
            blocked = None
        pending = sorted(row)
        idx = 0
        while idx < len(pending):
            pq = pending[idx]
            idx += 1
            cell = row.get(pq)
            if cell is None:
                continue
            added = self._process_cell(pq, pt, cell, row, blocked)
            if added:
                # same-row cells created at higher pq: merge into order
                rest = sorted(set(added))
                pending = pending[:idx] + sorted(
                    set(pending[idx:]) | {a for a in rest if a > pq})
        return

    # -- cell processing (ref: Scheduler_Cell_process) ----------------------

    def _process_cell(self, pq, pt, cell, row, blocked):
        model = self.model
        region = self.region
        qlen, tlen = region.query_length, region.target_length
        added = []
        src_q, src_t = self._orig(pq, pt)
        is_forward = self.is_forward
        use_boundary = self.use_boundary
        dropoff = self.dropoff
        score = cell.score
        pmax = cell.pmax
        seed = cell.seed
        rqs = region.query_start
        for (trans, aq, at, is_span_loop, in_id, out_id, calc, gmode,
             gval, grid, has_shadow_fn, p_under, p_over, is_match,
             rev_shadowed, can_wrap) in self.tinfo:
            # span transitions never walk cell-by-cell (ref:
            # scheduler.c:891-922)
            if is_span_loop:
                if is_forward and use_boundary:
                    span = self.span_by_state.get(out_id)
                    if span is not None and score[in_id] >= 0:
                        self._span_submit(span, cell, in_id, src_q,
                                          src_t)
                continue
            if is_forward:
                dst_q, dst_t = src_q + aq, src_t + at
                if dst_q > qlen or dst_t > tlen:
                    continue
                ip, op = in_id, out_id
                # span thaw into the input state (ref: scheduler.c:935-985)
                if use_boundary and cell.thaw:
                    span = self.span_by_state.get(in_id)
                    if span is not None:
                        self._span_thaw(span, cell, ip, src_q, src_t)
                calc_q, calc_t = src_q, src_t
            else:
                dst_q, dst_t = src_q - aq, src_t - at
                if dst_q < 0 or dst_t < 0:
                    continue
                ip, op = out_id, in_id
                calc_q, calc_t = dst_q, dst_t
            src_score = score[ip]
            if src_score <= NEG and not (can_wrap
                                         and not rev_shadowed):
                continue
            # transition score
            if calc is None:
                tscore = 0
            elif rev_shadowed:
                # reverse extends through shadowed transitions for free
                # (ref: scheduler.c:1008-1014)
                tscore = 0
            else:
                if gmode == 0:
                    tscore = gval
                elif gmode == 6:
                    tscore = int(grid[0][calc_q]) + int(grid[1][calc_t])
                elif gmode == 4:
                    # q_override REPLACES where nonzero (the CDS veto)
                    table, q_idx, t_idx, q_over = grid
                    if q_over is not None and q_over[calc_q]:
                        tscore = int(q_over[calc_q])
                    else:
                        tscore = int(table[q_idx[calc_q], t_idx[calc_t]])
                elif gmode == 3:
                    tscore = int(grid[calc_q, calc_t])
                elif gmode == 1:
                    tscore = int(grid[calc_q, 0])
                else:
                    tscore = int(grid[0, calc_t])
                if has_shadow_fn:
                    svals = {sh.name: (cell.shadow[ip][sh.designation]
                                       if cell.shadow is not None else 0)
                             for sh in trans.dst_shadows}
                    tscore = int(calc.shadow_fn(
                        np, tscore, svals,
                        self.shadow_inputs.get(id(calc), {}),
                        rqs + calc_q,
                        region.target_start + calc_t))
            max_score = pmax[ip]
            seed_id = seed[ip]
            # C4_Score is a 32-bit gint: the reference's adds and the
            # dropoff subtraction WRAP, and the UNDERFLOW clamp tests
            # the wrapped value — two stacked splice penalties (e.g.
            # --forcegtag non-gt..ag joint introns at -987654336 per
            # site) wrap POSITIVE and sail past the clamp, poisoning
            # the DP exactly as the reference does
            # (ref: scheduler.c:1019, C4_IMPOSSIBLY_LOW_SCORE=-987654321)
            dst_score = (src_score + tscore + 0x80000000 & 0xFFFFFFFF) \
                - 0x80000000
            if p_under and dst_score < NEG:
                dst_score = NEG
            if p_over and dst_score > -NEG:
                dst_score = -NEG
            if is_forward and dst_score < 0:
                continue
            if ((max_score - dst_score + 0x80000000 & 0xFFFFFFFF)
                    - 0x80000000) > dropoff:
                continue
            if is_match and blocked is not None \
                    and (rqs + src_q) in blocked:
                continue
            # destination cell (same processing-coords direction)
            dpq, dpt = pq + aq, pt + at
            if at:
                drow = self._get_row(dpt)
            else:
                drow = row
            dcell = drow.get(dpq)
            if dcell is None:
                dcell = drow[dpq] = _Cell(len(model.states),
                                          self.n_shadow, False)
                if at == 0 and aq > 0:
                    added.append(dpq)
            elif dst_score <= dcell.score[op]:
                # keep existing on ties (ref: scheduler.c:1048-1051)
                continue
            # assign, inlined (ref: Scheduler_Cell_assign,
            # scheduler.c:763-830)
            if _TRACE_ASSIGN:
                import sys as _sys
                print(f"Assign {'fwd' if is_forward else 'rev'} "
                      f"src({src_q},{src_t})->dst({dst_q},{dst_t}) "
                      f"dst_score[{dst_score}] seed[{seed_id}] "
                      f"[{trans.name}]", file=_sys.stderr)
            dcell.score[op] = dst_score
            dcell.seed[op] = seed_id
            if self.has_traceback:
                dcell.tb[op] = _TB(trans, 1, cell.tb[ip])
            if is_forward and dcell.shadow is not None:
                sh = list(cell.shadow[ip])
                for (des, on_query, vec_fn, shadow) in \
                        self.tstarts[id(trans)]:
                    if vec_fn is not None:
                        vec = self._shadow_vec(shadow)
                        sh[des] = int(vec[src_q if on_query else src_t])
                    else:
                        sh[des] = (rqs + src_q if on_query
                                   else region.target_start + src_t)
                dcell.shadow[op] = sh
            if dst_score < max_score:
                dcell.pmax[op] = max_score
            else:
                dcell.pmax[op] = dst_score
                if self.start_func is not None \
                        and trans.input is self.start_state:
                    self.start_func(seed_id, dst_score, dst_q, dst_t,
                                    dcell.tb[op])
                if self.end_func is not None \
                        and trans.output is self.end_state:
                    self.end_func(seed_id, dst_score, dst_q, dst_t,
                                  dcell.tb[op])
        return added

    _shadow_vec_cache = None

    def _shadow_vec(self, shadow):
        if self._shadow_vec_cache is None:
            self._shadow_vec_cache = {}
        vec = self._shadow_vec_cache.get(id(shadow))
        if vec is None:
            vec = np.asarray(shadow.start_vec_fn(self.region, self.data))
            self._shadow_vec_cache[id(shadow)] = vec
        return vec

    # -- spans (ref: scheduler.c:567-645) -----------------------------------

    def _span_submit(self, span, cell, ip, src_q, src_t):
        if not span.max_target:
            return
        key = (span.id, src_q)
        stored = self.span_cache.get(key)
        if stored is None:
            self.span_cache[key] = _SpanSeed(
                cell.score[ip], cell.pmax[ip], cell.seed[ip],
                cell.shadow[ip] if cell.shadow is not None else None,
                cell.tb[ip], src_q, src_t)
        elif stored.score <= cell.score[ip]:
            # IN-PLACE copy into the stored seed, exactly like
            # Scheduler_SpanSeed_copy into the cached struct
            # (scheduler.c:631-638): span_data->curr_span_seed is a
            # POINTER to this struct in the reference, so a
            # tie-replacing submit is visible through curr — a fresh
            # object here would leave curr stale and shift the
            # freeze/thaw split of the crossing (ner cigar parity)
            stored.score = cell.score[ip]
            stored.pmax = cell.pmax[ip]
            stored.seed = cell.seed[ip]
            stored.shadow = (list(cell.shadow[ip])
                             if cell.shadow is not None else None)
            stored.tb = cell.tb[ip]
            stored.q_entry = src_q
            stored.t_entry = src_t

    def _span_thaw(self, span, cell, ip, q_pos, t_pos):
        curr = self.span_curr[span.id]
        # expire curr (ref: Scheduler_SpanData_get_curr)
        if curr is not None:
            if (curr.q_entry > q_pos
                    or curr.q_entry + span.max_query < q_pos
                    or curr.t_entry + span.max_target < t_pos):
                curr = None
        stored = self.span_cache.get((span.id, q_pos))
        if stored is not None:
            if stored.t_entry + span.max_target >= t_pos:
                if curr is None or curr.score < stored.score:
                    curr = stored
            else:
                del self.span_cache[(span.id, q_pos)]
        self.span_curr[span.id] = curr
        if curr is not None and cell.score[ip] < curr.score:
            cell.score[ip] = curr.score
            cell.pmax[ip] = curr.pmax
            cell.seed[ip] = curr.seed
            tb = curr.tb
            qloop, tloop = self.span_loops[span.id]
            qdiff = q_pos - curr.q_entry
            tdiff = t_pos - curr.t_entry
            if qdiff:
                tb = _TB(qloop, qdiff, tb)
            if tdiff:
                tb = _TB(tloop, tdiff, tb)
            cell.tb[ip] = tb
            if cell.shadow is not None and curr.shadow is not None:
                cell.shadow[ip] = list(curr.shadow)


def _qsort_by_score(seeds):
    """Order seeds best-end-first with the REAL libc qsort and the
    reference's comparator `b->score - a->score` computed as a wrapping
    32-bit gint (ref: SDP_compare_SDP_Seed_by_score, sdp.c:735-741).
    The subtraction OVERFLOWS when garbage wrap-positive scores (e.g.
    genome2genome --forcegtag) meet IMPOSSIBLY_LOW pristine seeds,
    making the comparator inconsistent — the resulting permutation is
    then whatever glibc's qsort does with it, which a well-founded sort
    cannot reproduce; calling the same qsort with the same comparator
    values does."""
    import ctypes
    n = len(seeds)
    if n < 2:
        return list(seeds)
    scores = [s.max_end.score for s in seeds]
    if all(-(1 << 30) < sc < (1 << 30) for sc in scores):
        # comparator consistent (glibc qsort is a stable mergesort
        # here): plain stable sort matches
        return sorted(seeds, key=lambda s: -s.max_end.score)
    libc = ctypes.CDLL(None, use_errno=True)
    arr = (ctypes.c_int64 * n)(*range(n))
    cmp_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p)

    def cmp(pa, pb):
        a = ctypes.cast(pa, ctypes.POINTER(ctypes.c_int64))[0]
        b = ctypes.cast(pb, ctypes.POINTER(ctypes.c_int64))[0]
        d = scores[b] - scores[a]
        return ((d + 0x80000000) & 0xFFFFFFFF) - 0x80000000

    libc.qsort(arr, ctypes.c_size_t(n), ctypes.c_size_t(8), cmp_t(cmp))
    return [seeds[arr[i]] for i in range(n)]


class SDPPair:
    """(ref: SDP_Pair, sdp.h:69-106)."""

    def __init__(self, model: Model, comparison, data, subopt,
                 args: Optional[SdpArgs] = None, region=None,
                 seeds_override=None):
        """`region`/`seeds_override` restrict the pair to a target band
        (the device-hybrid path re-runs winning bands host-side for
        positions and tracebacks; calc grids materialize over the band
        window while shadow/splice arithmetic stays absolute, so a
        band-isolated run is byte-identical to the global one).
        seeds_override: [(q_cobs, t_cobs_absolute, hsp_score, hsp)]
        in global seed order."""
        self.model = model
        self.comparison = comparison
        self.data = data
        self.subopt = subopt
        self.args = args or SdpArgs()
        self.use_boundary = model_uses_boundary(model)
        self.region = region if region is not None else Region(
            0, 0, len(comparison.query), len(comparison.target))
        self._seeds_override = seeds_override
        # factored calcs (match grids) stay O(Q+T): score[i,j] =
        # table[q_idx[i], t_idx[j]] (+ q_add[i]) — materializing the
        # full Q*T match grid is prohibitive at genome scale
        self.grids = {}
        self.factored = {}
        self.qt = {}
        for c in model.calcs:
            if c.qt_fn is not None:
                qv, tv = c.qt_fn(self.region, data)
                self.qt[id(c)] = (np.ascontiguousarray(qv),
                                  np.ascontiguousarray(tv))
            elif c.factored_fn is not None:
                f = c.factored_fn(self.region, data)
                ov = f.get("q_override")
                if ov is not None and not np.any(ov):
                    ov = None
                self.factored[id(c)] = (
                    np.asarray(f["table"]), np.asarray(f["q_idx"]),
                    np.asarray(f["t_idx"]),
                    np.asarray(ov) if ov is not None else None)
            else:
                self.grids[id(c)] = np.asarray(
                    c.materialize(self.region, data))
        self.shadow_inputs = {
            id(c): c.shadow_inputs_fn(self.region, data)
            for c in model.calcs if c.shadow_inputs_fn is not None}
        self.seeds = self._make_seeds(comparison)
        self._native_desc = None
        self.alignment_count = 0
        self.last_score = NEG
        self.single_pass_order: Optional[list[_Seed]] = None
        self.single_pass_pos = 0
        self.boundary = None

    # (ref: SDP_Pair_create_seed_list, sdp.c:439-494)
    def _make_seeds(self, comparison):
        if self._seeds_override is not None:
            t0 = self.region.target_start
            return [_Seed(k, h, q_cobs, t_cobs - t0, hsp_score)
                    for k, (q_cobs, t_cobs, hsp_score, h)
                    in enumerate(self._seeds_override)]
        hsps = []
        for hs in comparison.hspsets():
            qadv = hs.qadv
            tadv = hs.tadv
            for h in hs.hsps:
                hsps.append((h.target_start + h.cobs * tadv,
                             h.query_start + h.cobs * qadv, h,
                             (h.target_start,
                              h.target_start + h.length * tadv)))
        hsps.sort(key=lambda x: (x[0], x[1]))
        seeds = []
        prev = None
        for t_cobs, q_cobs, h, ext in hsps:
            if prev is None or prev != (t_cobs, q_cobs):
                seeds.append(_Seed(len(seeds), h, q_cobs, t_cobs,
                                   h.score, ext))
            prev = (t_cobs, q_cobs)
        return seeds

    def _new_pass(self, is_forward: bool):
        n_shadow = self.model.total_shadow_designations
        return _Pass(self.model, self.region, self.grids,
                     self.shadow_inputs, self.data,
                     factored=self.factored, qt=self.qt,
                     is_forward=is_forward, use_boundary=self.use_boundary,
                     dropoff=self.args.dropoff, subopt=self.subopt,
                     n_shadow=n_shadow)

    def _native(self):
        """Native (C++) scheduler descriptor, or None (Python path).
        Set EXONERATE_TPU_SDP=python to force the Python oracle."""
        import os
        if self._native_desc is False:
            return None
        if self._native_desc is None:
            from . import sdp_native
            from .. import observe
            if os.environ.get("EXONERATE_TPU_SDP") == "python":
                observe.count_fallback(
                    "sdp native->python: forced by EXONERATE_TPU_SDP")
                self._native_desc = False
                return None
            if not sdp_native.supported(self.model):
                observe.count_fallback(
                    "sdp native->python: calc vocabulary unsupported")
                self._native_desc = False
                return None
            try:
                self._native_desc = sdp_native.NativeDescriptor(
                    self.model, self.region, self.grids, self.factored,
                    self.shadow_inputs, self.data, self.subopt,
                    self.args.dropoff, qt=self.qt)
                observe.count_engine("native-sdp")
            except (ValueError, KeyError) as exc:
                observe.count_fallback(
                    f"sdp native->python: {type(exc).__name__}")
                self._native_desc = False
                return None
        return self._native_desc

    # (ref: SDP_Pair_find_start_points)
    def _find_starts(self):
        # reverse seeds at mirrored cobs with +hsp.score/2
        # (ref: Scheduler_Seed_List_get_reverse, sdp.c:117-131)
        seeds = sorted(
            ((-s.t_cobs, -s.q_cobs, s.seed_id, s.hsp_score >> 1)
             for s in self.seeds), key=lambda x: (x[0], x[1]))
        nd = self._native()
        if nd is not None:
            (t_score, t_q, t_t, t_tb, boundary, arena) = nd.run_pass(
                is_forward=False, use_boundary=self.use_boundary,
                seeds=seeds, n_reg_seeds=len(self.seeds),
                want_start=not self.use_boundary, want_end=False,
                n_shadow=self.model.total_shadow_designations)
            if self.use_boundary:
                # raw (t, q, sid) triplets stay native-side; the
                # forward pass consumes them as numpy arrays
                self.boundary = ("native", boundary)
            else:
                trans = self.model.transitions
                for s in self.seeds:
                    sc = int(t_score[s.seed_id])
                    if sc > NEG:
                        head = int(t_tb[s.seed_id])
                        s.max_start = _Terminal(
                            sc, int(t_q[s.seed_id]),
                            int(t_t[s.seed_id]),
                            _ArenaTB(trans, arena, head)
                            if head >= 0 else None)
            return
        p = self._new_pass(False)
        if not self.use_boundary:
            def start_func(seed_id, score, q, t, tb):
                seed = self.seeds[seed_id]
                if seed.max_start.score < score:
                    seed.max_start = _Terminal(score, q, t, tb)
            p.start_func = start_func
        p.run(seeds)
        if self.use_boundary:
            self.boundary = p.boundary_rows

    # (ref: SDP_Pair_find_end_points)
    def _find_ends(self):
        if self.use_boundary:
            if isinstance(self.boundary, tuple) \
                    and self.boundary[0] == "native":
                tri = np.asarray(self.boundary[1]).reshape(-1, 3)
                order = np.lexsort((tri[:, 1], tri[:, 0]))
                tri = tri[order]
                seeds = (tri[:, 0], tri[:, 1], tri[:, 2],
                         np.zeros(len(tri), dtype=np.int64))
            else:
                seeds = []
                for t in sorted(self.boundary):
                    for q, sid in self.boundary[t]:
                        seeds.append((t, q, sid, 0))
        else:
            seeds = sorted(
                ((s.t_cobs, s.q_cobs, s.seed_id,
                  s.max_start.score - (s.hsp_score >> 1))
                 for s in self.seeds if s.max_start.score > NEG),
                key=lambda x: (x[0], x[1]))
        nd = self._native()
        if nd is not None:
            (t_score, t_q, t_t, t_tb, _boundary, arena) = nd.run_pass(
                is_forward=True, use_boundary=self.use_boundary,
                seeds=seeds, n_reg_seeds=len(self.seeds),
                want_start=False, want_end=True,
                n_shadow=self.model.total_shadow_designations)
            trans = self.model.transitions
            for s in self.seeds:
                sc = int(t_score[s.seed_id])
                if sc > NEG:
                    head = int(t_tb[s.seed_id])
                    s.max_end = _Terminal(sc, int(t_q[s.seed_id]),
                                          int(t_t[s.seed_id]),
                                          _ArenaTB(trans, arena, head)
                                          if head >= 0 else None)
            return
        p = self._new_pass(True)

        def end_func(seed_id, score, q, t, tb):
            seed = self.seeds[seed_id]
            if seed.max_end.score < score:
                seed.max_end = _Terminal(score, q, t, tb)
        p.end_func = end_func
        p.run(seeds)

    # (ref: SDP_Pair_find_path, sdp.c:707-733)
    def _find_path(self, seed: _Seed) -> Alignment:
        fwd_ops = _tb_ops(seed.max_end.tb)
        if self.use_boundary:
            # start derived by walking the forward traceback back
            # (ref: SDP_Seed_find_start, sdp.c:688-704)
            q, t = seed.max_end.qpos, seed.max_end.tpos
            for trans, length in fwd_ops:
                q -= trans.advance_query * length
                t -= trans.advance_target * length
            region = Region(q, t, seed.max_end.qpos - q,
                            seed.max_end.tpos - t)
            alignment = Alignment(self.model, region, seed.max_end.score)
            for trans, length in fwd_ops:
                alignment.add(trans, length)
        else:
            region = Region(seed.max_start.qpos, seed.max_start.tpos,
                            seed.max_end.qpos - seed.max_start.qpos,
                            seed.max_end.tpos - seed.max_start.tpos)
            alignment = Alignment(self.model, region, seed.max_end.score)
            # reverse traceback: ops near-seed-first; emit far-to-near,
            # dropping the op nearest the seed (ref: sdp.c:671-683)
            rev_ops = _tb_ops(seed.max_start.tb)[::-1]
            for trans, length in rev_ops[:-1] if rev_ops else []:
                alignment.add(trans, length)
            # forward traceback: skip the op leaving the seed cell
            for trans, length in fwd_ops[1:]:
                alignment.add(trans, length)
        return alignment

    def _overlaps(self, alignment: Alignment) -> bool:
        """(ref: SubOpt_overlaps_alignment, subopt.c:177-204)."""
        if self.subopt is None:
            return False
        qp = alignment.region.query_start
        tp = alignment.region.target_start
        for op in alignment.ops:
            trans = op.transition
            if trans.label == Label.MATCH:
                for _ in range(op.length):
                    for y in range(tp, tp + trans.advance_target):
                        rowset = self.subopt.by_row.get(y)
                        if rowset and any(
                                qp <= x < qp + trans.advance_query
                                for x in rowset):
                            return True
                    qp += trans.advance_query
                    tp += trans.advance_target
            else:
                qp += trans.advance_query * op.length
                tp += trans.advance_target * op.length
        return False

    def next_path(self, threshold: int) -> Optional[Alignment]:
        """(ref: SDP_Pair_next_path, sdp.c:743-814)."""
        if self.alignment_count:
            if not self.args.single_pass:
                for s in self.seeds:
                    s.max_start = _Terminal()
                self._find_starts()
                for s in self.seeds:
                    s.max_end = _Terminal()
                self._find_ends()
        else:
            self._find_starts()
            self._find_ends()
            if self.args.single_pass:
                self.single_pass_order = _qsort_by_score(self.seeds)
                self.single_pass_pos = 0
        alignment = None
        best_seed = None
        if self.args.single_pass:
            while self.single_pass_pos < len(self.single_pass_order):
                best_seed = self.single_pass_order[self.single_pass_pos]
                self.single_pass_pos += 1
                if best_seed.max_end.score < threshold:
                    return None
                alignment = self._find_path(best_seed)
                if self._overlaps(alignment):
                    alignment = None
                    best_seed = None
                else:
                    break
            if best_seed is None:
                return None
        else:
            best_seed = max(self.seeds, key=lambda s: s.max_end.score)
            if best_seed.max_end.score < threshold:
                return None
            alignment = self._find_path(best_seed)
        self.alignment_count += 1
        self.last_score = best_seed.max_end.score
        best_seed.max_end.score = NEG
        return alignment
