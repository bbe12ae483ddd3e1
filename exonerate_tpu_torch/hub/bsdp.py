"""BSDP: bounded sparse dynamic programming over the HSP graph.

Faithful reimplementation of the reference's first heuristic, selected
with --gappedextension no (ref: src/bsdp/bsdp.{h,c}, hpair.{h,c},
sar.{h,c}, heuristic.{h,c}).  HSPs become graph nodes; start/end
terminals and join/span edges are small bounded DPs on derived
sub-models (ref: C4_DerivedModel, c4.h:337-355) confirmed lazily
against admissible bound matrices, and the best chain assembles into a
full Alignment.  Spans (introns/NERs) cross unbounded gaps through a
src->span / span->dst DP pair communicating via integration matrices
(ref: Heuristic_Span, heuristic.c:445-676).

The small sub-DPs run on the native dense Viterbi (native/sdplib.cpp,
differential-tested vs the NumPy oracle) when the derived model's calcs
are expressible natively, falling back to the oracle otherwise (and for
the span integration DPs, which need per-cell start/end hooks); graph
search order, pairing-heap tie-breaking, mailboxes and SubOpt clash
re-confirmation reproduce the reference exactly so that byte-golden
outputs match.  EXONERATE_TPU_BSDP=python forces the oracle.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..align.alignment import Alignment
from ..engine.region import Region
from ..engine import reference as ref_engine
from ..model.ir import (IMPOSSIBLY_LOW_SCORE, DerivedModel, Label, Model,
                        Portal, Scope, Span)
from ..seeds.hsp import HSP, HspSet

NEG = IMPOSSIBLY_LOW_SCORE


def _viterbi(model: Model, region: Region, data, mode: str,
             subopt=None) -> "ref_engine.DPResult":
    """Hook-free sub-DP dispatcher: native dense Viterbi when the model
    is expressible, NumPy oracle otherwise (bit-identical engines; see
    tests/test_sdp_native.py)."""
    if os.environ.get("EXONERATE_TPU_BSDP") != "python":
        from ..engine import sdp_native
        res = sdp_native.run_viterbi(model, region, data, mode, subopt)
        if res is not None:
            return res
    return ref_engine.viterbi(model, region, data, mode, subopt=subopt)


@dataclass
class HeuristicArgs:
    """(ref: Heuristic_ArgumentSet heuristic.c:78-96;
    BSDP_ArgumentSet bsdp.c:25-26; SAR_ArgumentSet sar.c:26-27)."""
    terminal_range_internal: int = 12
    terminal_range_external: int = 12
    join_range_internal: int = 12
    join_range_external: int = 12
    span_range_internal: int = 12
    span_range_external: int = 12
    join_filter: int = 0
    hsp_quality: float = 0.0


# ---------------------------------------------------------------------------
# pairing-heap priority queue (ref: src/struct/pqueue.c) — tie behaviour
# (newest push wins root on equal keys) is parity-critical for BSDP
# ---------------------------------------------------------------------------

class _PQNode:
    __slots__ = ("data", "left", "next", "prev")

    def __init__(self, data):
        self.data = data
        self.left = None
        self.next = None
        self.prev = None


class PQueue:
    """Pairing heap with the reference's merge order
    (ref: PQueue_push/pop/top, pqueue.c:89-195)."""

    def __init__(self, comp: Callable):
        self.root: Optional[_PQNode] = None
        self.total = 0
        self.comp = comp  # comp(low, high): True when low > high

    def _order(self, a: _PQNode, b: _PQNode) -> _PQNode:
        if self.comp(a.data, b.data):
            a.next = b.next
            if a.next is not None:
                a.next.prev = a
            a, b = b, a
        else:
            b.prev = a.prev
        a.prev = b
        a.next = b.left
        if a.next is not None:
            a.next.prev = a
        b.left = a
        return b

    def push(self, data):
        n = _PQNode(data)
        if self.root is not None:
            self.root = self._order(self.root, n)
        else:
            self.root = n
        self.total += 1

    def top(self):
        return self.root.data if self.root is not None else None

    def _combine(self, n: _PQNode) -> _PQNode:
        if n.next is None:
            return n
        combine = []
        while n is not None:
            combine.append(n)
            n.prev.next = None
            n = n.next
        count = len(combine) - 1
        i = 0
        while i < count:
            combine[i] = self._order(combine[i], combine[i + 1])
            i += 2
        if not (count & 1):
            combine[i - 2] = self._order(combine[i - 2], combine[i])
        i -= 2
        while i >= 2:
            combine[i - 2] = self._order(combine[i - 2], combine[i])
            i -= 2
        return combine[0]

    def pop(self):
        if self.root is None:
            return None
        data = self.root.data
        self.root = (self._combine(self.root.left)
                     if self.root.left is not None else None)
        self.total -= 1
        if self.total == 0:
            self.root = None
        return data


# ---------------------------------------------------------------------------
# mutable region helper for the SAR geometry (engine Region is frozen)
# ---------------------------------------------------------------------------

class _Rect:
    __slots__ = ("qs", "ts", "ql", "tl")

    def __init__(self, qs=0, ts=0, ql=0, tl=0):
        self.qs, self.ts, self.ql, self.tl = qs, ts, ql, tl

    @property
    def q_end(self):
        return self.qs + self.ql

    @property
    def t_end(self):
        return self.ts + self.tl

    def region(self) -> Region:
        return Region(self.qs, self.ts, self.ql, self.tl)


# ---------------------------------------------------------------------------
# HSP helpers (ref macros, hspset.h:79-133)
# ---------------------------------------------------------------------------

class _HspInfo:
    """An HSP with its owning set + advance macros resolved."""
    __slots__ = ("hsp", "hspset", "qadv", "tadv")

    def __init__(self, hsp: HSP, hspset: HspSet):
        self.hsp = hsp
        self.hspset = hspset
        self.qadv = hspset.qadv
        self.tadv = hspset.tadv

    @property
    def q_start(self):
        return self.hsp.query_start

    @property
    def t_start(self):
        return self.hsp.target_start

    @property
    def q_end(self):
        return self.hsp.query_start + self.hsp.length * self.qadv

    @property
    def t_end(self):
        return self.hsp.target_start + self.hsp.length * self.tadv

    @property
    def q_cobs(self):
        return self.hsp.query_start + self.hsp.cobs * self.qadv

    @property
    def t_cobs(self):
        return self.hsp.target_start + self.hsp.cobs * self.tadv

    @property
    def diagonal(self):
        return (self.hsp.target_start * self.qadv
                - self.hsp.query_start * self.tadv)

    def cell_score(self, qpos: int, tpos: int) -> int:
        """Match score of the HSP cell at (qpos, tpos)
        (ref: HSP_get_score via the portal calc)."""
        return int(self.hspset.score_at(qpos, tpos))

    def self_score(self, qpos: int) -> int:
        """(ref: HSP_query_self)."""
        hs = self.hspset
        qi = hs._qi[qpos]
        return int(hs._mat[qi, qi])


# ---------------------------------------------------------------------------
# Heuristic: per-model derived components (ref: heuristic.{h,c})
# ---------------------------------------------------------------------------

def _path_is_possible(model: Model, src, dst) -> bool:
    """(ref: C4_Model_path_is_possible, c4.c:1307-1341)."""
    seen = set()
    stack = [src]
    while stack:
        s = stack.pop()
        for t in model.output_transitions(s):
            nxt = t.output
            if nxt is dst:
                return True
            if id(nxt) not in seen:
                seen.add(id(nxt))
                stack.append(nxt)
    return False


class HeuristicRange:
    """(ref: Heuristic_Range_create, heuristic.c:114-135)."""

    def __init__(self, internal: int, external: int, portal: Portal):
        self.internal_query = internal * portal.advance_query
        self.internal_target = internal * portal.advance_target
        self.external_query = external * portal.advance_query
        self.external_target = external * portal.advance_target


class HeuristicBound:
    """Admissible score-bound matrix: best path over every region shape
    with all calcs at their max_score (ref: Heuristic_Bound_create,
    heuristic.c:141-240)."""

    def __init__(self, model: Model, query_range: int, target_range: int,
                 data):
        self.query_range = query_range
        self.target_range = target_range
        bm = model.copy()
        bm.open()
        for c in bm.calcs:
            v = c.effective_max_score(data)
            c.grid_fn = None
            c.shadow_fn = None
            c.shadow_inputs_fn = None
            c.factored_fn = None
            c.pallas_fn = None
            c.kernel_inputs_fn = None
            c.max_score_fn = None
            c.max_score = v
        bm.shadows = []
        bm.configure_end(Scope.ANYWHERE)
        bm.close()
        self.matrix = np.full((query_range + 1, target_range + 1), NEG,
                              dtype=np.int64)

        def report(cell, q, t):
            self.matrix[q, t] = cell[0]

        ref_engine.viterbi(bm, Region(0, 0, query_range, target_range),
                           data, "score", end_report_fn=report)

    def max_region_convert(self):
        """Each cell becomes the max over all contained shapes
        (ref: Heuristic_Bound_max_region_convert, heuristic.c:247-266)."""
        m = self.matrix
        for i in range(1, self.query_range + 1):
            for j in range(1, self.target_range + 1):
                v = max(m[i - 1, j - 1], m[i - 1, j], m[i, j - 1])
                if m[i, j] < v:
                    m[i, j] = v


class HeuristicTerminal:
    """(ref: Heuristic_Terminal_create, heuristic.c:283-327)."""

    def __init__(self, model: Model, portal: Portal, transition,
                 is_start: bool, has: HeuristicArgs, data):
        self.range = HeuristicRange(has.terminal_range_internal,
                                    has.terminal_range_external, portal)
        if is_start:
            self.dm = DerivedModel(model, model.start_state.state,
                                   transition.output,
                                   model.start_state.scope, Scope.CORNER)
        else:
            self.dm = DerivedModel(model, transition.output,
                                   model.end_state.state,
                                   Scope.CORNER, model.end_state.scope)
        self.bound = HeuristicBound(
            self.dm.derived,
            self.range.internal_query + self.range.external_query,
            self.range.internal_target + self.range.external_target, data)
        self.bound.max_region_convert()


class HeuristicMatch:
    """One (portal, match transition) pair
    (ref: Heuristic_Match_create, heuristic.c:339-352)."""

    def __init__(self, model: Model, portal: Portal, transition, mid: int,
                 has: HeuristicArgs, data):
        self.id = mid
        self.portal = portal
        self.transition = transition
        self.start_terminal = HeuristicTerminal(model, portal, transition,
                                                True, has, data)
        self.end_terminal = HeuristicTerminal(model, portal, transition,
                                              False, has, data)


class HeuristicJoin:
    """(ref: Heuristic_Join_create, heuristic.c:270-310)."""

    def __init__(self, model: Model, src: HeuristicMatch,
                 dst: HeuristicMatch, has: HeuristicArgs, data):
        self.src_range = HeuristicRange(has.join_range_internal,
                                        has.join_range_external, src.portal)
        self.dst_range = HeuristicRange(has.join_range_internal,
                                        has.join_range_external, dst.portal)
        self.dm = DerivedModel(model, src.transition.output,
                               dst.transition.output,
                               Scope.CORNER, Scope.CORNER)
        # reference quirk: query range doubled from src, target from dst
        self.bound = HeuristicBound(
            self.dm.derived,
            2 * (self.src_range.internal_query
                 + self.src_range.external_query),
            2 * (self.dst_range.internal_target
                 + self.dst_range.external_target), data)


class HeuristicSpan:
    """Unbounded-gap crossing: src DP ends at the span state anywhere,
    its end cells transfer across the gap window into the dst DP's start
    cells via integration matrices (ref: Heuristic_Span_create,
    heuristic.c:445-531; _register/_integrate heuristic.c:566-676)."""

    def __init__(self, model: Model, src_state, dst_state,
                 src_portal: Portal, dst_portal: Portal, span: Span,
                 has: HeuristicArgs, data):
        self.span = span
        self.src_range = HeuristicRange(has.span_range_internal,
                                        has.span_range_external, src_portal)
        self.dst_range = HeuristicRange(has.span_range_internal,
                                        has.span_range_external, dst_portal)
        self.src_dm = DerivedModel(model, src_state, span.span_state,
                                   Scope.CORNER, Scope.ANYWHERE)
        self.dst_dm = DerivedModel(model, span.span_state, dst_state,
                                   Scope.ANYWHERE, Scope.CORNER)
        self.src_tb_dm = DerivedModel(model, src_state, span.span_state,
                                      Scope.CORNER, Scope.CORNER)
        self.src_bound = HeuristicBound(
            self.src_dm.derived,
            self.src_range.internal_query + self.src_range.external_query,
            self.src_range.internal_target + self.src_range.external_target,
            data)
        self.dst_bound = HeuristicBound(
            self.dst_dm.derived,
            self.dst_range.internal_query + self.dst_range.external_query,
            self.dst_range.internal_target + self.dst_range.external_target,
            data)
        self.src_bound.max_region_convert()
        self.dst_bound.max_region_convert()
        # span loop transitions for traceback
        # (ref: C4_Span_find_loop_transitions, c4.c:282-313)
        self.query_loop = None
        self.target_loop = None
        for t in model.output_transitions(span.span_state):
            if t.output is span.span_state and (t.calc is None):
                if t.advance_query:
                    self.query_loop = t
                else:
                    self.target_loop = t
        # integration matrices (cells carry the src model's shadow lanes)
        n_src = self.src_dm.derived.total_shadow_designations
        self.src_cell_size = 1 + n_src
        self.src_integration = np.full(
            (self.src_bound.query_range + 1,
             self.src_bound.target_range + 1, self.src_cell_size),
            0, dtype=np.int64)
        self.dst_integration = np.full(
            (self.dst_bound.query_range + 1,
             self.dst_bound.target_range + 1, 2), -1, dtype=np.int64)
        # lane transfer by shadow name (the reference shares one global
        # designation space across derived models; we re-map by name)
        src_lanes = {sh.name: sh.designation + 1
                     for sh in self.src_dm.derived.shadows}
        dst_shadows = self.dst_dm.derived.shadows
        self._transfer = [(sh.designation + 1, src_lanes.get(sh.name))
                          for sh in dst_shadows]
        self._dst_cell_size = 1 + self.dst_dm.derived \
            .total_shadow_designations
        self._dummy = np.full(self._dst_cell_size, 0, dtype=np.int64)
        self._dummy[0] = NEG
        self.curr_src_region: Optional[Region] = None
        self.curr_dst_region: Optional[Region] = None

    def get_max_query_range(self) -> int:
        return (self.src_range.external_query
                + self.dst_range.external_query + self.span.max_query)

    def get_max_target_range(self) -> int:
        return (self.src_range.external_target
                + self.dst_range.external_target + self.span.max_target)

    # -- the register/report/integrate/init protocol -----------------------

    def register(self, src_region: Region, dst_region: Region):
        self.curr_src_region = src_region
        self.curr_dst_region = dst_region
        self.src_integration[:, :, 0] = NEG

    def report_end(self, cell, qpos: int, tpos: int):
        r = self.curr_src_region
        i, j = qpos - r.query_start, tpos - r.target_start
        self.src_integration[i, j, :len(cell)] = cell

    def integrate(self):
        """(ref: Heuristic_Span_integrate, heuristic.c:589-676); the
        span crossing itself scores 0 (heuristic.c:362-366)."""
        src, dst = self.curr_src_region, self.curr_dst_region
        sp = self.span
        prev = None
        top_q = top_t = -1
        for i in range(dst.query_length + 1):
            for j in range(dst.target_length + 1):
                init_q = max(src.query_start,
                             dst.query_start + i - sp.max_query)
                init_t = max(src.target_start,
                             dst.target_start + j - sp.max_target)
                fin_q = min(src.query_start + src.query_length,
                            dst.query_start + i - sp.min_query)
                fin_t = min(src.target_start + src.target_length,
                            dst.target_start + j - sp.min_target)
                window = (init_q, init_t, fin_q, fin_t)
                if window != prev:
                    top_score = NEG
                    top_q = top_t = -1
                    for x in range(init_q, fin_q + 1):
                        for y in range(init_t, fin_t + 1):
                            cand = self.src_integration[
                                x - src.query_start,
                                y - src.target_start, 0]
                            if top_score < cand:
                                top_score = cand
                                top_q, top_t = x, y
                    prev = window
                self.dst_integration[i, j, 0] = top_q
                self.dst_integration[i, j, 1] = top_t

    def dst_init(self, qpos: int, tpos: int) -> np.ndarray:
        """(ref: Heuristic_Span_dst_init_start_func,
        heuristic.c:412-443)."""
        r = self.curr_dst_region
        i, j = qpos - r.query_start, tpos - r.target_start
        sq, st = self.dst_integration[i, j]
        if sq == -1 or st == -1:
            return self._dummy
        src = self.curr_src_region
        cell = self.src_integration[sq - src.query_start,
                                    st - src.target_start]
        out = np.zeros(self._dst_cell_size, dtype=np.int64)
        out[0] = cell[0]
        for d_lane, s_lane in self._transfer:
            if s_lane is not None:
                out[d_lane] = cell[s_lane]
        return out


class HeuristicPair:
    """(ref: Heuristic_Pair_create, heuristic.c:699-731)."""

    def __init__(self, model: Model, src: HeuristicMatch,
                 dst: HeuristicMatch, has: HeuristicArgs, data):
        self.src = src
        self.dst = dst
        self.join = HeuristicJoin(model, src, dst, has, data)
        self.span_list: list[HeuristicSpan] = []
        for span in model.spans:
            if _path_is_possible(model, src.transition.output,
                                 span.span_state) \
                    and _path_is_possible(model, span.span_state,
                                          dst.transition.output):
                self.span_list.append(HeuristicSpan(
                    model, src.transition.output, dst.transition.output,
                    src.portal, dst.portal, span, has, data))

    def get_max_range(self):
        """(ref: Heuristic_Pair_get_max_range, heuristic.c:745-767 —
        NOTE the reference's `if(...);` always-assign bug makes the max
        range simply the LAST span's range when spans exist)."""
        mq = (self.join.src_range.external_query
              + self.join.dst_range.external_query)
        mt = (self.join.src_range.external_target
              + self.join.dst_range.external_target)
        for hspan in self.span_list:
            mq = hspan.get_max_query_range()
            mt = hspan.get_max_target_range()
        return mq, mt


class Heuristic:
    """(ref: Heuristic_create, heuristic.c:772-829)."""

    def __init__(self, model: Model, has: Optional[HeuristicArgs], data):
        assert model.portals, "model has no portals"
        self.model = model
        self.has = has or HeuristicArgs()
        self.matches: list[HeuristicMatch] = []
        counter = 0
        for portal in model.portals:
            for transition in portal.transitions:
                self.matches.append(HeuristicMatch(
                    model, portal, transition, counter, self.has, data))
                counter += 1
        self.match_total = counter
        self.pair_matrix: list[list[Optional[HeuristicPair]]] = []
        for src in self.matches:
            row = []
            for dst in self.matches:
                if _path_is_possible(model, src.transition.output,
                                     dst.transition.output):
                    row.append(HeuristicPair(model, src, dst, self.has,
                                             data))
                else:
                    row.append(None)
            self.pair_matrix.append(row)


# ---------------------------------------------------------------------------
# SAR: sub-alignment regions (ref: src/bsdp/sar.c)
# ---------------------------------------------------------------------------

def _hsp_cells(hi: _HspInfo, qstart: int, tstart: int, n: int
               ) -> list[int]:
    """Scores of n HSP cells along the diagonal from (qstart, tstart)."""
    out = []
    q, t = qstart, tstart
    for _ in range(n):
        out.append(hi.cell_score(q, t))
        q += hi.qadv
        t += hi.tadv
    return out


def _find_start_component(region: _Rect, hi: _HspInfo):
    """(ref: SAR_find_start_component, sar.c:246-271)."""
    prefix = (region.q_end - hi.q_start) // hi.qadv
    component = sum(_hsp_cells(hi, hi.q_start, hi.t_start, prefix))
    return component, prefix


def _find_end_component(region: _Rect, hi: _HspInfo):
    """(ref: SAR_find_end_component, sar.c:273-297)."""
    suffix = (hi.q_end - region.qs) // hi.qadv
    component = sum(_hsp_cells(hi, region.qs, region.ts, suffix))
    return component, suffix


def _hsp_quality(hi: _HspInfo, start: int, length: int):
    """(ref: SAR_HSP_quality, sar.c:301-318)."""
    half = maxs = 0
    q = hi.q_start + start * hi.qadv
    t = hi.t_start + start * hi.tadv
    for _ in range(length):
        half += hi.cell_score(q, t)
        maxs += hi.self_score(q)
        q += hi.qadv
        t += hi.tadv
    return half, maxs


def _scope_edges_ok(scope: Scope, at_q: bool, at_t: bool) -> bool:
    if scope == Scope.ANYWHERE:
        return True
    if scope == Scope.CORNER:
        return at_q and at_t
    if scope == Scope.EDGE:
        return at_q or at_t
    if scope == Scope.QUERY:
        return at_q
    if scope == Scope.TARGET:
        return at_t
    return False


def _terminal_start_region(hi: _HspInfo, rng: HeuristicRange,
                           scope: Scope) -> Optional[_Rect]:
    """(ref: SAR_Terminal_calculate_start_region, sar.c:84-158)."""
    outer = _Rect(0, 0, hi.q_cobs, hi.t_cobs)
    r = _Rect(hi.q_start, hi.t_start, 0, 0)
    r.qs -= rng.external_query
    r.ts -= rng.external_target
    r.ql += rng.external_query
    r.tl += rng.external_target
    r.ql += rng.internal_query
    r.tl += rng.internal_target
    if r.qs < outer.qs:
        r.ql -= outer.qs - r.qs
        r.qs = outer.qs
    if r.ts < outer.ts:
        r.tl -= outer.ts - r.ts
        r.ts = outer.ts
    to_shrink = r.q_end - outer.q_end
    if to_shrink > 0:
        r.ql -= to_shrink
    to_shrink = r.t_end - outer.t_end
    if to_shrink > 0:
        r.tl -= to_shrink
    if r.ql <= 0 or r.tl <= 0:
        return None
    if not _scope_edges_ok(scope, r.qs == 0, r.ts == 0):
        return None
    return r


def _terminal_end_region(hi: _HspInfo, rng: HeuristicRange, scope: Scope,
                         qlen: int, tlen: int) -> Optional[_Rect]:
    """(ref: SAR_Terminal_calculate_end_region, sar.c:160-242)."""
    outer = _Rect(hi.q_cobs, hi.t_cobs, qlen - hi.q_cobs,
                  tlen - hi.t_cobs)
    r = _Rect(hi.q_end, hi.t_end, 0, 0)
    r.ql += rng.external_query
    r.tl += rng.external_target
    r.qs -= rng.internal_query
    r.ql += rng.internal_query
    r.ts -= rng.internal_target
    r.tl += rng.internal_target
    if r.q_end > outer.q_end:
        r.ql -= r.q_end - outer.q_end
    if r.t_end > outer.t_end:
        r.tl -= r.t_end - outer.t_end
    to_shrink = outer.qs - r.qs
    if to_shrink > 0:
        r.qs += to_shrink
        r.ql -= to_shrink
    to_shrink = outer.ts - r.ts
    if to_shrink > 0:
        r.ts += to_shrink
        r.tl -= to_shrink
    if r.ql <= 0 or r.tl <= 0:
        return None
    if not _scope_edges_ok(scope, r.q_end == qlen, r.t_end == tlen):
        return None
    return r


class SarTerminal:
    """(ref: SAR_Terminal_create, sar.c:321-371)."""

    def __init__(self, region: _Rect, component: int):
        self.region = region.region()
        self.component = component

    @classmethod
    def create(cls, hi: _HspInfo, hpair: "HPair", match: HeuristicMatch,
               is_start: bool) -> Optional["SarTerminal"]:
        model = hpair.heuristic.model
        if is_start:
            r = _terminal_start_region(hi, match.start_terminal.range,
                                       model.start_state.scope)
        else:
            r = _terminal_end_region(hi, match.end_terminal.range,
                                     model.end_state.scope,
                                     hpair.query_length,
                                     hpair.target_length)
        if r is None:
            return None
        if is_start:
            component, prefix = _find_start_component(r, hi)
            start, length = prefix, hi.hsp.cobs - prefix
        else:
            component, suffix = _find_end_component(r, hi)
            start = hi.hsp.cobs
            length = hi.hsp.length - hi.hsp.cobs - suffix
        if length and hpair.heuristic.has.hsp_quality > 0.0:
            half, maxs = _hsp_quality(hi, start, length)
            if (half / maxs) * 100.0 < hpair.heuristic.has.hsp_quality:
                return None
        return cls(r, component)

    def find_bound(self, bound: HeuristicBound) -> int:
        return int(bound.matrix[self.region.query_length,
                                self.region.target_length]) \
            - self.component

    def find_score(self, terminal: HeuristicTerminal, hpair: "HPair"
                   ) -> int:
        try:
            res = _viterbi(terminal.dm.derived, self.region,
                           hpair.data, "score", subopt=hpair.subopt)
        except AssertionError:
            return NEG
        return res.score - self.component


def _reduce_mid_overlap(hpair: "HPair", src: _HspInfo, dst: _HspInfo,
                        region: _Rect):
    """Pick the crossing point in an HSP overlap maximizing the summed
    cell scores, tie-broken nearest the overlap centre
    (ref: SAR_reduce_mid_overlap, sar.c:404-485)."""
    if region.ql + region.tl == 0:
        return
    src_total = dst_total = 0
    dq = region.q_end - dst.qadv
    dt = region.t_end - dst.tadv
    while (dq >= region.qs and dt >= region.ts
           and dq >= dst.q_start and dt >= dst.t_start):
        dst_total += dst.cell_score(dq, dt)
        dq -= dst.qadv
        dt -= dst.tadv
    dq += dst.qadv
    dt += dst.tadv
    sq, st = region.qs, region.ts
    max_total = dst_total
    max_sq, max_st, max_dq, max_dt = sq, st, dq, dt
    max_dist = region.q_end - sq
    while (sq < region.q_end and st < region.t_end
           and sq < src.q_end and st < src.t_end):
        src_total += src.cell_score(sq, st)
        while sq >= dq or st >= dt:
            dst_total -= dst.cell_score(dq, dt)
            dq += dst.qadv
            dt += dst.tadv
        if max_total <= src_total + dst_total:
            if (max_total < src_total + dst_total
                    or abs(region.q_end - sq) < max_dist):
                max_dist = abs(region.q_end - sq)
                max_total = src_total + dst_total
                max_sq, max_st, max_dq, max_dt = sq, st, dq, dt
        sq += src.qadv
        st += src.tadv
    region.qs = max_sq
    region.ts = max_st
    region.ql = max_dq - max_sq
    region.tl = max_dt - max_st


def _find_cobs_box(src: _HspInfo, dst: _HspInfo) -> Optional[_Rect]:
    """(ref: SAR_find_cobs_box, sar.c:565-578)."""
    r = _Rect(src.q_cobs, src.t_cobs,
              dst.q_cobs - src.q_cobs, dst.t_cobs - src.t_cobs)
    if r.ql <= 0 or r.tl <= 0:
        return None
    return r


def _find_end_box(hpair: "HPair", src: _HspInfo, dst: _HspInfo,
                  cobs_box: _Rect) -> _Rect:
    """(ref: SAR_find_end_box, sar.c:488-563)."""
    q_overlap = src.q_end - dst.q_start
    t_overlap = src.t_end - dst.t_start
    r = _Rect(min(src.q_end, dst.q_start), min(src.t_end, dst.t_start), 0,
              0)
    r.ql = max(src.q_end, dst.q_start) - r.qs
    r.tl = max(src.t_end, dst.t_start) - r.ts
    if q_overlap > 0 or t_overlap > 0:
        sq_move = r.qs - cobs_box.qs
        st_move = r.ts - cobs_box.ts
        if sq_move <= 0 or st_move <= 0:
            sq_move = st_move = 0
        else:
            sq_move -= sq_move % src.qadv
            st_move -= st_move % src.tadv
            if sq_move // src.qadv < st_move // src.tadv:
                st_move = (sq_move // src.qadv) * src.tadv
            else:
                sq_move = (st_move // src.tadv) * src.qadv
        dq_move = cobs_box.q_end - r.q_end
        dt_move = cobs_box.t_end - r.t_end
        if dq_move <= 0 or dt_move <= 0:
            dq_move = dt_move = 0
        else:
            dq_move -= dq_move % dst.qadv
            dt_move -= dt_move % dst.tadv
            if dq_move // dst.qadv < dt_move // dst.tadv:
                dt_move = (dq_move // dst.qadv) * dst.tadv
            else:
                dq_move = (dt_move // dst.tadv) * dst.qadv
        r.qs = cobs_box.qs + sq_move
        r.ts = cobs_box.ts + st_move
        r.ql = cobs_box.q_end - dq_move - r.qs
        r.tl = cobs_box.t_end - dt_move - r.ts
        _reduce_mid_overlap(hpair, src, dst, r)
    return r


def _join_region(hpair: "HPair", src: _HspInfo, dst: _HspInfo,
                 pair: HeuristicPair) -> Optional[_Rect]:
    """(ref: SAR_Join_calculate_region, sar.c:580-635)."""
    outer = _find_cobs_box(src, dst)
    if outer is None:
        return None
    r = _find_end_box(hpair, src, dst, outer)
    if r.ql > (pair.join.src_range.external_query
               + pair.join.dst_range.external_query):
        return None
    if r.tl > (pair.join.src_range.external_target
               + pair.join.dst_range.external_target):
        return None
    r.qs -= pair.join.src_range.internal_query
    r.ql += (pair.join.src_range.internal_query
             + pair.join.dst_range.internal_query)
    r.ts -= pair.join.src_range.internal_target
    r.tl += (pair.join.src_range.internal_target
             + pair.join.dst_range.internal_target)
    to_shrink = outer.qs - r.qs
    if to_shrink > 0:
        r.qs += to_shrink
        r.ql -= to_shrink
    to_shrink = outer.ts - r.ts
    if to_shrink > 0:
        r.ts += to_shrink
        r.tl -= to_shrink
    to_shrink = r.q_end - outer.q_end
    if to_shrink > 0:
        r.ql -= to_shrink
    to_shrink = r.t_end - outer.t_end
    if to_shrink > 0:
        r.tl -= to_shrink
    if r.ql < 1 or r.tl < 1:
        return None
    return r


class SarJoin:
    """(ref: SAR_Join_create, sar.c:637-676)."""

    def __init__(self, region: _Rect, src_component: int,
                 dst_component: int, pair: HeuristicPair):
        self.region = region.region()
        self.src_component = src_component
        self.dst_component = dst_component
        self.pair = pair

    @classmethod
    def create(cls, src: _HspInfo, dst: _HspInfo, hpair: "HPair",
               pair: HeuristicPair) -> Optional["SarJoin"]:
        r = _join_region(hpair, src, dst, pair)
        if r is None:
            return None
        src_component, suffix = _find_end_component(r, src)
        dst_component, prefix = _find_start_component(r, dst)
        has = hpair.heuristic.has
        src_length = src.hsp.length - src.hsp.cobs - suffix
        dst_length = dst.hsp.cobs - prefix
        if (src_length + dst_length) and has.hsp_quality > 0.0:
            sh, sm = _hsp_quality(src, src.hsp.cobs, src_length)
            dh, dm = _hsp_quality(dst, prefix, dst_length)
            if ((sh + dh) / (sm + dm)) * 100.0 < has.hsp_quality:
                return None
        return cls(r, src_component, dst_component, pair)

    def find_bound(self) -> int:
        return int(self.pair.join.bound.matrix[
            self.region.query_length, self.region.target_length]) \
            - (self.src_component + self.dst_component)

    def find_score(self, hpair: "HPair") -> int:
        try:
            res = _viterbi(self.pair.join.dm.derived, self.region,
                           hpair.data, "score", subopt=hpair.subopt)
        except AssertionError:
            return NEG
        return res.score - (self.src_component + self.dst_component)


def _span_regions(hpair: "HPair", src: _HspInfo, dst: _HspInfo,
                  hspan: HeuristicSpan):
    """(ref: SAR_Span_calculate_regions, sar.c:680-806)."""
    outer = _find_cobs_box(src, dst)
    if outer is None:
        return None
    end_box = _find_end_box(hpair, src, dst, outer)
    sr = _Rect(end_box.qs, end_box.ts, 0, 0)
    dr = _Rect(end_box.q_end, end_box.t_end, 0, 0)
    sr.ql += hspan.src_range.external_query
    sr.tl += hspan.src_range.external_target
    dr.qs -= hspan.dst_range.external_query
    dr.ts -= hspan.dst_range.external_target
    dr.ql += hspan.dst_range.external_query
    dr.tl += hspan.dst_range.external_target
    sr.qs -= hspan.src_range.internal_query
    sr.ql += hspan.src_range.internal_query
    sr.ts -= hspan.src_range.internal_target
    sr.tl += hspan.src_range.internal_target
    dr.ql += hspan.dst_range.internal_query
    dr.tl += hspan.dst_range.internal_target
    if sr.q_end > outer.q_end:
        sr.ql -= sr.q_end - outer.q_end
    if sr.t_end > outer.t_end:
        sr.tl -= sr.t_end - outer.t_end
    to_shrink = outer.qs - sr.qs
    if to_shrink > 0:
        sr.qs += to_shrink
        sr.ql -= to_shrink
    to_shrink = outer.ts - sr.ts
    if to_shrink > 0:
        sr.ts += to_shrink
        sr.tl -= to_shrink
    if dr.qs < outer.qs:
        dr.ql -= outer.qs - dr.qs
        dr.qs = outer.qs
    if dr.ts < outer.ts:
        dr.tl -= outer.ts - dr.ts
        dr.ts = outer.ts
    to_shrink = dr.q_end - outer.q_end
    if to_shrink > 0:
        dr.ql -= to_shrink
    to_shrink = dr.t_end - outer.t_end
    if to_shrink > 0:
        dr.tl -= to_shrink
    if sr.ql < 1 or sr.tl < 1 or dr.ql < 1 or dr.tl < 1:
        return None
    if dr.qs - sr.q_end > hspan.span.max_query:
        return None
    if dr.ts - sr.t_end > hspan.span.max_target:
        return None
    return sr, dr


class SarSpan:
    """(ref: SAR_Span_create, sar.c:808-870)."""

    def __init__(self, src_region: _Rect, dst_region: _Rect,
                 src_component: int, dst_component: int,
                 hspan: HeuristicSpan):
        self.src_region = src_region.region()
        self.dst_region = dst_region.region()
        self.src_component = src_component
        self.dst_component = dst_component
        self.hspan = hspan

    @classmethod
    def create(cls, src: _HspInfo, dst: _HspInfo, hpair: "HPair",
               hspan: HeuristicSpan) -> Optional["SarSpan"]:
        regions = _span_regions(hpair, src, dst, hspan)
        if regions is None:
            return None
        sr, dr = regions
        src_component, suffix = _find_end_component(sr, src)
        dst_component, prefix = _find_start_component(dr, dst)
        has = hpair.heuristic.has
        src_length = src.hsp.length - src.hsp.cobs - suffix
        dst_length = dst.hsp.cobs - prefix
        if (src_length + dst_length) and has.hsp_quality > 0.0:
            sh, sm = _hsp_quality(src, src.hsp.cobs, src_length)
            dh, dm = _hsp_quality(dst, prefix, dst_length)
            if ((sh + dh) / (sm + dm)) * 100.0 < has.hsp_quality:
                return None
        return cls(sr, dr, src_component, dst_component, hspan)

    def find_bound(self) -> int:
        """(ref: SAR_Span_find_bound, sar.c:879-911)."""
        hspan = self.hspan
        q_ov = self.src_region.query_end - self.dst_region.query_start
        t_ov = self.src_region.target_end - self.dst_region.target_start
        q_ov = max(0, q_ov)
        t_ov = max(0, t_ov)
        src_raw = hspan.src_bound.matrix[
            self.src_region.query_length - (q_ov >> 1),
            self.src_region.target_length - (t_ov >> 1)]
        dst_raw = hspan.dst_bound.matrix[
            self.dst_region.query_length - (q_ov >> 1) - (q_ov & 1),
            self.dst_region.target_length - (t_ov >> 1) - (t_ov & 1)]
        return (int(src_raw) - self.src_component) \
            + (int(dst_raw) - self.dst_component)

    def find_score(self, hpair: "HPair") -> int:
        """Two-pass span DP via the integration matrices
        (ref: SAR_Span_find_score, sar.c:913-933)."""
        hspan = self.hspan
        hspan.register(self.src_region, self.dst_region)
        try:
            ref_engine.viterbi(hspan.src_dm.derived, self.src_region,
                               hpair.data, "score", subopt=hpair.subopt,
                               end_report_fn=hspan.report_end)
            hspan.integrate()
            res = ref_engine.viterbi(hspan.dst_dm.derived,
                                     self.dst_region, hpair.data,
                                     "score", subopt=hpair.subopt,
                                     start_cell_fn=hspan.dst_init)
        except AssertionError:
            return NEG
        return res.score - (self.src_component + self.dst_component)


# ---------------------------------------------------------------------------
# BSDP graph solver (ref: src/bsdp/bsdp.c)
# ---------------------------------------------------------------------------

M_IS_NEW = 1
M_IS_INITIALISED = 2
M_IS_USED = 4
M_SCORED_TERMINAL = 8
M_IS_VALID_START = 16
M_IS_VALID_END = 32
M_CONFIRMED_START = 64
M_CONFIRMED_END = 128
M_USED_AS_START = 256
M_USED_AS_END = 512


class _BsdpEdge:
    __slots__ = ("edge_data", "dst", "join_score", "stored_partial",
                 "mailbox")

    def __init__(self, edge_data, dst, bound_score):
        self.edge_data = edge_data
        self.dst = dst
        self.join_score = bound_score
        self.stored_partial = 0
        self.mailbox = -1


class _BsdpNode:
    __slots__ = ("mask", "node_data", "node_score", "start_score",
                 "end_score", "stored_total", "edge_list", "edge_pq",
                 "edge_used", "start_mailbox", "end_mailbox")

    def __init__(self, node_data, node_score, is_valid_start,
                 is_valid_end, start_bound, end_bound):
        self.mask = M_IS_NEW
        self.start_score = NEG
        self.end_score = NEG
        if is_valid_start:
            self.mask |= M_IS_VALID_START
            self.start_score = start_bound
        if is_valid_end:
            self.mask |= M_IS_VALID_END
            self.end_score = end_bound
        self.node_data = node_data
        self.node_score = node_score
        self.stored_total = node_score
        self.edge_list: Optional[list] = None
        self.edge_pq: Optional[PQueue] = None
        self.edge_used: Optional[_BsdpEdge] = None
        self.start_mailbox = -1
        self.end_mailbox = -1


class Bsdp:
    """Lazy best-chain extraction with bound-then-confirm semantics
    (ref: BSDP, bsdp.h:114-169, bsdp.c)."""

    def __init__(self, confirm_edge, confirm_start, confirm_end,
                 update_edge, update_start, update_end, join_filter=0):
        self.confirm_edge = confirm_edge
        self.confirm_start = confirm_start
        self.confirm_end = confirm_end
        self.update_edge = update_edge
        self.update_start = update_start
        self.update_end = update_end
        self.join_filter = join_filter
        self.node_list: list[_BsdpNode] = []
        self.node_pq: Optional[PQueue] = None
        self.path_count = 0
        # join_filter mode: per-node src/dst potential queues
        self._filter: Optional[list] = None

    def add_node(self, node_data, node_score, is_valid_start,
                 is_valid_end, start_bound, end_bound) -> int:
        self.node_list.append(_BsdpNode(node_data, node_score,
                                        is_valid_start, is_valid_end,
                                        start_bound, end_bound))
        return len(self.node_list) - 1

    def add_edge(self, edge_data, src_id: int, dst_id: int,
                 bound_score: int):
        src = self.node_list[src_id]
        dst = self.node_list[dst_id]
        edge = _BsdpEdge(edge_data, dst, bound_score)
        if self.join_filter:
            if self._filter is None:
                self._filter = [None] * len(self.node_list)
            self._submit_filtered(edge, src, src_id, dst_id)
        else:
            if src.edge_list is None:
                src.edge_list = []
            src.edge_list.append(edge)

    # -- join filter (ref: BSDP_Edge_submit/BSDP_initialise_filter) -------

    def _submit_filtered(self, edge, src, src_id, dst_id):
        pot = {"score": (src.start_score + src.node_score
                         + edge.join_score + edge.dst.node_score
                         + edge.dst.end_score),
               "edge": edge, "src": src, "refs": 2}
        comp = lambda lo, hi: lo["score"] > hi["score"]  # noqa: E731
        for nid in (src_id, dst_id):
            if self._filter[nid] is None:
                self._filter[nid] = (PQueue(comp), PQueue(comp))
            pq = self._filter[nid][0 if nid == src_id else 1]
            if pq.total <= self.join_filter:
                pq.push(pot)
            else:
                top = pq.top()
                if top["score"] < pot["score"]:
                    prev = pq.pop()
                    prev["refs"] -= 1
                    pq.push(pot)
                else:
                    pot["refs"] -= 1

    def _apply_filter(self):
        if self._filter is None:
            return
        for pair in self._filter:
            if pair is None:
                continue
            # remove tie-breakers from the SRC queues only — the
            # reference's first initialise loop walks just
            # src_edge_pqueue (bsdp.c:509-515); dst queues keep their
            # N+1 entries and only gate survival via the ref count
            pq = pair[0]
            if pq.total > self.join_filter:
                pot = pq.pop()
                score = pot["score"]
                pot["refs"] -= 1
                while pq.total:
                    top = pq.top()
                    if top["score"] != score:
                        break
                    pq.pop()["refs"] -= 1
        for pair in self._filter:
            if pair is None:
                continue
            for pq in pair:
                while True:
                    pot = pq.pop()
                    if pot is None:
                        break
                    if pot["refs"] == 2:  # survived in src + dst queues
                        src = pot["src"]
                        if src.edge_list is None:
                            src.edge_list = []
                        src.edge_list.append(pot["edge"])
                        pot["refs"] = 0
                    elif pot["refs"]:
                        pot["refs"] -= 1
        self._filter = None

    # -- score propagation (ref: bsdp.c:360-430) ---------------------------

    def _top_partial(self, node: _BsdpNode, update: bool) -> int:
        node.mask &= ~M_SCORED_TERMINAL
        score = NEG
        if node.mask & M_IS_VALID_END:
            score = node.node_score + node.end_score
            node.mask |= M_SCORED_TERMINAL
        pq = node.edge_pq
        edge = None
        while True:
            edge = pq.top()
            if edge is None:
                break
            if edge.dst.mask & M_IS_USED:
                pq.pop()
            else:
                break
        if edge is not None:
            if update:
                while True:
                    edge = pq.pop()
                    if edge is None:
                        break
                    if edge.dst.mask & M_IS_USED:
                        continue
                    self._update(node, edge, True)
                    if pq.top() is edge:
                        break
            if edge is not None and score < edge.stored_partial:
                node.mask &= ~M_SCORED_TERMINAL
                score = edge.stored_partial
        return score

    def _stored_total(self, node: _BsdpNode, update: bool) -> int:
        if not (node.mask & M_IS_VALID_START):
            return NEG
        return node.start_score + self._top_partial(node, update)

    def _update(self, node: _BsdpNode, edge: _BsdpEdge, update: bool):
        edge.stored_partial = (node.node_score + edge.join_score
                               + self._top_partial(edge.dst, update))
        node.edge_pq.push(edge)

    def _initialise_recur(self, node: _BsdpNode):
        if node.mask & M_IS_INITIALISED:
            return
        edge_list = node.edge_list
        node.edge_pq = PQueue(
            lambda lo, hi: lo.stored_partial > hi.stored_partial)
        node.mask &= ~M_IS_NEW
        node.mask |= M_IS_INITIALISED
        if edge_list:
            for edge in edge_list:
                self._initialise_recur(edge.dst)
                self._update(node, edge, False)
        node.edge_list = None

    def initialise(self, threshold: int):
        if not self.node_list:
            return
        self._apply_filter()
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit,
                                  10000 + 10 * len(self.node_list)))
        for node in self.node_list:
            self._initialise_recur(node)
            node.stored_total = self._stored_total(node, False)
            if node.stored_total >= threshold:
                if self.node_pq is None:
                    self.node_pq = PQueue(
                        lambda lo, hi: lo.stored_total > hi.stored_total)
                self.node_pq.push(node)

    # -- validate / confirm / extract (ref: bsdp.c:560-790) ----------------

    def _path_validate_recur(self, node: _BsdpNode):
        if node.mask & M_SCORED_TERMINAL:
            return
        pq = node.edge_pq
        while True:
            edge = pq.pop()
            if edge is not None:
                if edge.dst.mask & M_IS_USED:
                    if pq.top() is edge:
                        break
                    continue
                self._path_validate_recur(edge.dst)
                self._update(node, edge, False)
            if pq.top() is edge:
                break

    def _path_validate(self, threshold: int) -> bool:
        if self.node_pq is None:
            return False
        while True:
            node = self.node_pq.pop()
            if node is None:
                return False
            if node.mask & M_IS_USED:
                if self.node_pq.top() is node:
                    break
                continue
            self._path_validate_recur(node)
            node.stored_total = self._stored_total(node, True)
            if node.stored_total >= threshold:
                self.node_pq.push(node)
            else:
                if self.node_pq.top() is node:
                    break
                continue
            if self.node_pq.top() is node:
                break
        return True

    def _path_confirm(self) -> int:
        first = self.node_pq.top()
        node = first
        confirm_count = 0
        while True:
            if node.mask & M_SCORED_TERMINAL:
                break
            edge = node.edge_pq.top()
            if edge is None:
                break
            if edge.mailbox == -1:
                edge.mailbox = self.path_count
                confirmed = self.confirm_edge(node.node_data,
                                              edge.edge_data,
                                              edge.dst.node_data)
                assert edge.join_score >= confirmed, \
                    "BSDP bound below confirmed score"
                if edge.join_score != confirmed:
                    edge.join_score = confirmed
                    confirm_count += 1
            else:
                if edge.mailbox != self.path_count:
                    prev = edge.join_score
                    edge.join_score = self.update_edge(
                        node.node_data, edge.edge_data,
                        edge.dst.node_data, prev, edge.mailbox)
                    edge.mailbox = self.path_count
                    if edge.join_score != prev:
                        confirm_count += 1
            node = edge.dst
        # confirm the start
        if first.mask & M_CONFIRMED_START:
            if first.start_mailbox != self.path_count:
                prev = first.start_score
                first.start_score = self.update_start(
                    first.node_data, prev, first.start_mailbox)
                first.start_mailbox = self.path_count
                if first.start_score != prev:
                    confirm_count += 1
        else:
            first.start_mailbox = self.path_count
            confirmed = self.confirm_start(first.node_data)
            first.mask |= M_CONFIRMED_START
            if first.start_score != confirmed:
                first.start_score = confirmed
                confirm_count += 1
        # confirm the end
        if node.mask & M_CONFIRMED_END:
            if node.end_mailbox != self.path_count:
                prev = node.end_score
                node.end_score = self.update_end(node.node_data, prev,
                                                 node.end_mailbox)
                node.end_mailbox = self.path_count
                if node.end_score != prev:
                    confirm_count += 1
        else:
            node.end_mailbox = self.path_count
            confirmed = self.confirm_end(node.node_data)
            node.mask |= M_CONFIRMED_END
            if node.end_score != confirmed:
                node.end_score = confirmed
                confirm_count += 1
        return confirm_count

    def _path_extract(self):
        node = self.node_pq.top()
        score = node.stored_total
        node.mask |= M_USED_AS_START
        nodes = []
        while True:
            nodes.append(node)
            node.mask |= M_IS_USED
            edge = node.edge_pq.pop()
            node.edge_pq = None
            node.edge_used = edge
            if node.mask & M_SCORED_TERMINAL:
                node.mask |= M_USED_AS_END
                break
            node = edge.dst
        return score, nodes

    def next_path(self, threshold: int):
        while True:
            if not self._path_validate(threshold):
                return None
            if not self._path_confirm():
                break
        path = self._path_extract()
        self.path_count += 1
        return path


# ---------------------------------------------------------------------------
# HPair: the BSDP graph for one sequence pair (ref: src/bsdp/hpair.c)
# ---------------------------------------------------------------------------

class _NodeData:
    __slots__ = ("match", "hi", "sar_start", "sar_end")

    def __init__(self, match: HeuristicMatch, hi: _HspInfo,
                 sar_start, sar_end):
        self.match = match
        self.hi = hi
        self.sar_start = sar_start
        self.sar_end = sar_end


class _EdgeData:
    __slots__ = ("sar_join", "sar_span")

    def __init__(self, sar_join=None, sar_span=None):
        self.sar_join = sar_join
        self.sar_span = sar_span


class HPair:
    """(ref: HPair, hpair.h:31-56)."""

    def __init__(self, heuristic: Heuristic, subopt, query_length: int,
                 target_length: int, data):
        self.heuristic = heuristic
        self.subopt = subopt
        self.query_length = query_length
        self.target_length = target_length
        self.data = data
        self.is_finalised = False
        self.portal_data: dict[int, HspSet] = {}
        self.node_offset = [0] * heuristic.match_total
        self.bsdp = Bsdp(self._confirm_edge, self._confirm_start,
                         self._confirm_end, self._update_edge,
                         self._update_start, self._update_end,
                         heuristic.has.join_filter)

    def add_hspset(self, portal: Portal, hspset: HspSet):
        pid = self.heuristic.model.portals.index(portal)
        assert pid not in self.portal_data
        self.portal_data[pid] = hspset

    # -- SubOpt clash checks (ref: hpair.c:88-145) -------------------------

    def _check_diag(self, hi: _HspInfo, region: Region) -> bool:
        diag = hi.diagonal

        def check(q, t, pid):
            return (t * hi.qadv - q * hi.tadv) == diag

        return self.subopt.find(region, check)

    def _check_entry(self, hi: _HspInfo, region: Region) -> bool:
        search = Region(hi.q_cobs, hi.t_cobs,
                        region.query_start - hi.q_cobs,
                        region.target_start - hi.t_cobs)
        return self._check_diag(hi, search)

    def _check_exit(self, hi: _HspInfo, region: Region) -> bool:
        search = Region(region.query_end, region.target_end,
                        hi.q_cobs - region.query_end,
                        hi.t_cobs - region.target_end)
        return self._check_diag(hi, search)

    def _check_region_since(self, region: Region, last_updated: int
                            ) -> bool:
        return self.subopt.find(
            region, lambda q, t, pid: pid >= last_updated)

    # -- BSDP callbacks (ref: hpair.c:148-291) -----------------------------

    def _confirm_edge(self, src_data: _NodeData, edge_data: _EdgeData,
                      dst_data: _NodeData) -> int:
        if edge_data.sar_join is not None:
            join = edge_data.sar_join
            if self._check_entry(src_data.hi, join.region) \
                    or self._check_exit(dst_data.hi, join.region):
                return NEG
            return join.find_score(self)
        span = edge_data.sar_span
        if self._check_entry(src_data.hi, span.src_region) \
                or self._check_exit(dst_data.hi, span.dst_region):
            return NEG
        return span.find_score(self)

    def _update_edge(self, src_data, edge_data, dst_data, prev_score,
                     last_updated) -> int:
        if edge_data.sar_join is not None:
            join = edge_data.sar_join
            if self._check_entry(src_data.hi, join.region) \
                    or self._check_exit(dst_data.hi, join.region):
                return NEG
            if self._check_region_since(join.region, last_updated):
                return join.find_score(self)
        else:
            span = edge_data.sar_span
            if self._check_entry(src_data.hi, span.src_region) \
                    or self._check_exit(dst_data.hi, span.dst_region):
                return NEG
            if self._check_region_since(span.src_region, last_updated) \
                    or self._check_region_since(span.dst_region,
                                                last_updated):
                return span.find_score(self)
        return prev_score

    def _confirm_start(self, node_data: _NodeData) -> int:
        if self._check_exit(node_data.hi, node_data.sar_start.region):
            return NEG
        return node_data.sar_start.find_score(
            node_data.match.start_terminal, self)

    def _update_start(self, node_data: _NodeData, prev_score,
                      last_updated) -> int:
        if self._check_exit(node_data.hi, node_data.sar_start.region):
            return NEG
        if self._check_region_since(node_data.sar_start.region,
                                    last_updated):
            return node_data.sar_start.find_score(
                node_data.match.start_terminal, self)
        return prev_score

    def _confirm_end(self, node_data: _NodeData) -> int:
        if self._check_entry(node_data.hi, node_data.sar_end.region):
            return NEG
        return node_data.sar_end.find_score(
            node_data.match.end_terminal, self)

    def _update_end(self, node_data: _NodeData, prev_score,
                    last_updated) -> int:
        if self._check_entry(node_data.hi, node_data.sar_end.region):
            return NEG
        if self._check_region_since(node_data.sar_end.region,
                                    last_updated):
            return node_data.sar_end.find_score(
                node_data.match.end_terminal, self)
        return prev_score

    # -- graph building (ref: hpair.c:383-670) -----------------------------

    def _initialise_nodes(self):
        for match in self.heuristic.matches:
            hspset = self.portal_data.get(
                self.heuristic.model.portals.index(match.portal))
            if hspset is None:
                continue
            for j, hsp in enumerate(hspset.hsps):
                hi = _HspInfo(hsp, hspset)
                sar_start = SarTerminal.create(hi, self, match, True)
                sar_end = SarTerminal.create(hi, self, match, False)
                start_bound = (sar_start.find_bound(
                    match.start_terminal.bound)
                    if sar_start is not None else NEG)
                end_bound = (sar_end.find_bound(match.end_terminal.bound)
                             if sar_end is not None else NEG)
                node_data = _NodeData(match, hi, sar_start, sar_end)
                node_id = self.bsdp.add_node(
                    node_data, hsp.score, sar_start is not None,
                    sar_end is not None, start_bound, end_bound)
                if not self.node_offset[match.id]:
                    self.node_offset[match.id] = node_id + 1

    @staticmethod
    def _pair_is_valid(src: _HspInfo, dst: _HspInfo) -> bool:
        """(ref: HPair_hsp_pair_is_valid, hpair.c:437-450)."""
        if src.hsp is dst.hsp:
            return False
        if src.q_cobs == dst.q_cobs and src.t_cobs == dst.t_cobs:
            return False
        if src.q_cobs > dst.q_cobs:
            return False
        if src.t_cobs > dst.t_cobs:
            return False
        return True

    def _calc_emit(self, src: _HspInfo, dst: _HspInfo):
        """(ref: HPair_hsp_pair_calc_emit, hpair.c:452-488)."""
        q_overlap = src.q_end > dst.q_start
        t_overlap = src.t_end > dst.t_start
        q_emit = dst.q_start - src.q_end
        if q_overlap:
            q_emit = q_emit % dst.qadv
        t_emit = dst.t_start - src.t_end
        if t_overlap:
            t_emit = t_emit % dst.tadv
        if q_overlap and not t_overlap:
            t_emit += (src.q_end - dst.q_start) \
                * (dst.tadv // src.qadv)
        if t_overlap and not q_overlap:
            q_emit += (src.t_end - dst.t_start) \
                * (dst.qadv // src.tadv)
        return q_emit, t_emit

    def _add_candidate(self, pair: HeuristicPair, src: _HspInfo,
                       dst: _HspInfo, src_hsp_id: int, dst_hsp_id: int):
        """(ref: HPair_add_candidate_hsp_pair, hpair.c:513-565)."""
        if not self._pair_is_valid(src, dst):
            return
        src_node_id = self.node_offset[pair.src.id] + src_hsp_id - 1
        dst_node_id = self.node_offset[pair.dst.id] + dst_hsp_id - 1
        q_emit, t_emit = self._calc_emit(src, dst)
        join = pair.join
        sar_join = None
        if q_emit <= join.bound.query_range \
                and t_emit <= join.bound.target_range:
            sar_join = SarJoin.create(src, dst, self, pair)
        if sar_join is not None:
            self.bsdp.add_edge(_EdgeData(sar_join=sar_join),
                               src_node_id, dst_node_id,
                               sar_join.find_bound())
        else:
            for hspan in pair.span_list:
                # (ref: HPair_Span_is_valid, hpair.c:497-511)
                if q_emit > (hspan.span.max_query
                             + hspan.src_bound.query_range
                             + hspan.dst_bound.query_range):
                    continue
                if t_emit > (hspan.span.max_target
                             + hspan.src_bound.target_range
                             + hspan.dst_bound.target_range):
                    continue
                if q_emit < hspan.span.min_query:
                    continue
                if t_emit < hspan.span.min_target:
                    continue
                sar_span = SarSpan.create(src, dst, self, hspan)
                if sar_span is None:
                    continue
                bound = sar_span.find_bound()
                if bound <= NEG:
                    continue
                self.bsdp.add_edge(_EdgeData(sar_span=sar_span),
                                   src_node_id, dst_node_id, bound)

    def _initialise_edges(self):
        model = self.heuristic.model
        for i in range(self.heuristic.match_total):
            for j in range(self.heuristic.match_total):
                pair = self.heuristic.pair_matrix[i][j]
                if pair is None:
                    continue
                src_set = self.portal_data.get(
                    model.portals.index(pair.src.portal))
                dst_set = self.portal_data.get(
                    model.portals.index(pair.dst.portal))
                if src_set is None or dst_set is None:
                    continue
                if not src_set.hsps or not dst_set.hsps:
                    continue
                mq, mt = pair.get_max_range()
                max_dst = max(dst_set.hsps, key=lambda h: h.cobs)
                md = _HspInfo(max_dst, dst_set)
                for si, src_hsp in enumerate(src_set.hsps):
                    src = _HspInfo(src_hsp, src_set)
                    q_lo = src.q_cobs
                    q_hi = q_lo + (src.q_cobs - src.q_start) \
                        + (md.q_cobs - md.q_start) + mq
                    t_lo = src.t_cobs
                    t_hi = t_lo + (src.t_cobs - src.t_start) \
                        + (md.t_cobs - md.t_start) + mt
                    for di, dst_hsp in enumerate(dst_set.hsps):
                        dst = _HspInfo(dst_hsp, dst_set)
                        # half-open RangeTree window on dst cobs
                        if not (q_lo <= dst.q_cobs < q_hi
                                and t_lo <= dst.t_cobs < t_hi):
                            continue
                        self._add_candidate(pair, src, dst, si, di)

    def finalise(self, threshold: int):
        assert not self.is_finalised
        self._initialise_nodes()
        self._initialise_edges()
        self.bsdp.initialise(threshold)
        self.is_finalised = True

    # -- path -> Alignment assembly (ref: SAR_Alignment, sar.c:937-1105) ---

    def next_path(self, threshold: int) -> Optional[Alignment]:
        assert self.is_finalised
        result = self.bsdp.next_path(threshold)
        if result is None:
            return None
        score, nodes = result
        first_data: _NodeData = nodes[0].node_data
        last_data: _NodeData = nodes[-1].node_data
        asm = _SarAlignment(self, first_data.sar_start,
                            last_data.sar_end, first_data.match,
                            last_data.match, score)
        asm.add_hsp(first_data.hi, first_data.match)
        for i in range(1, len(nodes)):
            edge = nodes[i - 1].edge_used
            edge_data: _EdgeData = edge.edge_data
            dst_data: _NodeData = nodes[i].node_data
            if edge_data.sar_join is not None:
                asm.add_join(edge_data.sar_join)
            else:
                asm.add_span(edge_data.sar_span)
            asm.add_hsp(dst_data.hi, dst_data.match)
        asm.finalise()
        return asm.alignment


class _SarAlignment:
    """Stitches terminal/HSP/join/span sub-paths into one Alignment
    (ref: SAR_Alignment_create/add_HSP/add_SAR_Join/add_SAR_Span/
    finalise, sar.c:937-1105)."""

    def __init__(self, hpair: HPair, sar_start: SarTerminal,
                 sar_end: SarTerminal, start_match: HeuristicMatch,
                 end_match: HeuristicMatch, score: int):
        self.hpair = hpair
        start_res = _viterbi(
            start_match.start_terminal.dm.derived, sar_start.region,
            hpair.data, "path", subopt=hpair.subopt)
        self.end_res = _viterbi(
            end_match.end_terminal.dm.derived, sar_end.region,
            hpair.data, "path", subopt=hpair.subopt)
        self.end_region = sar_end.region
        self.end_match = end_match
        start_abs = _abs_region(sar_start.region, start_res)
        end_abs = _abs_region(sar_end.region, self.end_res)
        region = Region(start_abs.query_start, start_abs.target_start,
                        end_abs.query_end - start_abs.query_start,
                        end_abs.target_end - start_abs.target_start)
        self.alignment = Alignment(hpair.heuristic.model, region, score)
        _import_derived(self.alignment, start_res.path,
                        start_match.start_terminal.dm)
        self.last_region: Optional[Region] = start_abs
        self.last_hi: Optional[_HspInfo] = None
        self.last_match: Optional[HeuristicMatch] = None

    def add_hsp(self, hi: _HspInfo, match: HeuristicMatch):
        prefix = (self.last_region.query_end - hi.q_start) // hi.qadv
        self.alignment.add(match.transition, hi.hsp.length - prefix)
        self.last_region = None
        self.last_hi = hi
        self.last_match = match

    def _add_region(self, src_region: Region, dst_region: Region):
        suffix = (self.last_hi.q_end - src_region.query_start) \
            // self.last_hi.qadv
        self.alignment.add(self.last_match.transition, -suffix)
        self.last_hi = None
        self.last_match = None
        self.last_region = dst_region

    def add_join(self, sar_join: SarJoin):
        res = _viterbi(sar_join.pair.join.dm.derived, sar_join.region,
                       self.hpair.data, "path",
                       subopt=self.hpair.subopt)
        self._add_region(sar_join.region, sar_join.region)
        _import_derived(self.alignment, res.path, sar_join.pair.join.dm)

    def add_span(self, sar_span: SarSpan):
        hspan = sar_span.hspan
        hpair = self.hpair
        hspan.register(sar_span.src_region, sar_span.dst_region)
        ref_engine.viterbi(hspan.src_dm.derived, sar_span.src_region,
                           hpair.data, "score", subopt=hpair.subopt,
                           end_report_fn=hspan.report_end)
        hspan.integrate()
        dst_res = ref_engine.viterbi(hspan.dst_dm.derived,
                                     sar_span.dst_region, hpair.data,
                                     "path", subopt=hpair.subopt,
                                     start_cell_fn=hspan.dst_init)
        dst_abs = _abs_region(sar_span.dst_region, dst_res)
        q_span_end = dst_abs.query_start - sar_span.dst_region.query_start
        t_span_end = dst_abs.target_start \
            - sar_span.dst_region.target_start
        sq, st = hspan.dst_integration[q_span_end, t_span_end]
        src_align_region = Region(
            sar_span.src_region.query_start,
            sar_span.src_region.target_start,
            int(sq) - sar_span.src_region.query_start,
            int(st) - sar_span.src_region.target_start)
        src_res = _viterbi(hspan.src_tb_dm.derived, src_align_region,
                           hpair.data, "path", subopt=hpair.subopt)
        self._add_region(sar_span.src_region, sar_span.dst_region)
        _import_derived(self.alignment, src_res.path, hspan.src_tb_dm)
        # the span loop transitions cross the gap
        # (ref: Heuristic_Span_add_traceback, heuristic.c:368-383)
        q_gap = dst_abs.query_start - src_align_region.query_end
        t_gap = dst_abs.target_start - src_align_region.target_end
        if q_gap:
            self.alignment.add(hspan.query_loop,
                               q_gap // hspan.query_loop.advance_query)
        if t_gap:
            self.alignment.add(hspan.target_loop,
                               t_gap // hspan.target_loop.advance_target)
        _import_derived(self.alignment, dst_res.path, hspan.dst_dm)

    def finalise(self):
        self._add_region(self.end_region, self.end_region)
        _import_derived(self.alignment, self.end_res.path,
                        self.end_match.end_terminal.dm)
        assert self.alignment.is_valid(), \
            "BSDP assembly does not tile its region"


def _abs_region(region: Region, res) -> Region:
    """Absolute region of a sub-DP path result."""
    return Region(region.query_start + res.query_start,
                  region.target_start + res.target_start,
                  res.query_end - res.query_start,
                  res.target_end - res.target_start)


def _import_derived(alignment: Alignment, path, dm: DerivedModel):
    """(ref: Alignment_import_derived, alignment.c)."""
    for t in path:
        alignment.add(dm.transition_map[id(t)], 1)
