"""Reference DP interpreter (NumPy).

The correctness oracle and small-region path engine: a faithful functional
re-derivation of the reference's interpreted Viterbi
(ref: src/c4/viterbi.c:655-837 Viterbi_interpreted), reproducing its
transition evaluation order, scope masking (ref: src/c4/layout.c:20-150),
tie-breaking (first max wins; SURVEY.md §8.2), shadow transport and
protection clamps — but formulated over materialized score grids rather than
per-cell callbacks, so the inner loops are vectorized per row.

Modes (ref: src/c4/viterbi.h:104-109):
- find_score: best score only.
- find_region: score + end point + start point (region-start shadow lanes).
- find_path: full traceback -> list of (transition, 1) ops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..model.ir import (IMPOSSIBLY_LOW_SCORE, IMPOSSIBLY_HIGH_SCORE,
                        Model, Protect, Scope, Transition)
from .region import Region

NEG = np.int64(IMPOSSIBLY_LOW_SCORE)


@dataclass
class DPResult:
    score: int
    query_end: int = 0       # region-local end position
    target_end: int = 0
    query_start: int = 0     # region-local start position (find_region/path)
    target_start: int = 0
    path: Optional[list] = None  # list of Transition, start->end order


def _materialize_grids(model: Model, region: Region, data) -> dict:
    """Materialize each calc's score grid once per region."""
    grids = {}
    for c in model.calcs:
        grids[id(c)] = np.asarray(c.materialize(region, data))
    return grids


def _grid_value(grid: np.ndarray, si: int, sj: int) -> int:
    """Read a broadcastable grid at source cell (si, sj)."""
    if grid.ndim == 0:
        return int(grid)
    if grid.ndim == 1:
        raise ValueError("1-D grids are ambiguous; use (Q+1,1) or (1,T+1)")
    i = si if grid.shape[0] > 1 else 0
    j = sj if grid.shape[1] > 1 else 0
    return int(grid[i, j])


def _scope_ok_start(scope: Scope, i: int, j: int) -> bool:
    if scope == Scope.ANYWHERE:
        return True
    if scope == Scope.EDGE:
        return i == 0 or j == 0
    if scope == Scope.QUERY:
        return i == 0
    if scope == Scope.TARGET:
        return j == 0
    return i == 0 and j == 0


def _scope_ok_end(scope: Scope, i: int, j: int, qlen: int, tlen: int) -> bool:
    if scope == Scope.ANYWHERE:
        return True
    if scope == Scope.EDGE:
        return i == qlen or j == tlen
    if scope == Scope.QUERY:
        return i == qlen
    if scope == Scope.TARGET:
        return j == tlen
    return i == qlen and j == tlen


def viterbi(model: Model, region: Region, data,
            mode: str = "score",
            subopt=None,
            traceback_region_start: bool = False,
            start_cell_fn=None,
            end_report_fn=None) -> DPResult:
    """Run the interpreted DP.

    mode: "score" | "region" | "path".
    subopt: optional SubOpt index; blocks MATCH transitions into blocked
    cells (ref: src/c4/viterbi.c:701-704).
    start_cell_fn(abs_q, abs_t) -> np.ndarray [1 + n_shadow]: initial cell
    for transitions leaving START (ref: cell_start_func, c4.h:102-105,
    viterbi.c:729-741); score base + seeded shadow lanes.
    end_report_fn(cell, abs_q, abs_t): called at every cell where the end
    state is set, with the [1 + n_shadow] prefix of that cell
    (ref: cell_end_func, viterbi.c:792-799).
    """
    assert not model.is_open
    qlen, tlen = region.query_length, region.target_length
    n_states = len(model.states)
    n_shadow = model.total_shadow_designations
    want_region = mode in ("region",)
    want_path = mode == "path"
    grids = _materialize_grids(model, region, data)
    shadow_inputs = {id(c): c.shadow_inputs_fn(region, data)
                     for c in model.calcs if c.shadow_inputs_fn is not None}

    start_state = model.start_state.state
    end_state = model.end_state.state
    start_scope = model.start_state.scope
    end_scope = model.end_state.scope

    # cell = [score, shadows..., (region-start q, region-start t)]
    n_extra = n_shadow + (2 if (want_region or want_path) else 0)
    rs_q = n_shadow if (want_region or want_path) else -1
    rs_t = n_shadow + 1 if (want_region or want_path) else -1

    mta = model.max_target_advance
    # rotating rows: rows[d] = row at target position j-d
    rows = [np.full((qlen + 1, n_states, 1 + n_extra), NEG, dtype=np.int64)
            for _ in range(mta + 1)]
    if want_path:
        tb = np.zeros((qlen + 1, tlen + 1, n_states), dtype=np.int16)

    best_score = NEG
    best_i = best_j = 0
    best_cell = None
    end_is_set = False

    transitions = model.transitions
    # precompute per-transition metadata
    tinfo = []
    for t in transitions:
        grid = grids[id(t.calc)] if t.calc is not None else None
        shadow_starts = model.src_shadows(t.input)
        tinfo.append((t, grid, shadow_starts))

    for j in range(tlen + 1):
        row0 = rows[0]
        row0[:] = NEG
        if subopt is not None:
            blocked_row = subopt.blocked_row(region, j)
        else:
            blocked_row = None
        for i in range(qlen + 1):
            state_is_set = np.zeros(n_states, dtype=bool)
            cell = row0[i]
            cell[:] = NEG
            for t, grid, shadow_starts in tinfo:
                aq, at = t.advance_query, t.advance_target
                si, sj = i - aq, j - at
                if si < 0 or sj < 0:
                    continue
                inp, out = t.input, t.output
                # scope validity (ref: layout.c:120-150)
                if inp is start_state:
                    if not _scope_ok_start(start_scope, si, sj):
                        continue
                if inp is end_state or out is start_state:
                    continue
                if out is end_state:
                    if not _scope_ok_end(end_scope, i, j, qlen, tlen):
                        continue
                if t.is_match and blocked_row is not None and blocked_row[i]:
                    continue
                if inp is start_state:
                    if start_cell_fn is not None:
                        init = start_cell_fn(region.query_start + si,
                                             region.target_start + sj)
                        src = np.zeros(1 + n_extra, dtype=np.int64)
                        src[:1 + n_shadow] = init[:1 + n_shadow]
                        base = int(src[0])
                    else:
                        base = 0
                        src = None
                else:
                    src = rows[at][si][inp.id]
                    base = int(src[0])
                # shadow-dependent calc (reads src cell lanes)
                if grid is None:
                    tscore = 0
                else:
                    tscore = _grid_value(grid, si, sj)
                    if t.calc.shadow_fn is not None:
                        svals = {sh.name: (int(src[sh.designation + 1])
                                           if src is not None else 0)
                                 for sh in t.dst_shadows}
                        tscore = int(t.calc.shadow_fn(
                            np, tscore, svals,
                            shadow_inputs.get(id(t.calc), {}),
                            region.query_start + si, region.target_start + sj))
                val = base + tscore
                if t.calc is not None:
                    if t.calc.protect & Protect.UNDERFLOW and \
                            val < IMPOSSIBLY_LOW_SCORE:
                        val = IMPOSSIBLY_LOW_SCORE
                    if t.calc.protect & Protect.OVERFLOW and \
                            val > IMPOSSIBLY_HIGH_SCORE:
                        val = IMPOSSIBLY_HIGH_SCORE
                dst = cell[out.id]
                if state_is_set[out.id] and dst[0] >= val:
                    continue
                state_is_set[out.id] = True
                # assign: score, shadow transport, traceback
                dst[0] = val
                if n_extra:
                    if src is not None:
                        dst[1:] = src[1:]
                    else:
                        dst[1:] = 0
                    # region-start lanes set on transitions from START
                    if inp is start_state and rs_q >= 0:
                        dst[1 + rs_q] = si
                        dst[1 + rs_t] = sj
                    # shadow starts: lanes reset when leaving src states
                    for sh in shadow_starts:
                        if sh.start == "query_pos":
                            dst[1 + sh.designation] = region.query_start + si
                        else:
                            dst[1 + sh.designation] = region.target_start + sj
                if want_path:
                    tb[i, j, out.id] = t.id + 1
            # end registration (ref: viterbi.c:779-800)
            if state_is_set[end_state.id]:
                tval = cell[end_state.id][0]
                if not end_is_set or best_score < tval:
                    best_score = tval
                    best_i, best_j = i, j
                    best_cell = cell[end_state.id].copy()
                    end_is_set = True
                if end_report_fn is not None:
                    end_report_fn(cell[end_state.id][:1 + n_shadow],
                                  region.query_start + i,
                                  region.target_start + j)
        rows = [rows[-1]] + rows[:-1]

    if not end_is_set and end_report_fn is not None:
        return DPResult(score=int(NEG))
    assert end_is_set, "no end state reached"
    res = DPResult(score=int(best_score), query_end=best_i, target_end=best_j)
    if (want_region or want_path) and best_cell is not None:
        res.query_start = int(best_cell[1 + rs_q])
        res.target_start = int(best_cell[1 + rs_t])
    if want_path:
        # walk traceback (ref: Viterbi_Data_create_Alignment viterbi.c:342-392)
        path = []
        i, j = best_i, best_j
        tid = tb[i, j, end_state.id]
        assert tid, "missing traceback at end cell"
        t = transitions[tid - 1]
        while True:
            path.append(t)
            i -= t.advance_query
            j -= t.advance_target
            if t.input is start_state:
                break
            tid = tb[i, j, t.input.id]
            if not tid:
                break
            t = transitions[tid - 1]
        path.reverse()
        res.path = path
        res.query_start, res.target_start = i, j
    return res


def find_score(model: Model, region: Region, data, subopt=None) -> int:
    return viterbi(model, region, data, "score", subopt).score


def find_region(model: Model, region: Region, data, subopt=None) -> DPResult:
    return viterbi(model, region, data, "region", subopt)


def find_path(model: Model, region: Region, data, subopt=None) -> DPResult:
    return viterbi(model, region, data, "path", subopt)
