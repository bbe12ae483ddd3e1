"""Splice-site / intron submodel (ref: src/model/intron.c).

An intron submodel is: START -(5'ss, advance 2, splice PSSM + open
penalty)-> intron state -(loop, advance 1)-> ... -(3'ss, advance 2, splice
PSSM + length-window check)-> END, with a span declaring the unbounded intron
range and a shadow lane recording where the intron started
(ref: src/model/intron.c:588-697).  Splice scores come in as whole-sequence
int32 arrays (SpliceCache), so the calc grids are just shifted vectors.
"""
from __future__ import annotations

import numpy as np

from ..engine.region import Region
from .ir import IMPOSSIBLY_LOW_SCORE, Label, Model, Protect
from .data import AlignData


_SPLICE_WIN_MEMO: dict = {}


def _splice_vector(data: AlignData, region: Region, on_query: bool,
                   site: str, forward: bool) -> np.ndarray:
    """Per-source-position splice scores as a broadcastable grid.
    The padded window slice memoizes per (scores array, window): every
    query of a scan (and every locus re-run) re-slices the same
    target-side vector; the value keeps `scores` alive so id() stays
    unambiguous.  Entries are read-only."""
    cache = data.splice_cache(on_query)
    scores = cache.scores(site, forward)
    if on_query:
        lo, n = region.query_start, region.query_length
    else:
        lo, n = region.target_start, region.target_length
    key = (id(scores), lo, n, on_query)
    hit = _SPLICE_WIN_MEMO.get(key)
    if hit is not None:
        return hit[1]
    out = np.zeros(n + 1, dtype=np.int32)
    take = scores[lo:lo + n]
    out[:len(take)] = take
    out = out[:, None] if on_query else out[None, :]
    if len(_SPLICE_WIN_MEMO) > 256:
        _SPLICE_WIN_MEMO.clear()
    _SPLICE_WIN_MEMO[key] = (scores, out)
    return out


_GRID_MEMO: dict = {}


def _grid_memo(parts: list, extra: int, builder):
    """Memoize composed intron grids per (input windows, penalty): the
    input windows are themselves memoized (stable id while alive), so
    the sum/astype over a 1 Mb window runs once per scan, not once per
    query.  The value keeps the inputs alive; entries are read-only."""
    key = tuple(id(p) for p in parts) + (extra,)
    hit = _GRID_MEMO.get(key)
    if hit is not None:
        return hit[1]
    out = builder()
    if len(_GRID_MEMO) > 256:
        _GRID_MEMO.clear()
    _GRID_MEMO[key] = (parts, out)
    return out


def _make_pre_grid(on_query: bool, on_target: bool,
                   site_q: str, site_t: str, forward: bool):
    """5'-side calc: intron open penalty + splice score(s) at the source
    position (ref: Intron_CalcFunc is_pre, src/model/intron.c:138-160)."""
    def grid_fn(region: Region, data: AlignData):
        parts = []
        if on_query:
            parts.append(_splice_vector(data, region, True, site_q,
                                        forward))
        if on_target:
            parts.append(_splice_vector(data, region, False, site_t,
                                        forward))
        pen = int(data.intron.intron_open_penalty)

        def build():
            total = parts[0]
            for v in parts[1:]:
                total = total + v
            return (total + np.int32(pen)).astype(np.int32)
        return _grid_memo(parts, pen, build)
    return grid_fn


def _make_post_grid(on_query: bool, on_target: bool,
                    site_q: str, site_t: str, forward: bool):
    def grid_fn(region: Region, data: AlignData):
        parts = []
        if on_query:
            parts.append(_splice_vector(data, region, True, site_q,
                                        forward))
        if on_target:
            parts.append(_splice_vector(data, region, False, site_t,
                                        forward))

        def build():
            total = parts[0]
            for v in parts[1:]:
                total = total + v
            return total.astype(np.int32)
        return _grid_memo(parts, None, build)
    return grid_fn


def _make_pre_qt(site_q: str, site_t: str, forward: bool):
    """Separable form of the joint pre grid: qvec[i] + tvec[j]
    (open penalty folded into qvec)."""
    def qt_fn(region: Region, data: AlignData):
        qv = _splice_vector(data, region, True, site_q, forward)[:, 0]
        tv = _splice_vector(data, region, False, site_t, forward)[0, :]
        return ((qv + np.int32(data.intron.intron_open_penalty))
                .astype(np.int32), tv.astype(np.int32))
    return qt_fn


def _make_post_qt(site_q: str, site_t: str, forward: bool):
    def qt_fn(region: Region, data: AlignData):
        qv = _splice_vector(data, region, True, site_q, forward)[:, 0]
        tv = _splice_vector(data, region, False, site_t, forward)[0, :]
        return qv.astype(np.int32), tv.astype(np.int32)
    return qt_fn


def _intron_shadow_inputs(region, data: AlignData):
    return {"min_intron": np.int32(data.intron.min_intron),
            "max_intron": np.int32(data.intron.max_intron)}


def _make_post_shadow_fn(on_query: bool, on_target: bool):
    """Length-window check using the intron-start shadow lane(s)
    (ref: Intron_CalcFunc !is_pre, src/model/intron.c:147-158):
    intron_length = pos - intron_start + 2; outside [min,max] -> impossible.
    """
    def shadow_fn(xp, grid_val, svals, inputs, qpos, tpos):
        lo, hi = inputs["min_intron"], inputs["max_intron"]
        bad = False
        if on_query:
            length = qpos - _shadow_value(svals, "query intron") + 2
            bad = bad | (length < lo) | (length > hi)
        if on_target:
            length = tpos - _shadow_value(svals, "target intron") + 2
            bad = bad | (length < lo) | (length > hi)
        return xp.where(bad, IMPOSSIBLY_LOW_SCORE, grid_val)
    return shadow_fn


def _shadow_value(svals: dict, prefix: str):
    for k, v in svals.items():
        if k.startswith(prefix):
            return v
    raise KeyError(f"no shadow with prefix {prefix!r} in {list(svals)}")


def intron_create(suffix: str, on_query: bool, on_target: bool,
                  is_forward: bool,
                  intron_args=None) -> Model:
    """(ref: Intron_create, src/model/intron.c:588-697)."""
    assert on_query or on_target
    from .data import IntronArgs
    ias = intron_args or IntronArgs()
    m = Model(f"intron {suffix}")
    if is_forward:
        pre_name, post_name = "5'ss forward", "3'ss forward"
        pre_label, post_label = Label.SS5, Label.SS3
        pre_site, post_site = "5", "3"
    else:
        pre_name, post_name = "3'ss reverse", "5'ss reverse"
        pre_label, post_label = Label.SS3, Label.SS5
        pre_site, post_site = "3", "5"
    qadv = 2 if on_query else 0
    tadv = 2 if on_target else 0

    # splice max scores bound the calcs (truncated to int like the C cast)
    sps = ias.predictor_set()
    pre_sp = sps.get(pre_site, is_forward)
    post_sp = sps.get(post_site, is_forward)
    pre_bound = ias.intron_open_penalty + int(
        pre_sp.max_score * (2 if (on_query and on_target) else 1))
    post_bound = int(post_sp.max_score * (2 if (on_query and on_target) else 1))

    pre_calc = m.add_calc(
        f"{pre_name} {suffix}", pre_bound,
        grid_fn=_make_pre_grid(on_query, on_target, pre_site, pre_site,
                               is_forward),
        protect=Protect.UNDERFLOW)
    if on_query and on_target:
        pre_calc.qt_fn = _make_pre_qt(pre_site, pre_site, is_forward)
    post_calc = m.add_calc(
        f"{post_name} {suffix}", post_bound,
        grid_fn=_make_post_grid(on_query, on_target, post_site, post_site,
                                is_forward),
        shadow_fn=_make_post_shadow_fn(on_query, on_target),
        shadow_inputs_fn=_intron_shadow_inputs,
        protect=Protect.UNDERFLOW)
    post_calc.native_shadow = ("intron_window",
                               {"on_query": on_query,
                                "on_target": on_target})
    if on_query and on_target:
        post_calc.qt_fn = _make_post_qt(post_site, post_site,
                                        is_forward)

    intron_state = m.add_state(f"intron {suffix}")
    m.add_transition(f"(START) to intron {suffix}", None, intron_state,
                     qadv, tadv, pre_calc, pre_label)
    if on_query:
        m.add_transition(f"query intron loop {suffix}", intron_state,
                         intron_state, 1, 0, None, Label.INTRON)
    if on_target:
        m.add_transition(f"target intron loop {suffix}", intron_state,
                         intron_state, 0, 1, None, Label.INTRON)
    m.add_transition(f"intron {suffix} to (END)", intron_state, None,
                     qadv, tadv, post_calc, post_label)
    m.add_span(f"intron span{suffix}", intron_state,
               ias.min_intron if on_query else 0,
               ias.max_intron if on_query else 0,
               ias.min_intron if on_target else 0,
               ias.max_intron if on_target else 0)
    if on_query:
        m.add_shadow(f"query intron {suffix}", None, None, "query_pos")
    if on_target:
        m.add_shadow(f"target intron {suffix}", None, None, "target_pos")
    # The reference CLOSES the intron submodel before it is inserted
    # (ref: src/model/intron.c:695) — the close's topological sort
    # REVERSES the advancing-transition list, and C4_Model_insert copies
    # that reversed order into the composed model.  The composed model's
    # own close reverses again, so the net per-cell evaluation order of
    # [5'ss, loops, 3'ss] depends on how many open/close cycles each
    # submodel went through.  This ordering is parity-critical: in the
    # forward boundary pass it decides whether a cell's span-loop SUBMIT
    # sees the pre- or post-THAW intron score, which controls whether
    # span seeds can chain (re-freeze at later entry points) across a
    # semi-alignable intron interior (genome2genome minus/minus judge
    # probe: 1118 vs 1108).
    m.close()
    return m
