"""Frameshift modelling (ref: src/model/frameshift.c).

Adds a frameshift state beside a codon match state with 1/2-advance open
transitions and 0/3-advance close transitions, keeping max advance at 3.
"""
from __future__ import annotations

from .ir import Label, Model
from .data import AlignData


def _frameshift_grid(region, data: AlignData):
    return data.frameshift.frameshift_penalty


def frameshift_add(m: Model, match_state, suffix: str,
                   apply_to_query: bool):
    """(ref: Frameshift_add, src/model/frameshift.c:76-123)."""
    fs_state = m.add_state(f"frameshift {suffix}")
    fs_calc = next((c for c in m.calcs if c.grid_fn is _frameshift_grid),
                   None)
    if fs_calc is None:
        fs_calc = m.add_calc(
            "frameshift", 0, grid_fn=_frameshift_grid,
            max_score_fn=lambda data: data.frameshift.frameshift_penalty)
    q, t = (1, 0) if apply_to_query else (0, 1)
    m.add_transition(f"frameshift open 1 {suffix}", match_state, fs_state,
                     q, t, fs_calc, Label.FRAMESHIFT)
    m.add_transition(f"frameshift open 2 {suffix}", match_state, fs_state,
                     2 * q, 2 * t, fs_calc, Label.FRAMESHIFT)
    m.add_transition(f"frameshift close 0 {suffix}", fs_state, match_state,
                     0, 0)
    m.add_transition(f"frameshift close 3 {suffix}", fs_state, match_state,
                     3 * q, 3 * t, None, Label.FRAMESHIFT)
