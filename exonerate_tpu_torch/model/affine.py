"""Affine gapped models: global / bestfit / local / overlap
(ref: src/model/affine.c:150-255)."""
from __future__ import annotations

import enum

from ..alphabet import AlphabetType
from .ir import Label, Model, Scope
from .match import match_type_find
from .data import AlignData
from .ungapped import ungapped_create


class AffineModelType(enum.Enum):
    GLOBAL = "global"
    BESTFIT = "bestfit"
    LOCAL = "local"
    OVERLAP = "overlap"


_SCOPE = {
    AffineModelType.GLOBAL: Scope.CORNER,
    AffineModelType.BESTFIT: Scope.QUERY,
    AffineModelType.LOCAL: Scope.ANYWHERE,
    AffineModelType.OVERLAP: Scope.EDGE,
}


def _gap_open_grid(region, data: AlignData):
    return data.affine.gap_open


def _gap_extend_grid(region, data: AlignData):
    return data.affine.gap_extend


def _codon_gap_open_grid(region, data: AlignData):
    return data.affine.codon_gap_open


def _codon_gap_extend_grid(region, data: AlignData):
    return data.affine.codon_gap_extend


def open_fn_max(codon: bool):
    if codon:
        return lambda data: data.affine.codon_gap_open
    return lambda data: data.affine.gap_open


def extend_fn_max(codon: bool):
    if codon:
        return lambda data: data.affine.codon_gap_extend
    return lambda data: data.affine.gap_extend


def affine_create(atype: AffineModelType,
                  query_type: AlphabetType,
                  target_type: AlphabetType,
                  translate_both: bool = False) -> Model:
    """Extend the ungapped model with insert/delete states
    (ref: Affine_create, src/model/affine.c:150-255)."""
    match_type = match_type_find(query_type, target_type, translate_both)
    m = ungapped_create(match_type)
    scope = _SCOPE[atype]
    m.open()
    m.rename(f"affine:{atype.value}:{match_type.value}")
    m.configure_start(scope)
    m.configure_end(scope)
    insert_state = m.add_state("insert")
    delete_state = m.add_state("delete")
    match_transition = m.select_single_transition(Label.MATCH)
    codon = max(match_transition.advance_query,
                match_transition.advance_target) == 3
    open_fn = _codon_gap_open_grid if codon else _gap_open_grid
    extend_fn = _codon_gap_extend_grid if codon else _gap_extend_grid
    # the admissible bound IS the (negative) penalty, like the reference
    # (ref: affine.c:210-217 passes aas->gap_open/gap_extend as max_score);
    # heuristic bound matrices depend on this
    gap_open = m.add_calc("gap open", 0, grid_fn=open_fn,
                          max_score_fn=open_fn_max(codon))
    gap_extend = m.add_calc("gap extend", 0, grid_fn=extend_fn,
                            max_score_fn=extend_fn_max(codon))
    m.add_transition("match to insert", match_transition.input, insert_state,
                     match_transition.advance_query, 0, gap_open, Label.GAP)
    m.add_transition("match to delete", match_transition.input, delete_state,
                     0, match_transition.advance_target, gap_open, Label.GAP)
    m.add_transition("insert", insert_state, insert_state,
                     match_transition.advance_query, 0, gap_extend, Label.GAP)
    m.add_transition("insert to match", insert_state,
                     match_transition.output, 0, 0)
    m.add_transition("delete", delete_state, delete_state,
                     0, match_transition.advance_target, gap_extend,
                     Label.GAP)
    m.add_transition("delete to match", delete_state,
                     match_transition.output, 0, 0)
    m.close()
    return m
