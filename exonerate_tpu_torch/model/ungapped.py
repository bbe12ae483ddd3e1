"""Ungapped alignment model (ref: src/model/ungapped.c:106-166)."""
from __future__ import annotations

from ..engine.region import Region
from .ir import Label, Model
from .match import Match, MatchType, match_type_name
from .data import AlignData


def make_match_grid_fn(mtype: MatchType):
    def grid_fn(region: Region, data: AlignData):
        return data.match(mtype).score_grid(data.query, data.target, region)
    return grid_fn


def make_match_factored_fn(mtype: MatchType):
    def factored_fn(region: Region, data: AlignData):
        return data.match(mtype).score_factored(data.query, data.target,
                                                region)
    return factored_fn


def ungapped_create(match_type: MatchType) -> Model:
    """One match state looping with the match calc; silent start/end links
    (ref: Ungapped_create, src/model/ungapped.c:106-166)."""
    match = Match.find(match_type)
    m = Model(f"ungapped:{match_type_name(match_type)}")
    match_state = m.add_state("match")
    match_calc = m.add_calc("match", match.max_score(),
                            grid_fn=make_match_grid_fn(match_type),
                            factored_fn=make_match_factored_fn(match_type),
                            # heuristic bound tracks the run's submat
                            # (ref: calc max bound from the ArgumentSet
                            # Match, ungapped.c:131-136)
                            max_score_fn=lambda data:
                            data.match(match_type).max_score())
    m.add_transition("start to match", None, match_state, 0, 0)
    m.add_transition("match to end", match_state, None, 0, 0)
    m.add_transition("match", match_state, match_state,
                     match.advance_query, match.advance_target,
                     match_calc, Label.MATCH, match)
    m.add_portal("match portal", match_calc,
                 match.advance_query, match.advance_target)
    m.close()
    return m
