"""Coding DNA <-> genome model (ref: src/model/coding2genome.c:54-78)."""
from __future__ import annotations

from .ir import Label, Model
from .match import Match, MatchType
from .coding2coding import coding2coding_create
from .phase import phase_create


def coding2genome_create(intron_args=None) -> Model:
    m = coding2coding_create()
    m.rename("coding2genome")
    m.open()
    match_transition = m.select_single_transition(Label.MATCH)
    match = match_transition.label_data or Match.find(MatchType.CODON2CODON)
    phase = phase_create("target intron", match, False, True, intron_args)
    m.insert(phase, match_transition.input, match_transition.input)
    m.close()
    return m
