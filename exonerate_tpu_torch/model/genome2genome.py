"""Genome <-> genome model (ref: src/model/genome2genome.c:58-96).

cdna2genome plus query-side and joint introns on every match state
(flagged "not working well yet" in the reference man page,
ref: doc/man/man1/exonerate.1:415).
"""
from __future__ import annotations

from .ir import Label, Model
from .match import Match, MatchType
from .intron import intron_create
from .phase import phase_create
from .cdna2genome import cdna2genome_create


def genome2genome_create(intron_args=None) -> Model:
    m = Model("genome2genome")
    cdna = cdna2genome_create(intron_args)
    m.insert(cdna, None, None)
    query_intron = intron_create("query", True, False, True, intron_args)
    joint_intron = intron_create("joint", True, True, True, intron_args)
    codon_match = Match.find(MatchType.CODON2CODON)
    query_phase = phase_create("query", codon_match, True, False, intron_args)
    joint_phase = phase_create("joint", codon_match, True, True, intron_args)
    for t in list(m.select_transitions(Label.MATCH)):
        if t.advance_query == 1:
            m.insert(query_intron, t.input, t.output)
            m.insert(joint_intron, t.input, t.output)
        else:
            assert t.advance_query == 3 and t.advance_target == 3
            m.insert(query_phase, t.input, t.output)
            m.insert(joint_phase, t.input, t.output)
    m.close()
    return m
