"""cDNA <-> genome model (ref: src/model/cdna2genome.c:50-93).

UTR (est2genome-style) flanks around a coding2genome core; the coding region
is forced through the codon submodel by the DNA2DNA match calc's CDS
annotation veto (ref: src/comparison/match.c:276-281).
"""
from __future__ import annotations

from ..alphabet import AlphabetType
from .ir import Label, Model
from .affine import AffineModelType, affine_create
from .match import MatchType
from .intron import intron_create
from .coding2genome import coding2genome_create


def _utr_create(intron_args=None) -> Model:
    m = affine_create(AffineModelType.LOCAL, AlphabetType.DNA,
                      AlphabetType.DNA, False)
    intron = intron_create("forward", False, True, True, intron_args)
    match_transition = m.select_single_transition(Label.MATCH)
    m.open()
    m.insert(intron, match_transition.input, match_transition.output)
    m.close()
    return m


def cdna2genome_create(intron_args=None) -> Model:
    m = Model("cdna2genome")
    c2g = coding2genome_create(intron_args)
    utr = _utr_create(intron_args)
    m.insert(c2g, None, None)
    codon_matches = [t for t in m.select_transitions(Label.MATCH)
                     if t.advance_query == 3 and t.advance_target == 3]
    assert len(codon_matches) == 1
    codon_match = codon_matches[0]
    assert codon_match.input is codon_match.output
    m.insert(utr, None, codon_match.input)
    m.insert(utr, codon_match.input, None)
    m.close()
    return m
