"""Protein <-> genome model (ref: src/model/protein2genome.c:45-68)."""
from __future__ import annotations

from .ir import Label, Model
from .affine import AffineModelType
from .match import Match, MatchType
from .protein2dna import protein2dna_create
from .phase import phase_create


def protein2genome_create(atype: AffineModelType = AffineModelType.LOCAL,
                          intron_args=None) -> Model:
    m = protein2dna_create(atype)
    m.rename(f"protein2genome:{atype.value}")
    m.open()
    match_transition = m.select_single_transition(Label.MATCH)
    match = match_transition.label_data or Match.find(MatchType.PROTEIN2DNA)
    phase = phase_create(None, match, False, True, intron_args)
    m.insert(phase, match_transition.input, match_transition.output)
    m.close()
    return m
