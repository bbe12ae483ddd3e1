"""EST <-> genome model (ref: src/model/est2genome.c:58-93).

affine:local over DNA made stereo (forward/reverse copies) with a target
intron submodel inserted at each side's match state.
"""
from __future__ import annotations

from ..alphabet import AlphabetType
from .ir import Label, Model
from .affine import AffineModelType, affine_create
from .intron import intron_create


def est2genome_create(intron_args=None) -> Model:
    m = affine_create(AffineModelType.LOCAL, AlphabetType.DNA,
                      AlphabetType.DNA, False)
    m.rename("est2genome")
    m.open()
    m.make_stereo("forward", "reverse")
    match_transitions = m.select_transitions(Label.MATCH)
    assert len(match_transitions) == 2
    match_forward, match_reverse = match_transitions
    intron_forward = intron_create("forward", False, True, True, intron_args)
    intron_reverse = intron_create("reverse", False, True, False, intron_args)
    m.insert(intron_forward, match_forward.input, match_forward.input)
    m.insert(intron_reverse, match_reverse.input, match_reverse.input)
    m.close()
    return m
