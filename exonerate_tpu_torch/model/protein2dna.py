"""Protein <-> DNA model (ref: src/model/protein2dna.c)."""
from __future__ import annotations

from ..alphabet import AlphabetType
from .ir import Label, Model
from .affine import AffineModelType, affine_create
from .frameshift import frameshift_add


def protein2dna_create(atype: AffineModelType = AffineModelType.LOCAL
                       ) -> Model:
    m = affine_create(atype, AlphabetType.PROTEIN, AlphabetType.DNA, False)
    m.rename(f"protein2dna:{atype.value}")
    m.open()
    match_transition = m.select_single_transition(Label.MATCH)
    frameshift_add(m, match_transition.input, "p2d", False)
    m.close()
    return m
