"""Coding DNA <-> coding DNA model (ref: src/model/coding2coding.c)."""
from __future__ import annotations

from ..alphabet import AlphabetType
from .ir import Label, Model
from .affine import AffineModelType, affine_create
from .frameshift import frameshift_add


def coding2coding_create() -> Model:
    m = affine_create(AffineModelType.LOCAL, AlphabetType.DNA,
                      AlphabetType.DNA, True)
    m.rename("coding2coding")
    m.open()
    match_transition = m.select_single_transition(Label.MATCH)
    frameshift_add(m, match_transition.input, "query", True)
    frameshift_add(m, match_transition.input, "target", False)
    m.close()
    return m
