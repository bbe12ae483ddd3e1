"""Model-type registry (ref: src/model/modeltype.{h,c}).

Maps the 16 model-type names / abbreviations to constructors and carries the
predicates (is_gapped, translate_both, dual_match, has_genomic_target) the
analysis driver uses for strategy selection.
"""
from __future__ import annotations

import enum
from typing import Optional

from ..alphabet import AlphabetType
from .ir import Model
from .match import match_type_find
from .affine import AffineModelType, affine_create
from .ungapped import ungapped_create
from .est2genome import est2genome_create
from .ner import ner_create
from .protein2dna import protein2dna_create
from .protein2genome import protein2genome_create
from .coding2coding import coding2coding_create
from .coding2genome import coding2genome_create
from .cdna2genome import cdna2genome_create
from .genome2genome import genome2genome_create


class ModelType(enum.Enum):
    UNGAPPED = "ungapped"
    UNGAPPED_TRANS = "ungapped:trans"
    AFFINE_GLOBAL = "affine:global"
    AFFINE_BESTFIT = "affine:bestfit"
    AFFINE_LOCAL = "affine:local"
    AFFINE_OVERLAP = "affine:overlap"
    EST2GENOME = "est2genome"
    NER = "ner"
    PROTEIN2DNA = "protein2dna"
    PROTEIN2DNA_BESTFIT = "protein2dna:bestfit"
    PROTEIN2GENOME = "protein2genome"
    PROTEIN2GENOME_BESTFIT = "protein2genome:bestfit"
    CODING2CODING = "coding2coding"
    CODING2GENOME = "coding2genome"
    CDNA2GENOME = "cdna2genome"
    GENOME2GENOME = "genome2genome"


_SHORT_NAMES = {
    "u": ModelType.UNGAPPED, "u:t": ModelType.UNGAPPED_TRANS,
    "a:g": ModelType.AFFINE_GLOBAL, "a:b": ModelType.AFFINE_BESTFIT,
    "a:l": ModelType.AFFINE_LOCAL, "a:o": ModelType.AFFINE_OVERLAP,
    "e2g": ModelType.EST2GENOME, "ner": ModelType.NER,
    "p2d": ModelType.PROTEIN2DNA, "p2d:b": ModelType.PROTEIN2DNA_BESTFIT,
    "p2g": ModelType.PROTEIN2GENOME,
    "p2g:b": ModelType.PROTEIN2GENOME_BESTFIT,
    "c2c": ModelType.CODING2CODING, "c2g": ModelType.CODING2GENOME,
    "cd2g": ModelType.CDNA2GENOME, "g2g": ModelType.GENOME2GENOME,
}


def model_type_from_string(s: str) -> ModelType:
    low = s.lower()
    for mt in ModelType:
        if mt.value == low:
            return mt
    if low in _SHORT_NAMES:
        return _SHORT_NAMES[low]
    raise ValueError(f"Unknown model type [{s}]")


def is_gapped(t: ModelType) -> bool:
    return t not in (ModelType.UNGAPPED, ModelType.UNGAPPED_TRANS)


def translate_both(t: ModelType) -> bool:
    return t in (ModelType.UNGAPPED_TRANS, ModelType.CODING2CODING,
                 ModelType.CODING2GENOME, ModelType.CDNA2GENOME,
                 ModelType.GENOME2GENOME)


def has_dual_match(t: ModelType) -> bool:
    return t in (ModelType.CDNA2GENOME, ModelType.GENOME2GENOME)


def has_genomic_target(t: ModelType) -> bool:
    return t in (ModelType.EST2GENOME, ModelType.PROTEIN2GENOME,
                 ModelType.PROTEIN2GENOME_BESTFIT, ModelType.CODING2GENOME,
                 ModelType.CDNA2GENOME, ModelType.GENOME2GENOME)


_DNA_ONLY = (ModelType.UNGAPPED_TRANS, ModelType.EST2GENOME,
             ModelType.CODING2CODING, ModelType.CODING2GENOME,
             ModelType.CDNA2GENOME, ModelType.GENOME2GENOME)


def check_input(t: ModelType, query_type: AlphabetType,
                target_type: AlphabetType):
    """(ref: Model_Type_check_input, modeltype.c:166-224)."""
    if t in _DNA_ONLY:
        if query_type != AlphabetType.DNA:
            raise ValueError(f"Expected DNA query for model [{t.value}]")
        if target_type != AlphabetType.DNA:
            raise ValueError(f"Expected DNA target for model [{t.value}]")
    elif t in (ModelType.AFFINE_GLOBAL, ModelType.AFFINE_BESTFIT,
               ModelType.AFFINE_LOCAL, ModelType.AFFINE_OVERLAP,
               ModelType.NER):
        if query_type != target_type:
            raise ValueError(
                f"Expected similar sequence types for model [{t.value}]")
    elif t in (ModelType.PROTEIN2DNA, ModelType.PROTEIN2DNA_BESTFIT,
               ModelType.PROTEIN2GENOME, ModelType.PROTEIN2GENOME_BESTFIT):
        if query_type != AlphabetType.PROTEIN:
            raise ValueError(f"Expected protein query for model [{t.value}]")
        if target_type != AlphabetType.DNA:
            raise ValueError(f"Expected DNA target for model [{t.value}]")


def get_model(t: ModelType, query_type: AlphabetType,
              target_type: AlphabetType, intron_args=None) -> Model:
    """(ref: Model_Type_get_model, modeltype.c:225-293)."""
    check_input(t, query_type, target_type)
    if t == ModelType.UNGAPPED:
        return ungapped_create(match_type_find(query_type, target_type,
                                               False))
    if t == ModelType.UNGAPPED_TRANS:
        return ungapped_create(match_type_find(query_type, target_type,
                                               True))
    if t == ModelType.AFFINE_GLOBAL:
        return affine_create(AffineModelType.GLOBAL, query_type, target_type)
    if t == ModelType.AFFINE_BESTFIT:
        return affine_create(AffineModelType.BESTFIT, query_type,
                             target_type)
    if t == ModelType.AFFINE_LOCAL:
        return affine_create(AffineModelType.LOCAL, query_type, target_type)
    if t == ModelType.AFFINE_OVERLAP:
        return affine_create(AffineModelType.OVERLAP, query_type,
                             target_type)
    if t == ModelType.EST2GENOME:
        return est2genome_create(intron_args)
    if t == ModelType.NER:
        return ner_create(query_type, target_type)
    if t == ModelType.PROTEIN2DNA:
        return protein2dna_create(AffineModelType.LOCAL)
    if t == ModelType.PROTEIN2DNA_BESTFIT:
        return protein2dna_create(AffineModelType.BESTFIT)
    if t == ModelType.PROTEIN2GENOME:
        return protein2genome_create(AffineModelType.LOCAL, intron_args)
    if t == ModelType.PROTEIN2GENOME_BESTFIT:
        return protein2genome_create(AffineModelType.BESTFIT, intron_args)
    if t == ModelType.CODING2CODING:
        return coding2coding_create()
    if t == ModelType.CODING2GENOME:
        return coding2genome_create(intron_args)
    if t == ModelType.CDNA2GENOME:
        return cdna2genome_create(intron_args)
    if t == ModelType.GENOME2GENOME:
        return genome2genome_create(intron_args)
    raise ValueError(f"Unknown model type {t}")
