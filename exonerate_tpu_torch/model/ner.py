"""Non-equivalenced-region model (ref: src/model/ner.c:66-115)."""
from __future__ import annotations

from ..alphabet import AlphabetType
from .ir import Label, Model
from .affine import AffineModelType, affine_create
from .data import AlignData


def _ner_open_grid(region, data: AlignData):
    return data.ner.ner_open_penalty


def ner_create(query_type: AlphabetType, target_type: AlphabetType,
               ner_args=None) -> Model:
    from .data import NerArgs
    nas = ner_args or NerArgs()
    m = affine_create(AffineModelType.LOCAL, query_type, target_type, False)
    m.rename(f"NER:{m.name}")
    m.open()
    match_transition = m.select_single_transition(Label.MATCH)
    ner_state = m.add_state("ner")
    ner_open = m.add_calc("ner open", nas.ner_open_penalty,
                          grid_fn=_ner_open_grid)
    m.add_transition("match to ner", match_transition.input, ner_state,
                     1, 1, ner_open, Label.NER)
    m.add_transition("ner to match", ner_state, match_transition.input,
                     0, 0)
    m.add_transition("ner loop insert", ner_state, ner_state, 1, 0,
                     None, Label.NER)
    m.add_transition("ner loop delete", ner_state, ner_state, 0, 1,
                     None, Label.NER)
    m.add_span("ner span", ner_state, nas.min_ner, nas.max_ner,
               nas.min_ner, nas.max_ner)
    m.close()
    return m
