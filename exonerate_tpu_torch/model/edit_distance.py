"""Edit-distance demo model (ref: src/model/edit_distance.c)."""
from __future__ import annotations

import numpy as np

from ..engine.region import Region
from .ir import Label, Model, Scope
from .data import AlignData


def _edit_match_grid(region: Region, data: AlignData):
    q = data.query.data[region.query_start:region.query_end]
    t = data.target.data[region.target_start:region.target_end]
    grid = np.zeros((region.query_length + 1, region.target_length + 1),
                    dtype=np.int32)
    grid[:len(q), :len(t)] = np.where(q[:, None] == t[None, :], 0, -1)
    return grid


def edit_distance_create() -> Model:
    m = Model("edit distance")
    main = m.add_state("main")
    indel = m.add_calc("indel", -1)
    match = m.add_calc("match", 0, grid_fn=_edit_match_grid)
    m.configure_start(Scope.CORNER)
    m.configure_end(Scope.CORNER)
    m.add_transition("start to main", None, main, 0, 0)
    m.add_transition("main to end", main, None, 0, 0)
    m.add_transition("match", main, main, 1, 1, match, Label.MATCH)
    m.add_transition("query insert", main, main, 1, 0, indel, Label.GAP)
    m.add_transition("target insert", main, main, 0, 1, indel, Label.GAP)
    m.add_portal("match portal", match, 1, 1)
    m.close()
    return m
