"""Per-alignment user data: sequences + scoring parameters.

The reference passes a per-model *_Data struct (all embedding Ungapped_Data,
ref: src/model/ungapped.h, affine.h, est2genome.h ...) through the DP as
`user_data`; calcs read sequences/matrices/splice caches from it.  Here one
AlignData carries everything any model needs; grid providers close over the
model parameters and read the pair from it at materialization time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from collections import OrderedDict

import numpy as np

from ..seqio import Sequence
from ..splice import SplicePredictorSet
from .match import Match, MatchArgs, MatchType, match_type_find


@dataclass
class AffineArgs:
    """(ref: Affine_ArgumentSet, src/model/affine.c:19-52)."""
    gap_open: int = -12
    gap_extend: int = -4
    codon_gap_open: int = -18
    codon_gap_extend: int = -8


@dataclass
class IntronArgs:
    """(ref: Intron_ArgumentSet, src/model/intron.c:19-44)."""
    min_intron: int = 30
    max_intron: int = 200000
    intron_open_penalty: int = -30
    sps: Optional[SplicePredictorSet] = None

    def predictor_set(self) -> SplicePredictorSet:
        if self.sps is None:
            self.sps = SplicePredictorSet()
        return self.sps


@dataclass
class FrameshiftArgs:
    """(ref: Frameshift_ArgumentSet, src/model/frameshift.c:24-25)."""
    frameshift_penalty: int = -28


@dataclass
class NerArgs:
    """(ref: NER_ArgumentSet, src/model/ner.c:25-32)."""
    ner_open_penalty: int = -20
    min_ner: int = 10
    max_ner: int = 50000


class SpliceCache:
    """Per-sequence cached splice-site int score arrays — the TPU-friendly
    replacement for the reference's SplicePrediction SparseCache pages
    (ref: src/sequence/splice.h:54-139)."""

    def __init__(self, seq: Sequence, sps: SplicePredictorSet):
        self.seq = seq
        self.sps = sps
        self._cache: dict[str, np.ndarray] = {}

    # global LRU over (sequence fingerprint, predictor, site): target
    # views are rebuilt per pair during scans, so per-object memoization
    # misses; this scores a streamed genome once per site, not once per
    # query (the reference equivalent is the per-sequence
    # SplicePrediction cache, splice.h:114-139)
    _memo: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
    _MEMO_CAP = 16

    def _fingerprint(self) -> tuple:
        from ..seqio import seq_ckey
        return seq_ckey(self.seq)

    def scores(self, site: str, forward: bool) -> np.ndarray:
        key = f"ss{site}_{'f' if forward else 'r'}"
        if key not in self._cache:
            # sps identity by CONTENT: each CLI invocation builds a new
            # predictor set, so id() would defeat warm-process caches
            memo_key = (self._fingerprint(), self.sps.fingerprint(), key)
            memo = SpliceCache._memo
            arr = memo.get(memo_key)
            if arr is None:
                sp = self.sps.get(site, forward)
                arr = sp.predict_array(self.seq.data)
                memo[memo_key] = arr
                while len(memo) > SpliceCache._MEMO_CAP:
                    memo.popitem(last=False)
            else:
                memo.move_to_end(memo_key)
            self._cache[key] = arr
        return self._cache[key]


class AlignData:
    """Everything the calcs of any model need for one (query, target) pair."""

    def __init__(self, query: Sequence, target: Sequence,
                 translate_both: bool = False,
                 mas: Optional[MatchArgs] = None,
                 affine: Optional[AffineArgs] = None,
                 intron: Optional[IntronArgs] = None,
                 frameshift: Optional[FrameshiftArgs] = None,
                 ner: Optional[NerArgs] = None):
        self.query = query
        self.target = target
        self.mas = mas or MatchArgs()
        self.affine = affine or AffineArgs()
        self.intron = intron or IntronArgs()
        self.frameshift = frameshift or FrameshiftArgs()
        self.ner = ner or NerArgs()
        self.match_type = match_type_find(query.alphabet.type,
                                          target.alphabet.type,
                                          translate_both)
        self._matches: dict[MatchType, Match] = {}
        self._splice: dict[str, SpliceCache] = {}

    def match(self, mtype: Optional[MatchType] = None) -> Match:
        mt = mtype or self.match_type
        if mt not in self._matches:
            self._matches[mt] = Match(mt, self.mas)
        return self._matches[mt]

    def splice_cache(self, on_query: bool) -> SpliceCache:
        key = "q" if on_query else "t"
        if key not in self._splice:
            seq = self.query if on_query else self.target
            self._splice[key] = SpliceCache(seq,
                                            self.intron.predictor_set())
        return self._splice[key]
