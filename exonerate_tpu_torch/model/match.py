"""Symbol-comparison machinery (Match types).

TPU-native equivalent of the reference Match module
(ref: src/comparison/match.{h,c}).  A Match knows its per-side advances and
produces the *whole score grid* for a region in one vectorized gather
(submat double-gather, with on-the-fly codon translation for translated
types), replacing the reference's per-position score_func vtable.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..alphabet import AlphabetType
from ..submat import Submat, SYMBOL_INDEX
from ..translate import GeneticCode, NT4, default_code
from ..seqio import Sequence
from ..engine.region import Region

MATCH_IMPOSSIBLY_LOW_SCORE = -987654321


class MatchType(enum.Enum):
    DNA2DNA = "dna2dna"
    PROTEIN2PROTEIN = "protein2protein"
    DNA2PROTEIN = "dna2protein"
    PROTEIN2DNA = "protein2dna"
    CODON2CODON = "codon2codon"


_ADVANCE = {
    MatchType.DNA2DNA: (1, 1),
    MatchType.PROTEIN2PROTEIN: (1, 1),
    MatchType.DNA2PROTEIN: (3, 1),
    MatchType.PROTEIN2DNA: (1, 3),
    MatchType.CODON2CODON: (3, 3),
}

# query/target-mirrored type (ref: Match_swap wiring, match.c mirror pairs)
_MIRROR = {
    MatchType.DNA2DNA: MatchType.DNA2DNA,
    MatchType.PROTEIN2PROTEIN: MatchType.PROTEIN2PROTEIN,
    MatchType.DNA2PROTEIN: MatchType.PROTEIN2DNA,
    MatchType.PROTEIN2DNA: MatchType.DNA2PROTEIN,
    MatchType.CODON2CODON: MatchType.CODON2CODON,
}


def match_type_find(query_type: AlphabetType, target_type: AlphabetType,
                    translate_both: bool) -> MatchType:
    """(ref: Match_Type_find, src/comparison/match.c)."""
    if query_type == AlphabetType.DNA:
        if target_type == AlphabetType.DNA:
            return (MatchType.CODON2CODON if translate_both
                    else MatchType.DNA2DNA)
        return MatchType.DNA2PROTEIN
    if target_type == AlphabetType.DNA:
        return MatchType.PROTEIN2DNA
    return MatchType.PROTEIN2PROTEIN


def match_type_name(mt: MatchType) -> str:
    """(ref: Match_Type_get_name, match.c:102-122 — CODON2CODON is
    named plain "codon", which reaches the GFF source field through the
    ungapped model name)."""
    return {"dna2dna": "dna2dna", "protein2protein": "protein2protein",
            "dna2protein": "dna2protein", "protein2dna": "protein2dna",
            "codon2codon": "codon"}[mt.value]


@dataclass
class MatchArgs:
    """Match scoring options (ref: Match_ArgumentSet, match.c:42-53)."""
    dna_submat: Submat = field(default_factory=lambda: Submat.create("nucleic"))
    protein_submat: Submat = field(
        default_factory=lambda: Submat.create("blosum62"))
    translate: GeneticCode = field(default_factory=default_code)
    softmask_query: bool = False
    softmask_target: bool = False


def _translated_indices(seq: Sequence, code: GeneticCode) -> np.ndarray:
    """Per-position submat row index of the codon starting at each position
    (positions len-2..len-1 padded with the catch-all index)."""
    d = seq.data.astype(np.int32)
    n = len(d)
    out = np.full(n, 24, dtype=np.int32)
    if n >= 3:
        packed = (NT4[d[:-2]] | (NT4[d[1:-1]] << 4) | (NT4[d[2:]] << 8))
        aa = code.trans[packed]
        out[:n - 2] = SYMBOL_INDEX[aa]
    return out


class Match:
    """One match class; singleton per type (ref: match.h:88-124)."""

    _cache: dict[MatchType, "Match"] = {}

    def __init__(self, mtype: MatchType, mas: Optional[MatchArgs] = None):
        self.type = mtype
        self.mas = mas or MatchArgs()
        self.advance_query, self.advance_target = _ADVANCE[mtype]
        self._mas = mas
        self._row_cache: dict = {}

    @classmethod
    def find(cls, mtype: MatchType, mas: Optional[MatchArgs] = None) -> "Match":
        if mas is not None:
            return cls(mtype, mas)
        if mtype not in cls._cache:
            cls._cache[mtype] = cls(mtype)
        return cls._cache[mtype]

    @property
    def submat(self) -> Submat:
        if self.type == MatchType.DNA2DNA:
            return self.mas.dna_submat
        return self.mas.protein_submat

    def max_score(self) -> int:
        return self.submat.max_score()

    # -- grid scoring ------------------------------------------------------

    # module-wide: Match instances are per-AlignData, but the row
    # indices depend only on (sequence content, advance, genetic code)
    # — a genome scan re-derives the same 1 Mb gather for every query's
    # comparison and locus re-run otherwise, and warm runs re-derive it
    # per invocation under id() keys
    _ROW_MEMO: dict = {}
    _ROW_CAP = 64

    def _row_indices(self, seq: Sequence, advance: int) -> np.ndarray:
        from ..seqio import seq_ckey
        if advance == 3:
            code = self.mas.translate
            ck = getattr(code, "_memo_key", None)
            if ck is None:
                ck = hash(code.trans.tobytes())
                try:
                    code._memo_key = ck
                except Exception:
                    pass
        else:
            ck = 0
        key = (seq_ckey(seq), advance, ck)
        hit = Match._ROW_MEMO.get(key)
        if hit is not None:
            return hit
        if advance == 3:
            out = _translated_indices(seq, self.mas.translate)
        else:
            out = SYMBOL_INDEX[seq.data]
        if len(Match._ROW_MEMO) > Match._ROW_CAP:
            Match._ROW_MEMO.clear()
        Match._ROW_MEMO[key] = out
        return out

    def swap(self) -> "Match":
        """Mirror of this match with query/target roles exchanged
        (ref: Match_swap, src/comparison/match.c)."""
        return Match(_MIRROR[self.type], self._mas)

    # padded target-index windows memoize too: every query of a scan
    # slices + pads the SAME 10 Mb row-index vector otherwise (a 40 MB
    # alloc+copy per comparison, ~25 s of a 64-query 10 Mb scan)
    _PAD_MEMO: dict = {}

    def _padded_window(self, seq: Sequence, advance: int, start: int,
                       n: int) -> np.ndarray:
        from ..seqio import seq_ckey
        rows = self._row_indices(seq, advance)
        key = (seq_ckey(seq), advance, id(rows), start, n)
        hit = Match._PAD_MEMO.get(key)
        if hit is not None:
            return hit[1]
        out = np.zeros(n + 1, dtype=np.int32)
        out[:n] = rows[start:start + n]
        out[n:] = 24
        out.setflags(write=False)
        if len(Match._PAD_MEMO) > 64:
            Match._PAD_MEMO.clear()
        Match._PAD_MEMO[key] = (rows, out)
        return out

    def score_factored(self, query: Sequence, target: Sequence,
                       region: Region) -> dict:
        """Factored form: grid[i,j] = table[q_idx[i], t_idx[j]] + q_add[i]
        (see Calc.factored_fn).  The CDS annotation veto becomes a q_add
        plane of IMPOSSIBLY_LOW offsets."""
        qlen, tlen = region.query_length, region.target_length
        qi = self._padded_window(query, self.advance_query,
                                 region.query_start, qlen)
        ti = self._padded_window(target, self.advance_target,
                                 region.target_start, tlen)
        # q_override REPLACES the table value where nonzero (the CDS
        # annotation veto, ref: match.c:276-281, 513-519)
        override = np.zeros(qlen + 1, dtype=np.int32)
        ann = query.annotation
        if ann is not None and query.alphabet.type == AlphabetType.DNA:
            qpos = region.query_start + np.arange(qlen + 1)
            if self.type == MatchType.DNA2DNA:
                bad = ((qpos >= ann.cds_start)
                       & (qpos < ann.cds_start + ann.cds_length))
            elif self.type == MatchType.CODON2CODON:
                bad = ((qpos < ann.cds_start)
                       | (qpos >= ann.cds_start + ann.cds_length)
                       | ((qpos % 3) != (ann.cds_start % 3)))
            else:
                bad = np.zeros(qlen + 1, dtype=bool)
            override = np.where(bad, MATCH_IMPOSSIBLY_LOW_SCORE,
                                0).astype(np.int32)
        return {"q_idx": qi, "t_idx": ti,
                "table": self.submat.matrix.astype(np.int32),
                "q_override": override}

    def score_grid(self, query: Sequence, target: Sequence,
                   region: Region) -> np.ndarray:
        """Full [Q+1, T+1] int32 grid; entry [i, j] scores the match whose
        source cell is region-local (i, j).  The final row/col are padding
        (never read for valid transitions)."""
        qlen, tlen = region.query_length, region.target_length
        qi = self._row_indices(query, self.advance_query)[
            region.query_start:region.query_start + qlen]
        ti = self._row_indices(target, self.advance_target)[
            region.target_start:region.target_start + tlen]
        mat = self.submat.matrix
        grid = np.full((qlen + 1, tlen + 1), 0, dtype=np.int32)
        grid[:qlen, :tlen] = mat[qi[:, None], ti[None, :]]
        # CDS annotation veto (ref: match.c:276-281, 513-519): DNA2DNA match
        # is impossible inside an annotated CDS; codon match impossible
        # outside it or out of frame.
        ann = query.annotation
        if ann is not None and query.alphabet.type == AlphabetType.DNA:
            qpos = region.query_start + np.arange(qlen)
            if self.type == MatchType.DNA2DNA:
                bad = ((qpos >= ann.cds_start)
                       & (qpos < ann.cds_start + ann.cds_length))
                grid[:qlen, :][bad] = MATCH_IMPOSSIBLY_LOW_SCORE
            elif self.type == MatchType.CODON2CODON:
                bad = ((qpos < ann.cds_start)
                       | (qpos >= ann.cds_start + ann.cds_length)
                       | ((qpos % 3) != (ann.cds_start % 3)))
                grid[:qlen, :][bad] = MATCH_IMPOSSIBLY_LOW_SCORE
        return grid

    def score(self, query: Sequence, target: Sequence,
              qpos: int, tpos: int) -> int:
        """Single-position score (ref score_func; used by HSP extension)."""
        r = Region(qpos, tpos, 1, 1)
        return int(self.score_grid(query, target, r)[0, 0])

    def split_score(self, query: Sequence, target: Sequence,
                    qps, tps) -> int:
        """Split-codon score across an intron (ref: match.c:332-364,
        508-530): translate the possibly non-contiguous codon positions."""
        code = self.mas.translate
        if self.advance_query == 3:
            qsym = code.codon(query.symbol(qps[0]), query.symbol(qps[1]),
                              query.symbol(qps[2]))
        else:
            qsym = query.symbol(qps[0])
        if self.advance_target == 3:
            tsym = code.codon(target.symbol(tps[0]), target.symbol(tps[1]),
                              target.symbol(tps[2]))
        else:
            tsym = target.symbol(tps[0])
        return self.mas.protein_submat.lookup(qsym, tsym)

    def self_score(self, seq: Sequence) -> int:
        """Score of a sequence against itself (for --percent thresholds,
        ref: match.c self_score paths)."""
        idx = self._row_indices(seq, self.advance_query)
        adv = self.advance_query
        n = (len(seq) // adv) * adv
        take = idx[:max(n - (adv - 1), 0):adv] if adv > 1 else idx
        mat = self.submat.matrix
        return int(mat[take, take].sum())
