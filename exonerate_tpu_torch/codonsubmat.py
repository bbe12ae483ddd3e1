"""Codon substitution matrices.

TPU-native equivalent of the reference CodonSubmat
(ref: src/sequence/codonsubmat.{h,c}): a 125x125 codon-by-codon score
matrix (5 nucleotide classes A,C,G,T,N per position) built from an
amino-acid substitution matrix through the genetic code, with a
base-triple lookup.  The reference's live DP path scores codons by
translating through the protein submat (ref: match.c:508-530, the
CodonSubmat path is compiled out), which this module reproduces as the
construction rule; it exists for the codon wordhood and for API parity.
"""
from __future__ import annotations

import numpy as np

from .submat import Submat, SYMBOL_INDEX
from .translate import GeneticCode, NT4, default_code

CODON_DIM = 125  # 5^3

# nucleotide class per symbol: A=0 C=1 G=2 T=3 N/other=4
_BASE5 = np.full(256, 4, dtype=np.int32)
for _i, _c in enumerate("ACGT"):
    _BASE5[ord(_c)] = _i
    _BASE5[ord(_c.lower())] = _i

_BASE5_CHARS = "ACGTN"


class CodonSubmat:
    """(ref: CodonSubmat, codonsubmat.h:37-44)."""

    def __init__(self, protein_submat: Submat | None = None,
                 code: GeneticCode | None = None):
        psub = protein_submat or Submat.create("blosum62")
        code = code or default_code()
        aa = np.zeros(CODON_DIM, dtype=np.uint8)
        for a in range(5):
            for b in range(5):
                for c in range(5):
                    aa[a * 25 + b * 5 + c] = code.codon(
                        ord(_BASE5_CHARS[a]), ord(_BASE5_CHARS[b]),
                        ord(_BASE5_CHARS[c]))
        idx = SYMBOL_INDEX[aa]
        self.matrix = psub.matrix[idx[:, None], idx[None, :]].astype(
            np.int32)
        self.codon_aa = aa

    @staticmethod
    def codon_index(b1: int, b2: int, b3: int) -> int:
        """(ref: CodonSubmat_lookup_base macro)."""
        return (int(_BASE5[b1]) * 25 + int(_BASE5[b2]) * 5
                + int(_BASE5[b3]))

    def lookup_base(self, q1, q2, q3, t1, t2, t3) -> int:
        return int(self.matrix[self.codon_index(q1, q2, q3),
                               self.codon_index(t1, t2, t3)])

    def max_score(self) -> int:
        return int(self.matrix.max())
