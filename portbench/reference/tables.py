"""Scoring tables of exonerate's est2genome and protein2genome models.

Plain data, written out here so that the reference shares nothing with
the program under test:

- gap and intron penalties: exonerate v2.4.0's defaults (exonerate.1:
  --gapopen -12, --gapextend -4, --codongapopen -18, --codongapextend -8,
  --intronpenalty -30, --frameshift -28, --minintron 30, --maxintron);
- the DNA score (exonerate's "nucleic" matrix on A, C, G, T: +5 / -4);
- BLOSUM62 (Henikoff & Henikoff 1992), the default protein matrix;
- the standard genetic code (NCBI table 1);
- the primate splice-site frequencies of Senapathy, Shapiro & Harris,
  Methods in Enzymology 183:252-278, the source exonerate's splice
  predictor cites, and that predictor's log-odds (x1.5, rounded half
  away from zero; float32 accumulation as exonerate's gfloat).
"""
from __future__ import annotations

import numpy as np

GAP_OPEN, GAP_EXTEND = -12, -4
CODON_GAP_OPEN, CODON_GAP_EXTEND = -18, -8
INTRON_OPEN = -30
FRAMESHIFT = -28
MIN_INTRON = 30

DNA_MATCH, DNA_MISMATCH = 5, -4

AA_ORDER = "ARNDCQEGHILKMFPSTWYVBZX*"
BLOSUM62 = np.array([[int(x) for x in row.split()] for row in """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
""".strip().splitlines()], dtype=np.int64)
AA_INDEX = {a: i for i, a in enumerate(AA_ORDER)}

# NCBI table 1, codons in TCAG order of each base
_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_TCAG = {"T": 0, "C": 1, "A": 2, "G": 3}
CODON_AA = {a + b + c: _CODE[16 * _TCAG[a] + 4 * _TCAG[b] + _TCAG[c]]
            for a in "TCAG" for b in "TCAG" for c in "TCAG"}
AA_CODONS: dict = {}
for _codon, _aa in CODON_AA.items():
    AA_CODONS.setdefault(_aa, []).append(_codon)
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def translate(codon: str) -> str:
    return CODON_AA.get(codon.upper(), "X")


def pair_score(aa: str, codon: str) -> int:
    return int(BLOSUM62[AA_INDEX.get(aa.upper(), 22),
                        AA_INDEX[translate(codon)]])


# splice-site frequencies (percent), rows are positions, columns A C G T
SS5_FREQ = [[28, 40, 17, 14], [59, 14, 13, 14], [8, 5, 81, 6], [0, 0, 100, 0],
            [0, 0, 0, 100], [54, 2, 42, 2], [74, 8, 11, 8], [5, 6, 85, 4],
            [16, 18, 21, 45]]
SS5_SPLICE_AFTER = 3
SS3_FREQ = [[10, 31, 14, 44], [8, 36, 14, 43], [6, 34, 12, 48],
            [6, 34, 8, 52], [9, 37, 9, 45], [9, 38, 10, 44], [8, 44, 9, 40],
            [9, 41, 8, 41], [6, 44, 6, 45], [6, 40, 6, 48],
            [23, 28, 26, 23], [2, 79, 1, 18], [100, 0, 0, 0],
            [0, 0, 100, 0], [28, 14, 47, 11]]
SS3_SPLICE_AFTER = 14


class SpliceSite:
    """The integer score of one splice-site kind at a position of a
    sequence: the first intron base for a 5' site (the G of GT), the
    first base of the final AG for a 3' site; on the reverse gene
    orientation the reverse complement of each (CT..AC)."""

    def __init__(self, site: str, forward: bool):
        freq = np.array(SS5_FREQ if site == "5" else SS3_FREQ, np.float64)
        after = SS5_SPLICE_AFTER if site == "5" else SS3_SPLICE_AFTER - 2
        if not forward:
            freq = freq[::-1]
            after = len(freq) - after - 2
        self.after = after
        step = ((1.0 + freq) / 26.0).astype(np.float32)
        self.logodds = (np.log(step.astype(np.float64)) * 1.5).astype(
            np.float32)
        self.column = {b: i for i, b in enumerate("ACGT" if forward
                                                  else "TGCA")}

    def score(self, seq: str, p: int) -> int:
        total = np.float32(0.0)
        for row in range(len(self.logodds)):
            k = p - self.after + row
            if 0 <= k < len(seq):
                col = self.column.get(seq[k].upper())
                if col is not None:
                    total = np.float32(total + self.logodds[row, col])
        f = float(total)
        return int(f - 0.5) if f < 0 else int(f + 0.5)


SPLICE = {(site, fwd): SpliceSite(site, fwd)
          for site in ("5", "3") for fwd in (True, False)}
