"""Splice-site prediction (PSSM predictors).

TPU-native equivalent of the reference Splice module
(ref: src/sequence/splice.{h,c}). Four predictors (5'/3' x forward/reverse)
score every position of a sequence in one vectorized pass: the PSSM is applied
as a sum of shifted gathers, then rounded to int (x1.5 log-odds, ref:
src/sequence/splice.c:283-292). Scores feed the intron model as per-position
int32 arrays — the TPU replacement for the reference's lazy SparseCache pages.

PSSM data: Senapathy, Shapiro & Harris, Methods in Enzymology 183:252-278
(same public source as the reference, src/sequence/splice.c:53-117).
"""
from __future__ import annotations

import numpy as np

IMPOSSIBLY_LOW = -987654321

# rows: positions; cols: A C G T (frequencies, percent)
PRIMATE_5SS = np.array([
    [28, 40, 17, 14],
    [59, 14, 13, 14],
    [8, 5, 81, 6],
    [0, 0, 100, 0],    # G  <- splice site after row 3
    [0, 0, 0, 100],    # T
    [54, 2, 42, 2],
    [74, 8, 11, 8],
    [5, 6, 85, 4],
    [16, 18, 21, 45],
], dtype=np.float64)
PRIMATE_5SS_SPLICE_AFTER = 3

PRIMATE_3SS = np.array([
    [10, 31, 14, 44],
    [8, 36, 14, 43],
    [6, 34, 12, 48],
    [6, 34, 8, 52],
    [9, 37, 9, 45],
    [9, 38, 10, 44],
    [8, 44, 9, 40],
    [9, 41, 8, 41],
    [6, 44, 6, 45],
    [6, 40, 6, 48],
    [23, 28, 26, 23],
    [2, 79, 1, 18],
    [100, 0, 0, 0],    # A
    [0, 0, 100, 0],    # G  <- splice site after row 14 (pre-adjustment)
    [28, 14, 47, 11],
], dtype=np.float64)
PRIMATE_3SS_SPLICE_AFTER = 14


def _parse_pssm(path: str) -> tuple[np.ndarray, int]:
    """Parse a user splice-frequency file (ref: src/sequence/splice.c
    SplicePredictor_parse_data; format: doc/man/man1/exonerate.1:1222-1279)."""
    rows: list[list[float]] = []
    splice_after = 0
    with open(path) as fh:
        for line in fh:
            words = line.split()
            if not words or words[0].startswith("#"):
                continue
            if len(words) == 1:
                if words[0].lower() == "splice":
                    splice_after = len(rows)
                else:
                    raise ValueError(f"bad line in splice data file: {line!r}")
            elif len(words) == 4:
                rows.append([float(w) for w in words])
            else:
                raise ValueError(f"bad line in splice data file: {line!r}")
    return np.array(rows, dtype=np.float64), splice_after


class SplicePredictor:
    """One of ss5_forward / ss5_reverse / ss3_forward / ss3_reverse.

    ``predict_array(seq)`` returns the rounded int32 score for every position
    p, where p is the coordinate the intron model evaluates: for ss5_forward
    the first intron base (the G of "GT"), for ss3_forward the first base of
    the terminal "AG" (ref splice-after adjustment src/sequence/splice.c:208).
    """

    GTAG = {
        ("5", True): ("G", "T"),
        ("3", True): ("A", "G"),
        ("5", False): ("A", "C"),
        ("3", False): ("C", "T"),
    }

    def __init__(self, site: str, forward: bool,
                 data: np.ndarray | None = None,
                 splice_after: int | None = None,
                 force_gtag: bool = False):
        assert site in ("5", "3")
        self.site, self.forward, self.force_gtag = site, forward, force_gtag
        if data is None:
            if site == "5":
                data = PRIMATE_5SS.copy()
                splice_after = PRIMATE_5SS_SPLICE_AFTER
            else:
                data = PRIMATE_3SS.copy()
                splice_after = PRIMATE_3SS_SPLICE_AFTER
        else:
            data = np.asarray(data, dtype=np.float64).copy()
            assert splice_after is not None
        if site == "3":
            splice_after -= 2  # score at the first base of "AG"
        if not forward:
            data = data[::-1].copy()
            splice_after = len(data) - splice_after - 2
        self.model_length = len(data)
        self.splice_after = splice_after
        # base index: forward A,C,G,T ; reverse T,G,C,A (complement); else 4
        index = np.full(256, 4, dtype=np.int32)
        order = "ACGT" if forward else "TGCA"
        for i, ch in enumerate(order):
            index[ord(ch)] = i
            index[ord(ch.lower())] = i
        self.index = index
        # log-odds: log((1+freq)/26) * 1.5 ; column 4 (non-ACGT) scores 0.
        # The reference stores intermediates in float32 (gfloat) but divides,
        # logs and multiplies in double — replicate that rounding exactly.
        step1 = ((1.0 + data) / 26.0).astype(np.float32)
        model32 = np.zeros((self.model_length, 5), dtype=np.float32)
        model32[:, :4] = (np.log(step1.astype(np.float64)) * 1.5
                          ).astype(np.float32)
        self.model = model32
        self.max_score = float(self.model[:, :4].max(axis=1).sum())

    def predict_array_float(self, seq: np.ndarray) -> np.ndarray:
        """Float score at every position of a uint8 sequence (vectorized)."""
        seq = np.asarray(seq, dtype=np.uint8)
        n = len(seq)
        cols = self.index[seq]                         # [n] in 0..4
        scores = np.zeros(n, dtype=np.float32)
        # position p scores rows i at seq[p - splice_after + i]
        for i in range(self.model_length):
            off = i - self.splice_after
            contrib = self.model[i][cols]              # [n]
            lo = max(0, -off)
            hi = min(n, n - off)
            if lo < hi:
                scores[lo:hi] += contrib[lo + off:hi + off]
        if self.force_gtag:
            e1, e2 = self.GTAG[(self.site, self.forward)]
            b1 = np.zeros(n, dtype=bool)
            b2 = np.zeros(n, dtype=bool)
            up = np.frombuffer(seq.tobytes().upper(), dtype=np.uint8)
            b1[:n] = up == ord(e1)
            b2[:n - 1] = up[1:] == ord(e2)
            b2[n - 1] = False
            scores = np.where(b1 & b2, scores, np.float32(IMPOSSIBLY_LOW))
        return scores

    def predict_array(self, seq: np.ndarray) -> np.ndarray:
        """Rounded int32 scores (round half away from zero,
        ref: src/sequence/splice.c SplicePredictor_round)."""
        f = self.predict_array_float(seq).astype(np.float64)
        out = np.where(f < 0, f - 0.5, f + 0.5)
        return np.clip(out, -2**31, 2**31 - 1).astype(np.int32)


class SplicePredictorSet:
    """All four predictors (ref: src/sequence/splice.h SplicePredictorSet)."""

    def __init__(self, splice5_path: str | None = None,
                 splice3_path: str | None = None,
                 force_gtag: bool = False):
        d5 = a5 = d3 = a3 = None
        if splice5_path and splice5_path.lower() != "primate":
            d5, a5 = _parse_pssm(splice5_path)
        if splice3_path and splice3_path.lower() != "primate":
            d3, a3 = _parse_pssm(splice3_path)
        self.ss5_forward = SplicePredictor("5", True, d5, a5, force_gtag)
        self.ss5_reverse = SplicePredictor("5", False, d5, a5, force_gtag)
        self.ss3_forward = SplicePredictor("3", True, d3, a3, force_gtag)
        self.ss3_reverse = SplicePredictor("3", False, d3, a3, force_gtag)

    def get(self, site: str, forward: bool) -> SplicePredictor:
        return getattr(self, f"ss{site}_{'forward' if forward else 'reverse'}")

    def fingerprint(self) -> tuple:
        """Content identity for cross-run memo keys (a fresh set is
        built per CLI invocation; id() would defeat warm caches)."""
        return tuple(
            (p.splice_after, p.force_gtag, p.model.tobytes())
            for p in (self.ss5_forward, self.ss5_reverse,
                      self.ss3_forward, self.ss3_reverse))
