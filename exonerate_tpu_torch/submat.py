"""Substitution matrices.

TPU-native equivalent of the reference Submat module
(ref: src/sequence/submat.{h,c}). A Submat is a 25x25 int32 matrix (24 real
rows in A R N D C Q E G H I L K M F P S T W Y V B Z X * order plus one
catch-all row for unknown symbols) plus a 256-entry symbol->row index, so a
whole score grid materializes as one vectorized double-gather:
``matrix[index[q][:, None], index[t][None, :]]``.

Built-ins: blosum62, pam250, nucleic, edit, identity, iupac-identity, and a
BLAST-format file parser (same sources as ref: src/sequence/submat.c).
"""
from __future__ import annotations

import numpy as np

SUBMAT_ORDER = "ARNDCQEGHILKMFPSTWYVBZX*"
SUBMAT_SIZE = 24

# symbol -> row index; unknown -> 24 (catch-all zero row);
# selenocysteine U scores as C (ref: src/sequence/submat.c:26-55, ChangeLog 2.4.1)
_INDEX_MAP = {
    "A": 0, "R": 1, "N": 2, "D": 3, "C": 4, "Q": 5, "E": 6, "G": 7,
    "H": 8, "I": 9, "L": 10, "K": 11, "M": 12, "F": 13, "P": 14, "S": 15,
    "T": 16, "W": 17, "Y": 18, "V": 19, "B": 20, "Z": 21, "X": 22, "*": 23,
    "U": 4,
}

SYMBOL_INDEX = np.full(256, 24, dtype=np.int32)
for _ch, _ix in _INDEX_MAP.items():
    SYMBOL_INDEX[ord(_ch)] = _ix
    SYMBOL_INDEX[ord(_ch.lower())] = _ix


def _mat(rows: str) -> np.ndarray:
    data = np.array([[int(x) for x in line.split()] for line in
                     rows.strip().splitlines()], dtype=np.int32)
    assert data.shape == (SUBMAT_SIZE, SUBMAT_SIZE), data.shape
    out = np.zeros((SUBMAT_SIZE + 1, SUBMAT_SIZE + 1), dtype=np.int32)
    out[:SUBMAT_SIZE, :SUBMAT_SIZE] = data
    return out


# ref data: src/sequence/submat.c local_submat_blosum62 (standard BLOSUM62)
BLOSUM62 = _mat("""
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
""")

# ref data: src/sequence/submat.c local_submat_pam250 (standard PAM250)
PAM250 = _mat("""
 2 -2  0  0 -2  0  0  1 -1 -1 -2 -1 -1 -3  1  1  1 -6 -3  0  0  0  0 -8
-2  6  0 -1 -4  1 -1 -3  2 -2 -3  3  0 -4  0  0 -1  2 -4 -2 -1  0 -1 -8
 0  0  2  2 -4  1  1  0  2 -2 -3  1 -2 -3  0  1  0 -4 -2 -2  2  1  0 -8
 0 -1  2  4 -5  2  3  1  1 -2 -4  0 -3 -6 -1  0  0 -7 -4 -2  3  3 -1 -8
-2 -4 -4 -5 12 -5 -5 -3 -3 -2 -6 -5 -5 -4 -3  0 -2 -8  0 -2 -4 -5 -3 -8
 0  1  1  2 -5  4  2 -1  3 -2 -2  1 -1 -5  0 -1 -1 -5 -4 -2  1  3 -1 -8
 0 -1  1  3 -5  2  4  0  1 -2 -3  0 -2 -5 -1  0  0 -7 -4 -2  3  3 -1 -8
 1 -3  0  1 -3 -1  0  5 -2 -3 -4 -2 -3 -5  0  1  0 -7 -5 -1  0  0 -1 -8
-1  2  2  1 -3  3  1 -2  6 -2 -2  0 -2 -2  0 -1 -1 -3  0 -2  1  2 -1 -8
-1 -2 -2 -2 -2 -2 -2 -3 -2  5  2 -2  2  1 -2 -1  0 -5 -1  4 -2 -2 -1 -8
-2 -3 -3 -4 -6 -2 -3 -4 -2  2  6 -3  4  2 -3 -3 -2 -2 -1  2 -3 -3 -1 -8
-1  3  1  0 -5  1  0 -2  0 -2 -3  5  0 -5 -1  0  0 -3 -4 -2  1  0 -1 -8
-1  0 -2 -3 -5 -1 -2 -3 -2  2  4  0  6  0 -2 -2 -1 -4 -2  2 -2 -2 -1 -8
-3 -4 -3 -6 -4 -5 -5 -5 -2  1  2 -5  0  9 -5 -3 -3  0  7 -1 -4 -5 -2 -8
 1  0  0 -1 -3  0 -1  0  0 -2 -3 -1 -2 -5  6  1  0 -6 -5 -1 -1  0 -1 -8
 1  0  1  0  0 -1  0  1 -1 -1 -3  0 -2 -3  1  2  1 -2 -3 -1  0  0  0 -8
 1 -1  0  0 -2 -1  0  0 -1  0 -2  0 -1 -3  0  1  3 -5 -3  0  0 -1  0 -8
-6  2 -4 -7 -8 -5 -7 -7 -3 -5 -2 -3 -4  0 -6 -2 -5 17  0 -6 -5 -6 -4 -8
-3 -4 -2 -4  0 -4 -4 -5  0 -1 -1 -4 -2  7 -5 -3 -3  0 10 -2 -3 -4 -2 -8
 0 -2 -2 -2 -2 -2 -2 -1 -2  4  2 -2  2 -1 -1 -1  0 -6 -2  4 -2 -2 -1 -8
 0 -1  2  3 -4  1  3  0  1 -2 -3  1 -2 -4 -1  0  0 -5 -3 -2  3  2 -1 -8
 0  0  1  3 -5  3  3  0  2 -2 -3  0 -2 -5  0  0 -1 -6 -4 -2  2  3 -1 -8
 0 -1  0 -1 -3 -1 -1 -1 -1 -1 -1 -1 -1 -2 -1  0  0 -4 -2 -1 -1 -1 -1 -8
-8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8  1
""")

# ref data: src/sequence/submat.c local_submat_nucleic
# (exonerate's default DNA matrix: +5 match / -4 mismatch with IUPAC averaging)
NUCLEIC = _mat("""
 5  1 -2 -1 -4  0  0 -4 -1  0  0 -4  1  0  0 -4 -4  1 -4 -1 -4  0 -2  0
 1 -1 -1 -1 -4  0  0  1 -3  0  0 -2 -2  0  0 -2 -4 -2 -4 -1 -3  0 -1  0
-2 -1 -1 -1 -2  0  0 -2 -1  0  0 -1 -1  0  0 -1 -2 -1 -1 -1 -1  0 -1  0
-1 -1 -1 -1 -4  0  0 -1 -2  0  0 -1 -3  0  0 -3 -1 -1 -3 -2 -2  0 -1  0
-4 -4 -2 -4  5  0  0 -4 -1  0  0 -4  1  0  0  1 -4 -4  1 -1 -1  0 -2  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
-4  1 -2 -1 -4  0  0  5 -4  0  0  1 -4  0  0  1 -4 -4 -4 -1 -1  0 -2  0
-1 -3 -1 -2 -1  0  0 -4 -1  0  0 -3 -1  0  0 -3 -1 -1 -1 -2 -2  0 -1  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
-4 -2 -1 -1 -4  0  0  1 -3  0  0 -1 -4  0  0 -2  1 -2 -2 -3 -1  0 -1  0
 1 -2 -1 -3  1  0  0 -4 -1  0  0 -4 -1  0  0 -2 -4 -2 -2 -1 -3  0 -1  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
-4 -2 -1 -3  1  0  0  1 -3  0  0 -2 -2  0  0 -1 -4 -4 -2 -1 -1  0 -1  0
-4 -4 -2 -1 -4  0  0 -4 -1  0  0  1 -4  0  0 -4  5  1  1 -4 -1  0 -2  0
 1 -2 -1 -1 -4  0  0 -4 -1  0  0 -2 -2  0  0 -4  1 -1 -2 -3 -3  0 -1  0
-4 -4 -1 -3  1  0  0 -4 -1  0  0 -2 -2  0  0 -2  1 -2 -1 -3 -1  0 -1  0
-1 -1 -1 -2 -1  0  0 -1 -2  0  0 -3 -1  0  0 -1 -4 -3 -3 -1 -2  0 -1  0
-4 -3 -1 -2 -1  0  0 -1 -2  0  0 -1 -3  0  0 -1 -1 -3 -1 -2 -1  0 -1  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
-2 -1 -1 -1 -2  0  0 -2 -1  0  0 -1 -1  0  0 -1 -2 -1 -1 -1 -1  0 -1  0
 0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0  0
""")


def _edit() -> np.ndarray:
    out = np.zeros((SUBMAT_SIZE + 1, SUBMAT_SIZE + 1), dtype=np.int32)
    out[:SUBMAT_SIZE, :SUBMAT_SIZE] = -1
    np.fill_diagonal(out[:SUBMAT_SIZE, :SUBMAT_SIZE], 0)
    return out


def _identity() -> np.ndarray:
    out = np.zeros((SUBMAT_SIZE + 1, SUBMAT_SIZE + 1), dtype=np.int32)
    np.fill_diagonal(out[:SUBMAT_SIZE, :SUBMAT_SIZE], 1)
    return out


EDIT = _edit()
IDENTITY = _identity()

# ref data: src/sequence/submat.c local_submat_iupac_identity
IUPAC_IDENTITY = _mat("""
 1 1 1 1 0 0 0 0 1 0 0 0 1 0 0 0 0 1 0 1 0 0 0 0
 1 1 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
 1 0 1 0 1 0 0 1 0 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0
 1 0 0 1 0 0 0 1 0 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0
 0 0 1 0 1 0 0 0 1 0 0 0 1 0 0 1 0 0 1 1 1 0 0 0
 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
 0 1 1 1 0 0 0 1 0 0 0 1 0 0 0 1 0 0 0 1 1 0 0 0
 1 0 0 0 1 0 0 0 1 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0
 0 0 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0
 0 0 0 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0 0 0
 0 0 0 0 0 0 0 1 0 0 0 1 0 0 0 0 1 0 0 0 0 0 0 0
 1 0 0 0 1 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0
 0 0 0 0 0 0 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0
 0 0 0 0 0 0 0 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0 0
 0 0 0 0 1 0 0 1 0 0 0 0 0 0 0 1 0 0 0 0 0 0 0 0
 0 0 1 1 0 0 0 0 1 0 0 1 0 0 0 0 1 1 1 0 1 0 0 0
 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 1 1 0 0 0 0 0 0
 0 0 0 0 1 0 0 0 0 0 0 0 0 0 0 0 1 0 1 0 0 0 0 0
 1 0 0 0 1 0 0 1 0 0 0 0 0 0 0 0 0 0 0 1 0 0 0 0
 0 0 0 0 1 0 0 1 0 0 0 0 0 0 0 0 1 0 0 0 1 0 0 0
 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 1 0 0
 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 1 0
 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 1
""")

_BUILTINS = {
    "blosum62": BLOSUM62,
    "pam250": PAM250,
    "nucleic": NUCLEIC,
    "edit": EDIT,
    "identity": IDENTITY,
    "iupac-identity": IUPAC_IDENTITY,
}


class Submat:
    """Substitution matrix + lookup (ref: src/sequence/submat.h:36-57)."""

    def __init__(self, matrix: np.ndarray, name: str = "custom"):
        self.matrix = np.asarray(matrix, dtype=np.int32)
        self.name = name

    @classmethod
    def create(cls, path_or_name: str | None) -> "Submat":
        name = path_or_name or "nucleic"
        builtin = _BUILTINS.get(name)
        if builtin is not None:
            return cls(builtin, name)
        return cls(parse_blast_matrix(name), name)

    def lookup(self, a: int, b: int) -> int:
        return int(self.matrix[SYMBOL_INDEX[a], SYMBOL_INDEX[b]])

    def grid(self, query: np.ndarray, target: np.ndarray) -> np.ndarray:
        """Full [len(q), len(t)] int32 score grid via double gather."""
        qi = SYMBOL_INDEX[np.asarray(query, dtype=np.uint8)]
        ti = SYMBOL_INDEX[np.asarray(target, dtype=np.uint8)]
        return self.matrix[qi[:, None], ti[None, :]]

    def rows(self, seq: np.ndarray) -> np.ndarray:
        """Per-symbol score rows [len(seq), 25] (for on-device gathers)."""
        return self.matrix[SYMBOL_INDEX[np.asarray(seq, dtype=np.uint8)]]

    def max_score(self) -> int:
        return int(self.matrix[:SUBMAT_SIZE, :SUBMAT_SIZE].max())


def parse_blast_matrix(path: str) -> np.ndarray:
    """Parse a BLAST-format substitution matrix file
    (ref: src/sequence/submat.c Submat_read_matrix)."""
    out = np.zeros((SUBMAT_SIZE + 1, SUBMAT_SIZE + 1), dtype=np.int32)
    col_syms: list[int] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line or line.lstrip().startswith("#"):
                continue
            parts = line.split()
            if not col_syms:
                # header row of symbols
                col_syms = [SYMBOL_INDEX[ord(p[0])] for p in parts]
                continue
            row_ix = SYMBOL_INDEX[ord(parts[0][0])]
            for ci, val in zip(col_syms, parts[1:]):
                out[row_ix, ci] = int(val)
    if not col_syms:
        raise ValueError(f"empty substitution matrix file: {path}")
    return out
