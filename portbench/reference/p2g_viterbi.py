"""The plain reference of protein2genome:local: a score-only Viterbi in
plain PyTorch, the optimum that an exhaustive (``-E yes``) run must print.

    best = p2g_viterbi.best(protein, genomic)        # {"+": End, "-": End}

It imports torch, NumPy and ``tables.py`` alone (the judge's scores:
BLOSUM62 on the standard code, codon gaps -18 / -8, frameshift -28,
intron open -30, the primate splice-site log-odds, ``MIN_INTRON`` 30), and
nothing of the program.

The automaton is exonerate's protein2genome:local (exonerate v2.4.0,
src/model/protein2genome.c over protein2dna.c, affine.c, frameshift.c,
phase.c and intron.c), on cells (i, j): i residues of the protein and j
bases of the target strand consumed.  States and their transitions:

- match M(i, j): START (0, anywhere: local), a codon match from
  M(i-1, j-3) + BLOSUM62(q[i-1], t[j-3:j]), insert and delete (silent),
  a frameshift F(i, j) (close 0) or F(i, j-3) (close 3, no score), a
  phase-0 intron N0(i, j-2) through its 3' site, and the split codons
  below; END anywhere, so the optimum is the best M of any cell;
- insert I(i, j) = max(M(i-1, j) - 18, I(i-1, j) - 8);
  delete D(i, j) = max(M(i, j-3) - 18, D(i, j-3) - 8);
- frameshift F(i, j) = max(M(i, j-1), M(i, j-2)) - 28;
- intron N0 (phase 0, between codons): entered from M(i, e) through the
  5' site at e, ``-30 + ss5(e)``, into N0(i, e+2), then one target base a
  step at no cost, left through the 3' site at s into M(i, s+2) for
  ``ss3(s)`` where its length ``s - e + 2`` lies in [30, max_intron];
- phase 1 (a codon split 1|2): M(i, j) -> pre(i, j+1) takes the codon's
  first base, the intron N1 runs as N0 does from pre's column e, and
  post(i, s+2) -> M(i+1, s+4) scores BLOSUM62(q[i], t[e-1] t[s+2]
  t[s+3]); phase 2 (2|1): pre takes two bases, the codon is
  t[e-2] t[e-1] t[s+2] and post advances (1, 1).

The shadow rule.  An intron state keeps one donor per cell: the column e
of the path that reached it with the best score.  The split codon's
first bases and the intron's length are read from that kept donor, at
the acceptor (src/model/phase.c:141-230, src/model/intron.c:138-160), so
a path through another donor of the same cell is not scored, however the
acceptor would have scored it.  The tie order: exonerate's Viterbi keeps
the first of equal candidates in the model's transition order (strict
``>``), and the composed model lists each intron's loop before its 5'
entry (the order the intron submodel's close leaves, src/model/intron.c:
695, noted in the port's model/intron.py), so on a tie the intron is
extended and the earlier donor kept: N(i, j) keeps the smallest e of the
best entries ``A(i, e) = pre(i, e) - 30 + ss5(e)`` with e <= j - 2.

How it runs: row by row over the protein's residues, vectorised over the
target's columns and over the strands (a (strands, columns) int64 plane
a state, so memory grows with the target alone and no blocking is needed
below chromosome scale).  The vertical moves come from the row before.
The horizontal chains of a row (the delete's stride-3 chain, the
frameshifts, the phase-0 introns) are resolved by passes until the row's
match scores stop changing; in each pass the delete chain is a
``cummax`` over each column class mod 3, and each intron a ``cummax``
over its entries keyed (score, -e), which keeps the first donor on a tie.
A shift along the columns is a view of a plane padded with NEG on the
left, so a pass is a couple of dozen tensor operations.

Departures from the published model, each on the side of the judge's
tables: a splice site whose window runs off the sequence is scored over
the bases present (``tables.SpliceSite``); a codon holding a base other
than A, C, G or T is X; no soft-masking; the score only, no traceback.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import tables as tb

NEG = -(1 << 36)           # unreached; a real score lies within +-2**24
_SHIFT = 24                # the donor's column in an intron's cummax key
_LOW = (1 << _SHIFT) - 1
_PAD = 4                   # the largest column shift a state is read at
_X = 125                   # the codon code that scores NEG (none there)
_NT = {b: k for k, b in enumerate("ACGT")}


@dataclass
class End:
    score: int             # the optimum; NEG where no cell scored
    query_end: int         # its end cell (score desc, j asc, i asc)
    target_end: int


def _codes(seq: str) -> np.ndarray:
    return np.array([_NT.get(c, 4) for c in seq.upper()], np.int64)


def _codon_table() -> np.ndarray:
    """(24, 126): BLOSUM62's row of each residue against every codon
    code 25 a + 5 b + c of base classes in 0..4 (4: not A/C/G/T, the codon
    X); code 125 scores NEG."""
    aa = [tb.AA_INDEX[tb.translate(x + y + z)] if "N" not in x + y + z
          else tb.AA_INDEX["X"]
          for x in "ACGTN" for y in "ACGTN" for z in "ACGTN"]
    return np.concatenate([tb.BLOSUM62[:, aa],
                           np.full((24, 1), NEG, np.int64)], axis=1)


def _splice(seq: str, site: str) -> np.ndarray:
    """``tables.SPLICE[(site, True)].score(seq, p)`` at every p, the same
    float32 sums row by row."""
    ss = tb.SPLICE[(site, True)]
    n = len(seq)
    cols = np.array([ss.column.get(c, -1) for c in seq.upper()], np.int64)
    total = np.zeros(n, np.float32)
    for row in range(len(ss.logodds)):
        k = np.arange(n) - ss.after + row
        ok = (k >= 0) & (k < n)
        c = np.where(ok, cols[np.clip(k, 0, n - 1)], -1)
        add = np.where(c >= 0, ss.logodds[row][np.clip(c, 0, 3)],
                       np.float32(0)).astype(np.float32)
        total = (total + add).astype(np.float32)
    f = total.astype(np.float64)
    return np.where(f < 0, np.trunc(f - 0.5), np.trunc(f + 0.5)).astype(
        np.int64)


def _at(codes: np.ndarray, k: int, n: int) -> np.ndarray:
    """codes[j + k] at each column j < n, -1 past either end."""
    out = np.full(n, -1, np.int64)
    lo, hi = max(0, -k), min(n, len(codes) - k)
    if hi > lo:
        out[lo:hi] = codes[lo + k:hi + k]
    return out


class _Planes:
    """The strands' tables, and a left-padded plane per state read at a
    column shift: ``view(plane, k)`` is the plane's x[j - k] at j."""

    def __init__(self, targets: list, max_intron: int, dev):
        T = len(targets[0])
        if T >= 1 << _SHIFT:
            raise ValueError(f"target of {T} bases: over {1 << _SHIFT}")
        n = self.n = T + 1
        self.dev = dev
        self.max_intron = max_intron
        codes = [_codes(t) for t in targets]

        def plane(rows):
            return torch.as_tensor(np.stack(rows), device=dev)

        def code(c, k, scale):          # scale * base class at j + k
            v = _at(c, k, n)
            return np.where(v >= 0, scale * v, 1000)
        # the codon into column j, t[j-3:j]: 25 a + 5 b + c, or >= 125
        self.cod = plane([np.minimum(code(c, -3, 25) + code(c, -2, 5)
                                     + code(c, -1, 1), _X) for c in codes])
        # split codons, at the intron's column s and its donor e:
        # phase 1: t[e-1] | t[s+2] t[s+3]; phase 2: t[e-2] t[e-1] | t[s+2]
        self.tail1 = plane([code(c, -1, 25) for c in codes])
        self.head1 = plane([code(c, 2, 5) + code(c, 3, 1) for c in codes])
        self.tail2 = plane([code(c, -2, 25) + code(c, -1, 5)
                            for c in codes])
        self.head2 = plane([code(c, 2, 1) for c in codes])
        self.table = torch.as_tensor(_codon_table(), device=dev)
        pad = np.zeros(n, np.int64)
        ss5, ss3 = [], []
        for t in targets:
            a, b = pad.copy(), pad.copy()
            if T:
                a[:T], b[:T] = _splice(t, "5"), _splice(t, "3")
            ss5.append(a + tb.INTRON_OPEN)
            ss3.append(b)
        self.ss5, self.ss3 = plane(ss5), plane(ss3)
        cols = torch.arange(n, device=dev)
        ext = -tb.CODON_GAP_EXTEND
        self.key_low = _LOW - cols + 2          # -e of the entry at s - 2
        self.len_base = cols + 2 - _LOW          # s - e + 2 from the key
        self.del_in = ext * (cols // 3 - 1)
        self.del_out = ext * (cols // 3) - tb.CODON_GAP_OPEN - ext
        rows = -(-n // 3)
        self.d_buf = torch.full((len(targets), 3 * rows), NEG,
                                dtype=torch.int64, device=dev)
        self.neg = torch.full((len(targets), n), NEG, dtype=torch.int64,
                              device=dev)

    def padded(self) -> torch.Tensor:
        return torch.full((self.d_buf.shape[0], _PAD + self.n), NEG,
                          dtype=torch.int64, device=self.dev)

    def view(self, plane: torch.Tensor, k: int) -> torch.Tensor:
        return plane[:, _PAD - k:_PAD - k + self.n]

    def delete(self, mp: torch.Tensor) -> torch.Tensor:
        """D(j) = max over k >= 1 of M(j - 3k) - 18 - 8 (k - 1): a cummax
        over each column class mod 3 of M(j - 3) + 8 (j // 3 - 1)."""
        B, n = self.d_buf.shape[0], self.n
        torch.add(self.view(mp, 3), self.del_in, out=self.d_buf[:, :n])
        best = self.d_buf.view(B, -1, 3).cummax(dim=1).values
        return best.view(B, -1)[:, :n] - self.del_out

    def intron(self, pre: torch.Tensor, entry: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
        """An intron entered from ``pre`` at each column e through the 5'
        site (written to the padded plane ``entry``), kept at each column
        s by its best entry with e <= s - 2 (the first e of equal ones),
        left through the 3' site at s where its length s - e + 2 lies in
        the window: that score is written to the padded plane ``out`` at
        column s.  Returns the kept donor e at each column s."""
        torch.add(pre, self.ss5, out=self.view(entry, 0))
        kept = ((self.view(entry, 2) << _SHIFT) + self.key_low).cummax(
            dim=1).values
        bits = kept & _LOW
        length = bits + self.len_base
        ok = (length >= tb.MIN_INTRON) & (length <= self.max_intron)
        torch.where(ok, (kept >> _SHIFT) + self.ss3, self.neg,
                    out=self.view(out, 0))
        return _LOW - bits

    def split(self, residue: int, out: torch.Tensor, donor: torch.Tensor,
              tail: torch.Tensor, head: torch.Tensor,
              into: torch.Tensor) -> None:
        """The split codon of ``residue`` after an intron that ``out``
        leaves at column s with the kept ``donor``: its score from the
        donor's tail bases and the bases at s + 2, written to ``into`` at
        column s."""
        e = donor.clamp(0, self.n - 1)
        code = (torch.gather(tail, 1, e) + head).clamp(max=_X)
        torch.add(self.view(out, 0), self.table[residue][code],
                  out=self.view(into, 0))


def _run(protein: str, targets: list, split_codons: bool,
         max_intron: int, device) -> list:
    """The optimum and end cell on each of ``targets`` (one length)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device) if device is not None else torch.device("cpu")
    pl = _Planes(targets, max_intron, dev)
    B, n = len(targets), pl.n
    res = [tb.AA_INDEX.get(a, tb.AA_INDEX["X"]) for a in protein.upper()]
    mp, fp, e0, o0 = pl.padded(), pl.padded(), pl.padded(), pl.padded()
    e1, o1, v1 = pl.padded(), pl.padded(), pl.padded()
    e2, o2, v2 = pl.padded(), pl.padded(), pl.padded()
    m = pl.view(mp, 0)
    ins = torch.full((B, n), NEG, dtype=torch.int64, device=dev)
    score = torch.full((B,), NEG, dtype=torch.int64, device=dev)
    best_i = torch.zeros(B, dtype=torch.int64, device=dev)
    best_j = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(len(res) + 1):
        if i:
            r = res[i - 1]
            ins = torch.maximum(m + tb.CODON_GAP_OPEN,
                                ins + tb.CODON_GAP_EXTEND)
            base = torch.maximum(ins.clamp(min=0),
                                 pl.view(mp, 3) + pl.table[r][pl.cod])
            if split_codons:
                base = torch.maximum(base, pl.view(v1, 4))
                base = torch.maximum(base, pl.view(v2, 3))
        else:
            base = torch.zeros((B, n), dtype=torch.int64, device=dev)
        m.copy_(base)
        while True:
            torch.maximum(pl.view(mp, 1), pl.view(mp, 2),
                          out=pl.view(fp, 0))
            pl.view(fp, 0).add_(tb.FRAMESHIFT)
            pl.intron(m, e0, o0)
            nxt = torch.maximum(base, pl.delete(mp))
            nxt = torch.maximum(nxt, pl.view(fp, 0))
            nxt = torch.maximum(nxt, pl.view(fp, 3))
            nxt = torch.maximum(nxt, pl.view(o0, 2))
            if torch.equal(nxt, m):
                break
            m.copy_(nxt)
        if split_codons and i < len(res):
            # pre1(e) = M(e - 1), pre2(e) = M(e - 2); each phase's intron
            # and the split codon of the next residue, at column s
            d1 = pl.intron(pl.view(mp, 1), e1, o1)
            pl.split(res[i], o1, d1, pl.tail1, pl.head1, v1)
            d2 = pl.intron(pl.view(mp, 2), e2, o2)
            pl.split(res[i], o2, d2, pl.tail2, pl.head2, v2)
        top, j = m.max(dim=1)
        better = (top > score) | ((top == score) & (j < best_j))
        score = torch.where(better, top, score)
        best_i = torch.where(better, i, best_i)
        best_j = torch.where(better, j, best_j)
    return [End(int(s), int(a), int(b)) for s, a, b in
            zip(score.tolist(), best_i.tolist(), best_j.tolist())]


def best(protein: str, genomic: str, split_codons: bool = True,
         max_intron: int = 200000, device=None) -> dict:
    """The optimum of protein2genome:local of ``protein`` on each strand of
    ``genomic`` and its end cell: {"+": End, "-": End}, the reverse
    strand's end cell on its own coordinates.  ``split_codons`` False
    leaves out the phase-1 and phase-2 introns (the control)."""
    plus, minus = _run(protein, [genomic, tb.revcomp(genomic)],
                       split_codons, max_intron, device)
    return {"+": plus, "-": minus}
