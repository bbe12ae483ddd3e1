"""The plain reference that decides ``correct``.

It reads the alignments that a run printed (``vulgar:`` lines) and
holds each to the model on the run's own inputs:

- ``score_err``: the largest gap between an alignment's printed score
  and the score that the reference gives the printed path, summed
  transition by transition under the model (match, codon and split-codon
  scores, affine gaps, intron open penalty, splice-site scores, the
  intron length window).  A path that leaves its printed ranges, runs
  past a sequence end or breaks the intron window has no score and reads
  ``INVALID``.  Exact: the limit is 0.
- ``truth_gap_pct``: for each query, how far (in % of the planted score)
  its best printed alignment lies below its best planted alignment, the
  path along which the generator planted one of the query's copies in
  the target, scored the same way.  An optimal aligner prints no less; a
  heuristic one may, a little (exonerate's C binary reads the same gaps
  on the same inputs).
- ``second_gap_pct``: for each query planted twice and asked for two
  alignments or more (``--bestn``), how far its second-best printed
  alignment lies below its second-best planted path, in % of that path's
  score: Waterman-Eggert's second alignment, the masked scan's answer.
- ``missing``: queries printed with fewer alignments than ``--bestn``
  asks and they have planted copies.  Exact: the limit is 0.
- ``overlap``: alignments that share a match cell with a better one
  printed for the same query, target and strands.  Waterman-Eggert masks
  every match cell of the alignments found before, so the limit is 0.

Nothing here imports the program or takes anything the program made.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as tb

INVALID = 10 ** 9


@dataclass
class Alignment:
    query: str
    q_start: int
    q_end: int
    q_strand: str
    target: str
    t_start: int
    t_end: int
    t_strand: str
    score: int
    ops: list          # [(label, query advance, target advance)]


def parse_vulgar(text: str) -> list:
    out = []
    for line in text.splitlines():
        if not line.startswith("vulgar: "):
            continue
        w = line.split()[1:]
        ops = [(w[k], int(w[k + 1]), int(w[k + 2]))
               for k in range(9, len(w), 3)]
        out.append(Alignment(w[0], int(w[1]), int(w[2]), w[3], w[4],
                             int(w[5]), int(w[6]), w[7], int(w[8]), ops))
    return out


def _oriented(seq: str, start: int, end: int, strand: str):
    """The sequence as aligned and the alignment's start on it."""
    if strand == "-":
        return tb.revcomp(seq), len(seq) - start, start - end
    return seq, start, end - start


def _dna_match(q: str, t: str) -> int:
    a = np.frombuffer(q.upper().encode(), np.uint8)
    b = np.frombuffer(t.upper().encode(), np.uint8)
    same = int((a == b).sum())
    return same * tb.DNA_MATCH + (len(a) - same) * tb.DNA_MISMATCH


def _gap(n: int, codon: bool) -> int:
    if codon:
        return tb.CODON_GAP_OPEN + (n - 1) * tb.CODON_GAP_EXTEND
    return tb.GAP_OPEN + (n - 1) * tb.GAP_EXTEND


def path_score(model: str, query: str, target: str, aln: Alignment,
               max_intron: int):
    """The model's score of the printed path, or None where the path is
    not one the model allows on these sequences."""
    protein = model == "protein2genome"
    q, i, q_len = ((query, aln.q_start, aln.q_end - aln.q_start) if protein
                   else _oriented(query, aln.q_start, aln.q_end,
                                  aln.q_strand))
    t, j, t_len = _oriented(target, aln.t_start, aln.t_end, aln.t_strand)
    i0, j0 = i, j
    score = 0
    intron = None          # (start, forward) while inside an intron
    tail = None            # the bases of a split codon before its intron
    for label, qa, ta in aln.ops:
        if i + qa > len(q) or j + ta > len(t) or qa < 0 or ta < 0:
            return None
        if label == "M":
            if protein:
                if ta != 3 * qa:
                    return None
                score += sum(tb.pair_score(q[i + k],
                                           t[j + 3 * k:j + 3 * k + 3])
                             for k in range(qa))
            else:
                if qa != ta:
                    return None
                score += _dna_match(q[i:i + qa], t[j:j + ta])
        elif label == "G":
            if (qa == 0) == (ta == 0):
                return None
            if protein and ta % 3:
                return None
            score += _gap(qa or (ta // 3 if protein else ta), protein)
        elif label in ("5", "3"):
            if (qa, ta) != (0, 2):
                return None
            if intron is None:
                forward = label == "5"
                if protein and not forward:
                    return None
                intron = (j, forward)
                score += (tb.INTRON_OPEN
                          + tb.SPLICE[(label, forward)].score(t, j))
            else:
                start, forward = intron
                if label != ("3" if forward else "5"):
                    return None
                length = j - start + 2
                if not tb.MIN_INTRON <= length <= max_intron:
                    return None
                score += tb.SPLICE[(label, forward)].score(t, j)
                intron = None
        elif label == "I":
            if intron is None or qa != 0:
                return None
        elif label == "S" and protein:
            if qa == 0 and ta in (1, 2) and tail is None:
                tail = t[j:j + ta]
            elif qa == 1 and tail is not None and len(tail) + ta == 3:
                score += tb.pair_score(q[i], tail + t[j:j + ta])
                tail = None
            else:
                return None
        elif label == "F" and protein:
            if qa != 0 or ta % 3 == 0 or ta > 5:
                return None
            score += tb.FRAMESHIFT
        else:
            return None
        i += qa
        j += ta
    if intron is not None or tail is not None:
        return None
    if i - i0 != q_len or j - j0 != t_len:
        return None
    return score


@dataclass
class Verdict:
    numbers: dict          # name -> value
    checked: int           # alignments rescored
    queries: int           # queries held to their planted paths
    worst: str = ""        # the query of the widest truth gap, as printed


def match_cells(model: str, query: str, target: str, aln: Alignment
                ) -> set:
    """The (query, target) cells of ``aln``'s match steps, in the
    coordinates of the strands it was aligned on."""
    protein = model == "protein2genome"
    i = aln.q_start if protein else _oriented(query, aln.q_start, aln.q_end,
                                              aln.q_strand)[1]
    j = _oriented(target, aln.t_start, aln.t_end, aln.t_strand)[1]
    cells = set()
    for label, qa, ta in aln.ops:
        if label == "M":
            cells.update((i + k, j + k * (ta // qa)) for k in range(qa))
        i += qa
        j += ta
    return cells


def judge(model: str, max_intron: int, bestn: int, invocations) -> Verdict:
    """``invocations``: (printed text, {query id: sequence},
    {target id: sequence}, {query id: [planted Alignment, ...]}) each."""
    score_err = overlap = 0
    gap = gap2 = -float("inf")
    checked = queries = missing = 0
    worst = ""
    for text, qseqs, tseqs, planted in invocations:
        by_query: dict = {}
        taken: dict = {}             # (query, target, strands) -> cells
        for aln in sorted(parse_vulgar(text), key=lambda a: -a.score):
            checked += 1
            want = None
            if aln.query in qseqs and aln.target in tseqs:
                want = path_score(model, qseqs[aln.query],
                                  tseqs[aln.target], aln, max_intron)
            err = INVALID if want is None else abs(aln.score - want)
            score_err = max(score_err, err)
            by_query.setdefault(aln.query, []).append(aln.score)
            if want is not None:
                key = (aln.query, aln.target, aln.q_strand, aln.t_strand)
                cells = match_cells(model, qseqs[aln.query],
                                    tseqs[aln.target], aln)
                overlap += bool(cells & taken.get(key, set()))
                taken[key] = taken.get(key, set()) | cells
        for qid, truths in planted.items():
            scores = []
            for p in truths:
                s = path_score(model, qseqs[qid], tseqs[p.target], p,
                               max_intron)
                if s is None:
                    raise ValueError(f"planted path of {qid} has no score")
                scores.append(s)
            scores.sort(reverse=True)
            got = by_query.get(qid, [])
            queries += 1
            if len(got) < min(bestn, len(scores)):
                missing += 1
            have = max(got, default=0)
            if 100.0 * (scores[0] - have) / scores[0] > gap:
                gap = 100.0 * (scores[0] - have) / scores[0]
                worst = "\n".join(
                    [f"{qid}: planted {scores}"] +
                    [ln for ln in text.splitlines()
                     if ln.startswith(f"vulgar: {qid} ")])
            if bestn >= 2 and len(scores) >= 2:
                second = got[1] if len(got) >= 2 else 0
                gap2 = max(gap2, 100.0 * (scores[1] - second) / scores[1])
    return Verdict({"score_err": score_err, "truth_gap_pct": gap,
                    "second_gap_pct": gap2, "missing": missing,
                    "overlap": overlap}, checked, queries, worst)
