"""GFF2 output (ref: src/c4/alignment.c:2710-3210).

Feature set and attribute formats reproduced from the reference: `gene`
(gene_id/sequence/gene_orientation/identity/similarity), per-exon `exon`
(insertions/deletions/identity/similarity[/Target][/frameshifts]),
`utr5`/`cds`/`utr3`, `intron` + `splice5`/`splice3`, and the closing
`similarity` feature with Align blocks.
"""
from __future__ import annotations

import time
from typing import Optional

from ..model.ir import Label
from ..seqio import Sequence
from .alignment import Alignment, AlignmentArgs

PACKAGE = "exonerate"
VERSION = "2.4.0"


def _strand_char(seq: Sequence) -> str:
    return {"+": "+", "-": "-"}.get(seq.strand, ".")


def _gff_line(alignment, query, target, on_query: bool, feature: str,
              qs: int, ts: int, qe: int, te: int,
              score: Optional[int], frame: Optional[int],
              attributes: Optional[list[str]]) -> str:
    """(ref: Alignment_display_gff_line, alignment.c:2733-2795)."""
    seq = query if on_query else target
    start = qs if on_query else ts
    end = qe if on_query else te
    if seq.strand == "-":
        start, end = seq.len - end, seq.len - start
    parts = [seq.id, f"{PACKAGE}:{alignment.model.name}", feature,
             str(start + 1), str(end),
             str(score) if score is not None else ".",
             _strand_char(seq),
             str(frame) if frame is not None else ".",
             " ; ".join(attributes) if attributes else ""]
    return "\t".join(parts) + "\n"


def _percent_region(alignment: Alignment, data, report_id: bool,
                    q_lo: int, q_hi: int) -> float:
    """identity/similarity restricted to a query range
    (ref: Alignment_get_percent_score_region, alignment.c:1524-1533).

    The query range is INCLUSIVE of ``q_hi``: the reference's region
    walkers stop only once ``query_pos > exon_query_end``
    (alignment.c:1495-1520), so a MATCH unit starting exactly at the
    exon-end query position (e.g. the first base of the next exon when
    only a target-advancing intron intervenes) is counted in this
    exon's identity/similarity stats."""
    from ..engine.reference import _materialize_grids, _grid_value
    code = data.mas.translate
    total = match = 0
    grids = None
    for op, qp, tp in alignment.walk():
        t = op.transition
        if t.label != Label.MATCH:
            continue
        for k in range(op.length):
            cq = qp + t.advance_query * k
            ct = tp + t.advance_target * k
            if not (q_lo <= cq <= q_hi):
                continue
            total += 1
            if report_id:
                qs = alignment._match_symbol(data.query, cq,
                                             t.advance_query, code)
                ts = alignment._match_symbol(data.target, ct,
                                             t.advance_target, code)
                if chr(qs).upper() == chr(ts).upper():
                    match += 1
            else:
                if grids is None:
                    grids = _materialize_grids(alignment.model,
                                               alignment.region, data)
                if _grid_value(grids[id(t.calc)],
                               cq - alignment.region.query_start,
                               ct - alignment.region.target_start) > 0:
                    match += 1
    if not total:
        return 0.0
    return match / total * 100.0


from ..alphabet import AlphabetType

# (ref: Alphabet_Type_get_name, alphabet.c:299-311)
_TYPE_NAME = {AlphabetType.DNA: "DNA", AlphabetType.PROTEIN: "Protein",
              AlphabetType.UNKNOWN: "Unknown"}


def display_gff(alignment: Alignment, query: Sequence, target: Sequence,
                data, on_query: bool, on_genomic: bool,
                args: Optional[AlignmentArgs] = None,
                result_id: int = 0) -> str:
    """(ref: Alignment_display_gff, alignment.c:3212-3231)."""
    out = ["# --- START OF GFF DUMP ---\n#\n"]
    seq = query if on_query else target
    date = time.strftime("%Y-%m-%d")
    out.append("#\n"
               "##gff-version 2\n"
               f"##source-version {PACKAGE}:{alignment.model.name} "
               f"{VERSION}\n"
               f"##date {date}\n"
               f"##type {_TYPE_NAME[seq.alphabet.type]}\n"
               "#\n")
    out.append("#\n# seqname source feature start end"
               " score strand frame attributes\n#\n")
    if on_genomic:
        out.append(_gff_gene(alignment, query, target, data, on_query,
                             result_id))
    out.append(_gff_similarity(alignment, query, target, on_query,
                               result_id))
    out.append("# --- END OF GFF DUMP ---\n#\n")
    return "".join(out)


def _gff_exon(alignment, query, target, data, on_query, qpos, tpos,
              eqs, ets, eq_gap, et_gap, eq_fs, et_fs) -> str:
    """(ref: Alignment_display_gff_exon, alignment.c:2806-2860)."""
    attrs = [
        f"insertions {eq_gap if on_query else et_gap}",
        f"deletions {et_gap if on_query else eq_gap}",
        "identity %2.2f" % _percent_region(alignment, data, True, eqs,
                                           qpos),
        "similarity %2.2f" % _percent_region(alignment, data, False, eqs,
                                             qpos),
    ]
    if on_query:
        if eq_fs:
            attrs.append(f"frameshifts {eq_fs}")
    else:
        attrs.append(f"Target {query.id} {eqs + 1} {qpos}")
        if et_fs:
            attrs.append(f"frameshifts {et_fs}")
    return _gff_line(alignment, query, target, on_query, "exon",
                     eqs, ets, qpos, tpos, None, None, attrs)


def _gff_utr(alignment, query, target, on_query, post_cds,
             cqs, cts, cqe, cte, eqs, ets, qpos, tpos) -> str:
    """(ref: Alignment_display_gff_utr, alignment.c:2862-2897)."""
    if post_cds:
        return _gff_line(alignment, query, target, on_query, "utr3",
                         max(eqs, cqe), max(ets, cte), qpos, tpos,
                         None, None, None)
    if cqs == -1:
        return _gff_line(alignment, query, target, on_query, "utr5",
                         eqs, ets, qpos, tpos, None, None, None)
    return _gff_line(alignment, query, target, on_query, "cds",
                     max(cqs, eqs), max(cts, ets), qpos, tpos,
                     None, None, None)


def _gff_gene(alignment: Alignment, query, target, data, on_query,
              result_id) -> str:
    """(ref: Alignment_display_gff_gene, alignment.c:2898-3142)."""
    out = []
    code = data.mas.translate
    r = alignment.region
    ori = alignment.gene_orientation()
    attrs = [f"gene_id {result_id}",
             f"sequence {target.id if on_query else query.id}",
             f"gene_orientation {ori}",
             "identity %2.2f" % alignment.percent_id(query, target, code),
             "similarity %2.2f" % alignment.percent_similarity(
                 query, target, code, data)]
    out.append(_gff_line(alignment, query, target, on_query, "gene",
                         r.query_start, r.target_start, r.query_end,
                         r.target_end, alignment.score, None, attrs))
    qpos, tpos = r.query_start, r.target_start
    intron_id = 0
    intron_length = 0
    eqs = ets = 0
    eq_gap = et_gap = eq_fs = et_fs = 0
    cqs = cts = cqe = cte = -1
    in_exon = False
    post_cds = False
    ops = alignment.ops
    first = True
    for op in ops:
        t = op.transition
        if first:
            first = False
            qpos += t.advance_query * op.length
            tpos += t.advance_target * op.length
            continue
        label = t.label
        if label in (Label.MATCH, Label.SPLIT_CODON):
            if label == Label.MATCH:
                if t.advance_query == 1 and t.advance_target == 1:
                    if cqs != -1 and not post_cds:
                        out.append(_gff_line(
                            alignment, query, target, on_query, "cds",
                            eqs, ets, qpos, tpos, None, None, None))
                        post_cds = True
                else:
                    if cqs == -1:
                        if in_exon:
                            out.append(_gff_line(
                                alignment, query, target, on_query,
                                "utr5", eqs, ets, qpos, tpos, None, None,
                                None))
                        cqs, cts = qpos, tpos
                    cqe = qpos + t.advance_query * op.length
                    cte = tpos + t.advance_target * op.length
            if not in_exon:
                eqs, ets = qpos, tpos
                eq_gap = et_gap = eq_fs = et_fs = 0
                in_exon = True
        elif label == Label.GAP:
            eq_gap += t.advance_query * op.length
            et_gap += t.advance_target * op.length
        elif label == Label.SS5:
            if in_exon:
                out.append(_gff_utr(alignment, query, target, on_query,
                                    post_cds, cqs, cts, cqe, cte, eqs,
                                    ets, qpos, tpos))
                out.append(_gff_exon(alignment, query, target, data,
                                     on_query, qpos, tpos, eqs, ets,
                                     eq_gap, et_gap, eq_fs, et_fs))
                in_exon = False
            seq, pos = (query, qpos) if on_query else (target, tpos)
            attrs = [f"intron_id {intron_id + 1}",
                     'splice_site "%c%c"' % (seq.symbol(pos),
                                             seq.symbol(pos + 1))]
            out.append(_gff_line(alignment, query, target, on_query,
                                 "splice5", qpos, tpos, qpos + 2,
                                 tpos + 2, None, None, attrs))
            intron_length = 0
        elif label == Label.SS3:
            if in_exon:
                out.append(_gff_utr(alignment, query, target, on_query,
                                    post_cds, cqs, cts, cqe, cte, eqs,
                                    ets, qpos, tpos))
                out.append(_gff_exon(alignment, query, target, data,
                                     on_query, qpos, tpos, eqs, ets,
                                     eq_gap, et_gap, eq_fs, et_fs))
                in_exon = False
            if ori == "+":
                intron_id += 1
                attrs = [f"intron_id {intron_id}"]
                out.append(_gff_line(alignment, query, target, on_query,
                                     "intron",
                                     qpos - intron_length - 2,
                                     tpos - intron_length - 2,
                                     qpos + 2, tpos + 2, None, None,
                                     attrs))
            seq, pos = (query, qpos) if on_query else (target, tpos)
            attrs = [f"intron_id {intron_id - 1}",
                     'splice_site "%c%c"' % (seq.symbol(pos),
                                             seq.symbol(pos + 1))]
            out.append(_gff_line(alignment, query, target, on_query,
                                 "splice3", qpos, tpos, qpos + 2,
                                 tpos + 2, None, None, attrs))
            intron_length = 0
        elif label == Label.INTRON:
            intron_length += op.length
        elif label == Label.FRAMESHIFT:
            eq_fs += t.advance_query * op.length
            et_fs += t.advance_target * op.length
        qpos += t.advance_query * op.length
        tpos += t.advance_target * op.length
    if in_exon:
        if cqe != -1:
            if cqe != qpos:
                out.append(_gff_line(alignment, query, target, on_query,
                                     "utr3b", max(eqs, cqe),
                                     max(ets, cte), qpos, tpos, None,
                                     None, None))
            else:
                out.append(_gff_line(alignment, query, target, on_query,
                                     "cds", eqs, ets, qpos, tpos, None,
                                     None, None))
        out.append(_gff_exon(alignment, query, target, data, on_query,
                             qpos, tpos, eqs, ets, eq_gap, et_gap,
                             eq_fs, et_fs))
    return "".join(out)


def _gff_similarity(alignment: Alignment, query, target, on_query,
                    result_id) -> str:
    """(ref: Alignment_display_gff_similarity, alignment.c:3144-3208)."""
    r = alignment.region
    attrs = [f"alignment_id {result_id}"]
    attrs.append(f"Target {target.id}" if on_query
                 else f"Query {query.id}")
    qpos, tpos = r.query_start, r.target_start
    first = True
    for op in alignment.ops:
        t = op.transition
        if first:
            first = False
        elif t.label == Label.MATCH:
            qp, tp = qpos, tpos
            if query.strand == "-":
                qp = query.len - qp
            if target.strand == "-":
                tp = target.len - tp
            if on_query:
                attrs.append("Align %d %d %d" % (
                    qp + 1, tp + 1, op.length * t.advance_query))
            else:
                attrs.append("Align %d %d %d" % (
                    tp + 1, qp + 1, op.length * t.advance_target))
        qpos += t.advance_query * op.length
        tpos += t.advance_target * op.length
    return _gff_line(alignment, query, target, on_query, "similarity",
                     r.query_start, r.target_start, r.query_end,
                     r.target_end, alignment.score, None, attrs)
