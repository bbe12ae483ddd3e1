"""--ryo ("roll your own") printf-style output
(ref: src/c4/alignment.c:1771-2667; token list alignment.c:2190-2215).

Tokens: %[qt][idlsSt], %[qt]a[bels], %[qt]c[bels], %s %m %r,
%p[cIisS], %e[tism], %g, %S %C %V, %% \\n \\t \\{ \\}, and per-transition
{...} sections with %P[qt][sabe] / %P[nsl].
"""
from __future__ import annotations

from typing import Optional

from ..model.ir import Label
from ..seqio import Sequence
from .alignment import Alignment, AlignmentArgs
from . import formats


def _fasta_block(seq_bytes: bytes) -> str:
    """(ref: Sequence_print_fasta_block, sequence.c:287-303)."""
    s = seq_bytes.decode()
    out = []
    for i in range(0, max(len(s), 1), 70):
        out.append(s[i:i + 70])
    return "\n".join(out) + "\n"


def _convert_coord(alignment, query, target, qpos, tpos, on_query,
                   args: AlignmentArgs) -> int:
    """(ref: Alignment_convert_coordinate, alignment.c:209-232)."""
    if on_query:
        pos = qpos
        if args.forward_strand_coords and query.strand == "-":
            pos = query.len - pos
    else:
        pos = tpos
        if args.forward_strand_coords and target.strand == "-":
            pos = target.len - pos
    return pos


def _coding(alignment: Alignment, src: Sequence, on_query: bool):
    """(ref: Alignment_Coding_create, alignment.c:2330-2392): returns
    (begin, end, coding_bytes); begin/end are the first/last codon
    cell's source position."""
    begin = end = 0
    parts = bytearray()
    qp = alignment.region.query_start
    tp = alignment.region.target_start
    data = src.data
    for op in alignment.ops:
        t = op.transition
        for _ in range(op.length):
            advance = t.advance_query if on_query else t.advance_target
            pos = qp if on_query else tp
            if t.label == Label.MATCH and advance == 3:
                if not parts:
                    begin = pos
                parts.extend(data[pos:pos + 3].tobytes())
                end = pos
            elif t.label == Label.SPLIT_CODON and advance:
                parts.extend(data[pos:pos + advance].tobytes())
            elif t.label == Label.GAP and advance == 3:
                parts.extend(data[pos:pos + 3].tobytes())
            qp += t.advance_query
            tp += t.advance_target
    return begin, end, bytes(parts)


class _Position:
    """Per-unit-step walker for {...} sections
    (ref: Alignment_Position, alignment.c:2228-2320)."""

    def __init__(self, alignment: Alignment):
        self.alignment = alignment
        self.op_id = 0
        self.op_pos = 0
        self.qpos = alignment.region.query_start
        self.tpos = alignment.region.target_start

    @property
    def op(self):
        return self.alignment.ops[self.op_id]

    def next(self) -> bool:
        t = self.op.transition
        self.qpos += t.advance_query
        self.tpos += t.advance_target
        self.op_pos += 1
        if self.op_pos < self.op.length:
            return True
        if self.op_id + 1 < len(self.alignment.ops):
            self.op_id += 1
            self.op_pos = 0
            return True
        return False


def display_ryo(alignment: Alignment, query: Sequence, target: Sequence,
                data, fmt: str, rank,
                args: Optional[AlignmentArgs] = None) -> str:
    a = args or AlignmentArgs()
    code = data.mas.translate
    out: list[str] = []
    i = 0
    n = len(fmt)
    pto_start = -1
    ap: Optional[_Position] = None
    grids = None

    def seq_for(on_query):
        return query if on_query else target

    def step_score(ap):
        nonlocal grids
        t = ap.op.transition
        if t.calc is None:
            return 0
        from ..engine.reference import _materialize_grids, _grid_value
        if grids is None:
            grids = _materialize_grids(alignment.model, alignment.region,
                                       data)
        return _grid_value(grids[id(t.calc)],
                           ap.qpos - alignment.region.query_start,
                           ap.tpos - alignment.region.target_start)

    while i < n:
        c = fmt[i]
        if c == "\\" and i + 1 < n:
            out.append({"\\": "\\", "n": "\n", "t": "\t", "{": "{",
                        "}": "}"}.get(fmt[i + 1], fmt[i + 1]))
            i += 2
            continue
        if c == "{":
            if pto_start != -1:
                raise ValueError("Cannot nest PTO brackets")
            pto_start = i
            ap = _Position(alignment)
            i += 1
            continue
        if c == "}":
            if pto_start == -1:
                raise ValueError("No opening PTO bracket in --ryo string")
            if ap.next():
                i = pto_start + 1
            else:
                pto_start = -1
                ap = None
                i += 1
            continue
        if c != "%":
            out.append(c)
            i += 1
            continue
        # % tokens
        t2 = fmt[i + 1] if i + 1 < n else ""
        t3 = fmt[i + 2] if i + 2 < n else ""
        t4 = fmt[i + 3] if i + 3 < n else ""
        if t2 == "%":
            out.append("%")
            i += 2
        elif t2 in "qt" and t3 in "idlsSt":
            on_q = t2 == "q"
            seq = seq_for(on_q)
            if t3 == "i":
                out.append(seq.id)
            elif t3 == "d":
                out.append(seq.definition or "")
            elif t3 == "l":
                out.append(str(seq.len))
            elif t3 == "S":
                out.append(formats.strand_char(seq))
            elif t3 == "s":
                out.append(_fasta_block(seq.data.tobytes()))
            elif t3 == "t":
                out.append(seq.alphabet.type.value)
            i += 3
        elif t2 in "qt" and t3 == "a" and t4 in "bels":
            on_q = t2 == "q"
            r = alignment.region
            if t4 == "b":
                out.append(str(alignment.coordinate(query, target, on_q,
                                                    True, a)))
            elif t4 == "e":
                out.append(str(alignment.coordinate(query, target, on_q,
                                                    False, a)))
            elif t4 == "l":
                out.append(str(r.query_length if on_q
                               else r.target_length))
            else:
                seq = seq_for(on_q)
                lo = r.query_start if on_q else r.target_start
                ln = r.query_length if on_q else r.target_length
                out.append(_fasta_block(seq.data[lo:lo + ln].tobytes()))
            i += 4
        elif t2 in "qt" and t3 == "c" and t4 in "bels":
            # coding tokens (ref: Alignment_Coding_create,
            # alignment.c:2330-2392): codon-advance MATCH cells (+ split
            # codons, + codon gaps on the source side) concatenated
            on_q = t2 == "q"
            begin, end, coding = _coding(alignment, seq_for(on_q), on_q)
            if t4 == "b":
                out.append(str(_convert_coord(alignment, query, target,
                                              begin, begin, on_q, a)))
            elif t4 == "e":
                out.append(str(_convert_coord(alignment, query, target,
                                              end, end, on_q, a)))
            elif t4 == "l":
                out.append(str(len(coding)))
            else:
                out.append(_fasta_block(coding))
            i += 4
        elif t2 == "s":
            out.append(str(alignment.score))
            i += 2
        elif t2 == "m":
            out.append(alignment.model.name)
            i += 2
        elif t2 == "r":
            out.append("%_EXONERATE_BESTN_RANK_%" if rank in (-1, None)
                       else str(rank))
            i += 2
        elif t2 == "g":
            out.append(alignment.gene_orientation())
            i += 2
        elif t2 == "S":
            out.append(formats.sugar_block(alignment, query, target, a))
            i += 2
        elif t2 == "C":
            out.append(formats.cigar_block(alignment))
            i += 2
        elif t2 == "V":
            out.append(formats.vulgar_block(alignment))
            i += 2
        elif t2 == "p" and t3 in "cIisS":
            et = alignment.equivalenced_total()
            if t3 == "c":
                val = et / query.len * 100.0
            elif t3 == "I":
                gaps = sum(op.length for op in alignment.ops
                           if op.transition.label == Label.GAP)
                ident = alignment.equivalenced_matching(query, target,
                                                        code, True)
                val = ident / (et + gaps) * 100.0 if (et + gaps) else 0.0
            elif t3 == "i":
                val = alignment.percent_id(query, target, code)
            elif t3 == "s":
                val = alignment.percent_similarity(query, target, code,
                                                   data)
            else:
                val = alignment.percent_self(query, target, data)
            out.append("%2.2f" % val)
            i += 3
        elif t2 == "e" and t3 in "tism":
            et = alignment.equivalenced_total()
            if t3 == "t":
                out.append(str(et))
            elif t3 == "i":
                out.append(str(alignment.equivalenced_matching(
                    query, target, code, True)))
            elif t3 == "s":
                out.append(str(alignment.equivalenced_matching(
                    query, target, code, False, data)))
            else:
                out.append(str(et - alignment.equivalenced_matching(
                    query, target, code, True)))
            i += 3
        elif t2 == "P":
            assert ap is not None, "%P token outside {...} section"
            t_obj = ap.op.transition
            if t3 in "qt" and t4 in "sabe":
                on_q = t3 == "q"
                adv = (t_obj.advance_query if on_q
                       else t_obj.advance_target)
                if t4 == "s":
                    if adv:
                        seq = seq_for(on_q)
                        pos = ap.qpos if on_q else ap.tpos
                        out.append(seq.data[pos:pos + adv].tobytes()
                                   .decode())
                    else:
                        out.append("-")
                elif t4 == "a":
                    out.append(str(adv))
                elif t4 == "b":
                    out.append(str(_convert_coord(
                        alignment, query, target, ap.qpos, ap.tpos,
                        on_q, a)))
                else:
                    out.append(str(_convert_coord(
                        alignment, query, target,
                        ap.qpos + t_obj.advance_query,
                        ap.tpos + t_obj.advance_target, on_q, a)))
                i += 4
            elif t3 == "n":
                out.append(t_obj.name)
                i += 3
            elif t3 == "s":
                out.append(str(step_score(ap)))
                i += 3
            elif t3 == "l":
                out.append(t_obj.label.value)
                i += 3
            else:
                raise ValueError(f"Unknown [%P{t3}] in format string")
        else:
            raise ValueError(f"Unknown [%{t2}] in format string [{fmt}]")
    return "".join(out)
