"""Alignment output formats: human display, sugar, cigar, vulgar.

Byte-parity reimplementation of the reference emitters
(ref: src/c4/alignment.c:1622-1769 for sugar/cigar/vulgar;
alignment.c:251-1380 for the human-readable block display with ruler,
intron folding, codon rows and split-codon braces).  GFF and ryo live in
gff.py / ryo.py.
"""
from __future__ import annotations

from typing import Optional

from ..model.ir import Label
from ..seqio import Sequence
from ..translate import GeneticCode
from .alignment import Alignment, AlignmentArgs

# three-letter amino-acid names (ref: Alphabet_aa2tla, alphabet.c:330-377)
_TLA_ORDER = "ARNDCQEGHILKMFPSTWYVBZX*U"
_TLA_NAMES = ["Ala", "Arg", "Asn", "Asp", "Cys", "Gln", "Glu", "Gly",
              "His", "Ile", "Leu", "Lys", "Met", "Phe", "Pro", "Ser",
              "Thr", "Trp", "Tyr", "Val", "Asx", "Zed", "Unk", "***",
              "Sec"]


def aa2tla(aa: int | str, use_tla: bool = True) -> str:
    ch = chr(aa) if isinstance(aa, int) else aa
    ix = _TLA_ORDER.find(ch.upper())
    if ix < 0:
        raise ValueError(f"Unknown amino acid [{ch}]")
    return _TLA_NAMES[ix] if use_tla else f"^{ch.upper()}^"


def strand_char(seq: Sequence) -> str:
    return {"+": "+", "-": "-"}.get(seq.strand, ".")


# ---------------------------------------------------------------------------
# sugar / cigar / vulgar (ref: alignment.c:1622-1769)
# ---------------------------------------------------------------------------

def sugar_block(alignment: Alignment, query: Sequence, target: Sequence,
                args: Optional[AlignmentArgs] = None) -> str:
    a = args or AlignmentArgs()
    return "%s %d %d %c %s %d %d %c %d" % (
        query.id,
        alignment.coordinate(query, target, True, True, a),
        alignment.coordinate(query, target, True, False, a),
        strand_char(query),
        target.id,
        alignment.coordinate(query, target, False, True, a),
        alignment.coordinate(query, target, False, False, a),
        strand_char(target),
        alignment.score)


def _cigar_type(t) -> tuple[str, int]:
    if not t.advance_query:
        return "D", t.advance_target
    if not t.advance_target:
        return "I", t.advance_query
    return "M", max(t.advance_query, t.advance_target)


def cigar_block(alignment: Alignment) -> str:
    """(ref: Alignment_print_cigar_block, alignment.c:1656-1681).  The
    separator flips to " " whenever a group *ends*, even a zero-move
    group that prints nothing — so an alignment whose op list starts
    with a silent transition gets a leading space (reference emits a
    double space after the sugar score in that case).  Byte parity
    requires reproducing that."""
    out: list[str] = []
    gap = ""
    ops = alignment.ops
    ctype, unit = _cigar_type(ops[0].transition)
    move = unit * ops[0].length
    for op in ops[1:]:
        ntype, nunit = _cigar_type(op.transition)
        nmove = nunit * op.length
        if ntype == ctype:
            move += nmove
        else:
            if move:
                out.append(f"{gap}{ctype} {move}")
            ctype, move = ntype, nmove
            gap = " "
    if move:
        out.append(f"{gap}{ctype} {move}")
    return "".join(out)


_VULGAR_LABEL = {
    Label.MATCH: "M", Label.GAP: "G", Label.NER: "N", Label.SS5: "5",
    Label.SS3: "3", Label.INTRON: "I", Label.SPLIT_CODON: "S",
    Label.FRAMESHIFT: "F",
}


def vulgar_block(alignment: Alignment) -> str:
    """(ref: Alignment_print_vulgar_block, alignment.c:1683-1769).  Runs
    merge while the label matches, codon-ness matches and gap direction is
    consistent; NONE runs are silent; the trailing run (always NONE) is
    dropped exactly as in the reference."""
    parts: list[str] = []
    ops = alignment.ops

    def flush(label, is_codon, aq, at):
        if label == Label.NONE:
            return
        ch = _VULGAR_LABEL[label]
        if label == Label.MATCH and is_codon:
            ch = "C"
        parts.append(f"{ch} {aq} {at}")

    t = ops[0].transition
    curr_label = t.label
    curr_codon = t.advance_query == 3 and t.advance_target == 3
    curr_aq = t.advance_query * ops[0].length
    curr_at = t.advance_target * ops[0].length
    for op in ops[1:]:
        t = op.transition
        is_codon = t.advance_query == 3 and t.advance_target == 3
        if (t.label == curr_label
                and (curr_aq or not t.advance_query)
                and (curr_at or not t.advance_target)
                and curr_codon == is_codon):
            curr_aq += t.advance_query * op.length
            curr_at += t.advance_target * op.length
        else:
            flush(curr_label, curr_codon, curr_aq, curr_at)
            curr_label = t.label
            curr_codon = is_codon
            curr_aq = t.advance_query * op.length
            curr_at = t.advance_target * op.length
    return " ".join(parts)


def display_sugar(alignment, query, target, args=None) -> str:
    return "sugar: " + sugar_block(alignment, query, target, args) + "\n"


def display_cigar(alignment, query, target, args=None) -> str:
    return ("cigar: " + sugar_block(alignment, query, target, args)
            + " " + cigar_block(alignment) + "\n")


def display_vulgar(alignment, query, target, args=None) -> str:
    return ("vulgar: " + sugar_block(alignment, query, target, args)
            + " " + vulgar_block(alignment) + "\n")


# ---------------------------------------------------------------------------
# human-readable display (ref: alignment.c:251-1380)
# ---------------------------------------------------------------------------

class _View:
    """Accumulates the 3-5 display rows (ref: AlignmentView)."""

    def __init__(self, alignment: Alignment, query, target,
                 args: AlignmentArgs):
        self.args = args
        self.outer_query: list[str] = []
        self.inner_query: Optional[list[str]] = (
            [] if alignment.model.max_query_advance == 3 else None)
        self.middle: list[str] = []
        self.inner_target: Optional[list[str]] = (
            [] if alignment.model.max_target_advance == 3 else None)
        self.outer_target: list[str] = []
        self.row_marker: list[tuple[int, int]] = []
        self.max_pos_len = self._max_pos_len(alignment, query, target)
        self.width = args.alignment_width - ((self.max_pos_len + 5) << 1)
        assert self.width > 0
        self.limit = self.width
        self.query_intron_count = 0
        self.target_intron_count = 0
        self.joint_intron_count = 0
        self.intron_advance_query = 0
        self.intron_advance_target = 0
        self.gene_orientation = alignment.gene_orientation()
        self.ner_count = 0
        self.ner_advance_query = 0
        self.ner_advance_target = 0
        self.curr_split_codon = 0
        # split codon separations (ref: AlignmentView_create 322-346)
        self.split_separations: list[tuple[int, int]] = []
        curr = None
        for op in alignment.ops:
            if curr is not None:
                if op.transition.label == Label.SPLIT_CODON:
                    self.split_separations.append(tuple(curr))
                    curr = None
                else:
                    curr[0] += op.length * op.transition.advance_query
                    curr[1] += op.length * op.transition.advance_target
            elif op.transition.label == Label.SPLIT_CODON:
                curr = [op.length * op.transition.advance_query,
                        op.length * op.transition.advance_target]
        assert curr is None

    def _max_pos_len(self, alignment, query, target):
        a = self.args if hasattr(self, "args") else AlignmentArgs()
        vals = [alignment.coordinate(query, target, True, True, a),
                alignment.coordinate(query, target, True, False, a),
                alignment.coordinate(query, target, False, True, a),
                alignment.coordinate(query, target, False, False, a)]
        return len(str(max(vals)))

    def cur_len(self):
        return sum(len(s) for s in self.outer_query)

    def add(self, qs: str, iqs: Optional[str], ms: str,
            its: Optional[str], ts: str, qpos: int, tpos: int):
        assert len(qs) == len(ms) == len(ts), (qs, ms, ts)
        if self.inner_query is not None:
            self.inner_query.append(iqs if iqs is not None
                                    else " " * len(ms))
        if self.inner_target is not None:
            self.inner_target.append(its if its is not None
                                     else " " * len(ms))
        self.outer_query.append(qs)
        self.middle.append(ms)
        self.outer_target.append(ts)
        if self.cur_len() >= self.limit:
            self.row_marker.append((qpos, tpos))
            self.limit += self.width


def _equiv_symbol(a: str, b: str, submat) -> str:
    """(ref: Alignment_get_equiv_symbol, alignment.c:434-455)."""
    if submat is not None:
        score = submat.lookup(ord(a), ord(b))
        if score == 0:
            return "."
        if score > 0:
            return "|" if a.upper() == b.upper() else ":"
    else:
        if a == b:
            return "|"
    return " "


def _display_symbol(submat, a: str, b: str) -> str:
    """(ref: Match_get_display_symbol, match.c:224-236)."""
    if a.upper() == b.upper():
        return "|"
    score = submat.lookup(ord(a), ord(b))
    if score == 0:
        return "."
    if score > 0:
        return ":"
    return " "


def _revtrans_codons(code: GeneticCode, aa: str) -> list[str]:
    """All codons (GATC bit order -> chars) encoding aa
    (ref: Translate_reverse)."""
    nt = "GATC"
    out = []
    for cid in code.revtrans.get(aa.upper(), []):
        out.append(nt[(cid >> 4) & 3] + nt[(cid >> 2) & 3] + nt[cid & 3])
    return out


def _codon_match_string(codon: str, aa: str, protein_submat,
                        code: GeneticCode) -> str:
    """(ref: Alignment_get_codon_match_string, alignment.c:459-479)."""
    codon_aa = chr(code.codon(*(ord(c) for c in codon)))
    sym = _equiv_symbol(codon_aa, aa, protein_submat)
    out = [sym] * 3
    if sym != "|":
        for cand in _revtrans_codons(code, aa):
            for i in range(3):
                if cand[i] == codon[i]:
                    out[i] = "!"
    return "".join(out)


def _match_display(match, query, target, qpos, tpos) -> str:
    """(ref: match display_func vtable)."""
    mas = match.mas
    code = mas.translate
    aq, at = match.advance_query, match.advance_target
    if aq == 1 and at == 1:
        sub = (mas.dna_submat if match.type.value == "dna2dna"
               else mas.protein_submat)
        return _display_symbol(sub, chr(query.symbol(qpos)),
                               chr(target.symbol(tpos)))
    if aq == 1 and at == 3:
        qs = chr(query.symbol(qpos))
        ts = chr(code.codon(target.symbol(tpos), target.symbol(tpos + 1),
                            target.symbol(tpos + 2)))
        sym = _display_symbol(mas.protein_submat, qs, ts)
        out = [sym] * 3
        if qs != ts:
            codon = "".join(chr(target.symbol(tpos + k)) for k in range(3))
            for cand in _revtrans_codons(code, qs):
                for i in range(3):
                    if cand[i] == codon[i]:
                        out[i] = "!"
        return "".join(out)
    if aq == 3 and at == 1:
        ts = chr(target.symbol(tpos))
        qsym = chr(code.codon(query.symbol(qpos), query.symbol(qpos + 1),
                              query.symbol(qpos + 2)))
        sym = _display_symbol(mas.protein_submat, ts, qsym)
        out = [sym] * 3
        if ts != qsym:
            codon = "".join(chr(query.symbol(qpos + k)) for k in range(3))
            for cand in _revtrans_codons(code, ts):
                for i in range(3):
                    if cand[i] == codon[i]:
                        out[i] = "!"
        return "".join(out)
    # 3:3 codon match (ref: Match_3_3_split_display_func, match.c:590-642)
    qsym = chr(code.codon(query.symbol(qpos), query.symbol(qpos + 1),
                          query.symbol(qpos + 2)))
    tsym = chr(code.codon(target.symbol(tpos), target.symbol(tpos + 1),
                          target.symbol(tpos + 2)))
    sym = _display_symbol(mas.protein_submat, qsym, tsym)
    out = []
    for k in range(3):
        ch = sym
        qb = chr(query.symbol(qpos + k)).upper()
        tb = chr(target.symbol(tpos + k)).upper()
        if qsym == tsym:
            if qb != tb:
                ch = "+"
        else:
            if qb == tb:
                ch = "!"
        out.append(ch)
    return "".join(out)


def _match_get_string(seq: Sequence, pos: int, advance: int, mx: int,
                      code, use_tla: bool) -> str:
    """(ref: Alignment_match_get_string, alignment.c:126-160)."""
    if mx == 1:
        return chr(seq.symbol(pos))
    if advance == 1:
        return aa2tla(seq.symbol(pos), use_tla)
    return "".join(chr(seq.symbol(pos + k)) for k in range(3))


def _match_get_symbol(seq: Sequence, pos: int, advance: int, code) -> int:
    if advance == 1:
        return seq.symbol(pos)
    return code.codon(seq.symbol(pos), seq.symbol(pos + 1),
                      seq.symbol(pos + 2))


def _center(label: str, width_name: int) -> str:
    """(ref: middle_string formatting in AlignmentView_add_INTRON)."""
    fill = (width_name - len(label)) + 1
    left = (fill | 1) >> 1
    right = (fill - 1) >> 1
    return " " * left + label + " " * right


class _Displayer:
    def __init__(self, alignment: Alignment, query, target, data,
                 args: Optional[AlignmentArgs] = None):
        self.alignment = alignment
        self.query = query
        self.target = target
        self.data = data
        self.args = args or AlignmentArgs()
        self.code = data.mas.translate
        self.view = _View(alignment, query, target, self.args)
        self.last_match = None

    # -- label renderers --------------------------------------------------

    def add_match(self, t, total, qpos, tpos):
        av = self.view
        self.last_match = t
        # resolve through the run's AlignData so user --proteinsubmat/
        # --dnasubmat reach the midline equivalence symbols (the reference
        # Match vtable reads the global Match_ArgumentSet,
        # ref: match.c:224-236, alignment.c:431-455)
        match = (self.data.match(t.label_data.type)
                 if t.label_data is not None else None)
        use_tla = self.args.use_aa_tla
        for _ in range(total):
            mx = max(t.advance_query, t.advance_target)
            qs = _match_get_string(self.query, qpos, t.advance_query, mx,
                                   self.code, use_tla)
            ts = _match_get_string(self.target, tpos, t.advance_target, mx,
                                   self.code, use_tla)
            iqs = its = None
            if t.advance_query == 3:
                iqs = aa2tla(_match_get_symbol(self.query, qpos, 3,
                                               self.code), use_tla)
            if t.advance_target == 3:
                its = aa2tla(_match_get_symbol(self.target, tpos, 3,
                                               self.code), use_tla)
            if match is not None:
                ms = _match_display(match, self.query, self.target,
                                    qpos, tpos)
            else:
                ms = ("|" if self.query.symbol(qpos)
                      == self.target.symbol(tpos) else " ")
            av.add(qs, iqs, ms, its, ts, qpos, tpos)
            qpos += t.advance_query
            tpos += t.advance_target

    def add_gap(self, aq, at, total, qpos, tpos):
        """(ref: AlignmentView_add_GAP, alignment.c:525-608)."""
        av = self.view
        qt = self.query.alphabet.type.value
        tt = self.target.alphabet.type.value
        translating = ((qt == "protein" and tt == "dna")
                       or (qt == "dna" and tt == "protein")
                       or ((aq | at) == 3))
        emitted = qt if aq else tt
        for _ in range(total):
            n = aq | at
            if aq:
                seq_s = "".join(chr(self.query.symbol(qpos + k))
                                for k in range(n))
            else:
                seq_s = "".join(chr(self.target.symbol(tpos + k))
                                for k in range(n))
            match_s = " " * n
            gap_s = "-" * n
            tr_name = None
            if translating:
                if emitted == "protein":
                    seq_s = aa2tla(seq_s[0], self.args.use_aa_tla)
                    match_s = " " * 3
                    gap_s = "-" * 3
                if n == 3:
                    gap_s = "<->"
                    tr = self.code.codon(*(ord(c) for c in seq_s))
                    tr_name = aa2tla(tr, self.args.use_aa_tla)
            if aq:
                av.add(seq_s, tr_name, match_s,
                       gap_s if translating else None, gap_s, qpos, tpos)
            else:
                av.add(gap_s, gap_s if translating else None, match_s,
                       tr_name, seq_s, qpos, tpos)
            qpos += aq
            tpos += at

    def add_splice(self, aq, at, qpos, tpos, is5: bool):
        """(ref: AlignmentView_add_SPLICE_SITE, alignment.c:645-705)."""
        av = self.view
        gap = "  "
        ori = av.gene_orientation

        def cons(two: str) -> str:
            if ori == "+":
                ca, cb = ("G", "T") if is5 else ("A", "G")
            else:
                ca, cb = ("A", "C") if is5 else ("C", "T")
            return (("+" if two[0].upper() == ca else "-")
                    + ("+" if two[1].upper() == cb else "-"))

        if aq == 2:
            qseq = (chr(self.query.symbol(qpos))
                    + chr(self.query.symbol(qpos + 1)))
            qcons = cons(qseq)
            qseq = qseq.lower()
        if at == 2:
            tseq = (chr(self.target.symbol(tpos))
                    + chr(self.target.symbol(tpos + 1)))
            tcons = cons(tseq)
            tseq = tseq.lower()
        if aq == 2 and at == 2:
            av.add(qseq, qcons, gap, tcons, tseq, qpos, tpos)
        elif aq == 2:
            if self.last_match is not None \
                    and self.last_match.advance_query == 3:
                av.add(qseq, qcons, gap, gap, gap, qpos, tpos)
            else:
                av.add(qseq, None, qcons, None, gap, qpos, tpos)
        else:
            if self.last_match is not None \
                    and self.last_match.advance_target == 3:
                av.add(gap, gap, gap, tcons, tseq, qpos, tpos)
            else:
                av.add(gap, None, tcons, None, tseq, qpos, tpos)

    def add_intron(self, aq, at, qpos, tpos):
        """(ref: AlignmentView_add_INTRON, alignment.c:707-775)."""
        av = self.view
        dir_sign = {"+": ">>>>", "-": "<<<<"}.get(av.gene_orientation,
                                                  "????")
        if aq:
            if at:
                av.joint_intron_count += 1
                count, name = av.joint_intron_count, "Joint"
                label = f"{aq + 4} bp // {at + 4} bp"
            else:
                av.query_intron_count += 1
                count, name = av.query_intron_count, "Query"
                label = f"{aq + 4} bp"
        else:
            av.target_intron_count += 1
            count, name = av.target_intron_count, "Target"
            label = f"{at + 4} bp"
        name_s = f"{dir_sign} {name} Intron {count} {dir_sign}"
        assert len(name_s) > len(label)
        mid_s = _center(label, len(name_s))
        gap_s = "." * len(name_s)
        pad_s = "^" * len(name_s)
        lm = self.last_match
        if aq:
            if at:
                av.add(name_s, None, mid_s, None, name_s, qpos, tpos)
            elif lm is not None and lm.advance_query == 3:
                av.add(gap_s, pad_s, mid_s, pad_s, name_s, qpos, tpos)
            else:
                av.add(gap_s, None, mid_s, None, name_s, qpos, tpos)
        else:
            if lm is not None and lm.advance_target == 3:
                av.add(name_s, pad_s, mid_s, pad_s, gap_s, qpos, tpos)
            else:
                av.add(name_s, None, mid_s, None, gap_s, qpos, tpos)

    def add_ner(self, aq, at, qpos, tpos):
        """(ref: AlignmentView_add_NER, alignment.c:777-817)."""
        av = self.view
        av.ner_count += 1
        up, mid, low = str(aq), f"NER {av.ner_count}", str(at)
        mx = max(len(up), len(mid), len(low))

        def padded(s):
            return ("--<" + " " * (1 + (((mx - len(s)) + 1) >> 1)) + s
                    + " " * (1 + ((mx - len(s)) >> 1)) + ">--")

        av.add(padded(up), None, padded(mid), None, padded(low), qpos, tpos)

    def add_split_codon(self, aq, at, qpos, tpos):
        """(ref: AlignmentView_add_SPLIT_CODON, alignment.c:822-1040)."""
        av = self.view
        q_dna = self.query.alphabet.type.value == "dna"
        t_dna = self.target.alphabet.type.value == "dna"
        before = (av.curr_split_codon & 1) == 0
        qsep, tsep = av.split_separations[av.curr_split_codon >> 1]
        qp = tp = None
        qaa = taa = None
        if q_dna and t_dna:
            if (aq, at) == (1, 1):
                if before:
                    start = 0
                    qp = (qpos, qpos + qsep, qpos + qsep + 1)
                    tp = (tpos, tpos + tsep, tpos + tsep + 1)
                else:
                    start = 2
                    qp = (qpos - qsep, qpos - qsep + 1, qpos)
                    tp = (tpos - tsep, tpos - tsep + 1, tpos)
            elif (aq, at) == (2, 2):
                if before:
                    start = 0
                    qp = (qpos, qpos + 1, qpos + qsep)
                    tp = (tpos, tpos + 1, tpos + tsep)
                else:
                    start = 1
                    qp = (qpos - qsep, qpos, qpos + 1)
                    tp = (tpos - tsep, tpos, tpos + 1)
            else:
                raise ValueError(f"unexpected d2d split codon {aq},{at}")
        elif q_dna:
            taa = chr(self.target.symbol(tpos))
            if (aq, at) == (1, 0):
                start = 0
                qp = (qpos, qpos + qsep, qpos + qsep + 1)
            elif (aq, at) == (2, 0):
                start = 0
                qp = (qpos, qpos + 1, qpos + qsep)
            elif (aq, at) == (2, 1):
                start = 1
                qp = (qpos - qsep, qpos, qpos + 1)
            elif (aq, at) == (1, 1):
                start = 2
                qp = (qpos - qsep, qpos - qsep + 1, qpos)
            else:
                raise ValueError(f"unexpected d2p split codon {aq},{at}")
        else:
            qaa = chr(self.query.symbol(qpos))
            if (aq, at) == (0, 1):
                start = 0
                tp = (tpos, tpos + tsep, tpos + tsep + 1)
            elif (aq, at) == (0, 2):
                start = 0
                tp = (tpos, tpos + 1, tpos + tsep)
            elif (aq, at) == (1, 2):
                start = 1
                tp = (tpos - tsep, tpos, tpos + 1)
            elif (aq, at) == (1, 1):
                start = 2
                tp = (tpos - tsep, tpos - tsep + 1, tpos)
            else:
                raise ValueError(f"unexpected p2d split codon {aq},{at}")
        av.curr_split_codon += 1
        use_tla = self.args.use_aa_tla
        qy_codon = ("".join(chr(self.query.symbol(p)) for p in qp)
                    if qp else "")
        tg_codon = ("".join(chr(self.target.symbol(p)) for p in tp)
                    if tp else "")
        qy_name = aa2tla(qaa, use_tla) if qaa else None
        tg_name = aa2tla(taa, use_tla) if taa else None
        n = max(aq, at)
        qsrc = qy_codon if q_dna else qy_name
        tsrc = tg_codon if t_dna else tg_name
        q_str = "{%s}" % qsrc[start:start + n]
        t_str = "{%s}" % tsrc[start:start + n]
        iqs = its = None
        if q_dna:
            qaa = chr(self.code.codon(*(ord(c) for c in qy_codon.upper())))
            iqs = "{%s}" % aa2tla(qaa, use_tla)[start:start + n]
        if t_dna:
            taa = chr(self.code.codon(*(ord(c) for c in tg_codon.upper())))
            its = "{%s}" % aa2tla(taa, use_tla)[start:start + n]
        psub = self.data.mas.protein_submat
        if q_dna and t_dna:
            cm = _equiv_symbol(qaa, taa, psub) * 3
        elif q_dna:
            cm = _codon_match_string(qy_codon.upper(), taa, psub, self.code)
        else:
            cm = _codon_match_string(tg_codon.upper(), qaa, psub, self.code)
        m_str = "{%s}" % cm[start:start + n]
        av.add(q_str, iqs, m_str, its, t_str, qpos, tpos)

    def add_frameshift(self, aq, at, total, qpos, tpos):
        """(ref: AlignmentView_add_FRAMESHIFT, alignment.c:1042-1092)."""
        av = self.view
        emitted = (self.query.alphabet.type.value if aq
                   else self.target.alphabet.type.value)
        for _ in range(total):
            n = aq | at
            if aq:
                seq_s = "".join(chr(self.query.symbol(qpos + k))
                                for k in range(n))
            else:
                seq_s = "".join(chr(self.target.symbol(tpos + k))
                                for k in range(n))
            match_s = "#" * n
            gap_s = "-" * n
            if emitted == "protein":
                seq_s = aa2tla(seq_s[0], self.args.use_aa_tla)
                match_s = "#" * 3
                gap_s = "-" * 3
            if aq:
                av.add(seq_s, match_s, match_s, gap_s, gap_s, qpos, tpos)
            else:
                av.add(gap_s, gap_s, match_s, match_s, seq_s, qpos, tpos)
            qpos += aq
            tpos += at

    # -- assembly (ref: AlignmentView_prepare, alignment.c:1094-1160) ------

    def prepare(self):
        al = self.alignment
        av = self.view
        av.row_marker.append((al.region.query_start - 1,
                              al.region.target_start - 1))
        groups = al.grouped()
        qpos = al.region.query_start
        tpos = al.region.target_start
        for gi, op in enumerate(groups):
            t = op.transition
            next_same = (gi + 1 < len(groups)
                         and groups[gi + 1].transition.label == t.label)
            self._add_label_op(t, op.length, qpos, tpos, next_same)
            qpos += t.advance_query * op.length
            tpos += t.advance_target * op.length
        av.row_marker.append((al.region.query_end - 1,
                              al.region.target_end - 1))

    def _add_label_op(self, t, total, qpos, tpos, next_same):
        av = self.view
        if t.label == Label.NONE:
            pass
        elif t.label == Label.MATCH:
            self.add_match(t, total, qpos, tpos)
        elif t.label == Label.GAP:
            self.add_gap(t.advance_query, t.advance_target, total,
                         qpos, tpos)
        elif t.label == Label.SS5:
            self.add_splice(t.advance_query, t.advance_target, qpos, tpos,
                            True)
        elif t.label == Label.SS3:
            self.add_splice(t.advance_query, t.advance_target, qpos, tpos,
                            False)
        elif t.label == Label.INTRON:
            av.intron_advance_query += t.advance_query * total
            av.intron_advance_target += t.advance_target * total
            if not next_same:
                self.add_intron(av.intron_advance_query,
                                av.intron_advance_target, qpos, tpos)
                av.intron_advance_query = 0
                av.intron_advance_target = 0
        elif t.label == Label.NER:
            av.ner_advance_query += t.advance_query * total
            av.ner_advance_target += t.advance_target * total
            if not next_same:
                self.add_ner(av.ner_advance_query, av.ner_advance_target,
                             qpos, tpos)
                av.ner_advance_query = 0
                av.ner_advance_target = 0
        elif t.label == Label.SPLIT_CODON:
            assert total == 1
            self.add_split_codon(t.advance_query, t.advance_target,
                                 qpos, tpos)
        elif t.label == Label.FRAMESHIFT:
            self.add_frameshift(t.advance_query, t.advance_target, total,
                                qpos, tpos)

    # -- rendering (ref: AlignmentView_display*, alignment.c:1162-1340) ----

    def render(self) -> str:
        av = self.view
        oq = list("".join(av.outer_query))
        mid = "".join(av.middle)
        ot = list("".join(av.outer_target))
        iq = list("".join(av.inner_query)) if av.inner_query is not None \
            else None
        it = list("".join(av.inner_target)) if av.inner_target is not None \
            else None
        out = []
        total = len(mid)
        pos = 0
        row = 0
        pause = total - av.width
        while pos < pause:
            out.append(self._render_row(row, pos, av.width, oq, iq, mid,
                                        it, ot))
            out.append("\n")
            pos += av.width
            row += 1
        out.append(self._render_row(row, pos, total - pos, oq, iq, mid,
                                    it, ot))
        out.append("\n")
        return "".join(out)

    def _render_row(self, row, pos, width, oq, iq, mid, it, ot) -> str:
        av = self.view
        a = self.args
        q1, t1 = av.row_marker[row]
        q2, t2 = av.row_marker[row + 1] if row + 1 < len(av.row_marker) \
            else av.row_marker[-1]
        p1q, p2q = q1 + 1, q2 + 1
        p1t, p2t = t1 + 1, t2 + 1
        if a.forward_strand_coords:
            if self.query.strand == "-":
                p1q = self.query.len - p1q - 1
                p2q = self.query.len - p2q + 1
            if self.target.strand == "-":
                p1t = self.target.len - p1t - 1
                p2t = self.target.len - p2t + 1
        show_iq = iq is not None and any(
            c != " " for c in iq[pos:pos + width])
        show_it = it is not None and any(
            c != " " for c in it[pos:pos + width])
        if show_iq:
            _prepare_seq(oq, iq, pos, width)
        if show_it:
            _prepare_seq(ot, it, pos, width)
        _replace_padding(oq, pos, width)
        _replace_padding(ot, pos, width)
        mp = av.max_pos_len
        lines = []
        lines.append(" %*d : %s : %*d\n" % (
            mp, p1q + 1, "".join(oq[pos:pos + width]), mp, p2q))
        if show_iq:
            lines.append(" %*s   %s\n" % (mp, " ",
                                          "".join(iq[pos:pos + width])))
        lines.append(" %*s   %s\n" % (mp, " ", mid[pos:pos + width]))
        if show_it:
            lines.append(" %*s   %s\n" % (mp, " ",
                                          "".join(it[pos:pos + width])))
        lines.append(" %*d : %s : %*d\n" % (
            mp, p1t + 1, "".join(ot[pos:pos + width]), mp, p2t))
        return "".join(lines)


def _prepare_seq(outer: list, inner: list, pos: int, width: int):
    """(ref: AlignmentView_prepare_seq, alignment.c:1180-1196)."""
    for i in range(pos, pos + width):
        if inner[i] == " ":
            inner[i], outer[i] = outer[i], inner[i]
            continue
        if inner[i] == "^":
            inner[i] = " "


def _replace_padding(chars: list, pos: int, width: int):
    for i in range(pos, pos + width):
        if chars[i] == "^":
            chars[i] = " "


def display_human(alignment: Alignment, query: Sequence, target: Sequence,
                  data, args: Optional[AlignmentArgs] = None) -> str:
    """Full human-readable alignment (ref: Alignment_display,
    alignment.c:1343-1380)."""
    a = args or AlignmentArgs()
    header = ("\n"
              "C4 Alignment:\n"
              "------------\n"
              "         Query: %s%s%s\n"
              "        Target: %s%s%s\n"
              "         Model: %s\n"
              "     Raw score: %d\n"
              "   Query range: %d -> %d\n"
              "  Target range: %d -> %d\n\n" % (
                  query.id, " " if query.definition else "",
                  query.definition or "",
                  target.id, " " if target.definition else "",
                  target.definition or "",
                  alignment.model.name,
                  alignment.score,
                  alignment.coordinate(query, target, True, True, a),
                  alignment.coordinate(query, target, True, False, a),
                  alignment.coordinate(query, target, False, True, a),
                  alignment.coordinate(query, target, False, False, a)))
    d = _Displayer(alignment, query, target, data, a)
    d.prepare()
    return header + d.render()
