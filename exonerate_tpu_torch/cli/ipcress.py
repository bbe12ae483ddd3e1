"""ipcress: In-silico PCR Experiment Simulation System
(ref: src/program/ipcress.c, src/comparison/pcr.{h,c}).

Primer probes (seed-length prefixes expanded to a mismatch neighbourhood
over IUPAC codes) are matched against each target with the vectorized
packed-word scan; probe hits stream in position order through the
reference's sliding product-window pairing.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..alphabet import COMPLEMENT, TO_UPPER
from ..seqio import FastaDB, Sequence
from ..submat import Submat
from . import args as A

_IUPAC = Submat.create("iupac-identity")


def _iupac_match(a: int, b: int) -> bool:
    return _IUPAC.lookup(a, b) > 0


def _revcomp_str(s: str) -> str:
    arr = np.frombuffer(s.encode(), dtype=np.uint8)
    return COMPLEMENT[arr[::-1]].tobytes().decode()


@dataclass
class Probe:
    primer: "Primer"
    word: str
    strand: str            # '+' forward, '-' revcomp
    mismatch: int          # mismatches already inside the probe word
    order: int = 0


@dataclass
class Primer:
    experiment: "Experiment"
    seq: str               # uppercase primer, 5'->3'
    probe_len: int
    which: str             # 'A' | 'B'

    @property
    def length(self):
        return len(self.seq)

    @property
    def revcomp(self):
        return _revcomp_str(self.seq)


@dataclass
class Experiment:
    id: str
    primer_a: Primer = None
    primer_b: Primer = None
    min_len: int = 0
    max_len: int = 0
    matches: list = field(default_factory=list)  # sliding queue
    product_count: int = 0


@dataclass
class Match:
    probe: Probe
    position: int
    mismatch: int


def _expand_probes(primer: Primer, mismatches: int) -> list[Probe]:
    """Neighbourhood of the seed prefix within the mismatch budget
    (ref: PCR_Primer_create + WordHood over iupac-identity,
    pcr.c:228-252)."""
    seed = primer.seq[:primer.probe_len]
    out: list[Probe] = []

    def dfs(pos: int, word: str, mm: int):
        if pos == len(seed):
            out.append(Probe(primer, word, "+", mm))
            out.append(Probe(primer, _revcomp_str(word), "-", mm))
            return
        for base in "ACGT":
            hit = _iupac_match(ord(seed[pos]), ord(base))
            nmm = mm + (0 if hit else 1)
            if nmm <= mismatches:
                dfs(pos + 1, word + base, nmm)

    dfs(0, "", 0)
    return out


class PCR:
    """(ref: PCR, pcr.h:80-108)."""

    def __init__(self, report_func, mismatches: int = 0,
                 seed_length: int = 12):
        self.report_func = report_func
        self.mismatches = mismatches
        self.seed_length = seed_length
        self.experiments: list[Experiment] = []
        self.probes_by_len: dict[int, dict[str, list[Probe]]] = {}
        self._order = 0

    def add_experiment(self, eid, primer_a, primer_b, min_len, max_len):
        exp = Experiment(eid, min_len=min_len, max_len=max_len)
        for which, p in (("A", primer_a), ("B", primer_b)):
            p = p.upper()
            plen = (min(self.seed_length, len(p)) if self.seed_length
                    else len(p))
            primer = Primer(exp, p, plen, which)
            if which == "A":
                exp.primer_a = primer
            else:
                exp.primer_b = primer
            for probe in _expand_probes(primer, self.mismatches):
                probe.order = self._order
                self._order += 1
                self.probes_by_len.setdefault(
                    len(probe.word), {}).setdefault(
                        probe.word, []).append(probe)
        self.experiments.append(exp)

    def simulate(self, sequence: Sequence, out):
        up = TO_UPPER[sequence.data]
        n = len(up)
        hits: list[tuple[int, int, Probe]] = []
        for wlen, words in self.probes_by_len.items():
            if n < wlen:
                continue
            # vectorized window join over 2-bit codes
            codes = np.full(256, -1, dtype=np.int64)
            for k, ch in enumerate("ACGT"):
                codes[ord(ch)] = k
            code = codes[up]
            valid = code >= 0
            csum = np.concatenate([[0], np.cumsum(~valid)])
            win_ok = (csum[wlen:] - csum[:-wlen]) == 0
            packed = np.zeros(n - wlen + 1, dtype=np.int64)
            safe = np.where(valid, code, 0)
            for k in range(wlen):
                packed = packed * 4 + safe[k:n - wlen + 1 + k]
            word_keys = {}
            for w, plist in words.items():
                wp = 0
                for ch in w:
                    wp = wp * 4 + codes[ord(ch)]
                word_keys.setdefault(wp, []).extend(plist)
            starts = np.nonzero(win_ok)[0]
            found = packed[starts]
            for st, wp in zip(starts, found):
                plist = word_keys.get(int(wp))
                if plist:
                    end = int(st) + wlen - 1
                    for probe in plist:
                        hits.append((end, probe.order, probe))
        hits.sort(key=lambda h: (h[0], h[1]))
        for exp in self.experiments:
            exp.matches = []
        for end, _order, probe in hits:
            self._register_hit(probe, sequence, up, end, out)

    def _register_hit(self, probe: Probe, sequence: Sequence,
                      up: np.ndarray, seq_pos: int, out):
        """(ref: PCR_Probe_register_hit, pcr.c:67-144)."""
        primer = probe.primer
        exp = primer.experiment
        wlen = len(probe.word)
        if probe.strand == "+":
            match_start = seq_pos - wlen + 1
        else:
            match_start = seq_pos - primer.length + 1
        if match_start < 0:
            return
        if match_start + primer.length > len(up):
            return
        mismatch = probe.mismatch
        # extension counts exact symbol mismatches (ref: pcr.c:88-107)
        if probe.strand == "+":
            rest = primer.seq[wlen:]
            for k, ch in enumerate(rest):
                if ord(ch) != int(up[match_start + wlen + k]):
                    mismatch += 1
                    if mismatch > self.mismatches:
                        return
        else:
            rc = primer.revcomp
            lead = primer.length - wlen
            for k in range(lead):
                if ord(rc[k]) != int(up[match_start + k]):
                    mismatch += 1
                    if mismatch > self.mismatches:
                        return
        # pop matches now out of range
        while exp.matches:
            prev = exp.matches[0]
            product_length = match_start - prev.position + primer.length
            if product_length <= exp.max_len:
                break
            exp.matches.pop(0)
        match = Match(probe, match_start, mismatch)
        for prev in exp.matches:
            product_length = match_start - prev.position + primer.length
            if product_length < exp.min_len:
                break
            if (prev.probe.strand != probe.strand
                    and prev.probe.strand == "+"
                    and probe.strand == "-"):
                self.report_func(sequence, prev, match, product_length,
                                 out)
        exp.matches.append(match)


def _ipcress_type(match_a: Match, match_b: Match) -> str:
    pa = match_a.probe.primer
    pb = match_b.probe.primer
    if pa.which == "A":
        return "forward" if pb.which == "B" else "single_A"
    return "revcomp" if pb.which == "A" else "single_B"


def build_parser():
    p = A.ArgumentParser("ipcress",
                         "In-silico PCR Experiment Simulation System")
    aset = A.ArgumentSet("File Input Options")
    aset.add("i", "input", "path", "Primer data in IPCRESS file format",
             None, A.parse_string, "input")
    aset.add("s", "sequence", "paths", "Fasta format sequence database",
             None, A.parse_string, "sequence")
    p.add_set(aset)
    params = A.ArgumentSet("PCR Simulation Parameters")
    params.add("m", "mismatch", "mismatches",
               "number of mismatches allowed per primer", "0",
               A.parse_int, "mismatch")
    params.add("M", "memory", "Mb", "Memory limit for FSM data", "32",
               A.parse_int, "memory")
    params.add("p", "pretty", None, "Include 'pretty' output", "TRUE",
               A.parse_boolean, "pretty")
    params.add("S", "seed", None, "Seed length (use zero for full length)",
               "12", A.parse_int, "seed")
    params.add("P", "products", None, "Report PCR products", "FALSE",
               A.parse_boolean, "products")
    p.add_set(params)
    return p


def main(argv=None, out=None):
    argv = argv if argv is not None else sys.argv[1:]
    out = out or sys.stdout
    v = build_parser().parse(argv)
    pos = v.get("_positional", [])
    ipcress_path = v["input"] or (pos[0] if pos else None)
    seq_paths = [v["sequence"]] if v["sequence"] else pos[1:]
    if not ipcress_path or not seq_paths:
        raise SystemExit("ipcress: need an ipcress file and sequences")

    display_pretty = v["pretty"]
    display_products = v["products"]

    def report(sequence, match_a, match_b, product_length, out):
        pa = match_a.probe.primer
        pb = match_b.probe.primer
        exp = pa.experiment
        desc = _ipcress_type(match_a, match_b)
        if display_pretty:
            _print_pretty(out, sequence, exp, match_a, match_b,
                          product_length, desc)
        out.write("ipcress: %s %s %d %c %d %d %c %d %d %s\n" % (
            sequence.id, exp.id, product_length,
            pa.which[0], match_a.position, match_a.mismatch,
            pb.which[0], match_b.position, match_b.mismatch,
            desc))
        if display_products:
            exp.product_count += 1
            sub = sequence.data[match_a.position:
                                match_a.position + product_length]
            if desc == "revcomp":
                sub = COMPLEMENT[sub[::-1]]
            out.write(">%s_product_%d seq %s start %d length %d\n" % (
                exp.id, exp.product_count, sequence.id,
                match_a.position, product_length))
            s = sub.tobytes().decode()
            for k in range(0, max(len(s), 1), 70):
                out.write(s[k:k + 70] + "\n")

    pcr = PCR(report, v["mismatch"], v["seed"])
    with open(ipcress_path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            eid, pa, pb, mn, mx = (parts[0], parts[1], parts[2],
                                   int(parts[3]), int(parts[4]))
            pcr.add_experiment(eid, pa, pb, mn, mx)
    for seq in FastaDB(seq_paths):
        # reference scans an UNMASKED (TO_UPPER) filter view, which
        # renames the id (ref: ipcress.c:298, sequence.c:453-460)
        from ..seqio import Sequence as _S
        filt = _S(seq.id + ":filter(unmasked)", seq.definition,
                  TO_UPPER[seq.data], seq.alphabet, seq.strand)
        pcr.simulate(filt, out)
    out.write("-- completed ipcress analysis\n")
    return 0


def _print_pretty(out, sequence, exp, match_a, match_b, product_length,
                  desc):
    """(ref: ipcress.c:126-194)."""
    pa = match_a.probe.primer
    pb = match_b.probe.primer
    up = TO_UPPER[sequence.data]
    out.write("\nIpcress result\n--------------\n")
    out.write(" Experiment: %s\n" % exp.id)
    out.write("    Primers: %c %c\n" % (pa.which[0], pb.which[0]))
    out.write("     Target: %s%s%s\n" % (
        sequence.id, " " if sequence.definition else "",
        sequence.definition or ""))
    out.write("    Matches: %d/%d %d/%d\n" % (
        pa.length - match_a.mismatch, pa.length,
        pb.length - match_b.mismatch, pb.length))
    out.write("    Product: %d bp (range %d-%d)\n" % (
        product_length, exp.min_len, exp.max_len))
    out.write("Result type: %s\n\n" % desc)
    seg_a = sequence.data[match_a.position:
                          match_a.position + pa.length].tobytes().decode()
    out.write("...%s.......%s... # forward\n" % (
        seg_a, "." * pb.length))
    bar_a = "".join("|" if pa.seq[i] == chr(up[match_a.position + i])
                    else " " for i in range(pa.length))
    out.write("   %s-->\n" % bar_a)
    out.write("5'-%s-3' 3'-%s-5' # primers\n" % (pa.seq, pb.seq[::-1]))
    rc_b = pb.revcomp
    bar_b = "".join("|" if rc_b[i] == chr(up[match_b.position + i])
                    else " " for i in range(pb.length))
    out.write("   %s    <--%s\n" % (" " * pa.length, bar_b))
    comp = COMPLEMENT[sequence.data[match_b.position:
                                    match_b.position + pb.length]]
    out.write("...%s.......%s... # revcomp\n--\n" % (
        "." * pa.length, comp.tobytes().decode()))


if __name__ == "__main__":
    sys.exit(main())
