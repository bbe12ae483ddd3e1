"""Inputs whose best alignments cross split codons of both phases.

Shared by the K9 tests (``tests/test_torch_*.py``) and ``chip_smoke.py``;
everything is made in code from ``tests/golden/data/all4.fa`` (record 1
is calm, 2175 bp, CDS 0-based 103..552 = CALM_HUMAN, 149 aa) and a numpy
seed, as plain strings, so that each caller builds its own package's
sequences from them.

The split cuts: ``calm[:1200]`` cut into three exons at cDNA 251 and
402.  Those are CDS offsets 148 = 49 codons + 1 nt (a phase-1, "1:2"
intron, inside codon 49) and 299 = 99 codons + 2 nt (a phase-2, "2:1"
intron, inside codon 99).  The in-repo fixtures splice at phase 0
(cDNA 400) or phase 2 only (cDNA 150), so they cross no phase-1 split.
"""
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "data")
CDS = (103, 553)                 # calm's coding sequence, 0-based, end open
CUTS = (251, 402)                # exon junctions in calm[:1200]
# coding2genome picks its reading frame (any frame of identical DNA
# matches); on the small cDNA pair it picks the frame one base after the
# CDS's, so its pair is cut one base earlier to split codons of both phases
C2G_CUTS = (250, 401)
AAS = "ACDEFGHIKLMNPQRSTVWY"
_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def calm() -> str:
    with open(os.path.join(DATA, "all4.fa")) as fh:
        rec = fh.read()[1:].split("\n>")[0]
    return "".join(rec.split("\n")[1:]).upper()


def translate(dna: str) -> str:
    """The standard genetic code (NCBI table 1), codon by codon."""
    ix = {b: k for k, b in enumerate("TCAG")}
    return "".join(_CODE[16 * ix[dna[k]] + 4 * ix[dna[k + 1]]
                         + ix[dna[k + 2]]]
                   for k in range(0, len(dna) - 2, 3))


def calm_protein() -> str:
    """CALM_HUMAN: the translation of the CDS without its stop codon."""
    prot = translate(calm()[CDS[0]:CDS[1]])
    assert prot.endswith("*") and "*" not in prot[:-1]
    return prot[:-1]


def split_exons(cdna: str = None, cuts=CUTS) -> list:
    cdna = cdna if cdna is not None else calm()[:1200]
    edges = (0,) + tuple(cuts) + (len(cdna),)
    return [cdna[a:b] for a, b in zip(edges, edges[1:])]


def _intron(rng, n: int) -> str:
    return "gt" + "".join(rng.choice(list("acgt"), n - 4)) + "ag"


def split_locus(seed: int = 17) -> str:
    """genome.fa's recipe with the split cuts: a 12 kb random background
    holding the three exons from 3000 on, joined by GT..AG introns of 400
    and 600 bp."""
    rng = np.random.default_rng(seed)
    bg = rng.choice(list("acgt"), 12000).tolist()
    pos = 3000
    exons = split_exons()
    for i, exon in enumerate(exons):
        bg[pos:pos + len(exon)] = list(exon)
        pos += len(exon)
        if i < len(exons) - 1:
            intron = _intron(rng, 400 + 200 * i)
            bg[pos:pos + len(intron)] = list(intron)
            pos += len(intron)
    return "".join(bg)


def scan_genome(cuts, n_genes: int = 8, n_queries: int = 16,
                length: int = 1_000_000, seed: int = 7):
    """benchmarks/genome_scan.py's recipe: ``n_genes`` copies of
    calm[:1200] cut into three exons at ``cuts`` with 200-1200 bp GT..AG
    introns, ~1% mutated, in a random genome of ``length``; and
    ``n_queries`` cDNAs with ~2% mutations.  Returns (queries, genome)."""
    rng = np.random.default_rng(seed)
    cdna = calm()[:1200]
    exons = split_exons(cdna, cuts)
    genome = rng.choice(list("acgt"), length).tolist()
    spacing = length // (n_genes + 1)
    for g in range(n_genes):
        pos = spacing * (g + 1)
        for i, exon in enumerate(exons):
            ex = list(exon)
            for _ in range(len(ex) // 100):
                ex[rng.integers(0, len(ex))] = rng.choice(list("ACGT"))
            genome[pos:pos + len(ex)] = ex
            pos += len(ex)
            if i < len(exons) - 1:
                ilen = int(rng.integers(200, 1200))
                genome[pos:pos + ilen] = (["g", "t"] + rng.choice(
                    list("acgt"), ilen - 4).tolist() + ["a", "g"])
                pos += ilen
    queries = []
    for _ in range(n_queries):
        q = list(cdna)
        for _ in range(len(q) // 50):
            q[rng.integers(0, len(q))] = rng.choice(list("ACGT"))
        queries.append("".join(q))
    return queries, "".join(genome)


def two_copy_locus(query: str, gap: int, length: int, start: int,
                   seed: int = 11) -> str:
    """A genomic window of ``length`` random bases holding two spliced
    copies of ``query``, for Waterman-Eggert re-runs: each copy cut into
    three exons at thirds, about 1% of each exon's bases redrawn, the
    six exons interleaved from ``start`` on (copy 1 exon 1, copy 2 exon
    1, copy 1 exon 2, ...) ``gap`` bases apart, each gap GT..AG.  So each
    copy's introns hold the other copy's exon, and each copy's box holds
    cells of the other's path."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("acgt"), length).tolist()
    third = len(query) // 3
    exons = [query[:third], query[third:2 * third], query[2 * third:]]
    pos = start
    for k in range(6):
        ex = list(exons[k // 2])
        for _ in range(max(1, len(ex) // 100)):
            ex[rng.integers(0, len(ex))] = rng.choice(list("ACGT"))
        genome[pos:pos + len(ex)] = ex
        pos += len(ex)
        if k < 5:
            genome[pos:pos + gap] = (["g", "t"] + rng.choice(
                list("acgt"), gap - 4).tolist() + ["a", "g"])
            pos += gap
    assert pos <= length
    return "".join(genome)


def chromosome_locus(query: str, length: int = 1_200_000,
                     starts=(300_000, 800_000), intron: int = 3125,
                     seed: int = 23) -> str:
    """A chromosome-scale target for ``-E yes`` (kernel K2): ``length``
    random bases holding, at each of ``starts``, one spliced copy of
    ``query`` (three exons at thirds, about 1% of each exon's bases
    redrawn, joined by GT..AG introns of ``intron`` bp), the copies apart.
    With calm and the default introns each copy spans 8,425 bp, as in
    ``two_copy_locus``, so that its box (18.3 M cells) stays over the
    16 M cells up to which a masked path DP runs on the host."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("acgt"), length).tolist()
    third = len(query) // 3
    exons = [query[:third], query[third:2 * third], query[2 * third:]]
    for pos in starts:
        for k, exon in enumerate(exons):
            ex = list(exon)
            for _ in range(max(1, len(ex) // 100)):
                ex[rng.integers(0, len(ex))] = rng.choice(list("ACGT"))
            genome[pos:pos + len(ex)] = ex
            pos += len(ex)
            if k < 2:
                genome[pos:pos + intron] = (["g", "t"] + rng.choice(
                    list("acgt"), intron - 4).tolist() + ["a", "g"])
                pos += intron
        assert pos <= length
    return "".join(genome)


def mutated_proteins(n: int = 8, seed: int = 13) -> list:
    """tools/refbuild/bench_baseline.py's p2g queries: copies of
    CALM_HUMAN with one residue in 20 redrawn."""
    rng = np.random.default_rng(seed)
    prot = calm_protein()
    out = []
    for _ in range(n):
        p = list(prot)
        for _ in range(len(p) // 20):
            p[int(rng.integers(0, len(p)))] = str(rng.choice(list(AAS)))
        out.append("".join(p))
    return out


# the cDNA of small_pair("cdna"): calm 181..481, in the CDS's frame
# (181 = 103 + 26 codons), so that its own codons split at both cuts;
# cdna2genome needs it annotated as coding, cds_start 0, length 300
SMALL_CDNA = (181, 481)


def small_pair(kind: str, seed: int = 5, cuts=CUTS, flank: int = 40):
    """A small (query, target) pair for the CPU tests, cut like the
    split cuts: ``kind`` "protein" gives calm residues 30..119 (codons
    49 and 99 are split) against a genomic stretch of their three exon
    pieces with 70- and 90-bp GT..AG introns; "cdna" gives the cDNA
    ``SMALL_CDNA`` (a phase-1 split 70 bp in, a phase-2 split 221 bp in)
    against the same kind of stretch.  Flanks are random, ``flank`` bp
    on each side."""
    rng = np.random.default_rng(seed)
    c = calm()
    if kind == "protein":
        lo, hi = CDS[0] + 3 * 30, CDS[0] + 3 * 120
        query = calm_protein()[30:120]
    else:
        lo, hi = SMALL_CDNA
        query = c[lo:hi]
    pieces = [c[lo:cuts[0]], c[cuts[0]:cuts[1]], c[cuts[1]:hi]]
    flank = "".join(rng.choice(list("acgt"), flank))
    target = (flank + pieces[0] + _intron(rng, 70) + pieces[1]
              + _intron(rng, 90) + pieces[2] + flank[::-1])
    return query, target


def small_exons(kind: str, cuts=CUTS, flank: int = 40) -> list:
    """The exon pieces of ``small_pair(kind, cuts=cuts)``: per piece
    (query start, target start, whole codons) of its first whole codon in
    the frame that splits ``cuts[0]`` at phase 1 (query start in residues
    for "protein", in bases for "cdna")."""
    if kind == "protein":
        lo, hi = CDS[0] + 3 * 30, CDS[0] + 3 * 120
    else:
        lo, hi = SMALL_CDNA
    edges = (lo, cuts[0], cuts[1], hi)
    frame = (cuts[0] - 1) % 3
    out, tpos = [], flank
    for k in range(3):
        a, b = edges[k], edges[k + 1]
        p = a + (frame - a) % 3
        q0 = (p - lo) // 3 if kind == "protein" else p - lo
        out.append((q0, tpos + p - a, (b - p) // 3))
        tpos += (b - a) + (70 if k == 0 else 90)
    return out


def write_fasta(path: str, records) -> str:
    """Write (name, sequence) records to ``path``; returns the path."""
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for k in range(0, len(seq), 60):
                fh.write(seq[k:k + 60] + "\n")
    return path
