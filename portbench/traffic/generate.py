"""The one traffic generator: reads a mix's parameters (a ``.json`` file
beside this one) and makes, from the run's seed, the target and the
queries of every invocation, with the paths along which it planted each
query's copies in the target.

Every seed draws the same parts in another order, so that seeds change
the order and the mutations, not the amount of work: a scan's genome is
one fixed genome (made from the library seed below) rotated by an offset
of the seed's, cut between two genes; what each invocation sends (its
queries' mutations and order, the locus windows) is drawn from the seed.
Sequences are upper-case where planted, lower-case elsewhere, A/C/G/T.

Recipes (``"recipe"`` in the mix's file):

- ``cdna_scan``: a genome of ``genome_bp`` random bases (``gc_pct`` % G+C)
  holding ``genes`` distinct genes, one copy each, alternately on the
  forward and the reverse strand, spaced evenly.  Each gene's exon count,
  exon lengths, UTRs and introns are the mid-quantiles of lognormals with
  the medians and means given (``exons``, ``exon_bp``, ``utr5_bp`` added
  to the first exon, ``utr3_bp`` to the last, ``intron_bp``), shuffled
  among the genes; introns are GT..AG.  Each invocation sends every
  gene's cDNA (its exons joined) with ``query_redraw`` bases in 100
  redrawn, in an order of the seed's;
- ``protein_scan``: a random genome holding ``genes`` protein-coding
  genes: random proteins of ``protein_aa`` residues, back-translated with
  random synonymous codons, in ``exons`` exons joined by GT..AG introns
  from ``intron_bp`` whose phases (0, 1, 2) all occur in every gene;
  each invocation sends every protein with ``query_sub_pct`` % of its
  residues substituted;
- ``two_copy_locus``: per invocation one pair: ``data/calm.fa`` (its
  first ``query_bp`` bases where given) with ``query_redraw`` bases in
  100 redrawn, against a fresh ``window_bp`` window holding two
  interleaved spliced copies of it, a gene and its paralog (each cut
  into exons at thirds, ``copy_redraw[c]`` bases in 100 of copy c
  redrawn, the six exons ``gap`` bases apart from ``start`` on, each gap
  GT..AG; after tests/torch_split_cases.py's ``two_copy_locus``).
"""
from __future__ import annotations

import json
import math
import os
from statistics import NormalDist
from dataclasses import dataclass, field

import numpy as np

from ..reference import tables as tb
from ..reference.judge import Alignment

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "data")
_LOWER = np.frombuffer(b"acgt", np.uint8)
_UPPER = "ACGT"


def load(name: str) -> dict:
    with open(os.path.join(HERE, name + ".json")) as fh:
        return json.load(fh)


def read_fasta(path: str) -> str:
    with open(os.path.join(DATA, path)) as fh:
        return "".join(ln.strip() for ln in fh if not ln.startswith(">"))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, *stream])


LIBRARY = 20261018             # the seed of the parts every seed shares


def _rotated(rng, genome: list, starts: list):
    """``genome`` rotated by an offset of ``rng``'s, 1 kb before one of
    the genes that start at ``starts``, and the starts moved with it."""
    off = sorted(starts)[int(rng.integers(0, len(starts)))] - 1000
    n = len(genome)
    return "".join(genome[off:] + genome[:off]), [(s - off) % n
                                                    for s in starts]


def _random_dna(rng, n: int, gc_pct: float = None) -> list:
    """``n`` random bases, ``gc_pct`` % of them G or C where given, else
    uniform."""
    if gc_pct is None:
        idx = rng.integers(0, 4, n)
    else:
        at, gc = (100 - gc_pct) / 200, gc_pct / 200
        idx = rng.choice(4, n, p=[at, gc, gc, at])
    return list(_LOWER[idx].tobytes().decode())


def _lognormal(rng, d: dict, n: int) -> list:
    """``n`` whole lengths at the mid-quantiles of the lognormal with
    ``d``'s median and mean (at least ``d["least"]``), in ``rng``'s
    order."""
    sigma = math.sqrt(2 * math.log(d["mean"] / d["median"]))
    z = (NormalDist().inv_cdf((k + 0.5) / n) for k in range(n))
    return rng.permutation([max(d.get("least", 1),
                                round(d["median"] * math.exp(sigma * x)))
                            for x in z]).tolist()


def _redraw(rng, seq: str, per_100: float) -> str:
    """``len(seq) * per_100 / 100`` bases redrawn from A/C/G/T."""
    s = list(seq)
    for _ in range(int(len(s) * per_100 / 100)):
        s[rng.integers(0, len(s))] = _UPPER[rng.integers(0, 4)]
    return "".join(s)


def _intron(rng, n: int, gc_pct: float = None) -> list:
    return ["g", "t"] + _random_dna(rng, n - 4, gc_pct) + ["a", "g"]


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, n)).astype(int)


def _spliced_ops(exons: list, introns: list) -> list:
    """A gapless spliced path: each exon ``(query advance, target
    advance)`` a match, each intron of length L ``5 0 2, I 0 L-4, 3 0 2``."""
    ops = []
    for k, (qa, ta) in enumerate(exons):
        ops.append(("M", qa, ta))
        if k < len(introns):
            ops += [("5", 0, 2), ("I", 0, introns[k] - 4), ("3", 0, 2)]
    return ops


@dataclass
class Invocation:
    query_file: str
    target_file: str
    queries: dict                  # id -> sequence
    targets: dict                  # id -> sequence
    planted: dict                  # query id -> [Alignment]
    units: int                     # queries or pairs this invocation sends


@dataclass
class Traffic:
    mode: str                      # the configuration's argv to use
    invocations: list = field(default_factory=list)


def _write(path: str, records: dict) -> str:
    with open(path, "w") as fh:
        for name, seq in records.items():
            fh.write(f">{name}\n")
            for k in range(0, len(seq), 80):
                fh.write(seq[k:k + 80] + "\n")
    return path


def _cdna_scan(p: dict, seed: int, workdir: str, n_inv: int) -> list:
    lib = rng_for(LIBRARY, 0)
    genes, gc = p["genes"], p["gc_pct"]
    n_exons = _lognormal(lib, {"least": 2, **p["exons"]}, genes)
    exon_bp = iter(_lognormal(lib, p["exon_bp"], sum(n_exons)))
    intron_bp = iter(_lognormal(lib, p["intron_bp"], sum(n_exons) - genes))
    utr5 = _lognormal(lib, p["utr5_bp"], genes)
    utr3 = _lognormal(lib, p["utr3_bp"], genes)
    cdnas, loci = {}, []            # loci: (gene, exon lengths, introns)
    for g in range(genes):
        ex = [next(exon_bp) for _ in range(n_exons[g])]
        ex[0] += utr5[g]
        ex[-1] += utr3[g]
        lens = [next(intron_bp) for _ in range(n_exons[g] - 1)]
        cdna = "".join(_random_dna(lib, sum(ex), gc)).upper()
        body, at = [], 0
        for k, n in enumerate(ex):
            body.append(cdna[at:at + n])
            at += n
            if k < len(lens):
                body.append("".join(_intron(lib, lens[k], gc)))
        cdnas[f"g{g}"] = cdna
        loci.append(("".join(body), ex, lens))
    free = p["genome_bp"] - sum(len(b) for b, _, _ in loci)
    space = free // (genes + 1)
    if space < 2000:
        raise ValueError(f"{genes} genes do not fit {p['genome_bp']} bp")
    genome = _random_dna(lib, p["genome_bp"], gc)
    pos, starts = 0, []
    for g, (body, _, _) in enumerate(loci):
        pos += space
        starts.append(pos)
        genome[pos:pos + len(body)] = (body if g % 2 == 0
                                       else tb.revcomp(body))
        pos += len(body)
    genome, starts = _rotated(rng_for(seed, 0), genome, starts)
    target = {"genome": genome}
    tfile = _write(os.path.join(workdir, "genome.fa"), target)
    out = []
    for k in range(n_inv):
        r = rng_for(seed, 1, k)
        qs, planted = {}, {}
        for g in r.permutation(genes).tolist():
            qid = f"g{g}_{k}"
            qs[qid] = _redraw(r, cdnas[f"g{g}"], p["query_redraw"])
            body, ex, lens = loci[g]
            s, e, strand = starts[g], starts[g] + len(body), "+"
            if g % 2:
                s, e, strand = e, s, "-"
            planted[qid] = [Alignment(
                qid, 0, len(qs[qid]), "+", "genome", s, e, strand, 0,
                _spliced_ops([(n, n) for n in ex], lens))]
        qfile = _write(os.path.join(workdir, f"q{k}.fa"), qs)
        out.append(Invocation(qfile, tfile, qs, target, planted, len(qs)))
    return out


def _gene(rng, aa: int, n_exons: int):
    """A random protein of ``aa`` residues and its CDS cut into
    ``n_exons`` exons, the cuts' phases 0, 1 and 2 in turn, permuted."""
    protein = "".join(tb.AMINO_ACIDS[i] for i in rng.integers(0, 20, aa))
    cds = "".join(rng.choice(tb.AA_CODONS[a]) for a in protein)
    phases = rng.permutation([k % 3 for k in range(n_exons - 1)]).tolist()
    cuts = []
    for m in range(1, n_exons):
        base = len(cds) * m // n_exons
        jitter = int(rng.integers(-len(cds) // (5 * n_exons),
                                  len(cds) // (5 * n_exons) + 1))
        cuts.append(3 * ((base + jitter) // 3) + phases[m - 1])
    bounds = [0] + cuts + [len(cds)]
    return protein, [cds[a:b] for a, b in zip(bounds, bounds[1:])]


def _protein_ops(exons: list, introns: list) -> list:
    """The planted path of a protein over its gene: codon matches, a
    split codon (``S``) around each intron of phase 1 or 2."""
    ops = []
    carry = 0                              # codon bases before the intron
    for k, exon in enumerate(exons):
        n = len(exon)
        if carry:
            ops.append(("S", 1, 3 - carry))
            n -= 3 - carry
        if n // 3:
            ops.append(("M", n // 3, 3 * (n // 3)))
        carry = n % 3
        if k < len(introns):
            if carry:
                ops.append(("S", 0, carry))
            ops += [("5", 0, 2), ("I", 0, introns[k] - 4), ("3", 0, 2)]
    return ops


def _protein_scan(p: dict, seed: int, workdir: str, n_inv: int) -> list:
    lib = rng_for(LIBRARY, 1)
    genes = p["genes"]
    lengths = lib.permutation(_spread(*p["protein_aa"], genes)).tolist()
    n_exons = lib.permutation(_spread(*p["exons"], genes)).tolist()
    introns = lib.permutation(_spread(*p["intron_bp"],
                                      sum(n_exons) - genes)).tolist()
    genome = _random_dna(lib, p["genome_bp"])
    spacing = p["genome_bp"] // (genes + 1)
    proteins, genes_at = {}, []
    for g in range(genes):
        lens = introns[sum(n_exons[:g]) - g:sum(n_exons[:g + 1]) - g - 1]
        protein, exons = _gene(lib, lengths[g], n_exons[g])
        pos = start = spacing * (g + 1)
        for k, exon in enumerate(exons):
            genome[pos:pos + len(exon)] = exon
            pos += len(exon)
            if k < len(lens):
                genome[pos:pos + lens[k]] = _intron(lib, lens[k])
                pos += lens[k]
        proteins[f"p{g}"] = protein
        genes_at.append((start, pos - start, _protein_ops(exons, lens)))
    genome, starts = _rotated(rng_for(seed, 0), genome,
                              [g[0] for g in genes_at])
    planted_at = {f"p{g}": (starts[g], starts[g] + span, ops)
                  for g, (_, span, ops) in enumerate(genes_at)}
    target = {"genome": genome}
    tfile = _write(os.path.join(workdir, "genome.fa"), target)
    out = []
    for k in range(n_inv):
        r = rng_for(seed, 1, k)
        qs, planted = {}, {}
        for name in r.permutation(sorted(proteins)).tolist():
            prot = list(proteins[name])
            for i in r.choice(len(prot), round(len(prot)
                                               * p["query_sub_pct"] / 100),
                              replace=False):
                prot[i] = r.choice([a for a in tb.AMINO_ACIDS
                                    if a != prot[i]])
            qid = f"{name}_{k}"
            qs[qid] = "".join(prot)
            s, e, ops = planted_at[name]
            planted[qid] = [Alignment(qid, 0, len(prot), ".", "genome", s, e,
                                      "+", 0, ops)]
        qfile = _write(os.path.join(workdir, f"q{k}.fa"), qs)
        out.append(Invocation(qfile, tfile, qs, target, planted, len(qs)))
    return out


def _two_copy_locus(p: dict, seed: int, workdir: str, n_inv: int) -> list:
    calm = read_fasta(p["source"])[:p.get("query_bp")]
    third = len(calm) // 3
    exons = [calm[:third], calm[third:2 * third], calm[2 * third:]]
    gap = p["gap"]
    out = []
    for k in range(n_inv):
        r = rng_for(seed, 1, k)
        window = _random_dna(r, p["window_bp"])
        pos, starts = p["start"], []
        for m in range(6):
            ex = _redraw(r, exons[m // 2], p["copy_redraw"][m % 2])
            starts.append(pos)
            window[pos:pos + len(ex)] = ex
            pos += len(ex)
            if m < 5:
                window[pos:pos + gap] = _intron(r, gap)
                pos += gap
        qid, tid = f"calm_{k}", f"locus_{k}"
        qs = {qid: _redraw(r, calm, p["query_redraw"])}
        ts = {tid: "".join(window)}
        planted = []
        for c in range(2):
            at = starts[c::2]
            lens = [at[m + 1] - at[m] - len(exons[m]) for m in range(2)]
            planted.append(Alignment(
                qid, 0, len(calm), "+", tid, at[0], at[2] + len(exons[2]),
                "+", 0, _spliced_ops([(len(e), len(e)) for e in exons],
                                     lens)))
        out.append(Invocation(
            _write(os.path.join(workdir, f"q{k}.fa"), qs),
            _write(os.path.join(workdir, f"t{k}.fa"), ts),
            qs, ts, {qid: planted}, 1))
    return out


RECIPES = {"cdna_scan": _cdna_scan, "protein_scan": _protein_scan,
           "two_copy_locus": _two_copy_locus}


def make(name: str, seed: int, workdir: str, overrides: dict = None
         ) -> Traffic:
    """The mix ``traffic/<name>.json`` from ``seed``, its files written
    under ``workdir``; ``overrides`` replaces parameters (tests)."""
    p = {**load(name), **(overrides or {})}
    invs = RECIPES[p["recipe"]](p, seed, workdir, p["invocations"])
    return Traffic(p["mode"], invs)
