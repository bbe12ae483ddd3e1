"""protein2genome ``-E yes`` on the port against the plain reference.

Seeded random proteins of 40-80 residues, cut into 3-4 exons joined by
introns of phases 0, 1 and 2 (60-300 bp), 10% of the residues substituted,
in 1.5-3 kb windows on either strand, run through
``exonerate_tpu_torch.cli.exonerate.main`` with the flags of the benchmark
cell ``p2g.exh_locus`` on the CPU, two ways: on the wavefront kernels'
route (``optimal.NATIVE_TPU_CELLS`` lowered, so the plain K1 and K4 run)
and on the default route (the native dense DP at these sizes).  The
printed best score must equal ``portbench/reference/p2g_viterbi.py``'s
optimum over both strands, and the benchmark's judge must rescore each
printed path to its printed score.  The control: the reference with the
split codons left out reads a lower optimum on every case, so the
comparison would catch a split codon the program left out.
"""
import ast
import io
import os
import sys

import numpy as np
import pytest

import exonerate_tpu_torch
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.cli.exonerate import main
from exonerate_tpu_torch.engine import optimal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.reference import judge, p2g_viterbi  # noqa: E402
from portbench.reference import tables as tb  # noqa: E402

ARGV = ["-m", "protein2genome", "-E", "yes", "--bestn", "1",
        "--showvulgar", "yes", "--showalignment", "no"]


def _case(k: int):
    """(protein, window, intron phases) of case ``k``: a gene planted in
    a random window, on the reverse strand for odd ``k``."""
    r = np.random.default_rng([20261018, k])
    aa = int(r.integers(40, 81))
    protein = "".join(tb.AMINO_ACIDS[i] for i in r.integers(0, 20, aa))
    cds = "".join(r.choice(tb.AA_CODONS[a]) for a in protein)
    n_exons = 3 + k % 2
    phases = r.permutation([1, 2, 0][:n_exons - 1]).tolist()
    codons = np.sort(r.choice(np.arange(4, aa - 4), n_exons - 1,
                              replace=False))
    cuts = [3 * int(c) + p for c, p in zip(codons, phases)]
    edges = [0] + cuts + [len(cds)]
    gene = ""
    for a, b in zip(edges, edges[1:]):
        gene += cds[a:b].upper()
        if b < len(cds):
            size = int(r.integers(60, 301))
            gene += "gt" + "".join(r.choice(list("acgt"), size - 4)) + "ag"
    window = int(r.integers(1500, 3001))
    at = int(r.integers(50, window - len(gene) - 50))
    dna = list("".join(r.choice(list("acgt"), window)))
    dna[at:at + len(gene)] = gene
    dna = "".join(dna)
    if k % 2:
        dna = tb.revcomp(dna)
    query = list(protein)
    for i in r.choice(aa, aa // 10, replace=False):
        query[i] = r.choice([a for a in tb.AMINO_ACIDS if a != query[i]])
    return "".join(query), dna, phases


CASES = [_case(k) for k in range(4)]


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")


def _printed(query: str, target: str, tmp_path) -> str:
    qf, tf = tmp_path / "q.fa", tmp_path / "t.fa"
    qf.write_text(f">q\n{query}\n")
    tf.write_text(f">t\n{target}\n")
    buf = io.StringIO()
    assert main(ARGV + [str(qf), str(tf)], out=buf) == 0
    return buf.getvalue()


@pytest.mark.parametrize("route", ["kernels", "default"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_printed_best_is_the_reference_optimum(cpu_device, monkeypatch,
                                               tmp_path, case, route):
    query, target, phases = CASES[case]
    assert {1, 2} <= set(phases)
    if route == "kernels":
        monkeypatch.setattr(optimal, "NATIVE_TPU_CELLS", 10_000)
    observe.reset()
    text = _printed(query, target, tmp_path)
    if route == "kernels":
        assert observe.engine_counts["torch-wavefront"] >= 2
    assert not observe.fallback_counts
    found = judge.parse_vulgar(text)
    assert found, text
    for a in found:
        assert judge.path_score("protein2genome", query, target, a,
                                200000) == a.score, text
    best = p2g_viterbi.best(query, target)
    strand = "-" if case % 2 else "+"
    assert max(a.score for a in found) == max(e.score for e in best.values())
    assert best[strand].score > best["+" if case % 2 else "-"].score
    ops = {op[0] for a in found for op in a.ops}
    assert "S" in ops and "I" in ops, text


@pytest.mark.parametrize("case", range(len(CASES)))
def test_the_reference_without_split_codons_reads_lower(case):
    query, target, _ = CASES[case]
    whole = p2g_viterbi.best(query, target)
    phase0 = p2g_viterbi.best(query, target, split_codons=False)
    assert max(e.score for e in phase0.values()) < \
        max(e.score for e in whole.values())


def test_the_reference_imports_nothing_of_the_program():
    for name in ("p2g_viterbi.py", "tables.py"):
        path = os.path.join(ROOT, "portbench", "reference", name)
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = ({node.module.split(".")[0]} if not node.level
                        else {"." + (node.module or a.name)
                              for a in node.names})
            else:
                continue
            assert tops <= {"__future__", "dataclasses", "numpy", "torch",
                            ".tables"}, (name, tops)
