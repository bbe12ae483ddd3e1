"""CPU tests of the traffic generator, the reference's scoring and the
roofline's work counts.

    python -m pytest portbench/tests -q
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.reference import judge, tables  # noqa: E402
from portbench.traffic import generate  # noqa: E402
from portbench.work import roofline  # noqa: E402

MIXES = {"cdna16_genome1mb": {"genome_bp": 200_000, "genes": 4,
                             "intron_bp": {"median": 1000, "mean": 1500},
                             "invocations": 3},
         "protein8_genome1mb": {"genome_bp": 1_000_000, "invocations": 2},
         "calm_locus30kb": {"invocations": 2}}


def _make(name, seed, tmp_path):
    d = tmp_path / str(seed)
    d.mkdir(exist_ok=True)
    return generate.make(name, seed, str(d), MIXES[name])


@pytest.mark.parametrize("name", sorted(MIXES))
def test_a_seed_gives_the_same_inputs_and_another_the_same_sizes(
        name, tmp_path):
    a = _make(name, 2 ** 31 + 11, tmp_path)
    b = _make(name, 2 ** 31 + 11, tmp_path)
    c = _make(name, 5, tmp_path)
    for x, y, z in zip(a.invocations, b.invocations, c.invocations):
        assert x.queries == y.queries and x.targets == y.targets
        assert x.queries != z.queries
        assert x.units == z.units
    sizes = [sorted(len(s) for s in t.invocations[0].queries.values())
             for t in (a, c)]
    assert sizes[0] == sizes[1]
    spans = [sum(p.t_end - p.t_start for ps in t.invocations[0]
                 .planted.values() for p in ps) for t in (a, c)]
    assert spans[0] == spans[1]


def _introns(path, target):
    """The target on the path's strand, and (start, length) of each planted
    intron on it."""
    seq, j, _ = judge._oriented(target, path.t_start, path.t_end,
                                path.t_strand)
    out = []
    for label, qa, ta in path.ops:
        if label == "5":
            start = j
        if label == "3":
            out.append((start, j + 2 - start))
        j += ta
    return seq, out


@pytest.mark.parametrize("name", sorted(MIXES))
def test_the_planted_paths_are_what_the_recipe_says(name, tmp_path):
    t = _make(name, 3, tmp_path)
    p = {**generate.load(name), **MIXES[name]}
    inv = t.invocations[0]
    for qid, paths in inv.planted.items():
        for path in paths:
            target, introns = _introns(path, inv.targets[path.target])
            for start, length in introns:
                assert target[start:start + 2] == "gt"
                assert target[start + length - 2:start + length] == "ag"
                if isinstance(p.get("intron_bp"), list):
                    assert p["intron_bp"][0] <= length <= p["intron_bp"][1]
            s = judge.path_score(
                "protein2genome" if p["recipe"] == "protein_scan"
                else "est2genome", inv.queries[qid],
                inv.targets[path.target], path, 200_000)
            assert s is not None and s > 0
    if p["recipe"] == "protein_scan":
        for qid, (path,) in inv.planted.items():
            assert p["protein_aa"][0] <= len(inv.queries[qid]) \
                <= p["protein_aa"][1]
            labels = [o[0] for o in path.ops]
            assert p["exons"][0] - 1 <= labels.count("I") <= p["exons"][1] - 1
            carried = {o[2] for o in path.ops if o[0] == "S" and o[1] == 0}
            assert carried == {1, 2}        # phase 1 and phase 2 introns
            assert labels.count("I") > len(
                [o for o in path.ops if o[0] == "S"]) // 2   # and phase 0
            assert 10_000 <= path.t_end - path.t_start <= 80_000
    if p["recipe"] == "cdna_scan":
        genes = {qid.split("_")[0] for qid in inv.queries}
        assert len(genes) == len(inv.queries) == p["genes"]   # distinct
        assert all(len(paths) == 1 for paths in inv.planted.values())
        strands = [paths[0].t_strand for paths in inv.planted.values()]
        assert sorted(strands) == ["+", "+", "-", "-"]
        genome = inv.targets["genome"].upper()
        assert abs(sum(map(genome.count, "GC")) / len(genome) - 0.41) < 0.01
    if p["recipe"] == "two_copy_locus":
        (gene, paralog), = inv.planted.values()
        scores = [judge.path_score("est2genome", *inv.queries.values(),
                                   *inv.targets.values(), x, 200_000)
                  for x in (gene, paralog)]
        assert scores[0] > scores[1]        # the paralog diverged more


def test_the_planted_protein_is_the_gene_translated(tmp_path):
    t = _make("protein8_genome1mb", 4, tmp_path)
    inv = t.invocations[0]
    qid, (path,) = next(iter(inv.planted.items()))
    target, cds, j = inv.targets["genome"], "", path.t_start
    for label, qa, ta in path.ops:
        if label in "MS":
            cds += target[j:j + ta]
        j += ta
    protein = "".join(tables.translate(cds[k:k + 3])
                      for k in range(0, len(cds), 3))
    sub = sum(a != b for a, b in zip(protein, inv.queries[qid]))
    assert len(protein) == len(inv.queries[qid])
    assert sub == round(len(protein) * 0.10)


def test_path_score_by_hand():
    q, t = "ACGTACGTAC", "ACGTACGTTCxxgtaaaaaaaaaaaaaaaaaaaaaaaaaaaaagAC"
    aln = judge.Alignment("q", 0, 10, "+", "t", 0, 10, "+", 0,
                          [("M", 10, 10)])
    assert judge.path_score("est2genome", q, t, aln, 200_000) == 9 * 5 - 4
    gap = judge.Alignment("q", 0, 10, "+", "t", 0, 12, "+", 0,
                          [("M", 5, 5), ("G", 0, 2), ("M", 5, 5)])
    assert judge.path_score("est2genome", q, "ACGTAggCGTAC", gap,
                            200_000) == 50 - 12 - 4
    short = judge.Alignment("q", 0, 10, "+", "t", 0, 11, "+", 0,
                            [("M", 5, 5), ("5", 0, 2), ("I", 0, 0),
                             ("3", 0, 2), ("M", 5, 5)])
    assert judge.path_score("est2genome", q, "ACGTAgtagCGTAC", short,
                            200_000) is None           # a 4 bp intron
    pep = judge.Alignment("p", 0, 2, ".", "t", 0, 6, "+", 0, [("M", 2, 6)])
    assert judge.path_score("protein2genome", "MW", "ATGTGG", pep, 1) == \
        tables.BLOSUM62[12, 12] + tables.BLOSUM62[17, 17]


def test_splice_scores_by_hand():
    s5 = tables.SPLICE[("5", True)]
    seq = "CAGGTAAGT"
    # the consensus site scores each row's best column, G of GT at 3
    want = np.float32(0)
    for row, base in enumerate(seq):
        want = np.float32(want + s5.logodds[row, "ACGT".index(base)])
    assert s5.score(seq, 3) == int(float(want) + 0.5)
    assert s5.score("C" * 9, 3) < 0


def test_lognormal_lengths_have_the_median_and_mean_asked():
    d = {"median": 3365, "mean": 5419}
    v = generate._lognormal(np.random.default_rng(1), d, 2001)
    assert sorted(v)[1000] == 3365
    assert abs(np.mean(v) / 5419 - 1) < 0.02
    assert generate._lognormal(np.random.default_rng(1),
                               {"median": 7, "mean": 8.8, "least": 2},
                               16) != sorted(v)[:16]
    assert min(generate._lognormal(np.random.default_rng(1),
                                   {"median": 7, "mean": 8.8, "least": 2},
                                   16)) == 2


def test_work_counts_by_hand():
    assert roofline.dp_work(2, 3, 4) == (4 * 2 * 7, 2 * 12 * 4)
    n_bytes, n_ops = roofline.band_work([[2, 3], [1, 1]], 4)
    assert n_ops == 2 * 2 * (3 * 4 + 2 * 2) * 4
    assert n_bytes == 2 * 4 * 2 * ((2 + 3 + 2) + (1 + 1 + 2))
    assert roofline.bound_s(n_bytes, n_ops) == max(
        n_bytes / 3.35e12, n_ops / (128 * 132 * 1.98e9))
