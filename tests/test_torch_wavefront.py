"""The port's host prep and plain PyTorch wavefront against the JAX package.

The jobs follow tests/test_pallas_wavefront.py, with calm taken from the
in-repo tests/golden/data/all4.fa (record 1, 2175 bp).  Each JAX
reference runs as its own tests run it on the CPU: the XLA scan engine
(engine/wavefront.py) and the Pallas kernel in interpret mode.  Scores,
cells and tracebacks are int32 or discrete, so the tolerance is zero.
"""
import os

import numpy as np
import pytest
import torch

from exonerate_tpu.alphabet import AlphabetType
from exonerate_tpu.engine import pallas_wavefront, reference
from exonerate_tpu.engine import wavefront as jwf
from exonerate_tpu.engine.region import Region
from exonerate_tpu.model.affine import AffineModelType, affine_create
from exonerate_tpu.model.coding2coding import coding2coding_create
from exonerate_tpu.model.data import AlignData, IntronArgs
from exonerate_tpu.model.est2genome import est2genome_create
from exonerate_tpu.model.match import MatchType
from exonerate_tpu.model.ner import ner_create
from exonerate_tpu.model.protein2dna import protein2dna_create
from exonerate_tpu.model.registry import ModelType, get_model
from exonerate_tpu.model.ungapped import ungapped_create
from exonerate_tpu.seqio import Sequence, iter_fasta
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import wavefront as twf

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")


def _calm():
    s = next(iter(iter_fasta(ALL4)))
    s.strand = "+"
    assert len(s) == 2175
    return s


@pytest.fixture(scope="module")
def e2g():
    calm = _calm()
    return est2genome_create(), AlignData(calm, calm)


def _affine_protein(repeat: int = 1):
    a = Sequence("a", None, "MKVLAAGICAGWLLWKKMKVL" * repeat)
    b = Sequence("b", None, "MKVLGAGICAWWLLAKKMK" * repeat)
    model = affine_create(AffineModelType.LOCAL, AlphabetType.PROTEIN,
                          AlphabetType.PROTEIN)
    data = AlignData(a, b)
    return model, [(Region(0, 0, len(a), len(b)), data)]


def _e2g_jobs(data):
    return [(Region(0, 0, 100, 160), data), (Region(40, 10, 80, 150), data),
            (Region(10, 30, 120, 90), data)]


def _assert_same_inputs(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_inputs(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k


@pytest.mark.parametrize("which", ["est2genome", "affine_local"])
@pytest.mark.parametrize("pad_to", [None, (256, 512)])
def test_prepare_inputs_matches_jax(e2g, which, pad_to):
    if which == "est2genome":
        model, data = e2g
        region = Region(40, 10, 80, 150)
    else:
        model, jobs = _affine_protein()
        region, data = jobs[0]
    for for_pallas in (False, True):
        got, gk = twf.prepare_inputs(model, region, data, pad_to=pad_to,
                                     for_pallas=for_pallas)
        want, wk = jwf.prepare_inputs(model, region, data, pad_to=pad_to,
                                      for_pallas=for_pallas)
        assert gk == wk
        _assert_same_inputs(got, want)


def test_bucket_matches_jax():
    assert twf._bucket_ladder() == jwf._bucket_ladder()
    for n in [0, 1, 255, 256, 257, 1000, 1200, 2175, 5000, 123457, 1 << 24]:
        assert twf._bucket(n) == jwf._bucket(n)


def test_region_mode_matches_jax_engines(e2g):
    model, data = e2g
    jobs = _e2g_jobs(data)
    got = cw.find_batched(model, jobs, "region", device=CPU)
    assert got == jwf.find_region_batched(model, jobs)
    assert got == pallas_wavefront.find_batched(model, jobs, "region",
                                                interpret=True)


def test_score_mode_matches_jax_engines(e2g):
    model, data = e2g
    jobs = [(Region(0, 0, 90, 140), data)]
    got = cw.find_batched(model, jobs, "score", device=CPU)
    assert got == pallas_wavefront.find_batched(model, jobs, "score",
                                                interpret=True)
    ref = jwf.find_region_batched(model, jobs)[0]
    assert (got[0].score, got[0].query_end, got[0].target_end) == \
        (ref.score, ref.query_end, ref.target_end)


@pytest.mark.parametrize("mode", ["score", "region"])
def test_affine_local_protein_matches_jax_engines(mode):
    model, jobs = _affine_protein()
    got = cw.find_batched(model, jobs, mode, device=CPU)
    assert got == pallas_wavefront.find_batched(model, jobs, mode,
                                                interpret=True)
    if mode == "region":
        assert got == jwf.find_region_batched(model, jobs)


@pytest.mark.parametrize("mtname", ["PROTEIN2DNA", "CODING2CODING", "NER"])
def test_model_family_region_matches_xla(mtname):
    """Codon-advance models exercise the K=4/6 carry rings."""
    calm = _calm()
    prot = Sequence("p", None, "MADQLTEEQIAEFKEAFSLFDKDGDGTITTKELGTVMRSL")
    dna = calm.subseq(0, 260)
    q, t = (prot, dna) if mtname.startswith("PROTEIN") else (dna, dna)
    model = get_model(getattr(ModelType, mtname), q.alphabet.type,
                      t.alphabet.type)
    assert cw.unsupported_reason(model) is None
    jobs = [(Region(0, 0, len(q), len(t)), AlignData(q, t))]
    assert cw.find_batched(model, jobs, "region", device=CPU) == \
        jwf.find_region_batched(model, jobs)


@pytest.mark.parametrize("atype", ["GLOBAL", "BESTFIT", "OVERLAP"])
def test_scoped_affine_matches_xla(atype):
    """Start/end scopes other than ANYWHERE (corner, query, edge)."""
    calm = _calm()
    q, t = calm.subseq(0, 120), calm.subseq(10, 150)
    model = affine_create(getattr(AffineModelType, atype), AlphabetType.DNA,
                          AlphabetType.DNA)
    jobs = [(Region(0, 0, len(q), len(t)), AlignData(q, t))]
    assert cw.find_batched(model, jobs, "region", device=CPU) == \
        jwf.find_region_batched(model, jobs)
    got = cw.find_path_batched(model, jobs, device=CPU)[0]
    assert _path_key(got) == _path_key(jwf.find_path(model, *jobs[0]))


def _random_case(name, rng):
    """Random pairs across the model zoo (tests/test_wavefront_parity.py),
    with a short intron window so random introns are possible."""
    def seq(alphabet, n):
        return Sequence("s", None, "".join(rng.choice(list(alphabet), n)))
    dna = "ACGTN"
    intron = IntronArgs(min_intron=5, max_intron=100)
    if name.startswith("affine_"):
        model = affine_create(AffineModelType[name[7:].upper()],
                              AlphabetType.DNA, AlphabetType.DNA)
        q, t = seq(dna, 30), seq(dna, 45)
    elif name == "ungapped":
        model = ungapped_create(MatchType.DNA2DNA)
        q, t = seq(dna, 40), seq(dna, 40)
    elif name == "est2genome":
        model = est2genome_create(intron)
        q, t = seq(dna, 30), seq(dna, 80)
    elif name == "ner":
        model = ner_create(AlphabetType.DNA, AlphabetType.DNA)
        q, t = seq(dna, 40), seq(dna, 60)
    elif name == "protein2dna":
        model = protein2dna_create()
        q, t = seq("ARNDCQEGHILKMFPSTWYV", 15), seq(dna, 60)
    else:
        model = coding2coding_create()
        q, t = seq(dna, 30), seq(dna, 45)
    data = AlignData(q, t, name == "coding2coding")
    data.intron = intron
    return model, Region(0, 0, len(q), len(t)), data


@pytest.mark.parametrize("name", [
    "affine_local", "affine_global", "affine_bestfit", "affine_overlap",
    "ungapped", "est2genome", "ner", "protein2dna", "coding2coding"])
def test_random_pairs_match_reference_interpreter(name):
    rng = np.random.default_rng(1234)
    for _ in range(2):
        model, region, data = _random_case(name, rng)
        got = cw.find_batched(model, [(region, data)], "region",
                              device=CPU)[0]
        ref = reference.find_region(model, region, data)
        assert (got.score, got.query_end, got.target_end, got.query_start,
                got.target_start) == (ref.score, ref.query_end,
                                      ref.target_end, ref.query_start,
                                      ref.target_start)
        path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
        want = reference.viterbi(model, region, data, "path")
        assert _path_key(path) == _path_key(want)


def _path_key(r):
    return (r.score, r.query_start, r.target_start, r.query_end,
            r.target_end, [id(t) for t in r.path])


def test_path_mode_matches_jax_engines(e2g):
    model, data = e2g
    jobs = _e2g_jobs(data)
    got = cw.find_path_batched(model, jobs, device=CPU)
    pal = pallas_wavefront.find_path_batched(model, jobs, interpret=True)
    for (region, d), g, p in zip(jobs, got, pal):
        ref = jwf.find_path(model, region, d)
        assert _path_key(g) == _path_key(ref) == _path_key(p)


def test_path_mode_affine_matches_jax_engines():
    model, jobs = _affine_protein(repeat=3)
    got = cw.find_path_batched(model, jobs, device=CPU)[0]
    ref = jwf.find_path(model, jobs[0][0], jobs[0][1])
    pal = pallas_wavefront.find_path_batched(model, jobs, interpret=True)[0]
    assert _path_key(got) == _path_key(ref) == _path_key(pal)


def test_jax_prep_through_kernel_inputs(e2g):
    """to_kernel_inputs takes the JAX package's own prep output: both
    sides then compute on identical data."""
    model, data = e2g
    jobs = _e2g_jobs(data)
    per_pair = []
    for region, d in jobs:
        inputs, kinds = jwf.prepare_inputs(model, region, d,
                                           pad_to=(256, 256),
                                           for_pallas=True)
        per_pair.append(inputs)
    ki = cw.to_kernel_inputs(model, per_pair, kinds, CPU, "region")
    out = cw.wavefront_scan(ki).T.tolist()
    ref = jwf.find_region_batched(model, jobs)
    assert out == [[r.score, r.query_end, r.target_end, r.query_start,
                    r.target_start] for r in ref]


def test_walkback_stops_at_cap(e2g):
    """A walk longer than its cap reports n_ops == cap (unusable), and
    find_path_batched then leaves the job to the host."""
    model, data = e2g
    region = Region(0, 0, 100, 160)
    inputs, kinds = twf.prepare_inputs(model, region, data,
                                       pad_to=(256, 256), for_pallas=True)
    ki = cw.to_kernel_inputs(model, [inputs], kinds, CPU, "path")
    stats, tb = cw.wavefront_path(ki)
    ops, res = cw.walkback(tb, stats, ki.walk, ki.end_id, 5)
    assert res[0, 0].item() == 5
    full_ops, full = cw.walkback(tb, stats, ki.walk, ki.end_id, 1000)
    assert 5 < full[0, 0].item() < 1000
    assert ops[0].tolist() == full_ops[0, :5].tolist()


def test_optimal_region_then_path_equals_direct(monkeypatch):
    """The port's optimal, routed onto the wavefront (region scan, then
    the path DP on the scan's box), gives the alignment of the JAX
    package's direct path DP (ref: Optimal_find_path region-then-path)."""
    from exonerate_tpu import observe
    from exonerate_tpu.engine import optimal as jopt
    from exonerate_tpu_torch.engine import optimal as topt
    calm = _calm()
    model = est2genome_create()
    data = AlignData(calm.subseq(100, 300), calm.subseq(0, 500))
    region = Region(0, 0, 300, 500)
    direct = jopt.find_path(model, region, data)
    monkeypatch.setattr(topt, "NATIVE_TPU_CELLS", 40_000)
    observe.reset()
    scanned = topt.find_path(model, region, data, device=CPU)
    assert observe.engine_counts["torch-wavefront"] >= 2
    assert "native" not in observe.engine_counts
    assert not observe.fallback_counts
    assert direct is not None and scanned is not None
    assert scanned.score == direct.score
    assert scanned.region.__dict__ == direct.region.__dict__
    assert [(op.transition.name, op.length) for op in scanned.ops] == \
        [(op.transition.name, op.length) for op in direct.ops]
