"""The port's host prep and plain PyTorch wavefront against the JAX package.

The jobs follow tests/test_pallas_wavefront.py, with calm taken from the
in-repo tests/golden/data/all4.fa (record 1, 2175 bp).  Each JAX
reference runs as its own tests run it on the CPU: the XLA scan engine
(engine/wavefront.py) and the Pallas kernel in interpret mode.  The port
has its own host layer, so every job is built twice with the same
arguments, once from each package (``torch_twins``).  Scores, cells and
tracebacks are int32 or discrete, so the tolerance is zero.
"""
import os

import numpy as np
import pytest
import torch

from exonerate_tpu.engine import pallas_wavefront
from exonerate_tpu.engine import wavefront as jwf
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import wavefront as twf
from torch_twins import (JAX, PORT, SPLIT_MODELS, dp_key, split_job,
                         split_phases)

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")


def _calm(X):
    s = next(iter(X.iter_fasta(ALL4)))
    s.strand = "+"
    assert len(s) == 2175
    return s


def _e2g(X):
    calm = _calm(X)
    return X.est2genome_create(), X.AlignData(calm, calm)


def _affine_protein(X, repeat: int = 1):
    a = X.Sequence("a", None, "MKVLAAGICAGWLLWKKMKVL" * repeat)
    b = X.Sequence("b", None, "MKVLGAGICAWWLLAKKMK" * repeat)
    model = X.affine_create(X.AffineModelType.LOCAL, X.AlphabetType.PROTEIN,
                            X.AlphabetType.PROTEIN)
    data = X.AlignData(a, b)
    return model, [(X.Region(0, 0, len(a), len(b)), data)]


def _e2g_jobs(X, data):
    return [(X.Region(0, 0, 100, 160), data),
            (X.Region(40, 10, 80, 150), data),
            (X.Region(10, 30, 120, 90), data)]


def _keys(results):
    return [dp_key(r) for r in results]


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
def test_prepare_inputs_matches_jax(which, pad_to):
    out = []
    for X in (PORT, JAX):
        if which == "est2genome":
            model, data = _e2g(X)
            region = X.Region(40, 10, 80, 150)
        else:
            model, jobs = _affine_protein(X)
            region, data = jobs[0]
        out.append((model, region, data))
    for for_pallas in (False, True):
        got, gk = twf.prepare_inputs(*out[0], pad_to=pad_to,
                                     for_pallas=for_pallas)
        want, wk = jwf.prepare_inputs(*out[1], pad_to=pad_to,
                                      for_pallas=for_pallas)
        assert gk == wk
        _assert_same_inputs(got, want)


def test_bucket_matches_jax():
    assert twf._bucket_ladder() == jwf._bucket_ladder()
    for n in [0, 1, 255, 256, 257, 1000, 1200, 2175, 5000, 123457, 1 << 24]:
        assert twf._bucket(n) == jwf._bucket(n)


def test_region_mode_matches_jax_engines():
    model, data = _e2g(PORT)
    jmodel, jdata = _e2g(JAX)
    jobs, jjobs = _e2g_jobs(PORT, data), _e2g_jobs(JAX, jdata)
    got = _keys(cw.find_batched(model, jobs, "region", device=CPU))
    assert got == _keys(jwf.find_region_batched(jmodel, jjobs))
    assert got == _keys(pallas_wavefront.find_batched(jmodel, jjobs,
                                                      "region",
                                                      interpret=True))


def test_score_mode_matches_jax_engines():
    model, data = _e2g(PORT)
    jmodel, jdata = _e2g(JAX)
    jobs = [(PORT.Region(0, 0, 90, 140), data)]
    jjobs = [(JAX.Region(0, 0, 90, 140), jdata)]
    got = cw.find_batched(model, jobs, "score", device=CPU)
    assert _keys(got) == _keys(pallas_wavefront.find_batched(
        jmodel, jjobs, "score", interpret=True))
    ref = jwf.find_region_batched(jmodel, jjobs)[0]
    assert (got[0].score, got[0].query_end, got[0].target_end) == \
        (ref.score, ref.query_end, ref.target_end)


@pytest.mark.parametrize("mode", ["score", "region"])
def test_affine_local_protein_matches_jax_engines(mode):
    model, jobs = _affine_protein(PORT)
    jmodel, jjobs = _affine_protein(JAX)
    got = _keys(cw.find_batched(model, jobs, mode, device=CPU))
    assert got == _keys(pallas_wavefront.find_batched(jmodel, jjobs, mode,
                                                      interpret=True))
    if mode == "region":
        assert got == _keys(jwf.find_region_batched(jmodel, jjobs))


def _family_job(X, mtname):
    calm = _calm(X)
    prot = X.Sequence("p", None, "MADQLTEEQIAEFKEAFSLFDKDGDGTITTKELGTVMRSL")
    dna = calm.subseq(0, 260)
    q, t = (prot, dna) if mtname.startswith("PROTEIN") else (dna, dna)
    model = X.get_model(getattr(X.ModelType, mtname), q.alphabet.type,
                        t.alphabet.type)
    return model, [(X.Region(0, 0, len(q), len(t)), X.AlignData(q, t))]


@pytest.mark.parametrize("mtname", ["PROTEIN2DNA", "CODING2CODING", "NER"])
def test_model_family_region_matches_xla(mtname):
    """Codon-advance models exercise the K=4/6 carry rings."""
    model, jobs = _family_job(PORT, mtname)
    assert cw.unsupported_reason(model) is None
    assert _keys(cw.find_batched(model, jobs, "region", device=CPU)) == \
        _keys(jwf.find_region_batched(*_family_job(JAX, mtname)))


def _scoped_job(X, atype):
    calm = _calm(X)
    q, t = calm.subseq(0, 120), calm.subseq(10, 150)
    model = X.affine_create(getattr(X.AffineModelType, atype),
                            X.AlphabetType.DNA, X.AlphabetType.DNA)
    return model, [(X.Region(0, 0, len(q), len(t)), X.AlignData(q, t))]


@pytest.mark.parametrize("atype", ["GLOBAL", "BESTFIT", "OVERLAP"])
def test_scoped_affine_matches_xla(atype):
    """Start/end scopes other than ANYWHERE (corner, query, edge)."""
    model, jobs = _scoped_job(PORT, atype)
    jmodel, jjobs = _scoped_job(JAX, atype)
    assert _keys(cw.find_batched(model, jobs, "region", device=CPU)) == \
        _keys(jwf.find_region_batched(jmodel, jjobs))
    got = cw.find_path_batched(model, jobs, device=CPU)[0]
    assert dp_key(got) == dp_key(jwf.find_path(jmodel, *jjobs[0]))


def _random_case(X, name, rng):
    """Random pairs across the model zoo (tests/test_wavefront_parity.py),
    with a short intron window so random introns are possible."""
    def seq(alphabet, n):
        return X.Sequence("s", None, "".join(rng.choice(list(alphabet), n)))
    dna = "ACGTN"
    intron = X.IntronArgs(min_intron=5, max_intron=100)
    if name.startswith("affine_"):
        model = X.affine_create(X.AffineModelType[name[7:].upper()],
                                X.AlphabetType.DNA, X.AlphabetType.DNA)
        q, t = seq(dna, 30), seq(dna, 45)
    elif name == "ungapped":
        model = X.ungapped_create(X.MatchType.DNA2DNA)
        q, t = seq(dna, 40), seq(dna, 40)
    elif name == "est2genome":
        model = X.est2genome_create(intron)
        q, t = seq(dna, 30), seq(dna, 80)
    elif name == "ner":
        model = X.ner_create(X.AlphabetType.DNA, X.AlphabetType.DNA)
        q, t = seq(dna, 40), seq(dna, 60)
    elif name == "protein2dna":
        model = X.protein2dna_create()
        q, t = seq("ARNDCQEGHILKMFPSTWYV", 15), seq(dna, 60)
    else:
        model = X.coding2coding_create()
        q, t = seq(dna, 30), seq(dna, 45)
    data = X.AlignData(q, t, name == "coding2coding")
    data.intron = intron
    return model, X.Region(0, 0, len(q), len(t)), data


@pytest.mark.parametrize("name", [
    "affine_local", "affine_global", "affine_bestfit", "affine_overlap",
    "ungapped", "est2genome", "ner", "protein2dna", "coding2coding"])
def test_random_pairs_match_reference_interpreter(name):
    """Against the JAX package's NumPy oracle, on the same random pairs
    drawn twice from one seed."""
    rng, jrng = np.random.default_rng(1234), np.random.default_rng(1234)
    for _ in range(2):
        model, region, data = _random_case(PORT, name, rng)
        jmodel, jregion, jdata = _random_case(JAX, name, jrng)
        got = cw.find_batched(model, [(region, data)], "region",
                              device=CPU)[0]
        ref = JAX.reference.find_region(jmodel, jregion, jdata)
        assert dp_key(got)[:5] == dp_key(ref)[:5]
        path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
        want = JAX.reference.viterbi(jmodel, jregion, jdata, "path")
        assert dp_key(path) == dp_key(want)


def test_path_mode_matches_jax_engines():
    model, data = _e2g(PORT)
    jmodel, jdata = _e2g(JAX)
    jobs, jjobs = _e2g_jobs(PORT, data), _e2g_jobs(JAX, jdata)
    got = cw.find_path_batched(model, jobs, device=CPU)
    pal = pallas_wavefront.find_path_batched(jmodel, jjobs, interpret=True)
    for (region, d), g, p in zip(jjobs, got, pal):
        ref = jwf.find_path(jmodel, region, d)
        assert dp_key(g) == dp_key(ref) == dp_key(p)


def test_path_mode_affine_matches_jax_engines():
    model, jobs = _affine_protein(PORT, repeat=3)
    jmodel, jjobs = _affine_protein(JAX, repeat=3)
    got = cw.find_path_batched(model, jobs, device=CPU)[0]
    ref = jwf.find_path(jmodel, jjobs[0][0], jjobs[0][1])
    pal = pallas_wavefront.find_path_batched(jmodel, jjobs,
                                             interpret=True)[0]
    assert dp_key(got) == dp_key(ref) == dp_key(pal)


def test_jax_prep_through_kernel_inputs():
    """to_kernel_inputs takes the JAX package's own prep output (plain
    NumPy) beside the port's model: both sides then compute on
    identical data."""
    model, _ = _e2g(PORT)
    jmodel, jdata = _e2g(JAX)
    jjobs = _e2g_jobs(JAX, jdata)
    per_pair = []
    for region, d in jjobs:
        inputs, kinds = jwf.prepare_inputs(jmodel, region, d,
                                           pad_to=(256, 256),
                                           for_pallas=True)
        per_pair.append(inputs)
    ki = cw.to_kernel_inputs(model, per_pair, kinds, CPU, "region")
    out = cw.wavefront_scan(ki).T.tolist()
    ref = jwf.find_region_batched(jmodel, jjobs)
    assert out == [[r.score, r.query_end, r.target_end, r.query_start,
                    r.target_start] for r in ref]


def test_walkback_stops_at_cap():
    """A walk longer than its cap reports n_ops == cap (unusable), and
    find_path_batched then leaves the job to the host."""
    model, data = _e2g(PORT)
    region = PORT.Region(0, 0, 100, 160)
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
    from exonerate_tpu.engine import optimal as jopt
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.engine import optimal as topt

    def job(X):
        calm = _calm(X)
        return (X.est2genome_create(), X.Region(0, 0, 300, 500),
                X.AlignData(calm.subseq(100, 300), calm.subseq(0, 500)))
    direct = jopt.find_path(*job(JAX))
    monkeypatch.setattr(topt, "NATIVE_TPU_CELLS", 40_000)
    observe.reset()
    scanned = topt.find_path(*job(PORT), device=CPU)
    assert observe.engine_counts["torch-wavefront"] >= 2
    assert "native" not in observe.engine_counts
    assert not observe.fallback_counts
    assert direct is not None and scanned is not None
    assert scanned.score == direct.score
    assert scanned.region.__dict__ == direct.region.__dict__
    assert [(op.transition.name, op.length) for op in scanned.ops] == \
        [(op.transition.name, op.length) for op in direct.ops]


# -- kernel K9: the split-codon calc kind inside K1/K4 ---------------------

@pytest.mark.parametrize("mtname", sorted(SPLIT_MODELS))
def test_split_codon_models_match_jax_engines(mtname):
    """protein2genome, coding2genome and cdna2genome on pairs cut so that
    the best path crosses a phase-1 and a phase-2 split codon: the plain
    K1 (region) and K4 (path + walk-back) equal the XLA engine (which
    evaluates the split codon by shadow_fn gathers), the Pallas kernel in
    interpret mode (its pallas_fn) and the port's NumPy oracle."""
    model, region, data = split_job(PORT, mtname)
    jmodel, jregion, jdata = split_job(JAX, mtname)
    assert cw.unsupported_reason(model) is None
    got = cw.find_batched(model, [(region, data)], "region", device=CPU)[0]
    want = jwf.find_region_batched(jmodel, [(jregion, jdata)])[0]
    assert dp_key(got) == dp_key(want)
    assert dp_key(got) == dp_key(pallas_wavefront.find_batched(
        jmodel, [(jregion, jdata)], "region", interpret=True)[0])
    path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
    assert dp_key(path) == dp_key(jwf.find_path(jmodel, jregion, jdata))
    assert dp_key(path) == dp_key(JAX.reference.find_path(jmodel, jregion,
                                                          jdata))
    assert path.score == got.score
    assert split_phases(path.path) == {1, 2}


def test_split_codon_plan_rows_name_their_lanes():
    """A split-codon row of the plan table names the R0 query row, the
    target rows, the phase and the lanes of the designations the JAX
    package's pallas_fn reads; its start lanes read the shadow start
    vectors (ST_TVEC) at the source column."""
    model, region, data = split_job(PORT, "PROTEIN2GENOME")
    inputs, kinds = twf.prepare_inputs(model, region, data,
                                       pad_to=(256, 768), for_pallas=True)
    ki = cw.to_kernel_inputs(model, inputs, kinds, CPU, "region")
    rows = [r for r in ki.plan.tolist() if r[twf.P_CALC] == twf.C_SPLIT]
    assert sorted(r[twf.P_C2] for r in rows) == [1, 2]
    plan = cw._build_plan(model)
    for r, p in zip(ki.plan.tolist(), plan):
        if r[twf.P_CALC] != twf.C_SPLIT:
            continue
        des = dict(p["dst_shadows"])
        lanes = {name.split()[0] + name.split()[1]: d
                 for name, d in des.items()}
        if r[twf.P_C2] == 1:
            assert r[twf.P_C4] == lanes["splitc1"]
        else:
            assert [r[twf.P_C4], r[twf.P_C5], r[twf.P_C6]] == [
                lanes[f"splitp2k{k}"] for k in range(3)]
        ci = p["pallas_ci"]
        assert torch.equal(ki.qvecs[0, r[twf.P_C0]:r[twf.P_C0] + 25],
                           torch.from_numpy(np.stack(
                               [inputs[f"kc{ci}:R{a}"] for a in range(25)])))
    srcs = [r[twf.P_ST_SRC0 + 2 * k] for r in ki.plan.tolist()
            for k in range(r[twf.P_NSTART])]
    assert sum(s >= twf.ST_TVEC for s in srcs) >= 4
    assert ki.split and ki.L == model.total_shadow_designations + 2 <= cw.MAX_L
