"""The generic wavefront (``engine/generic_wavefront.py``) against the JAX
package's XLA engine (``exonerate_tpu/engine/wavefront.py``).

The port runs the models its hand-written kernels refuse, genome2genome
first among them, on the JAX engine's ``lax.scan`` written as a Python
loop of torch ops over the anti-diagonals.  On the CPU it must equal the
XLA engine exactly (int32 scores, end and start cells, traceback):

- score, region and path, mask-free and under a SubOpt mask, on small
  genome2genome, est2genome and protein2genome pairs cut from the in-repo
  ``cdna_mut.fa`` x ``genome.fa``;
- ``find_region_batched`` over a bucket, and ``find_path_checkpointed``
  at a budget that cuts the DP into segments;
- the refused buckets of ``cuda_wavefront.find_batched`` /
  ``find_path_batched``, with the JAX package's fallback reason.

The CLI runs are in ``test_torch_generic_cli.py``.

The test marked ``gpu`` runs the engine on a card against the CPU.
"""
import os

import pytest
import torch

from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import generic_wavefront as gw
from exonerate_tpu_torch.engine import optimal as topt
from exonerate_tpu_torch.engine.subopt import SubOpt

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def _seq(name):
    with open(os.path.join(DATA, name)) as fh:
        return "".join(fh.read().split("\n", 1)[1].split())


CDNA, GENOME = _seq("cdna_mut.fa"), _seq("genome.fa")
# cdna_mut[0:300] lies at genome[3000:3300] with ~1% mutations
PAIRS = {"genome2genome": ("GENOME2GENOME", CDNA[:40], GENOME[2995:3055]),
         "est2genome": ("EST2GENOME", CDNA[:40], GENOME[2995:3055])}


def _translate(dna):
    import torch_split_cases as sc
    return sc.translate(dna)


def _ns(pkg):
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    return (mod("model.registry"), mod("alphabet").AlphabetType,
            mod("seqio").Sequence, mod("engine.region").Region,
            mod("model.data").AlignData)


def _job(name, pkg="exonerate_tpu_torch", q=None, t=None):
    """(model, region, data) of a named pair, from package ``pkg``."""
    reg, A, Sequence, Region, AlignData = _ns(pkg)
    if name == "protein2genome":
        mt, qa = "PROTEIN2GENOME", A.PROTEIN
        q = q or _translate(GENOME[3000:3060])
        t = t or GENOME[2990:3080]
    else:
        mt, q0, t0 = PAIRS[name]
        qa, q, t = A.DNA, q or q0, t or t0
    mt = reg.ModelType[mt]
    model = reg.get_model(mt, qa, A.DNA)
    return (model, Region(0, 0, len(q), len(t)),
            AlignData(Sequence("q", None, q), Sequence("t", None, t),
                      reg.translate_both(mt)))


def _key(r):
    path = getattr(r, "path", None)
    return (r.score, r.query_start, r.target_start, r.query_end,
            r.target_end, None if path is None else [t.name for t in path])


def _masks(name):
    """The SubOpt masks of both packages after each one's best path."""
    from exonerate_tpu.engine import optimal as jopt
    from exonerate_tpu.engine import wavefront as jwf
    from exonerate_tpu.engine.subopt import SubOpt as JSubOpt
    jm, jr, jd = _job(name, "exonerate_tpu")
    model, region, data = _job(name)
    sub, jsub = SubOpt(), JSubOpt()
    jsub.add_alignment(jopt._to_alignment(jm, jr, jwf.find_path(jm, jr, jd)))
    sub.add_alignment(topt._to_alignment(
        model, region, gw.find_path(model, region, data, device=CPU)))
    return sub, jsub


@pytest.mark.parametrize("masked", [False, True], ids=["mask-free", "masked"])
@pytest.mark.parametrize("name", ["genome2genome", "est2genome",
                                  "protein2genome"])
def test_generic_engine_equals_xla(name, masked):
    from exonerate_tpu.engine import wavefront as jwf
    jm, jr, jd = _job(name, "exonerate_tpu")
    model, region, data = _job(name)
    sub, jsub = _masks(name) if masked else (None, None)
    if masked:
        _, kinds = gw.prepare_inputs(model, region, data, subopt=sub)
        assert ("_blocked", "blocked") in kinds
    assert gw.find_score(model, region, data, sub, device=CPU) \
        == jwf.find_score(jm, jr, jd, jsub)
    assert _key(gw.find_region(model, region, data, sub, device=CPU)) \
        == _key(jwf.find_region(jm, jr, jd, jsub))
    got = gw.find_path(model, region, data, sub, device=CPU)
    assert _key(got) == _key(jwf.find_path(jm, jr, jd, jsub))
    assert got.score > 0 and got.path


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the engine's tensors are a few hundred lanes,
    and the suite runs several test processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batched_and_checkpointed_equal_xla():
    """A bucket of three genome2genome pairs, and the checkpointed path DP
    (est2genome; genome2genome's runs in ``test_torch_generic_cli.py``)
    with a budget of a few segments.  The pairs have one length: the JAX
    engine stacks each shadow calc's arrays over the bucket, which fails
    for pairs of different lengths (the port runs such pairs alone)."""
    from exonerate_tpu.engine import wavefront as jwf
    cuts = [(CDNA[:40], GENOME[2995:3055]), (CDNA[5:45], GENOME[3000:3060]),
            (CDNA[20:60], GENOME[2990:3050])]
    jobs = [_job("genome2genome", q=q, t=t)[1:] for q, t in cuts]
    jjobs = [_job("genome2genome", "exonerate_tpu", q=q, t=t)[1:]
             for q, t in cuts]
    model = _job("genome2genome")[0]
    jm = _job("genome2genome", "exonerate_tpu")[0]
    got = gw.find_region_batched(model, jobs, device=CPU)
    want = jwf.find_region_batched(jm, jjobs)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    model, region, data = _job("est2genome")
    jm, jr, jd = _job("est2genome", "exonerate_tpu")
    budget = 41 * len(model.states) * 30        # segments of 30 diagonals
    got = gw.find_path_checkpointed(model, region, data, budget_bytes=budget,
                                    device=CPU)
    assert _key(got) == _key(jwf.find_path_checkpointed(
        jm, jr, jd, budget_bytes=budget))
    assert _key(got) == _key(gw.find_path(model, region, data, device=CPU))


def test_refused_buckets_run_on_the_generic_engine():
    """``find_batched`` and ``find_path_batched`` send genome2genome to the
    generic engine with the JAX package's fallback reason, where they
    raised before."""
    from exonerate_tpu import observe as jobserve
    from exonerate_tpu.engine import pallas_wavefront
    jm, jr, jd = _job("genome2genome", "exonerate_tpu")
    model, region, data = _job("genome2genome")
    jobserve.reset()
    want = pallas_wavefront.find_batched(jm, [(jr, jd)], "region",
                                         interpret=True)[0]
    observe.reset()
    got = cw.find_batched(model, [(region, data)], "region", device=CPU)[0]
    assert _key(got) == _key(want)
    assert dict(observe.fallback_counts) == dict(jobserve.fallback_counts)
    assert observe.engine_counts == {"torch-generic": 1}
    path = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
    assert _key(path) == _key(gw.find_path(model, region, data, device=CPU))
    assert dict(observe.fallback_counts) == {
        k: 2 * v for k, v in jobserve.fallback_counts.items()}


# -- the engine on a card ------------------------------------------------

@pytest.mark.gpu
def test_generic_engine_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    dev = torch.device("cuda")
    model, region, data = _job("genome2genome")
    sub = SubOpt()
    sub.add_alignment(topt._to_alignment(
        model, region, gw.find_path(model, region, data, device=CPU)))
    for s in (None, sub):
        assert _key(gw.find_path(model, region, data, s, device=dev)) == \
            _key(gw.find_path(model, region, data, s, device=CPU))
        assert _key(gw.find_path_checkpointed(
            model, region, data, s, budget_bytes=41 * 40 * 30,
            device=dev)) == _key(gw.find_path(model, region, data, s,
                                              device=CPU))
