"""The port's row-scan SDP tier (``exonerate_tpu_torch/engine/sdp_rows.py``)
against the JAX package's (``exonerate_tpu/engine/sdp_rows.py``).

The same pair, built once from each package's host layer, goes through
both engines' ``get_fn`` on the CPU; every output field must be equal,
the per-row sweep counts included: the fast-tier fixtures of
``tests/test_sdp_rows.py`` (affine:local on one band, est2genome
spliced, protein2genome across a split codon), a batched bucket whose
pairs converge after different numbers of sweeps, the fixed-sweep knob,
and a custom submat with scores past 256 held to the NumPy oracle.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from exonerate_tpu.engine import sdp_device as jsd, sdp_rows as jrows
from exonerate_tpu_torch.engine import sdp_device as tsd, sdp_rows as trows

import torch_sdp_cases as tc

CPU = torch.device("cpu")
JAX_PKG = "exonerate_tpu"


def _rng_fixture(name):
    """The fixtures of tests/test_sdp_rows.py's fast tier, from a seed."""
    rng = np.random.default_rng({"affine": 7, "e2g": 8, "p2g": 9}[name])

    def gene():
        ex1, ex2 = tc.dna(rng, 150), tc.dna(rng, 150)
        return ex1, ex2, "GT" + tc.dna(rng, 96) + "AG"
    if name == "affine":
        base = tc.dna(rng, 400)
        return ("AFFINE_LOCAL", base[:200], tc.mutate(rng, base[50:350], 20),
                [(60, 10, 80, 300)], dict(margin=64))
    if name == "e2g":
        ex1, ex2, intr = gene()
        genome = tc.dna(rng, 200) + ex1 + intr + ex2 + tc.dna(rng, 200)
        return ("EST2GENOME", tc.mutate(rng, ex1 + ex2, 8), genome,
                [(10, 210, 120, 400), (160, 458, 130, 430)], dict(margin=96))
    from exonerate_tpu_torch.translate import default_code
    ex1, ex2, intr = gene()
    pep = default_code().translate(
        np.frombuffer((ex1 + ex2).encode(), np.uint8), 1)
    pep = pep.tobytes().decode()[:90]
    genome = tc.dna(rng, 120) + ex1 + intr + ex2 + tc.dna(rng, 120)
    return ("PROTEIN2GENOME", pep, genome, [(2, 126, 40, 200),
                                            (55, 430, 28, 160)],
            dict(margin=80, qt="PD", qadv=1, tadv=3))


def _twins(mt, q, t, hsps, kw, model=None, jmodel=None):
    port = tc.pair_and_plan(mt, q, t, hsps, model=model, **kw)
    jax = tc.pair_and_plan(mt, q, t, hsps, model=jmodel, pkg=JAX_PKG, **kw)
    return port, jax


def _inputs(sd, model, pair, plan, Qp, Wp, n_seed):
    inputs, kinds = sd.prepare_inputs(model, pair, plan, pad_to=(Qp, Wp))
    inputs.update(sd.prepare_seeds(pair, plan, n_seed))
    return inputs, kinds


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([d[k] for d in items]) for k in items[0]}
    return np.stack([np.asarray(x) for x in items])


def _run_both(jobs, Qp=None, Wp=None):
    """jobs: [((model, pair, plan) port, (...) jax)].  One bucket of the
    given pads through both engines (batched when there are two or more
    jobs); returns (port, jax) dicts of numpy arrays."""
    (pm, pp, pl), (jm, jp, jl) = jobs[0]
    Qp = Qp or max(p[1].region.query_length for p, _ in jobs)
    Wp = Wp or max(p[2].W for p, _ in jobs)
    n_seed = max(len(p[1].seeds) for p, _ in jobs)
    n_seg = max(len(p[2].loci) for p, _ in jobs) + 1
    batched = len(jobs) > 1
    outs = []
    for sd, rows, side in ((tsd, trows, 0), (jsd, jrows, 1)):
        items = [_inputs(sd, *job[side], Qp, Wp, n_seed) for job in jobs]
        kinds = items[0][1]
        model, pair = jobs[0][side][0], jobs[0][side][1]
        exts = rows.chain_ext_values(model, pair)
        fn = rows.get_fn(model, Qp, Wp, kinds, pair.use_boundary, n_seed,
                         n_seg, pair.args.dropoff, exts, batched=batched)
        inputs = _stack([i for i, _ in items]) if batched else items[0][0]
        if side == 0:
            out = {k: v.numpy() for k, v in fn(inputs, device=CPU).items()}
        else:
            out = {k: np.asarray(v) for k, v in fn(inputs).items()}
        outs.append(out)
    return outs


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["affine", "e2g", "p2g"])
def test_row_scan_matches_jax(name):
    mt, q, t, hsps, kw = _rng_fixture(name)
    port, jax = _twins(mt, q, t, hsps, kw)
    assert trows.supported(port[0]) and jrows.supported(jax[0])
    got, want = _run_both([(port, jax)])
    _assert_equal(got, want)
    assert not got["unconverged"]
    assert got["sweeps"] > 1


def test_batched_bucket_matches_jax_pair_by_pair():
    """Two affine:local pairs of one bucket: the batch sweeps while any
    pair changed, and each pair's sweep counts and results equal both
    its own unbatched run and the JAX package's vmapped run."""
    mt, q, t, hsps, kw = _rng_fixture("affine")
    # the second pair, a shorter query on a mutated target, converges
    # in fewer sweeps on some rows
    jobs = [_twins(mt, q, t, hsps, kw),
            _twins(mt, q[:150], tc.mutate(np.random.default_rng(5), t, 30),
                   [(60, 10, 60, 200)], kw)]
    Qp = max(p[1].region.query_length for p, _ in jobs)
    Wp = max(p[2].W for p, _ in jobs)
    got, want = _run_both(jobs, Qp, Wp)
    _assert_equal(got, want)
    assert got["row_sweeps_fwd"].shape[0] == 2
    assert not np.array_equal(got["row_sweeps_fwd"][0],
                              got["row_sweeps_fwd"][1])
    for b, job in enumerate(jobs):
        alone, _ = _run_both([job], Qp, Wp)
        for k, v in alone.items():
            np.testing.assert_array_equal(got[k][b], v, err_msg=k)


def test_fixed_sweeps_knob_matches_jax(monkeypatch):
    # the JAX package's cache key misses the knob: start it afresh
    monkeypatch.setattr(jrows, "_CACHE", {})
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS_FIXED", "3")
    mt, q, t, hsps, kw = _rng_fixture("affine")
    port, jax = _twins(mt, q, t, hsps, kw)
    got, want = _run_both([(port, jax)])
    _assert_equal(got, want)
    assert got["sweeps"] == 3


def test_custom_submat_past_256_matches_the_oracle(monkeypatch):
    """affine:local with every nucleic submat score times 97 (|score| up
    to 485): the factored calc's integer gather keeps every score exact,
    and the band ends and start scores equal the SDP oracle's."""
    from exonerate_tpu_torch.submat import Submat
    create = Submat.create

    def big(name):
        sub = create(name)
        sub.matrix = sub.matrix * 97
        return sub
    monkeypatch.setattr(Submat, "create", big)
    mt, q, t, hsps, kw = _rng_fixture("affine")
    hsps = [(a, b, c, d * 97) for a, b, c, d in hsps]
    # a band over the whole target: the scaled matches outrun any margin
    model, pair, plan = tc.pair_and_plan(mt, q, t, hsps, margin=len(t))
    inputs, kinds = _inputs(tsd, model, pair, plan, pair.region.query_length,
                            plan.W, len(pair.seeds))
    assert int(np.abs(inputs[[k for k, v in kinds if v == "factored"][0]]
                      ["table"]).max()) > 256
    fn = trows.get_fn(model, pair.region.query_length, plan.W, kinds,
                      pair.use_boundary, len(pair.seeds), len(plan.loci) + 1,
                      pair.args.dropoff, trows.chain_ext_values(model, pair))
    out = fn(inputs, device=CPU)
    assert not bool(out["live"]) and not bool(out["unconverged"])
    want = np.full(len(plan.loci), trows.NEG, np.int64)
    for lx, lc in enumerate(plan.loci):
        for s in pair.seeds[lc.seed_lo:lc.seed_hi]:
            want[lx] = max(want[lx], s.max_end.score)
    np.testing.assert_array_equal(out["band_end"][:len(plan.loci)].numpy(),
                                  want)
    np.testing.assert_array_equal(
        out["start_scores"][:len(pair.seeds)].numpy(),
        [s.max_start.score for s in pair.seeds])
    assert want.max() > 256 * 10


def test_bits_round_trip():
    g = torch.Generator().manual_seed(3)
    bits = torch.rand((3, 77), generator=g) > 0.5
    words = trows._pack_bits(bits, 3)
    assert words.shape == (3, 3)
    assert torch.equal(trows._unpack_bits(words, 77), bits)
    assert int(trows._pack_bits(torch.tensor([True] + [False] * 31 + [True]),
                                2)[1]) == 1


def test_function_cache_keys_on_sweeps_and_fixed(monkeypatch):
    mt, q, t, hsps, kw = _rng_fixture("affine")
    model, pair, plan = tc.pair_and_plan(mt, q, t, hsps, **kw)
    args = (model, 200, plan.W, (("c0", "scalar"),), False, 8, 8, 50, ())
    a = trows.get_fn(*args)
    monkeypatch.setattr(trows, "MAX_SWEEPS", 5)
    b = trows.get_fn(*args)
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS_FIXED", "2")
    c = trows.get_fn(*args)
    assert a is not b and b is not c and a is not c


# -- the CLI with the row-scan tier forced --------------------------------

import io  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

import exonerate_tpu_torch  # noqa: E402
from exonerate_tpu_torch import observe  # noqa: E402
from exonerate_tpu_torch.cli.exonerate import main  # noqa: E402

# tests/test_golden_rows.py's cases whose inputs are in the repository
ROWS_GOLDENS = sorted(
    name for name, prog, argv in cases.CASES
    if name in ("est2genome_genomic", "est2genome_bestn", "coding2genome",
                "cdna2genome_annot", "annotation_minus",
                "protein2genome_gff", "affine_local_dna_cross", "geneseed",
                "refine_region", "subopt_no", "forcegtag",
                "intron_penalty_opts", "bestn_ties", "querygff",
                "gapped_no_extension")
    and all(os.path.exists(a) for a in argv if a.startswith(os.sep))
    and os.path.exists(os.path.join(cases.OUTDIR, name + ".txt")))
ROWS_TIER1 = {"est2genome_genomic"}
ARGV = {name: argv for name, _prog, argv in cases.CASES}


@pytest.fixture
def rows_forced(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS", "all")


def _both_clis(argv):
    """The port's CLI and the JAX CLI on argv: (port bytes, engine
    counts, fallbacks), (JAX bytes, fallbacks)."""
    from exonerate_tpu import observe as jobserve
    from exonerate_tpu.cli.exonerate import main as jax_main
    observe.reset()
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    port = (buf.getvalue(), dict(observe.engine_counts),
            dict(observe.fallback_counts))
    jbuf = io.StringIO()
    assert jax_main(list(argv), out=jbuf) == 0
    return port, (jbuf.getvalue(), dict(jobserve.fallback_counts))


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if n in ROWS_TIER1 else pytest.mark.slow)
    for n in ROWS_GOLDENS])
def test_rows_route_matches_golden(rows_forced, name):
    (out, counts, fallbacks), (jout, jfallbacks) = _both_clis(ARGV[name])
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
        assert cases.normalize(out) == fh.read()
    assert out == jout
    assert fallbacks == jfallbacks
    # ungapped's results are its HSPs; --gappedextension no runs no SDP
    if name not in ("bestn_ties", "gapped_no_extension"):
        assert counts["sdp-rows"] > 0, counts


def test_rows_goldens_are_the_in_repo_cases():
    assert ROWS_GOLDENS == sorted([
        "annotation_minus", "bestn_ties", "cdna2genome_annot",
        "coding2genome", "est2genome_genomic", "forcegtag",
        "gapped_no_extension", "geneseed", "intron_penalty_opts",
        "querygff", "refine_region", "subopt_no"])


def test_rows_route_non_boundary_equals_jax_cli(rows_forced):
    """affine:local (start scores attributed to seeds in the reverse
    pass) on cdna_mut x genome_small: the JAX CLI's bytes."""
    argv = ["-m", "affine:local", os.path.join(cases.FIXDIR, "cdna_mut.fa"),
            os.path.join(cases.FIXDIR, "genome_small.fa"), "--showvulgar",
            "yes", "--showalignment", "no"]
    (out, counts, fallbacks), (jout, jfallbacks) = _both_clis(argv)
    assert out == jout and "vulgar:" in out
    assert counts["sdp-rows"] > 0, counts
    assert fallbacks == jfallbacks


def test_rows_knob_turns_the_tier_on_for_a_card(monkeypatch):
    """By default a card keeps the non-boundary models on the host; with
    EXONERATE_TPU_SDP_ROWS a rows-supported model takes the device tier
    (``exonerate_tpu/hub/gam.py:297-302``), and the short-query gate
    lifts for a pair the row scan serves."""
    from exonerate_tpu_torch.engine import sdp_hybrid as thy
    from exonerate_tpu_torch.hub.gam import GAM, GamArgs
    monkeypatch.delenv("EXONERATE_TPU_SDP", raising=False)
    model, pair, plan = tc.case("affine_local")
    gam = GAM(model, GamArgs(), None, device=torch.device("cuda", 0))
    assert gam.sdp_device_active() is False
    assert not thy.rows_usable(model, pair, plan)
    monkeypatch.setenv("EXONERATE_TPU_SDP_ROWS", "1")
    assert gam.sdp_device_active() is True
    assert thy.rows_usable(model, pair, plan)
    gam.device = CPU
    assert gam.sdp_device_active() is False
    monkeypatch.setattr(thy, "DEVICE_MIN_W", 1)
    monkeypatch.setattr(thy, "DEVICE_MIN_CELLS", 1)
    assert not thy.device_worthwhile(plan, 100)
    assert thy.device_worthwhile(plan, 100, rows_ok=True)


@pytest.mark.slow
def test_rows_route_p2g_scan_equals_jax_cli_not_native(rows_forced,
                                                       monkeypatch, tmp_path):
    """chip_smoke's phase 5f input: two mutated calm proteins against the
    1 Mb split-codon genome, both strands.  The port prints the JAX CLI's
    bytes and fallbacks; both report p1's alignment at the gene copy by
    333,439 (645) where the native route finds the copy by 777,883 (657):
    the row tier under-reports that locus, which the hybrid then never
    re-runs on the host."""
    import torch_split_cases as sc
    proteins = sc.mutated_proteins(8)[:2]
    _queries, genome = sc.scan_genome(sc.CUTS)
    qf = sc.write_fasta(str(tmp_path / "pq.fa"),
                        [(f"p{k}", p) for k, p in enumerate(proteins)])
    tf = sc.write_fasta(str(tmp_path / "st.fa"), [("split_genome", genome)])
    argv = ["-m", "protein2genome", "--bestn", "1", "--maxintron", "20000",
            "--showvulgar", "yes", "--showalignment", "no", qf, tf]
    (out, counts, fallbacks), (jout, jfallbacks) = _both_clis(argv)
    assert out == jout and fallbacks == jfallbacks
    assert counts["sdp-rows"] == 4
    monkeypatch.setenv("EXONERATE_TPU_SDP", "native")
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    rows = [ln.split()[:10] for ln in out.splitlines()
            if ln.startswith("vulgar:")]
    native = [ln.split()[:10] for ln in buf.getvalue().splitlines()
              if ln.startswith("vulgar:")]
    assert rows[0] == native[0]
    assert (rows[1][6], rows[1][9]) == ("333439", "645")
    assert (native[1][6], native[1][9]) == ("777883", "657")
