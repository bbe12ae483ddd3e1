"""The port's CLI through the forced device route of the heuristic.

With EXONERATE_TPU_TORCH_DEVICE=cpu and EXONERATE_TPU_SDP=device, the
seeded heuristic's SDP passes run the port's band scan (the plain
PyTorch version of K6/K7 on the CPU).  Every in-repo est2genome heuristic
golden, and every in-repo split-codon golden (coding2genome and
cdna2genome, kernel K9 inside K7), must be byte-equal, with
``torch-sdp`` counted and no fallback.
"""
import io
import os
import subprocess
import sys

import pytest

import exonerate_tpu_torch
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.cli.exonerate import main

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402
import torch_split_cases as sc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME_SMALL = os.path.join(cases.FIXDIR, "genome_small.fa")
CDNA_MUT = os.path.join(cases.FIXDIR, "cdna_mut.fa")
SMALL_ARGV = ["-m", "est2genome", CDNA_MUT, GENOME_SMALL,
              "--showvulgar", "yes", "--showalignment", "yes"]


def _heuristic_cases():
    out = {}
    for name, prog, argv in cases.CASES:
        if prog != "exonerate" or "est2genome" not in argv or "-E" in argv \
                or "--gappedextension" in argv:
            continue
        files = [a for a in argv if a.startswith(os.sep)]
        if all(os.path.exists(f) for f in files) and os.path.exists(
                os.path.join(cases.OUTDIR, name + ".txt")):
            out[name] = argv
    return out


CASES = _heuristic_cases()
TIER1 = {"est2genome_genomic"}
SPLIT_GOLDENS = ("coding2genome", "ryo_coding", "cdna2genome_annot",
                 "annotation_minus", "cd2g_gff_annot_bestn2")
SPLIT_CASES = {n: a for n, p, a in cases.CASES if n in SPLIT_GOLDENS}
SPLIT_TIER1 = {"coding2genome"}


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")


def _cli(argv):
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    return buf.getvalue()


def test_case_list_is_the_in_repo_est2genome_heuristic_set():
    assert sorted(CASES) == sorted([
        "est2genome_genomic", "querygff", "refine_region", "subopt_no",
        "ryo_sections", "intron_penalty_opts", "forcegtag", "geneseed",
        "geneseed_120", "e2g_gff_bestn_refine",
        # --refine full re-runs a 1200 x 12000 path DP under the SubOpt
        # mask: on K1/K4 with K3 since the masked route was ported
        "e2g_gff_refine_full_bestn2"])


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if n in TIER1 else pytest.mark.slow)
    for n in sorted(CASES)])
def test_forced_route_matches_golden(forced, name):
    out = _cli(CASES[name])
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
        assert cases.normalize(out) == fh.read()
    assert observe.engine_counts["torch-sdp"] >= 1, dict(
        observe.engine_counts)
    assert not observe.fallback_counts, dict(observe.fallback_counts)


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=() if n in SPLIT_TIER1 else pytest.mark.slow)
    for n in SPLIT_GOLDENS])
def test_forced_split_codon_route_matches_golden(forced, name):
    out = _cli(SPLIT_CASES[name])
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
        assert cases.normalize(out) == fh.read()
    assert observe.engine_counts["torch-sdp"] >= 1, dict(
        observe.engine_counts)
    assert not observe.fallback_counts, dict(observe.fallback_counts)


def _c2g_split_argv(tmp_path):
    """coding2genome on the small split cDNA pair."""
    q, t = sc.small_pair("cdna", cuts=sc.C2G_CUTS)
    return ["-m", "coding2genome", "--bestn", "1",
            sc.write_fasta(str(tmp_path / "q.fa"), [("calm_181_481", q)]),
            sc.write_fasta(str(tmp_path / "t.fa"), [("split", t)]),
            "--showvulgar", "yes", "--showalignment", "no"]


def test_forced_route_without_jax_equals_native_route(monkeypatch,
                                                      tmp_path):
    """cdna_mut x genome_small (est2genome) and coding2genome on the
    small split pair: the forced device route, in a process where
    neither jax nor the JAX package can be imported, prints what the
    host native route prints."""
    argvs = [SMALL_ARGV, _c2g_split_argv(tmp_path)]
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "native")
    native = []
    for argv in argvs:
        observe.reset()
        native.append(_cli(argv))
        assert "vulgar:" in native[-1]
        assert "torch-sdp" not in observe.engine_counts
    code = (
        "import io, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['exonerate_tpu'] = None\n"
        "from exonerate_tpu_torch.cli.exonerate import main\n"
        "from exonerate_tpu_torch import observe\n"
        f"for argv in {argvs!r}:\n"
        "    observe.reset()\n"
        "    buf = io.StringIO()\n"
        "    assert main(argv, out=buf) == 0\n"
        "    sys.stdout.write(buf.getvalue() + chr(0))\n"
        "    assert observe.engine_counts['torch-sdp'] >= 1, "
        "observe.engine_counts\n"
        "    assert not observe.fallback_counts, observe.fallback_counts\n")
    env = dict(os.environ, EXONERATE_TPU_TORCH_DEVICE="cpu",
               EXONERATE_TPU_SDP="device")
    env.pop("EXONERATE_TPU_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    outs = proc.stdout.split(chr(0))
    for got, want in zip(outs, native):
        assert cases.normalize(got) == cases.normalize(want)
    assert " S " in outs[1]


@pytest.mark.parametrize("knob", [("EXONERATE_TPU_SDP_ROWS", "1")])
def test_unported_tiers_are_refused(forced, monkeypatch, knob):
    monkeypatch.setenv(*knob)
    with pytest.raises(SystemExit, match="not ported"):
        main(list(SMALL_ARGV), out=io.StringIO())


def test_cross_chip_knob_on_one_device_prints_the_default_bytes(
        forced, monkeypatch):
    """EXONERATE_TPU_CROSS_CHIP=2 with fewer devices than that is ignored
    (``_cross_chip_config`` returns 0), as in the JAX package: the CLI
    prints what the JAX CLI prints, through the default device route.
    The column floor is lowered so that only the device count decides."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP", "2")
    jbuf = io.StringIO()
    assert jax_main(list(SMALL_ARGV), out=jbuf) == 0
    monkeypatch.setenv("EXONERATE_TPU_CROSS_CHIP_MIN_W", "1")
    observe.reset()
    assert _cli(SMALL_ARGV) == jbuf.getvalue()
    assert observe.engine_counts["torch-sdp"] >= 1, dict(
        observe.engine_counts)
    assert not any("xchip" in k for k in observe.engine_counts)
    assert not observe.fallback_counts, dict(observe.fallback_counts)


@pytest.mark.slow
def test_c2g_scan_crosscheck_disagrees_as_in_the_jax_package(forced,
                                                            monkeypatch,
                                                            tmp_path):
    """Query 9 of chip_smoke.py's coding2genome scan (the 1 Mb genome of
    ``scan_genome(CUTS)``) on the forced device route, in both packages
    (the port's plain band scan, the JAX package's XLA scan): the host's
    re-run of one locus alone scores 2008 where the band scan of the whole
    comparison scores 2007, so the hybrid's cross-check sends the
    comparison to the host in both, with the same fallback and the host
    route's bytes."""
    from exonerate_tpu import observe as jobserve
    from exonerate_tpu.cli.exonerate import main as jax_main
    from exonerate_tpu.engine import sdp_hybrid as jhy
    from exonerate_tpu_torch.engine import sdp_hybrid as thy
    queries, genome = sc.scan_genome(sc.CUTS)
    argv = ["-m", "coding2genome", "--bestn", "1", "--maxintron", "20000",
            sc.write_fasta(str(tmp_path / "q.fa"), [("q9", queries[9])]),
            sc.write_fasta(str(tmp_path / "t.fa"),
                           [("split_genome", genome)]),
            "--showvulgar", "yes", "--showalignment", "no"]
    for mod in (jhy, thy):
        monkeypatch.setattr(mod, "SCAN_DIAG_CAP", 10 ** 6)
    want = {"sdp device->host: locus score mismatch (2008 != 2007)": 1}
    observe.reset()
    got = _cli(argv)
    assert dict(observe.fallback_counts) == want
    jobserve.reset()
    buf = io.StringIO()
    assert jax_main(list(argv), out=buf) == 0
    assert dict(jobserve.fallback_counts) == want
    assert got == buf.getvalue()
    monkeypatch.setenv("EXONERATE_TPU_SDP", "native")
    assert _cli(argv) == got
