"""The port's CLI through the forced device route of the heuristic.

With EXONERATE_TPU_TORCH_DEVICE=cpu and EXONERATE_TPU_SDP=device, the
seeded heuristic's SDP passes run the port's band scan (the plain
PyTorch version of K6/K7 on the CPU).  Every in-repo est2genome heuristic
golden must be byte-equal, with ``torch-sdp`` counted and no fallback.
"""
import io
import os
import subprocess
import sys

import pytest

from exonerate_tpu import observe
import exonerate_tpu_torch
from exonerate_tpu_torch.cli.exonerate import main

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME_SMALL = os.path.join(cases.FIXDIR, "genome_small.fa")
CDNA_MUT = os.path.join(cases.FIXDIR, "cdna_mut.fa")
SMALL_ARGV = ["-m", "est2genome", CDNA_MUT, GENOME_SMALL,
              "--showvulgar", "yes", "--showalignment", "yes"]


def _heuristic_cases():
    out = {}
    for name, prog, argv in cases.CASES:
        # --refine full re-runs a 1200 x 12000 path DP, which needs the
        # checkpointed traceback (not ported yet, ROADMAP Queue 2)
        if prog != "exonerate" or "est2genome" not in argv or "-E" in argv \
                or "--gappedextension" in argv or "full" in argv:
            continue
        files = [a for a in argv if a.startswith(os.sep)]
        if all(os.path.exists(f) for f in files) and os.path.exists(
                os.path.join(cases.OUTDIR, name + ".txt")):
            out[name] = argv
    return out


CASES = _heuristic_cases()
TIER1 = {"est2genome_genomic"}


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
        "geneseed_120", "e2g_gff_bestn_refine"])


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


def test_forced_route_without_jax_equals_native_route(monkeypatch):
    """cdna_mut x genome_small: the forced device route, in a process
    where jax cannot be imported, prints what the host native route
    prints."""
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "native")
    native = _cli(SMALL_ARGV)
    assert "vulgar:" in native and "torch-sdp" not in observe.engine_counts
    code = (
        "import io, sys\n"
        "sys.modules['jax'] = None\n"
        "from exonerate_tpu_torch.cli.exonerate import main\n"
        "from exonerate_tpu import observe\n"
        "buf = io.StringIO()\n"
        f"assert main({SMALL_ARGV!r}, out=buf) == 0\n"
        "sys.stdout.write(buf.getvalue())\n"
        "assert observe.engine_counts['torch-sdp'] >= 1, "
        "observe.engine_counts\n"
        "assert not observe.fallback_counts, observe.fallback_counts\n")
    env = dict(os.environ, EXONERATE_TPU_TORCH_DEVICE="cpu",
               EXONERATE_TPU_SDP="device")
    env.pop("EXONERATE_TPU_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert cases.normalize(proc.stdout) == cases.normalize(native)


@pytest.mark.parametrize("knob", [("EXONERATE_TPU_SDP_ROWS", "1"),
                                  ("EXONERATE_TPU_CROSS_CHIP", "2")])
def test_unported_tiers_are_refused(forced, monkeypatch, knob):
    monkeypatch.setenv(*knob)
    with pytest.raises(SystemExit, match="not ported"):
        main(list(SMALL_ARGV), out=io.StringIO())
