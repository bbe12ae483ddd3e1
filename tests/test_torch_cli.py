"""The port's CLI against the byte goldens, on the CPU engines.

Every case of tests/golden/cases.py that runs exhaustive DP (-E yes) and
whose input files are all in the repository runs through
``exonerate_tpu_torch.cli.exonerate`` with EXONERATE_TPU_TORCH_DEVICE=cpu
and must reproduce its golden output byte for byte.  protein2genome
``-E yes`` on a small pair whose exons split codons of both phases must
print what the JAX package's CLI prints.
"""
import io
import os
import subprocess
import sys

import pytest

import exonerate_tpu_torch
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.cli.exonerate import main
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402
import torch_split_cases as sc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _exhaustive_cases():
    out = []
    for name, prog, argv in cases.CASES:
        if prog != "exonerate" or "-E" not in argv \
                or argv[argv.index("-E") + 1] != "yes":
            continue
        files = [a for a in argv if a.startswith(os.sep)]
        if all(os.path.exists(f) for f in files) and os.path.exists(
                os.path.join(cases.OUTDIR, name + ".txt")):
            out.append((name, argv))
    return out


CASES = dict(_exhaustive_cases())


def _run(name):
    buf = io.StringIO()
    assert main(list(CASES[name]), out=buf) == 0
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
        assert cases.normalize(buf.getvalue()) == fh.read()


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")


def test_case_list_is_the_in_repo_exhaustive_set():
    assert sorted(CASES) == sorted([
        "exhaustive_affine_local", "exhaustive_affine_global",
        "exhaustive_affine_bestfit", "exhaustive_affine_overlap",
        "exhaustive_subopt", "exhaustive_est2genome",
        "c2c_exhaustive_revcomp_display", "display_pam250_exhaustive"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_cli_matches_golden(cpu_device, name):
    _run(name)
    assert not observe.fallback_counts
    if name == "exhaustive_est2genome":
        # 1200 x 1000 is over NATIVE_TPU_CELLS: the region scans ran on
        # the wavefront engine (its plain version, on the CPU)
        assert observe.engine_counts["torch-wavefront"] >= 1


def test_est2genome_subregion_path_on_the_wavefront(cpu_device,
                                                    monkeypatch):
    """With the native cut-over lowered, the region scan's sub-box runs
    its path DP through find_path_batched as well."""
    monkeypatch.setattr(optimal, "NATIVE_TPU_CELLS", 40_000)
    calls = []
    real = cw.find_path_batched

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(res)
        return res

    monkeypatch.setattr(cw, "find_path_batched", spy)
    _run("exhaustive_est2genome")
    assert calls and all(r is not None for res in calls for r in res)
    assert "native" not in observe.engine_counts
    assert not observe.fallback_counts


def test_cores_matches_jax_cli(cpu_device, monkeypatch):
    """--cores 2 (the JAX package's thread pool; -E yes runs its pairs in
    the main thread) prints what the JAX CLI's --cores 2 prints, and
    what the port's --cores 1 prints but for the echoed command line.
    The native cut-over is lowered so that the pair runs on the
    wavefront (its plain version on the CPU)."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    monkeypatch.setattr(optimal, "NATIVE_TPU_CELLS", 40_000)
    argv = list(CASES["exhaustive_affine_local"])
    one, two, jax_two = io.StringIO(), io.StringIO(), io.StringIO()
    assert main(argv, out=one) == 0
    observe.reset()
    assert main(argv + ["--cores", "2"], out=two) == 0
    assert observe.engine_counts["torch-wavefront"] >= 1
    assert not observe.fallback_counts
    assert jax_main(argv + ["--cores", "2"], out=jax_two) == 0
    assert two.getvalue() == jax_two.getvalue()
    assert two.getvalue().replace(" --cores 2]", "]", 1) == one.getvalue()


def _p2g_split_argv(tmp_path):
    """protein2genome -E yes on the small calm-protein split pair."""
    q, t = sc.small_pair("protein")
    return ["-m", "protein2genome", "-E", "yes", "--bestn", "1",
            sc.write_fasta(str(tmp_path / "q.fa"), [("calm_30_120", q)]),
            sc.write_fasta(str(tmp_path / "t.fa"), [("split", t)]),
            "--showvulgar", "yes", "--showalignment", "yes"]


def test_port_runs_without_jax(tmp_path):
    """The package and its CLI import and run with jax and the JAX
    package both blocked (a subprocess: tests/conftest.py imports jax in
    this process): exhaustive affine:local and est2genome goldens, and
    protein2genome -E yes on the split pair, on the plain wavefront."""
    names = ["exhaustive_affine_local", "exhaustive_est2genome"]
    argvs = [list(CASES[n]) for n in names] + [_p2g_split_argv(tmp_path)]
    code = (
        "import io, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['exonerate_tpu'] = None\n"
        "import exonerate_tpu_torch.engine.cuda_wavefront\n"
        "import exonerate_tpu_torch.engine.optimal\n"
        "from exonerate_tpu_torch.cli.exonerate import main\n"
        "from exonerate_tpu_torch import observe\n"
        f"for argv in {argvs!r}:\n"
        "    observe.reset()\n"
        "    buf = io.StringIO()\n"
        "    assert main(argv, out=buf) == 0\n"
        "    sys.stdout.write(buf.getvalue() + chr(0))\n"
        "    assert observe.engine_counts['torch-wavefront'] >= 1\n"
        "    assert not observe.fallback_counts\n")
    env = dict(os.environ, EXONERATE_TPU_TORCH_DEVICE="cpu",
               EXONERATE_TPU_NATIVE_CELLS_TPU="40000")
    env.pop("EXONERATE_TPU_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    outs = proc.stdout.split(chr(0))
    for name, out in zip(names, outs):
        with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
            assert cases.normalize(out) == fh.read()
    assert outs[2].count("vulgar:") == 1 and " S " in outs[2]


def test_p2g_exhaustive_split_pair_matches_jax_cli(cpu_device, monkeypatch,
                                                  tmp_path):
    """protein2genome -E yes, routed onto the plain K1 and K4 (the native
    cut-over lowered), prints what the JAX package's CLI prints; the
    vulgar line holds split-codon (S) operations at both introns."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    argv = _p2g_split_argv(tmp_path)
    monkeypatch.setattr(optimal, "NATIVE_TPU_CELLS", 10_000)
    observe.reset()
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    # the region scan and the path DP; the SubOpt-masked re-run that
    # looks for a next alignment is under NATIVE_DIRECT_CELLS and runs
    # on the native dense DP, as in the JAX package
    assert observe.engine_counts["torch-wavefront"] >= 2
    assert not observe.fallback_counts
    want = io.StringIO()
    assert jax_main(list(argv), out=want) == 0
    assert buf.getvalue() == want.getvalue()
    vulgar = next(ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("vulgar:"))
    ops = vulgar.split()[10:]
    kinds = [ops[k] for k in range(0, len(ops), 3)]
    assert kinds.count("I") == 2 and kinds.count("S") == 4, vulgar
