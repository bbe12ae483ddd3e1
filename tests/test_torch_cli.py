"""The port's CLI against the byte goldens, on the CPU engines.

Every case of tests/golden/cases.py that runs exhaustive DP (-E yes) and
whose input files are all in the repository runs through
``exonerate_tpu_torch.cli.exonerate`` with EXONERATE_TPU_TORCH_DEVICE=cpu
and must reproduce its golden output byte for byte.
"""
import io
import os
import subprocess
import sys

import pytest

from exonerate_tpu import observe
import exonerate_tpu_torch
from exonerate_tpu_torch.cli.exonerate import main
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

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


def test_unported_routes_are_refused(cpu_device):
    argv = list(CASES["exhaustive_affine_local"])
    with pytest.raises(SystemExit, match="--cores"):
        main(argv + ["--cores", "2"], out=io.StringIO())


def test_port_runs_without_jax():
    """The package and its CLI import and run with jax blocked (a
    subprocess: tests/conftest.py imports jax in this process)."""
    name = "exhaustive_affine_local"
    code = (
        "import io, sys\n"
        "sys.modules['jax'] = None\n"
        "import exonerate_tpu_torch.engine.cuda_wavefront\n"
        "import exonerate_tpu_torch.engine.optimal\n"
        "from exonerate_tpu_torch.cli.exonerate import main\n"
        "from exonerate_tpu import observe\n"
        "buf = io.StringIO()\n"
        f"main({list(CASES[name])!r}, out=buf)\n"
        "sys.stdout.write(buf.getvalue())\n"
        "assert observe.engine_counts['torch-wavefront'] >= 1\n")
    env = dict(os.environ, EXONERATE_TPU_TORCH_DEVICE="cpu",
               EXONERATE_TPU_NATIVE_CELLS_TPU="40000")
    env.pop("EXONERATE_TPU_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(cases.OUTDIR, name + ".txt")) as fh:
        assert cases.normalize(proc.stdout) == fh.read()
