"""The pooled locus heuristic (``EXONERATE_TPU_HEURISTIC=locus``) of the
port, against the JAX package's pool run.

The Analysis defers every gapped comparison and flushes them through
``GAM.result_heuristic_pooled``: a generation-batched Waterman-Eggert
over every locus of every comparison, each generation one masked region
batch (K1 with the SubOpt mask, K3) and one masked path batch (K4 with
K3).  On the CPU the wrappers run the plain versions, so these tests walk
the card's route.  The JAX side runs the same pool with its Pallas
prescan forced in interpret mode and its ``_scan_mesh`` set to None (one
device), as on a single TPU chip.

The inputs follow ``test_locus_scan_mesh_scheduler``'s affine:local
recipe (rng 13): a 300 bp query, ``n`` random 350 bp spacers each
followed by a copy of the query, then the first 400 bp of the random
base, which holds the query once more.  Tier-1 runs ``n`` = 2 (three
copies); the nine-spacer version is slow.
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from exonerate_tpu.engine import optimal as jopt
from exonerate_tpu.hub.gam import GAM as JGAM
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _locus_argv(tmp_path, n: int):
    rng = np.random.default_rng(13)
    base = "".join(rng.choice(list("ACGT"), 4000))
    query = base[100:400]
    parts = []
    for i in range(n):
        parts.append(base[400 + i * 400:400 + i * 400 + 350])
        parts.append(query)
    target = "".join(parts) + base[:400]
    qf, tf = tmp_path / "q.fa", tmp_path / "t.fa"
    qf.write_text(">q\n" + query + "\n")
    tf.write_text(">t\n" + target + "\n")
    return ["-m", "affine:local", "--showvulgar", "yes", "--showalignment",
            "no", str(qf), str(tf)]


@pytest.fixture(scope="module")
def three_copies(tmp_path_factory):
    return _locus_argv(tmp_path_factory.mktemp("locus"), 2)


_JAX_OUT: dict = {}


def _jax_pool(argv, monkeypatch):
    """The JAX package's pool run on one device (its output is kept per
    argv: the tests of this file share the three-copy run)."""
    from exonerate_tpu.cli.exonerate import main
    if tuple(argv) not in _JAX_OUT:
        monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
        monkeypatch.setattr(jopt, "_FORCE_PRESCAN", True)
        monkeypatch.setattr(jopt, "_PRESCAN_INTERPRET", True)
        monkeypatch.setattr(JGAM, "_scan_mesh", lambda self: None)
        buf = io.StringIO()
        assert main(list(argv), out=buf) == 0
        _JAX_OUT[tuple(argv)] = buf.getvalue()
    return _JAX_OUT[tuple(argv)]


def _port_pool(argv, monkeypatch, n_copies: int):
    from exonerate_tpu_torch.cli.exonerate import main
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    gens = []
    real = cw.find_batched

    def spy(model, jobs, mode="region", device=None, subopt=None):
        gens.append(subopt)
        return real(model, jobs, mode, device=device, subopt=subopt)

    monkeypatch.setattr(cw, "find_batched", spy)
    observe.reset()
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    assert not observe.fallback_counts
    assert set(observe.engine_counts) == {"torch-wavefront"}
    # one region batch per generation, masked after the first
    assert len(gens) > n_copies
    assert all(any(s is not None and s.points for s in subs)
               for subs in gens[1:])
    out = buf.getvalue()
    full = [ln for ln in out.splitlines()
            if ln.startswith("vulgar:") and " 1500 M 300 300" in ln]
    assert len(full) == n_copies
    return out


def test_locus_pool_matches_jax_pool(monkeypatch, three_copies):
    monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
    got = _port_pool(three_copies, monkeypatch, 3)
    assert got == _jax_pool(three_copies, monkeypatch)


@pytest.mark.slow
def test_locus_pool_nine_loci_matches_jax_pool(monkeypatch, tmp_path):
    monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
    argv = _locus_argv(tmp_path, 9)
    got = _port_pool(argv, monkeypatch, 10)
    assert got == _jax_pool(argv, monkeypatch)


def test_locus_route_runs_without_jax(monkeypatch, three_copies):
    """The locus route with jax and the JAX package both blocked (a
    subprocess: tests/conftest.py imports jax in this process) prints
    what the JAX package's pool prints, on the plain K1/K4 with masks."""
    argv = three_copies
    code = (
        "import io, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['exonerate_tpu'] = None\n"
        "from exonerate_tpu_torch.cli.exonerate import main\n"
        "from exonerate_tpu_torch.engine import cuda_wavefront as cw\n"
        "from exonerate_tpu_torch import observe\n"
        "masked = []\n"
        "real = cw.find_batched\n"
        "def spy(*a, subopt=None, **k):\n"
        "    masked.append(any(s is not None and s.points\n"
        "                      for s in subopt or []))\n"
        "    return real(*a, subopt=subopt, **k)\n"
        "cw.find_batched = spy\n"
        "buf = io.StringIO()\n"
        f"assert main({argv!r}, out=buf) == 0\n"
        "assert set(observe.engine_counts) == {'torch-wavefront'}\n"
        "assert not observe.fallback_counts\n"
        "assert any(masked)\n"
        "sys.stdout.write(buf.getvalue())\n")
    env = dict(os.environ, EXONERATE_TPU_TORCH_DEVICE="cpu",
               EXONERATE_TPU_HEURISTIC="locus")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _jax_pool(argv, monkeypatch)


def test_locus_route_keeps_its_refusals(monkeypatch, tmp_path):
    """--cores > 1 (one device per worker thread) stays refused."""
    from exonerate_tpu_torch.cli.exonerate import main
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
    with pytest.raises(SystemExit, match="--cores"):
        main(_locus_argv(tmp_path, 1) + ["--cores", "2"], out=io.StringIO())
