"""The two genome2genome CLI runs that raised before the port had its
generic wavefront (ROADMAP Queue 3), byte for byte against the JAX CLI.

The first 300 bp of ``cdna_mut.fa`` against ``genome.fa[2990:3330]``,
where they align, with both packages' ``NATIVE_TB_BUDGET`` and
``--dpmemory`` at 1 MB, so that every path DP is past the host's budget:

- ``-E yes``: both packages take the checkpointed traceback, the JAX
  package on its XLA engine, the port on the generic wavefront (on the
  CPU here);
- ``EXONERATE_TPU_HEURISTIC=locus``: the pool's region and path batches
  go to the generic engine, with the JAX package's fallback reason (its
  Pallas prescan forced, one device).

``--score 1000`` bounds each run to the cut's best alignments, and
``--revcomp no`` to the forward strands (a third of the DPs).
"""
import io
import os

import pytest
import torch

from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import optimal as topt

DATA = os.path.join(os.path.dirname(__file__), "golden", "data")


def _seq(name):
    with open(os.path.join(DATA, name)) as fh:
        return "".join(fh.read().split("\n", 1)[1].split())


CDNA, GENOME = _seq("cdna_mut.fa"), _seq("genome.fa")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the engine's tensors are a few hundred lanes,
    and the suite runs several test processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CLI_CUT = (CDNA[:300], GENOME[2990:3330])


def _cli_files(tmp_path):
    qf, tf = tmp_path / "q.fa", tmp_path / "t.fa"
    qf.write_text(">q\n" + CLI_CUT[0] + "\n")
    tf.write_text(">t\n" + CLI_CUT[1] + "\n")
    return [str(qf), str(tf)]


def _both_clis(monkeypatch, argv, prescan):
    """(JAX bytes, JAX engines, JAX fallbacks), then the port's, with the
    native traceback budget and --dpmemory at 1 MB in both packages; the
    JAX package's Pallas prescan forced (in interpret mode, one device)
    when ``prescan``, as on a TPU."""
    from exonerate_tpu import observe as jobserve
    from exonerate_tpu.cli.exonerate import main as jax_main
    from exonerate_tpu.engine import optimal as jopt
    from exonerate_tpu.hub.gam import GAM as JGAM
    from exonerate_tpu_torch.cli.exonerate import main
    monkeypatch.setattr(jopt, "NATIVE_TB_BUDGET", 1 << 20)
    monkeypatch.setattr(topt, "NATIVE_TB_BUDGET", 1 << 20)
    monkeypatch.setattr(jopt, "_FORCE_PRESCAN", prescan)
    monkeypatch.setattr(jopt, "_PRESCAN_INTERPRET", True)
    monkeypatch.setattr(JGAM, "_scan_mesh", lambda self: None)
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    argv = ["--dpmemory", "1"] + argv
    jobserve.reset()
    jbuf = io.StringIO()
    assert jax_main(list(argv), out=jbuf) == 0
    want = (jbuf.getvalue(), dict(jobserve.engine_counts),
            dict(jobserve.fallback_counts))
    observe.reset()
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    return want, (buf.getvalue(), dict(observe.engine_counts),
                  dict(observe.fallback_counts))


def test_genome2genome_exhaustive_matches_jax_cli(monkeypatch, tmp_path):
    """``-E yes``: each path DP is over the native budget and its cube over
    --dpmemory, so both packages take the checkpointed traceback (XLA's,
    the generic engine's); --score 1000 keeps the loop to the cut's
    best alignments on the forward strands."""
    (jout, jeng, jfb), (out, eng, fb) = _both_clis(
        monkeypatch, ["-m", "genome2genome", "-E", "yes", "--score", "1000",
                      "--revcomp", "no"] + _cli_files(tmp_path),
        prescan=False)
    assert out == jout
    assert "vulgar: q 0 300 + t 10 310 + 1455 M 300 300" in out
    assert set(jeng) == {"xla"} and eng == {"torch-generic": jeng["xla"]}
    assert fb == jfb == {}


def test_genome2genome_locus_matches_jax_cli(monkeypatch, tmp_path):
    """``EXONERATE_TPU_HEURISTIC=locus``: the pool's region and path batches
    go to the generic engine, with the JAX package's fallback reason (its
    Pallas prescan forced, one device; genome2genome's 2-D calc grids
    are what its kernel refuses first).  --score 1000 ends the pool
    after its first generation of alignments."""
    monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
    (jout, jeng, jfb), (out, eng, fb) = _both_clis(
        monkeypatch, ["-m", "genome2genome", "--score", "1000", "--revcomp",
                      "no"] + _cli_files(tmp_path), prescan=True)
    assert out == jout
    assert "1455 M 300 300" in out
    assert set(fb) == set(jfb) == {"pallas->xla: unsupported input kinds"}
    assert set(eng) == {"torch-generic"}
