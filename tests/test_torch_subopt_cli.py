"""Waterman-Eggert re-runs of ``-E yes`` through the port's CLI.

``optimal.find_path`` routes a SubOpt-masked job as the JAX package
routes it with its prescan on: the native dense DP first while the job
is at most ``NATIVE_DIRECT_CELLS`` cells and its traceback fits the
budget, else the region scan and the path DP on the kernels with the
mask plane (kernel K3).  Before K3 the port kept every masked job off
the kernels, so a masked job over both bounds raised
``NotImplementedError``: the second iteration of any est2genome ``-E
yes`` run past 16 M cells.

Here the native cut-overs and the traceback budget are lowered in both
packages so that a 180 x 1000 pair walks that route on the CPU: two
interleaved spliced copies of calm 400..580 (exons of 60 bp, GT..AG
gaps of 100 bp), so that the second copy's box holds cells of the first
alignment and the second iteration's path DP runs masked.  The port's
output must be byte-equal to the JAX package's CLI, on its default CPU
route (the checkpointed XLA path DP) and, in a slow case, with its
Pallas prescan forced in interpret mode.
"""
import io

import pytest

from exonerate_tpu.engine import optimal as jopt
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal as topt
import torch_split_cases as sc

WE_QUERY = (400, 580)


def _we_argv(tmp_path):
    q = sc.calm()[WE_QUERY[0]:WE_QUERY[1]]
    t = sc.two_copy_locus(q, 100, 1000, 100)
    return ["-m", "est2genome", "-E", "yes", "--bestn", "2", "--score",
            "500", "--dpmemory", "1",
            sc.write_fasta(str(tmp_path / "q.fa"), [("calm_400_580", q)]),
            sc.write_fasta(str(tmp_path / "t.fa"), [("two_copies", t)]),
            "--showvulgar", "yes", "--showalignment", "no"]


def _lower_cutovers(monkeypatch):
    """The whole pair (181k cells) and each copy's box (~127k) are over
    both cut-overs, and --dpmemory 1 with this budget keeps their native
    traceback planes (20 B per cell) over it."""
    for mod in (topt, jopt):
        monkeypatch.setattr(mod, "NATIVE_TPU_CELLS", 20_000)
        monkeypatch.setattr(mod, "NATIVE_DIRECT_CELLS", 50_000)
        monkeypatch.setattr(mod, "NATIVE_TB_BUDGET", 1 << 20)


def _run_port(argv, monkeypatch):
    from exonerate_tpu_torch.cli.exonerate import main
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    calls = []
    real = cw.find_path_batched

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append((kwargs.get("subopt"), res))
        return res

    monkeypatch.setattr(cw, "find_path_batched", spy)
    observe.reset()
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    assert not observe.fallback_counts
    assert observe.engine_counts["torch-wavefront"] >= 6
    # a masked path DP ran on the plain K4 (the mask blocks cells of its
    # box) and served its job
    masked = [res for s, res in calls if s is not None and s.points]
    assert masked and all(r is not None for res in masked for r in res)
    out = buf.getvalue()
    vulgar = [ln.split() for ln in out.splitlines()
              if ln.startswith("vulgar:")]
    assert len(vulgar) == 2
    for v in vulgar:
        assert v[10::3].count("I") == 2 and int(v[9]) >= 500, v
    assert vulgar[0][6:8] != vulgar[1][6:8]
    return out


def test_masked_exhaustive_route_matches_jax_cli(monkeypatch, tmp_path):
    """The second Waterman-Eggert iteration's region scan and path DP run
    masked on the plain K1/K4; the JAX CLI's default CPU route prints
    the same bytes."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    argv = _we_argv(tmp_path)
    _lower_cutovers(monkeypatch)
    got = _run_port(argv, monkeypatch)
    want = io.StringIO()
    assert jax_main(list(argv), out=want) == 0
    assert got == want.getvalue()


@pytest.mark.slow
def test_masked_exhaustive_route_matches_jax_pallas_prescan(monkeypatch,
                                                            tmp_path):
    """The same run against the JAX CLI with its Pallas prescan forced
    (interpret mode), the TPU's route: masked K1 and K4 with the skewed
    mask plane."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    argv = _we_argv(tmp_path)
    _lower_cutovers(monkeypatch)
    got = _run_port(argv, monkeypatch)
    monkeypatch.setattr(jopt, "_FORCE_PRESCAN", True)
    monkeypatch.setattr(jopt, "_PRESCAN_INTERPRET", True)
    want = io.StringIO()
    assert jax_main(list(argv), out=want) == 0
    assert got == want.getvalue()
