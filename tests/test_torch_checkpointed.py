"""The checkpointed traceback in the port, against the JAX package.

A path DP whose traceback cube is over the card's budget and whose
native traceback is over the host's (a Waterman-Eggert alignment across
a chromosome-scale target) runs ``optimal.find_path_checkpointed``: a
forward pass over diagonal segments saving the carry rings, then a walk
back that re-runs in path mode only the segments the path crosses.  On
the card each segment is a launch of the cluster kernel that continues
the rings the segment before it left (``cuda_wavefront.wavefront_segment``);
on the CPU it is the plain wavefront over the same span.  These tests
run on the CPU:

- segments chained through the rings give the whole wavefront's best
  end cell and traceback planes;
- three Waterman-Eggert iterations (the later ones masked) of
  est2genome, affine:local and protein2genome: the port's checkpointed
  path equals the JAX package's ``find_path_checkpointed`` (XLA) and the
  port's full-cube path (K4), each segment walked back through
  ``cuda_wavefront.walk_segment`` (on the CPU its plain version, which
  counts no launch);
- an ``-E yes`` run whose every path DP takes the checkpointed route,
  byte-equal to the JAX CLI.

Scores, cells and tracebacks are int32 or discrete: the tolerance is 0.
"""
import dataclasses
import io

import pytest
import torch

from exonerate_tpu.engine import optimal as jopt
from exonerate_tpu.engine import wavefront as jwf
from exonerate_tpu.engine.subopt import SubOpt as JSubOpt
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal as topt
from exonerate_tpu_torch.engine import wavefront as twf
from exonerate_tpu_torch.engine.subopt import SubOpt
from test_torch_subopt import JOBS
from test_torch_subopt_cli import _lower_cutovers, _we_argv
from torch_twins import JAX, PORT, dp_key

CPU = torch.device("cpu")


def _masked_inputs(name: str):
    """The job's path-mode KernelInputs under the mask of its best
    alignment (a second Waterman-Eggert iteration)."""
    model, region, data = JOBS[name](PORT)
    first = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
    sub = SubOpt()
    sub.add_alignment(topt._to_alignment(model, region, first))
    pads = (twf._bucket(region.query_length),
            twf._bucket(region.target_length))
    inputs, kinds = twf.prepare_inputs(model, region, data, subopt=sub,
                                       pad_to=pads, for_pallas=True)
    return cw.to_kernel_inputs(model, inputs, kinds, CPU, "path")


@pytest.mark.parametrize("name", sorted(JOBS))
def test_segments_continue_the_carry_ring(name):
    """Score-mode segments over the rings the segment before left give
    the whole run's best end cell; path-mode segments re-run from the
    saved rings give the whole cube's planes."""
    ki = _masked_inputs(name)
    assert ki.masked
    want_out, want_tb = twf.plain_wavefront(ki)
    D = ki.Qp + ki.Tp + 1
    cut = [0, 7, D // 3, D // 3 + 1, D - 5, D]
    spans = list(zip(cut, cut[1:]))
    ring = cw.ring_buffers(ki)
    saved, bests = [], []
    for span in spans:
        saved.append(tuple(t.clone() for t in ring))
        out, tb = cw.wavefront_segment(cw.with_mode(ki, "score"), ring,
                                       span)
        assert tb is None
        bests.append(out[:3, 0].tolist())
    best = [twf.NEG, 0, 0]
    for cand in bests:
        if topt._better(cand, best):
            best = cand
    assert best == want_out[:3, 0].tolist()
    for span, rings in zip(spans, saved):
        _, tb = cw.wavefront_segment(ki, rings, span)
        assert tb.shape == (1, span[1] - span[0], ki.S, ki.Qp + 1)
        assert torch.equal(tb, want_tb[:, span[0]:span[1]]), span


def test_segment_checks_its_inputs():
    ki = _masked_inputs("est2genome_calm")
    ring = cw.ring_buffers(ki)
    with pytest.raises(ValueError, match="score/path"):
        cw.wavefront_segment(dataclasses.replace(ki, mode="region"), ring,
                             (0, 4))
    with pytest.raises(ValueError, match="span"):
        cw.wavefront_segment(ki, ring, (0, ki.Qp + ki.Tp + 2))
    with pytest.raises(ValueError, match="ring"):
        cw.wavefront_segment(ki, (ring[0][:, :1].contiguous(), ring[1]),
                             (0, 4))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_checkpointed_traceback_matches_jax(name, monkeypatch):
    """Three Waterman-Eggert iterations at about three host chunks each,
    in segments of one and of two chunks: the port's checkpointed path
    equals the JAX package's (XLA) and the port's full-cube path."""
    model, region, data = JOBS[name](PORT)
    jmodel, jregion, jdata = JOBS[name](JAX)
    Q, T = region.query_length, region.target_length
    D, S = Q + T + 1, len(model.states)
    budget = (twf._bucket(Q) + 1) * S * (D // 3)
    jbudget = (Q + 1) * S * (D // 3)
    sub, jsub = SubOpt(), JSubOpt()
    observe.reset()
    walks = []
    real_walk = cw.walk_segment

    def spy(planes, d0, cell, walk, cap):
        walks.append((d0, planes.shape[1]))
        return real_walk(planes, d0, cell, walk, cap)

    monkeypatch.setattr(cw, "walk_segment", spy)
    launches = cw.walkback.launches
    for it in range(3):
        del walks[:]
        got = topt.find_path_checkpointed(model, region, data, sub,
                                          budget_bytes=budget, device=CPU)
        # a walk per segment the path crosses, the last one first
        assert walks and walks == sorted(walks, reverse=True)
        assert walks[0][0] <= got.query_end + got.target_end \
            < sum(walks[0])
        want = jwf.find_path_checkpointed(jmodel, jregion, jdata, jsub,
                                          budget_bytes=jbudget)
        assert dp_key(got) == dp_key(want), f"iteration {it}"
        with monkeypatch.context() as m:
            m.setattr(topt, "_segment_bytes", lambda dev, b: 2 * b)
            wide = topt.find_path_checkpointed(model, region, data, sub,
                                               budget_bytes=budget,
                                               device=CPU)
        assert dp_key(wide) == dp_key(want), f"iteration {it}"
        full = cw.find_path_batched(model, [(region, data)], subopt=sub,
                                    device=CPU)[0]
        assert dp_key(got) == dp_key(full), f"iteration {it}"
        alignment = topt._to_alignment(model, region, got)
        if alignment is None or not alignment.ops:
            break
        sub.add_alignment(alignment)
        jsub.add_alignment(jopt._to_alignment(jmodel, jregion, want))
    assert it == 2
    assert not observe.fallback_counts
    assert cw.walkback.launches == launches


def test_exhaustive_route_takes_the_checkpointed_traceback(monkeypatch,
                                                           tmp_path):
    """With the card's cube budget lowered as well, every path DP of the
    ``-E yes`` run over the native cut-overs is over every budget: the
    port walks it back on the checkpointed route, where it raised
    NotImplementedError before, and prints the JAX CLI's bytes (whose
    default CPU route is the XLA checkpointed traceback)."""
    from exonerate_tpu.cli.exonerate import main as jax_main
    argv = _we_argv(tmp_path)
    _lower_cutovers(monkeypatch)
    monkeypatch.setattr(cw, "PATH_TB_BYTES", 1 << 20)
    calls = []
    real = topt.find_path_checkpointed

    def spy(model, region, *args, **kwargs):
        res = real(model, region, *args, **kwargs)
        calls.append((region.query_length, region.target_length,
                      res.score))
        return res

    monkeypatch.setattr(topt, "find_path_checkpointed", spy)
    from exonerate_tpu_torch.cli.exonerate import main
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    observe.reset()
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    assert not observe.fallback_counts
    got = buf.getvalue()
    assert got.count("vulgar:") == 2
    # both copies' boxes, the second one masked
    assert len(calls) >= 2 and all(sc >= 500 for _q, _t, sc in calls)
    want = io.StringIO()
    assert jax_main(list(argv), out=want) == 0
    assert got == want.getvalue()
