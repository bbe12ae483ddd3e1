"""The port's ``parallel/`` against the JAX package's.

- ``--multihost``: the chunk-merge tests of ``tests/test_multihost.py``
  on the port's CLI, and two real 2-rank runs (two processes on gloo over
  127.0.0.1, CPU device) whose rank 0 prints the one-process bytes;
- the sharded pair and the target-tiled pair on CPU device lists against
  the JAX functions over the conftest's 8-device CPU mesh;
- the sharded ungapped scan on a dp x sp grid of CPU devices against the
  JAX ``make_sharded_scan`` on the same mesh shape;
- ``dryrun_multichip`` on four CPU devices.
"""
from __future__ import annotations

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import exonerate_tpu_torch
from exonerate_tpu_torch.cli.exonerate import build_parser, make_analysis
from exonerate_tpu_torch.parallel.multihost import (ChunkReport,
                                                    gather_chunk_report,
                                                    merge_chunk_reports)

import torch_twins as tw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")


def _write_db(tmp_path):
    """tests/test_multihost.py's database: six targets, each a mutated
    copy of q0, so that bestn ranks across chunks with exact ties."""
    rng = np.random.default_rng(21)
    base = "".join(rng.choice(list("ACGT"), 2400))
    qf = tmp_path / "q.fa"
    qf.write_text(">q0\n" + base[200:500] + "\n>q1\n" + base[900:1150]
                  + "\n")
    targets = []
    for k in range(6):
        body = list(base[200:500])
        for pos in range(0, k * 20, 7):
            body[pos] = "ACGT"[(ord(body[pos]) + 1) % 4]
        targets.append(f">t{k}\n" + base[k * 100:k * 100 + 80]
                       + "".join(body) + base[1500:1700] + "\n")
    tf = tmp_path / "t.fa"
    tf.write_text("".join(targets))
    return str(qf), str(tf)


def _run(argv):
    v = build_parser().parse(argv)
    buf = io.StringIO()
    make_analysis(v, out=buf).process()
    return buf.getvalue()


def _merged(argv, axis, n_chunks):
    reports, best_n = [], 0
    for c in range(1, n_chunks + 1):
        v = build_parser().parse(argv + [f"--{axis}chunkid", str(c),
                                         f"--{axis}chunktotal",
                                         str(n_chunks)])
        buf = io.StringIO()
        analysis = make_analysis(v, out=buf)
        analysis.gam.defer_report = True
        analysis.process()
        rep = gather_chunk_report(analysis, buf)
        rep.chunk_id = c
        reports.append(rep)
        best_n = analysis.gam.gas.best_n
    # the merge must not depend on arrival order
    return merge_chunk_reports(reports[::-1], best_n)


AFFINE = ["-m", "affine:local", "--showalignment", "no", "--score", "120"]
MERGES = {
    "target_bestn": (["--showvulgar", "yes", "--bestn", "2"], "target", 3),
    "query_bestn": (["--showvulgar", "yes", "--bestn", "1"], "query", 2),
    "target_no_bestn": (["--showcigar", "yes"], "target", 3)}


@pytest.mark.parametrize("name", sorted(MERGES))
def test_chunk_merge_equals_one_run(tmp_path, name):
    flags, axis, n = MERGES[name]
    qf, tf = _write_db(tmp_path)
    argv = AFFINE + flags + [qf, tf]
    single = _run(argv)
    assert single.count("vulgar:") + single.count("cigar:") >= (
        2 if name == "target_bestn" else 1)
    assert _merged(argv, axis, n) == single


def test_merge_tie_rank_semantics():
    """Tie groups admit beyond N and evict wholesale (ref:
    gam.c:267-326), across chunk boundaries."""
    r1 = ChunkReport(1, "", {"q": [(100, "a#%_EXONERATE_BESTN_RANK_%\n", 0),
                                   (90, "b#%_EXONERATE_BESTN_RANK_%\n", 1)]})
    r2 = ChunkReport(2, "", {"q": [(100, "c#%_EXONERATE_BESTN_RANK_%\n", 0),
                                   (80, "d#%_EXONERATE_BESTN_RANK_%\n", 1)]})
    assert merge_chunk_reports([r2, r1], best_n=1) == "a#1\nc#2\n"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    env[exonerate_tpu_torch.DEVICE_ENV] = "cpu"
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env.update(extra)
    return env


def _cli_cmd(argv):
    return [sys.executable, "-m", "exonerate_tpu_torch.cli.exonerate"] + argv


@pytest.mark.parametrize("axis,flags", [
    ("target", ["--showvulgar", "yes", "--bestn", "2"]),
    ("query", ["--showvulgar", "yes", "--bestn", "1"])])
def test_two_rank_multihost_prints_the_one_process_bytes(tmp_path, axis,
                                                         flags):
    """Two ranks on gloo over 127.0.0.1: rank 0 prints exactly what one
    process prints; rank 1 prints the header and the footer only."""
    qf, tf = _write_db(tmp_path)
    argv = AFFINE + flags + [qf, tf]
    one = subprocess.run(_cli_cmd(argv + ["--multihost", axis]),
                         env=_cli_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert one.returncode == 0, one.stderr
    plain = subprocess.run(_cli_cmd(argv), env=_cli_env(),
                           capture_output=True, text=True, timeout=120,
                           cwd=ROOT)
    port = str(_free_port())
    procs = [subprocess.Popen(
        _cli_cmd(argv + ["--multihost", axis]),
        env=_cli_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    strip = lambda s: s.replace(" --multihost " + axis, "")  # noqa: E731
    assert outs[0][0] == one.stdout
    assert strip(outs[0][0]) == plain.stdout
    assert "vulgar:" in outs[0][0]
    lines = outs[1][0].splitlines()
    assert lines[0].startswith("Command line:") and \
        lines[-1] == "-- completed exonerate analysis" and len(lines) == 3


def _e2g_pair(X, seed, n_ex=60, n_intron=40, flank=30):
    rng = np.random.default_rng(seed)
    dna = X.AlphabetType.DNA

    def s(n):
        return "".join(rng.choice(list("ACGT"), n))
    ex1, ex2 = s(n_ex), s(n_ex)
    intr = "GT" + s(n_intron) + "AG"
    genome = s(flank) + ex1 + intr + ex2 + s(flank)
    from importlib import import_module
    Alphabet = import_module(f"{X.pkg}.alphabet").Alphabet
    q = X.Sequence("q", None, ex1 + ex2, Alphabet(dna))
    t = X.Sequence("t", None, genome, Alphabet(dna))
    ia = X.IntronArgs(min_intron=20, max_intron=1000)
    model = X.est2genome_create(ia)
    data = X.AlignData(q, t)
    data.intron = ia
    return model, X.Region(0, 0, len(q), len(t)), data


def _key(r):
    return (r.score, r.query_start, r.target_start, r.query_end,
            r.target_end)


def _mesh(dp, sp):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:dp * sp])
    return Mesh(devs.reshape(dp, sp), ("dp", "sp"))


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_pair_matches_jax(n):
    """Query slabs over n CPU devices (8 slabs of 16 lanes; the halo rows
    cross every slab each diagonal) against the JAX function over a
    1 x n mesh, and against the port's single-device region DP."""
    from exonerate_tpu.parallel import sharded_pair as jsp
    from exonerate_tpu_torch.engine import cuda_wavefront
    from exonerate_tpu_torch.parallel import sharded_pair as tsp
    model, region, data = _e2g_pair(tw.PORT, 3)
    jmodel, jregion, jdata = _e2g_pair(tw.JAX, 3)
    got = tsp.find_region_sharded_pair(model, region, data, [CPU] * n)
    want = jsp.find_region_sharded_pair(jmodel, jregion, jdata, _mesh(1, n))
    one = cuda_wavefront.find_batched(model, [(region, data)], "region",
                                      device=CPU)[0]
    assert _key(got) == _key(want) == _key(one)
    assert got.score > 0


def test_target_tiled_pair_matches_jax():
    from exonerate_tpu.parallel import sharded_pair as jsp
    from exonerate_tpu_torch.parallel import sharded_pair as tsp
    model, region, data = _e2g_pair(tw.PORT, 9)
    jmodel, jregion, jdata = _e2g_pair(tw.JAX, 9)
    got = tsp.find_region_target_tiled(model, region, data, [CPU] * 4)
    want = jsp.find_region_target_tiled(jmodel, jregion, jdata,
                                        _mesh(1, 4))
    assert _key(got) == _key(want)
    assert got.score > 0


def test_sharded_pair_halo_wider_than_a_slab():
    """coding2genome (query advance 3) on 8 slabs of 2 lanes: a slab's
    halo spans the two slabs below it.  Equal to the single device."""
    from exonerate_tpu_torch.engine import cuda_wavefront
    from exonerate_tpu_torch.parallel import sharded_pair as tsp
    X = tw.PORT
    rng = np.random.default_rng(4)
    cds = "".join(rng.choice(list("ACGT"), 15))
    t = "".join(rng.choice(list("ACGT"), 20)) + cds + "".join(
        rng.choice(list("ACGT"), 20))
    mt = X.ModelType.CODING2GENOME
    model = X.get_model(mt, X.AlphabetType.DNA, X.AlphabetType.DNA)
    data = X.AlignData(X.Sequence("q", None, cds),
                       X.Sequence("t", None, t), X.translate_both(mt))
    region = X.Region(0, 0, len(cds), len(t))
    assert max(tr.advance_query for tr in model.transitions) == 3
    got = tsp.find_region_sharded_pair(model, region, data, [CPU] * 8)
    one = cuda_wavefront.find_batched(model, [(region, data)], "region",
                                      device=CPU)[0]
    assert _key(got) == _key(one)


def test_sharded_ungapped_scan_matches_jax():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from exonerate_tpu.parallel import ungapped_scan as jus
    from exonerate_tpu_torch.parallel import ungapped_scan as tus
    from exonerate_tpu_torch.submat import SYMBOL_INDEX, Submat
    dp, sp = 2, 2
    B, Q, S, Tt = 4, 24, 4, 40
    rng = np.random.default_rng(0)
    acgt = np.array([SYMBOL_INDEX[ord(c)] for c in "ACGT"])
    q_codes = acgt[rng.integers(0, 4, (B, Q))].astype(np.int32)
    t_tiles = acgt[rng.integers(0, 4, (S, Tt))].astype(np.int32)
    starts = (np.arange(S) * Tt).astype(np.int32)
    sub = Submat.create("nucleic").matrix
    grid = [[CPU] * sp for _ in range(dp)]
    best, top = tus.make_sharded_scan(grid, B, Q, S * Tt, S, sub)(
        q_codes, t_tiles, starts)
    mesh = _mesh(dp, sp)
    jbest, jtop = jus.make_sharded_scan(mesh, B, Q, S * Tt, S, sub)(
        jax.device_put(q_codes, NamedSharding(mesh, P("dp", None))),
        jax.device_put(t_tiles, NamedSharding(mesh, P("sp", None))),
        jax.device_put(starts, NamedSharding(mesh, P("sp"))))
    assert best.tolist() == np.asarray(jbest).tolist()
    assert top.tolist() == np.asarray(jtop).tolist()
    one = tus.single_device_scan(sub, CPU)(q_codes, t_tiles, starts)
    assert one.tolist() == np.asarray(
        jus.single_device_scan(sub)(q_codes, t_tiles, starts)).tolist()


def test_dryrun_on_four_cpu_devices():
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.parallel.dryrun import dryrun_multichip
    observe.reset()
    res = dryrun_multichip([CPU] * 4)
    assert res["ungapped"]["dp"] == 2 and res["ungapped"]["sp"] == 2
    assert observe.engine_counts["torch-sdp-xchip"] == 1
    assert res["pair"][0] > 0
