"""K5, the sharded locus prescan: K1 data-parallel over several devices.

``cuda_wavefront.find_batched_sharded`` buckets the jobs as
``find_batched`` does, pads each chunk to a multiple of the device count
with copies of its last pair, and runs one contiguous shard per device
(K1 on a card, the plain wavefront on the CPU), every shard launched
before any result is fetched.  It must equal, exactly, the JAX
package's ``find_batched_sharded`` over its 8-device CPU mesh
(``tests/conftest.py``) in Pallas interpret mode, and the port's own
``find_batched``.  The GAM's locus pool takes it for the mask-free first
generation when ``_scan_devices`` names two devices or more; its bytes
must equal the JAX CLI's locus run with a mesh of as many devices.

The test marked ``gpu`` runs K5 on ``[cuda:0, cuda:0]`` against
``find_batched(..., stream=False)`` and skips without a card.
"""
import io
import os

import numpy as np
import pytest
import torch

from exonerate_tpu_torch import observe
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.hub.gam import GAM

CPU = torch.device("cpu")
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")


def _calm_jobs(pkg="exonerate_tpu_torch"):
    """``test_sharded_wavefront_parity``'s six est2genome jobs on calm
    (record 1 of all4.fa), built from package ``pkg``."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    calm = next(iter(mod("seqio").iter_fasta(ALL4)))
    calm.strand = "+"
    data = mod("model.data").AlignData(calm, calm)
    Region = mod("engine.region").Region
    return mod("model.est2genome").est2genome_create(), [
        (Region(0, i * 7, 100, 150 + i), data) for i in range(6)]


def dp_key(r):
    return (r.score, r.query_start, r.target_start, r.query_end,
            r.target_end)


def test_find_batched_sharded_equals_jax_mesh():
    import jax
    from jax.sharding import Mesh
    from exonerate_tpu.engine import pallas_wavefront
    jm, jjobs = _calm_jobs("exonerate_tpu")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "sp"))
    want = pallas_wavefront.find_batched_sharded(jm, jjobs, mesh, "region",
                                                 interpret=True)
    model, jobs = _calm_jobs()
    n5 = cw.K5.launches
    got = cw.find_batched_sharded(model, jobs, [CPU] * 8, "region")
    assert cw.K5.launches == n5 + 8        # 6 jobs padded to one per device
    assert [dp_key(r) for r in got] == [dp_key(r) for r in want]
    ref = cw.find_batched(model, jobs, "region", device=CPU, stream=False)
    assert [dp_key(r) for r in got] == [dp_key(r) for r in ref]


def _locus_argv(tmp_path):
    """``test_locus_scan_mesh_scheduler``'s affine:local recipe (rng 13)
    with two spacers (three copies of the 300 bp query, one locus), and
    the query twice, so that the first generation holds two jobs."""
    rng = np.random.default_rng(13)
    base = "".join(rng.choice(list("ACGT"), 4000))
    query = base[100:400]
    parts = []
    for i in range(2):
        parts += [base[400 + i * 400:400 + i * 400 + 350], query]
    qf, tf = tmp_path / "q.fa", tmp_path / "t.fa"
    qf.write_text(">q\n" + query + "\n>q2\n" + query + "\n")
    tf.write_text(">t\n" + "".join(parts) + base[:400] + "\n")
    return ["-m", "affine:local", "--showvulgar", "yes", "--showalignment",
            "no", str(qf), str(tf)]


def test_locus_pool_shards_its_first_scan(monkeypatch, tmp_path):
    """Two scan devices: the pool's first generation runs on K5 (a locus
    of each query over two CPU devices); the output is the JAX CLI's,
    whose pool runs over a mesh of two devices."""
    import jax
    from jax.sharding import Mesh
    from exonerate_tpu.cli.exonerate import main as jax_main
    from exonerate_tpu.engine import optimal as jopt
    from exonerate_tpu.hub.gam import GAM as JGAM
    from exonerate_tpu_torch.cli.exonerate import main
    argv = _locus_argv(tmp_path)
    monkeypatch.setenv("EXONERATE_TPU_HEURISTIC", "locus")
    monkeypatch.setattr(jopt, "_FORCE_PRESCAN", True)
    monkeypatch.setattr(jopt, "_PRESCAN_INTERPRET", True)
    meshes = []

    def two_devices(self):
        meshes.append(Mesh(np.array(jax.devices()[:2]), ("dp",)))
        return meshes[-1]

    monkeypatch.setattr(JGAM, "_scan_mesh", two_devices)
    jbuf = io.StringIO()
    assert jax_main(list(argv), out=jbuf) == 0
    assert meshes
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(GAM, "_scan_devices", lambda self: [CPU, CPU])
    observe.reset()
    n5 = cw.K5.launches
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    assert cw.K5.launches == n5 + 2
    assert not observe.fallback_counts, dict(observe.fallback_counts)
    assert buf.getvalue() == jbuf.getvalue()
    assert len([ln for ln in buf.getvalue().splitlines()
                if " 1500 M 300 300" in ln]) == 6


def test_scan_devices_need_two_cards():
    gam = GAM.__new__(GAM)
    gam.device = CPU
    assert gam._scan_devices() is None


# -- the kernel on a card ------------------------------------------------

@pytest.mark.gpu
def test_k5_on_one_card_twice_equals_find_batched():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    dev = torch.device("cuda", 0)
    model, jobs = _calm_jobs()
    n5, n1 = cw.K5.launches, cw.wavefront_scan.launches
    got = cw.find_batched_sharded(model, jobs, [dev, dev], "region")
    assert cw.K5.launches == n5 + 2
    assert cw.wavefront_scan.launches == n1 + 2
    ref = cw.find_batched(model, jobs, "region", device=dev, stream=False)
    assert [dp_key(r) for r in got] == [dp_key(r) for r in ref]
    plain = cw.find_batched(model, jobs, "region", device=CPU)
    assert [dp_key(r) for r in got] == [dp_key(r) for r in plain]
