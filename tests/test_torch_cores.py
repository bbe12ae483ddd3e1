"""``--cores N`` in the port: the JAX package's thread pool over
comparisons, against the JAX CLI's ``--cores N``, on the CPU.

Under ``--cores N`` the Analysis runs each comparison in a worker thread
(no deferral to the pooled band scan) and submits the results in
comparison order; on a card each worker launches on streams of its own.
The band scan's device tier then runs once per comparison.  The launch
counters, the typing of the kernels' entry points and the generic
wavefront's engine cache are shared by the workers, so they are exact
under concurrent calls.
"""
import io
import os
import sys
import threading
import time

import pytest

from exonerate_tpu.cli.exonerate import main as jax_main
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.cli.exonerate import main
from exonerate_tpu_torch.engine import cuda_sdp as cs
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import generic_wavefront as gw
from exonerate_tpu_torch.hub.gam import GAM
from exonerate_tpu_torch.model.registry import ModelType, get_model
from exonerate_tpu_torch.alphabet import AlphabetType

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

N_THREADS = 8


def _queries_argv(tmp_path):
    """est2genome of the two halves of cdna_mut.fa against
    genome_small.fa: four comparisons with both strands."""
    with open(os.path.join(cases.FIXDIR, "cdna_mut.fa")) as fh:
        seq = "".join(fh.read().split("\n", 1)[1].split())
    qf = tmp_path / "q.fa"
    qf.write_text(f">head\n{seq[:600]}\n>tail\n{seq[600:]}\n")
    return ["-m", "est2genome", str(qf),
            os.path.join(cases.FIXDIR, "genome_small.fa"),
            "--showvulgar", "yes", "--showalignment", "yes"]


def test_forced_band_scan_with_cores_matches_jax_cli(monkeypatch, tmp_path):
    """The default est2genome heuristic with EXONERATE_TPU_SDP=device and
    --cores 2: every comparison's band scan on the device tier (its plain
    version on the CPU) in a worker thread, byte-equal to the JAX CLI
    under the same environment and to the port's --cores 1."""
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")
    argv = _queries_argv(tmp_path)
    one = io.StringIO()
    assert main(argv, out=one) == 0
    workers = set()
    real = GAM.result_heuristic

    def spy(self, comparison):
        workers.add(threading.current_thread().name)
        return real(self, comparison)

    monkeypatch.setattr(GAM, "result_heuristic", spy)
    observe.reset()
    two = io.StringIO()
    assert main(argv + ["--cores", "2"], out=two) == 0
    assert observe.engine_counts["torch-sdp"] >= 1, dict(
        observe.engine_counts)
    assert not observe.fallback_counts, dict(observe.fallback_counts)
    assert workers and threading.main_thread().name not in workers
    assert two.getvalue().count("vulgar:") >= 2
    jax_two = io.StringIO()
    assert jax_main(argv + ["--cores", "2"], out=jax_two) == 0
    assert two.getvalue() == jax_two.getvalue()
    assert two.getvalue().replace(" --cores 2]", "]", 1) == one.getvalue()


def _in_threads(fn, n=N_THREADS):
    """fn(k) in n threads started together; their results in order."""
    out = [None] * n
    start = threading.Barrier(n)

    def run(k):
        start.wait()
        out[k] = fn(k)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_launch_counters_are_exact_under_threads():
    """Every wrapper counts through cuda_wavefront.count: the counts of
    many threads adding at once, with the interpreter switching threads
    as often as it can, equal the serial sum."""
    old = sys.getswitchinterval()
    counters = (cw.wavefront_scan, cw.wavefront_path, cw.walkback, cw.K2,
                cw.K3, cw.K5, cw.K9, cs.band_reverse, cs.band_forward, cs.K8)
    before = [c.launches for c in counters]
    reps = 2000
    sys.setswitchinterval(1e-6)
    try:
        _in_threads(lambda k: [cw.count(c, 1 + (k % 2)) for _ in range(reps)
                               for c in counters])
    finally:
        sys.setswitchinterval(old)
    want = reps * sum(1 + (k % 2) for k in range(N_THREADS))
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [want] * len(counters)


def test_entry_points_are_typed_once_under_threads(monkeypatch):
    """The lazily typed ctypes entry points (cuda_wavefront._lib): threads
    that reach one entry point together type it once."""

    class Entry:
        restype = None

        def __init__(self):
            self.typed = 0

        @property
        def argtypes(self):
            return None

        @argtypes.setter
        def argtypes(self, value):
            time.sleep(0.002)       # a window for another thread
            self.typed += 1

    class Lib:
        def __init__(self):
            self.entries = {}

        def __getattr__(self, name):
            return self.entries.setdefault(name, Entry())

    lib = Lib()
    monkeypatch.setattr(cw._cudabuild, "load", lambda stem: lib)
    monkeypatch.setattr(cw, "_typed", set())
    got = _in_threads(lambda k: cw._lib("stem", f"fn{k % 2}", []))
    assert {id(g) for g in got} == {id(lib.entries["fn0"]),
                                    id(lib.entries["fn1"])}
    assert [e.typed for e in lib.entries.values()] == [1, 1]


def test_generic_engine_cache_fills_once_under_threads(monkeypatch):
    """The generic wavefront's engine cache, filled on first use: threads
    asking for one key together get one engine."""
    model = get_model(ModelType.AFFINE_LOCAL, AlphabetType.DNA,
                      AlphabetType.DNA)
    monkeypatch.setattr(gw, "_CACHE", {})
    real = gw.Engine.__init__

    def slow_init(self, *args, **kwargs):
        time.sleep(0.002)           # a window for another thread
        real(self, *args, **kwargs)

    monkeypatch.setattr(gw.Engine, "__init__", slow_init)
    got = _in_threads(lambda k: gw.build_wavefront(model, 64, 96, "region"))
    assert len({id(e) for e in got}) == 1
    assert len(gw._CACHE) == 1


@pytest.mark.parametrize("cores", [2, 3])
def test_pool_devices_and_streams(monkeypatch, tmp_path, cores):
    """The pool's devices: the CPU for a caller there; on a card the
    visible cards up to --cores, each worker on a stream of its own per
    card (torch.cuda patched: no card here)."""
    from exonerate_tpu_torch.hub import analysis as an
    import torch
    argv = _queries_argv(tmp_path) + ["--cores", str(cores)]
    monkeypatch.setenv("EXONERATE_TPU_TORCH_DEVICE", "cpu")
    made = []
    real_init = an.Analysis.__init__

    def keep(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(an.Analysis, "__init__", keep)
    assert main(argv, out=io.StringIO()) == 0
    assert made[0].gam.devices == [torch.device("cpu")]
    assert made[0]._streams == []
    # a caller on a card: two visible cards, streams per worker
    a = made[0]
    a.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    a.gam.devices = a._pool_devices()
    assert a.gam.devices == [torch.device("cuda", k)
                             for k in range(min(cores, 2))]
    set_to = []
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda device: ("stream", device))
    monkeypatch.setattr(torch.cuda, "set_stream", set_to.append)
    _in_threads(lambda k: a._worker_streams(), 2)
    assert sorted(map(str, set_to)) == sorted(
        str(("stream", d)) for d in a.gam.devices * 2)
