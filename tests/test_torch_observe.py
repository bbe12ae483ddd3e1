"""The port's spans and counters (``exonerate_tpu_torch.observe``).

Off unless a ``torch.profiler`` session records: then nothing is kept and
no ``record_function`` range opens.  Under a profiler, one CLI invocation
on the forced band-scan route (the plain K6/K7 on the CPU, as
``test_torch_sdp_cli.py`` runs it) records the driver's, the hybrid's and
the band preparation's spans under one request id, with self times that
add up on each thread, each span among the profiler's own events, the
device batch's spans under the pool's on their worker thread, and the
printed bytes unchanged.
"""
import collections
import io
import os
import sys
import threading

import pytest
import torch.profiler as tp

import exonerate_tpu_torch
from exonerate_tpu_torch import observe
from exonerate_tpu_torch.cli.exonerate import main

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

ARGV = ["-m", "est2genome", os.path.join(cases.FIXDIR, "cdna_mut.fa"),
        os.path.join(cases.FIXDIR, "genome_small.fa"),
        "--showvulgar", "yes", "--showalignment", "yes"]


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")


@pytest.fixture(autouse=True)
def empty_trace():
    observe.clear_trace()
    yield
    observe.clear_trace()


def _cli(argv):
    buf = io.StringIO()
    assert main(list(argv), out=buf) == 0
    return buf.getvalue()


def _profile(all_threads=False):
    cfg = tp._ExperimentalConfig(profile_all_threads=True) \
        if all_threads else None
    return tp.profile(activities=[tp.ProfilerActivity.CPU],
                      experimental_config=cfg)


def _event_names(prof):
    return collections.Counter(e.name() for e in
                               prof.profiler.kineto_results.events())


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(observe._profiler, "record_function",
                        lambda name: opened.append(name))
    assert not observe._profiler._is_profiler_enabled
    assert observe.span("a") is observe.span("b", k=1)
    with observe.span("a") as s:
        assert s is None
    observe.add("c", 3)
    observe.count_engine("native-sdp")
    fn = observe.traced("d")(lambda x: x + 1)
    assert fn(1) == 2
    assert observe.carry(fn) is fn
    monkeypatch.setenv(exonerate_tpu_torch.DEVICE_ENV, "cpu")
    assert "vulgar:" in _cli(ARGV[:-2])
    t = observe.trace()
    assert t.spans == [] and t.counters == {}
    assert opened == []


def test_counters_and_reset():
    with _profile():
        observe.add("x")
        observe.add("x", 2)
        observe.add("zero", 0)
        observe.count_engine("cuda-sdp", 4)
        observe.count_fallback("why")
    observe.add("x")                          # the profiler has stopped
    observe.reset()
    assert observe.trace().counters == {"x": 3, "engine.cuda-sdp": 4,
                                        "fallback.why": 1}
    assert not observe.engine_counts and not observe.fallback_counts
    observe.clear_trace()
    assert observe.trace().counters == {}


def test_worker_thread_spans_take_the_submitting_span_as_parent():
    got = {}

    @observe.traced("work")
    def work():
        with observe.span("inner", n=2):
            got["thread"] = threading.get_ident()

    with _profile(all_threads=True) as prof:
        with observe.span("outer") as outer:
            t = threading.Thread(target=observe.carry(work))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
    spans = {s.name: s for s in observe.trace().spans}
    assert spans["work"].parent == outer.id
    assert spans["inner"].parent == spans["work"].id
    assert spans["inner"].attrs == {"n": 2}
    assert {s.request for s in spans.values()} == {outer.id}
    assert spans["inner"].thread == got["thread"] != spans["outer"].thread
    # a child on another thread leaves its parent's self time whole
    o = spans["outer"]
    assert o.self_s == pytest.approx(o.end - o.start, abs=1e-12)
    names = _event_names(prof)
    assert all(names[n] >= 1 for n in ("outer", "work", "inner"))


def test_traced_cli_run_records_the_layers(forced):
    plain = _cli(ARGV)
    with _profile() as prof:
        traced = _cli(ARGV)
    assert traced == plain
    t = observe.trace()
    names = {s.name for s in t.spans}
    assert {"run", "setup", "seed.query", "seed.target", "pool",
            "pool.plan", "pool.device", "band.build", "band.copy",
            "band.fetch", "hybrid.resolve", "hybrid.path",
            "report"} <= names, names
    assert t.counters["hybrid.device_comparisons"] >= 1
    assert t.counters["engine.torch-sdp"] >= 1
    (run,) = [s for s in t.spans if s.name == "run"]
    assert run.parent is None
    assert {s.request for s in t.spans} == {run.id}
    by_id = {s.id: s for s in t.spans}
    assert all(s.parent in by_id for s in t.spans if s is not run)
    # self time + the children's durations on the same thread = duration
    kids = collections.defaultdict(float)
    for s in t.spans:
        if s.parent is not None and by_id[s.parent].thread == s.thread:
            kids[s.parent] += s.end - s.start
    for s in t.spans:
        assert s.self_s >= 0
        assert s.self_s + kids[s.id] == pytest.approx(s.end - s.start,
                                                      abs=1e-9), s.name
    pool = next(s for s in t.spans if s.name == "pool")
    dev = next(s for s in t.spans if s.name == "pool.device")
    assert dev.parent == pool.id and dev.thread != pool.thread
    build = next(s for s in t.spans if s.name == "band.build")
    assert build.parent == dev.id
    # the profiler records the thread it runs on: each span there is one
    # of its events, under the span's name
    events = _event_names(prof)
    mine = collections.Counter(s.name for s in t.spans
                               if s.thread == run.thread)
    assert all(events[n] >= k for n, k in mine.items()), (mine, events)
