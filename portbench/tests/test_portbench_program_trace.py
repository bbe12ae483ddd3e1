"""CPU test of the metrics that read the program's own spans and counters
(``portbench/program_trace.py``): a traced ``e2g.scan`` run at a tiny
size on the forced band-scan route (the plain K6/K7), with every other
comparison sent to the pool's host route, reports the program-span and
program-counter metrics and none of the device-trace ones, names its idle
time by the program's spans, and leaves every other metric's reading as
it was.

    python -m pytest portbench/tests -q
"""
import argparse
import io
import itertools
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

# two short genes in a genome short enough that each comparison's band
# scan stays under the plain scan's diagonal cap on the CPU
SHORT = {"genome_bp": 8_000, "genes": 2, "exons": {"median": 2, "mean": 2.2},
         "exon_bp": {"median": 80, "mean": 90},
         "utr5_bp": {"median": 40, "mean": 45},
         "utr3_bp": {"median": 60, "mean": 70},
         "intron_bp": {"median": 300, "mean": 350}, "invocations": 3}

CPU_METRICS = {"host_route_ms.scan", "locus_resolve_ms.scan",
               "fallback_pct.scan", "band_copy_ms.scan"}
DEVICE_METRICS = {"band_us_per_diag.scan", "unnamed_idle_pct.scan"}
PROGRAM_SPANS = {"setup", "seed.query", "seed.target", "pool", "pool.plan",
                 "pool.device", "pool.wait", "pool.host_route", "band.build",
                 "band.copy", "band.fetch", "hybrid.resolve", "hybrid.path",
                 "report"}


def test_a_traced_scan_reads_the_program_spans(monkeypatch):
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.engine import sdp_hybrid
    monkeypatch.setenv("EXONERATE_TPU_SDP", "device")
    turn = itertools.count()
    monkeypatch.setattr(sdp_hybrid, "device_worthwhile",
                        lambda *a, **k: next(turn) % 2 == 0)
    seen = {}
    real = harness.reader

    def spy(name):
        mod = real(name)

        def read(ctx):
            seen[name] = ctx
            return mod.read(ctx)
        return types.SimpleNamespace(**{**vars(mod), "read": read})
    monkeypatch.setattr(harness, "reader", spy)
    observe.clear_trace()
    out, err = io.StringIO(), io.StringIO()
    args = argparse.Namespace(workload="e2g.scan", seed=2 ** 31 + 11,
                              seconds=0.1, trace=1)
    rc = harness.run(args, card=False, out=out, err=err,
                     traffic_overrides=SHORT)
    observe.clear_trace()
    assert rc == 0, err.getvalue()[-2000:]
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["correct"]
    metrics = res["metrics"]
    assert CPU_METRICS <= set(metrics), metrics
    assert not DEVICE_METRICS & set(metrics)
    assert all(metrics[n]["value"] > 0 for n in CPU_METRICS
               if n != "fallback_pct.scan")
    assert 0 <= metrics["fallback_pct.scan"]["value"] <= 100
    gaps = {n for n, _ in res["breakdown"]["idle_gaps"]}
    assert gaps & PROGRAM_SPANS and "other host work" not in gaps, gaps
    # the new readers add the program's spans to what the harness keeps
    # under its own names: every other metric reads what it read before
    ctx = seen["unnamed_idle_pct.scan"]
    assert PROGRAM_SPANS & set(ctx.spans) and "run" not in ctx.spans
    for name, v in metrics.items():
        if name not in CPU_METRICS:
            assert real(name).read(ctx) == v["value"], name
