"""The benchmark cell ``p2g.exh_locus`` on the CPU, and the span
attribution of the exhaustive cells' wavefront metrics.

The harness (``portbench.harness.run(..., card=False)``) runs the cell
at a small size (a 50-residue protein in 3 exons against a 2.4 kb window)
through ``cli.exonerate.main`` and reads ``correct``; in a process of its
own, since the harness refuses a run in which JAX is loaded (this suite's
conftest loads it).  A synthetic trace
holds ``scan_us_per_diag.exh`` and ``path_us_per_diag.exh`` to their
definition: each ``plan_kernel`` operation belongs to the exhaustive
route's span open at its midpoint on the host clock, one open in neither
span counts in neither, and a program without the counters reads nothing;
``ring_scan_us_per_diag.exh`` so reads ``ring_kernel`` inside ``exh.scan``
only, and ``cluster_scan_pct.exh`` is the cluster's share of the scan
diagonals.
"""
import json
import os
import subprocess
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, program_trace, trace  # noqa: E402

SMALL = {"p2g.exh_locus": {"genome_bp": 2400, "protein_aa": [50, 50],
                           "exons": [3, 3], "intron_bp": [100, 300],
                           "invocations": 3}}


RUN = """
import argparse, json, sys
from portbench import harness
args = argparse.Namespace(workload=sys.argv[1], seed=2 ** 31 + 18,
                          seconds=0.1, trace=0)
sys.exit(harness.run(args, card=False,
                     traffic_overrides=json.loads(sys.argv[2])))
"""


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_cell_runs_correct_on_the_cpu(name):
    r = subprocess.run([sys.executable, "-c", RUN, name,
                        json.dumps(SMALL[name])], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["correct"], r.stderr[-2000:]
    assert res["checks"]["score_err"]["value"] == 0
    assert res["checks"]["missing"]["value"] == 0
    assert {"pairs_per_s", "setup_s"} <= set(res["metrics"])


OFFSET = 100.0          # host clock = trace time + OFFSET
SPANS = [("exh.scan", 0.0, 1.0), ("exh.path", 1.5, 2.0),
         ("exh.scan", 3.0, 4.0), ("wave.prep", 0.05, 0.08)]
OPS = [("plan_kernel<false>", 0.1, 0.9),        # scan
       ("plan_kernel<false>", 1.4, 1.8),        # midpoint 1.6: path
       ("plan_kernel<false>", 2.2, 2.4),        # in neither span
       ("plan_kernel<true>", 3.2, 3.6),         # scan
       ("ring_kernel<true, true>", 0.2, 0.3),   # another kernel: scan
       ("ring_kernel<false, true>", 1.6, 1.9),  # path
       ("ring_kernel<false, true>", 2.5, 2.6)]  # in neither span


def _ctx(monkeypatch, counters):
    spans = [types.SimpleNamespace(name=n, start=s + OFFSET,
                                   end=e + OFFSET, thread=1, self_s=e - s)
             for n, s, e in SPANS]
    monkeypatch.setattr(program_trace, "_trace", lambda: types.SimpleNamespace(
        spans=spans, counters=counters))
    summary = trace.Summary(OPS, 2.0, 5.0, OFFSET, OFFSET - 0.1, OFFSET + 5)
    return types.SimpleNamespace(trace=summary)


def test_each_kernel_belongs_to_the_span_open_at_its_midpoint(monkeypatch):
    ctx = _ctx(monkeypatch, {"plan.scan_diagonals": 1000,
                             "plan.path_diagonals": 500})
    scan = harness.reader("scan_us_per_diag.exh").read(ctx)
    path = harness.reader("path_us_per_diag.exh").read(ctx)
    assert scan == pytest.approx(1e6 * (0.8 + 0.4) / 1000)
    assert path == pytest.approx(1e6 * 0.4 / 500)
    from portbench import kernel_spans
    by = kernel_spans.seconds_by_span(ctx, "plan_kernel", kernel_spans.EXH)
    assert by[None] == pytest.approx(0.2)
    assert sum(by.values()) == pytest.approx(
        ctx.trace.seconds(lambda n: "plan_kernel" in n))


def test_a_program_without_the_counters_reads_nothing(monkeypatch):
    ctx = _ctx(monkeypatch, {"plan.diagonals": 1500})
    assert harness.reader("scan_us_per_diag.exh").read(ctx) is None
    assert harness.reader("path_us_per_diag.exh").read(ctx) is None


def test_ring_scan_us_per_diag_reads_ring_kernel_inside_exh_scan(
        monkeypatch):
    ctx = _ctx(monkeypatch, {"ring.scan_diagonals": 400,
                             "ring.path_diagonals": 300,
                             "plan.scan_diagonals": 1000})
    got = harness.reader("ring_scan_us_per_diag.exh").read(ctx)
    assert got == pytest.approx(1e6 * 0.1 / 400)
    ctx = _ctx(monkeypatch, {"plan.scan_diagonals": 1000})
    assert harness.reader("ring_scan_us_per_diag.exh").read(ctx) is None


@pytest.mark.parametrize("counters, want", [
    ({"ring.scan_diagonals": 3000}, 100.0),
    ({"ring.scan_diagonals": 3000, "plan.scan_diagonals": 1000}, 75.0),
    ({"ring.path_diagonals": 300, "plan.scan_diagonals": 1000}, None),
    ({}, None)])
def test_cluster_scan_pct_is_the_cluster_share_of_scan_diagonals(
        monkeypatch, counters, want):
    """100 with only the cluster's scan diagonals; nothing where the
    program has no ``ring.scan_diagonals`` (the route gave no scan to the
    cluster, or the program does not count it)."""
    ctx = _ctx(monkeypatch, counters)
    got = harness.reader("cluster_scan_pct.exh").read(ctx)
    assert got == (None if want is None else pytest.approx(want))
