#!/usr/bin/env python3
"""What the port's spans and counters (``exonerate_tpu_torch.observe``)
cost and show in one benchmark cell, on one card.

    python3 tools/torch_trace_report.py --workload <cell> --seed <n> \
        [--invocations N] [--out FILE]

Builds the cell's traffic from ``--seed`` as ``portbench/run.py`` does,
warms up with one invocation of ``cli.exonerate.main``, then reports:

- ``span_us``: the cost of one empty span with no profiler (the flag
  check) and under the benchmark's own profiler (``portbench/trace.py``:
  CUDA activity), and of one counter add under it;
- ``invocations``: N untraced and N traced invocations in turns
  (untraced, traced, traced, untraced, ...), each timed on the host clock
  to its last synchronise; for each traced one the spans recorded, the
  counter adds made, the span count and self seconds by name, and the
  counters;
- ``ring_launches``: the cluster kernel's launches of the traced
  invocations by the home of their carry ring (the counters
  ``ring.smem_launches`` and ``ring.global_launches``), also printed on
  a line of their own;
- ``clock``: one more invocation under a profiler of CPU and CUDA
  activity on every thread: each span's ``perf_counter`` start against
  its ``record_function`` range's start in the profiler's events mapped
  onto the host clock with ``trace.stop``'s ``offset_s`` (milliseconds:
  the median difference, the 95th percentile and the largest of its
  size, and how many exceed 1 ms; the same for the ends).

Prints one JSON line and writes it to ``--out`` when given.  Needs one
CUDA card.
"""
import argparse
import collections
import io
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness, trace  # noqa: E402


def _span_cost(observe, n: int) -> float:
    """Microseconds of one empty span, less the bare loop's."""
    t = time.perf_counter()
    for _ in range(n):
        pass
    bare = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        with observe.span("cost"):
            pass
    return 1e6 * (time.perf_counter() - t - bare) / n


def span_costs(observe) -> dict:
    out = {"off": _span_cost(observe, 200_000)}
    prof = trace.start(True)
    try:
        out["on"] = _span_cost(observe, 20_000)
        n = 20_000
        t = time.perf_counter()
        for _ in range(n):
            observe.add("cost")
        out["add_on"] = 1e6 * (time.perf_counter() - t) / n
    finally:
        prof.__exit__(None, None, None)
    observe.clear_trace()
    return out


def _by_name(spans) -> dict:
    count, self_s = collections.Counter(), collections.Counter()
    for s in spans:
        count[s.name] += 1
        self_s[s.name] += s.self_s
    return {n: [count[n], self_s[n]] for n in sorted(count)}


def clock_check(observe, invoke) -> dict:
    """The spans of one invocation against their record_function ranges
    in the profiler's events, on the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch.profiler import _ExperimentalConfig
        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        all_threads = True
    except (ImportError, TypeError):
        prof = profile(activities=acts)
        all_threads = False
    observe.clear_trace()
    prof.__enter__()
    w0 = time.perf_counter()
    invoke()
    w1 = time.perf_counter()
    summary = trace.stop(prof, w0, w1)
    spans = observe.trace().spans
    observe.clear_trace()
    events = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU:
            s = ev.start_ns() / 1e9 + summary.offset_s
            events[ev.name()].append((s, s + ev.duration_ns() / 1e9))
    # each span against the range of its name that lies closest to it:
    # spans of one name on several threads may start in either order
    starts, ends, unmatched = [], [], collections.Counter()
    for s in sorted(spans, key=lambda s: s.start):
        evs = events.get(s.name)
        if not evs:
            unmatched[s.name] += 1
            continue
        k = min(range(len(evs)), key=lambda i: abs(evs[i][0] - s.start)
                + abs(evs[i][1] - s.end))
        e0, e1 = evs.pop(k)
        starts.append(1e3 * (e0 - s.start))
        ends.append(1e3 * (e1 - s.end))
    out = {"all_threads": all_threads, "spans": len(spans),
           "matched": len(starts), "unmatched": dict(unmatched),
           "offset_s": summary.offset_s}
    for what, v in (("start", starts), ("end", ends)):
        if v:
            a = sorted(abs(x) for x in v)
            out[what + "_ms"] = {
                "median": statistics.median(v), "abs_p95": a[
                    int(0.95 * (len(a) - 1))], "abs_max": a[-1],
                "over_1ms": sum(x > 1.0 for x in a)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--invocations", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("torch_trace_report: needs a CUDA card\n")
        return 2
    cell = harness.resolve(args.workload)
    os.environ["EXONERATE_TPU_NATIVE_DIR"] = harness.NATIVE_DIR
    from exonerate_tpu_torch import observe
    from exonerate_tpu_torch.cli import exonerate as cli
    with tempfile.TemporaryDirectory(prefix="trace-report-") as workdir:
        traffic = harness.make_traffic(cell, args.seed, workdir)
        argv_cell = cell.config["argv"][traffic.mode]
        invs = traffic.invocations
        turn = iter(range(10 ** 9))

        def invoke(inv=None):
            # the harness's order: the first for the warm-up, then the rest
            inv = inv or invs[1 + next(turn) % (len(invs) - 1)]
            cli.main(argv_cell + [inv.query_file, inv.target_file],
                     out=io.StringIO())
            torch.cuda.synchronize()
            return inv.units

        invoke(invs[0])                                # warm-up
        costs = span_costs(observe)
        real_add = observe.add
        adds = [0]

        def counting_add(counter, n=1):
            adds[0] += 1
            real_add(counter, n)
        rows = []
        for i in range(2 * args.invocations):
            traced = i % 4 in (1, 2)
            prof = trace.start(True) if traced else None
            observe.clear_trace()
            adds[0] = 0
            observe.add = counting_add
            try:
                t = time.perf_counter()
                units = invoke()
                secs = time.perf_counter() - t
            finally:
                observe.add = real_add
            row = {"traced": traced, "seconds": secs, "units": units}
            if prof is not None:
                trace.stop(prof, t, t + secs)
                got = observe.trace()
                row.update(spans=len(got.spans), adds=adds[0],
                           by_name=_by_name(got.spans),
                           counters=got.counters)
            rows.append(row)
        clock = clock_check(observe, invoke)
    ring = {route: sum(r.get("counters", {}).get(f"ring.{route}_launches",
                                                  0) for r in rows)
            for route in ("smem", "global")}
    print(f"cluster kernel launches of the traced invocations: "
          f"{ring['smem']} with the ring in shared memory, {ring['global']} "
          f"in global memory", file=sys.stderr)
    result = {"workload": args.workload, "seed": args.seed,
              "card": torch.cuda.get_device_name(0), "span_us": costs,
              "invocations": rows, "ring_launches": ring, "clock": clock}
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
