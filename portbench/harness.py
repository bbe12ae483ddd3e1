"""The benchmark of exonerate_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<name>.json``: the model, its flags per mode) under a traffic
mix (``traffic/<name>.json``, read by ``traffic/generate.py``), with the
limits of its correctness numbers in ``workloads/<cell>.json``.  Every
metric is a reader in ``metrics/<name>.py`` (``read(ctx)``, None where it
finds nothing to read; a metric ``<base>.<cells>`` may share
``metrics/<base>.py``), and may name program functions to time
(``SPANS``).  A metric with a ``workloads`` list is reported in those
cells, one without it in every cell.  A new cell, configuration or
metric is new files and a new entry in ``BENCHMARK.json``: nothing here
names one.

A run: set-up (imports, the card, the inputs from ``--seed``, one warm
invocation of ``exonerate_tpu_torch.cli.exonerate.main`` at the cell's own
shape, which builds or loads the plan libraries), then invocations back to
back for ``--seconds`` (a closed loop, each with fresh inputs), then the
reference judges every alignment printed in the window, and the last line
of standard output is the result.  With ``--trace 1`` the window runs under
``torch.profiler`` with the metrics' spans installed, and the result holds
the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import collections
import functools
import importlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "exonerate_tpu")
# the program's build caches, at fixed paths inside the checkout
NATIVE_DIR = os.path.join(HERE, ".cache", "native")


class NoCard(RuntimeError):
    pass


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: str
    limits: dict
    end_to_end: list
    per_layer: list


def resolve(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files and the
    metrics it reports."""
    bench = bench or benchmark()
    w = next((c for c in bench["workloads"] if c["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    e2e, layer = ([m for m in bench[kind]
                   if name in m.get("workloads", [name])]
                  for kind in ("end_to_end", "per_layer"))
    return Cell(name, w["chips"], config, w["traffic"],
                _json("workloads", name + ".json")["limits"], e2e, layer)


def reader(metric: str):
    """The module ``metrics/<metric>.py``; a metric ``<base>.<cells>``
    without a file of its own is read by ``metrics/<base>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", metric.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flag(argv: list, name: str, default):
    return type(default)(argv[argv.index(name) + 1]) if name in argv \
        else default


@dataclass
class Ctx:
    """What a metric reader reads."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    invocations: list = field(default_factory=list)   # (seconds, units)
    engines: collections.Counter = field(default_factory=collections.Counter)
    spans: dict = field(default_factory=lambda: collections.defaultdict(list))
    kept: dict = field(default_factory=lambda: collections.defaultdict(list))
    done: list = field(default_factory=list)   # (printed text, Invocation)
    trace: object = None               # trace.Summary of the traced window


def _process_start_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def _install_spans(ctx: Ctx, metrics: list):
    """Wrap the program functions that the metrics name with the host
    clock: ``SPANS`` maps a span name to ``"module:attr.path"`` targets,
    ``KEEP`` a span name to functions of a call's result whose values are
    kept in ``ctx.kept``.  Returns the undo."""
    targets, keeps = {}, collections.defaultdict(list)
    for mod in metrics:
        for span, names in getattr(mod, "SPANS", {}).items():
            for name in names:
                targets[name] = span
        for span, fn in getattr(mod, "KEEP", {}).items():
            keeps[span].append(fn)
    undo = []
    for target, span in targets.items():
        modname, path = target.split(":")
        owner = importlib.import_module(modname)
        *parents, attr = path.split(".")
        for p in parents:
            owner = getattr(owner, p)
        orig = getattr(owner, attr)

        def wrapped(*a, _orig=orig, _span=span, **kw):
            t = time.perf_counter()
            try:
                res = _orig(*a, **kw)
            finally:
                ctx.spans[_span].append((t, time.perf_counter() - t))
            for fn in keeps[_span]:
                ctx.kept[fn.__name__].append(fn(res))
            return res
        setattr(owner, attr, functools.wraps(orig)(wrapped))
        undo.append((owner, attr, orig))
    return lambda: [setattr(o, a, f) for o, a, f in reversed(undo)]


def run(args, card: bool = True, traffic_overrides: dict = None,
        out=sys.stdout, err=sys.stderr, bench: dict = None) -> int:
    """One run; ``card`` False runs on the CPU and ``bench`` stands for
    ``BENCHMARK.json`` (tests only)."""
    cell = resolve(args.workload, bench)
    os.environ["EXONERATE_TPU_NATIVE_DIR"] = NATIVE_DIR
    import torch
    if card:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            raise NoCard(f"{cell.name} needs {cell.chips} CUDA card(s); "
                         f"found {found}")
        torch.cuda.reset_peak_memory_stats()
    else:
        os.environ["EXONERATE_TPU_TORCH_DEVICE"] = "cpu"

    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        return _run(args, cell, card, workdir, traffic_overrides, out, err)


def make_traffic(cell: Cell, seed: int, workdir: str, overrides=None):
    """The cell's traffic from ``seed``, a scan's genome the size of the
    configuration's target chunk."""
    from .traffic import generate
    scale = {"genome_bp": cell.config["target_chunk_bp"]} \
        if "target_chunk_bp" in cell.config else {}
    return generate.make(cell.traffic, seed, workdir,
                         {**scale, **(overrides or {})})


def _run(args, cell, card, workdir, overrides, out, err) -> int:
    import torch
    sync = torch.cuda.synchronize if card else (lambda: None)
    cfg = cell.config
    traffic = make_traffic(cell, args.seed, workdir, overrides)
    argv = cfg["argv"][traffic.mode]
    from exonerate_tpu_torch.cli import exonerate as cli

    def invoke(inv) -> str:
        buf = io.StringIO()
        cli.main(argv + [inv.query_file, inv.target_file], out=buf)
        sync()
        return buf.getvalue()

    invoke(traffic.invocations[0])                      # warm-up
    ctx = Ctx(cell)
    ctx.setup_s = _process_start_s()
    metrics = {m["name"]: reader(m["name"])
               for m in (cell.per_layer if args.trace else cell.end_to_end)}
    undo = _install_spans(ctx, metrics.values()) if args.trace else None
    from exonerate_tpu_torch import observe
    prof = None
    if args.trace:
        from . import trace
        prof = trace.start(card)
    w0 = time.perf_counter()
    k = 0
    while True:
        inv = traffic.invocations[1 + k % (len(traffic.invocations) - 1)]
        t = time.perf_counter()
        text = invoke(inv)
        t_end = time.perf_counter()
        ctx.invocations.append((t_end - t, inv.units))
        ctx.engines.update(observe.engine_counts)
        ctx.done.append((text, inv))
        k += 1
        if t_end - w0 >= args.seconds:
            break
    ctx.window_s = t_end - w0
    ctx.units = sum(u for _, u in ctx.invocations)
    if prof is not None:
        ctx.trace = trace.stop(prof, w0, t_end)
        undo()
    peak = torch.cuda.max_memory_allocated() if card else 0
    device = ({"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
              if card else {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0})
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s

    verdict = _judge(cfg, traffic, ctx.done)
    numbers = verdict.numbers
    limits = cell.limits
    correct = (verdict.queries > 0 and
               all(numbers[n] <= limits[n] for n in limits))
    values = {}
    for name, mod in metrics.items():
        v = mod.read(ctx)
        if v is not None:
            unit = next(m["unit"] for m in cell.end_to_end + cell.per_layer
                        if m["name"] == name)
            values[name] = {"value": v, "unit": unit}
    found = sorted(m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN)
    if found:
        err.write(f"portbench: the run loaded {', '.join(found)}\n")
        return 3
    result = {"correct": correct, "attempted": ctx.units,
              "failed": numbers["missing"], "metrics": values,
              "device": device}
    if ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown(ctx.spans)
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                        for n in limits}
    result["checks"]["alignments"] = verdict.checked
    result["checks"]["queries"] = verdict.queries
    err.write(f"widest truth gap: {verdict.worst}\n")
    err.write("window: " + " ".join(f"{d:.3f}" for d, _ in
                                    ctx.invocations) + " s\n")
    for n in limits:
        err.write(f"check {n} {numbers[n]!r} limit {limits[n]!r}\n")
    err.write(f"check alignments {verdict.checked} queries "
              f"{verdict.queries}\n")
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0


def _judge(cfg, traffic, done):
    from .reference import judge
    argv = cfg["argv"][traffic.mode]
    return judge.judge(cfg["model"], flag(argv, "--maxintron", 200000),
                       flag(argv, "--bestn", 1),
                       [(text, inv.queries, inv.targets, inv.planted)
                        for text, inv in done])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        return run(args)
    except NoCard as exc:
        sys.stderr.write(f"portbench: {exc}\n")
        return 2
