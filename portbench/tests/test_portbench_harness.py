"""CPU tests of the benchmark's harness: every cell, configuration and
metric resolves from its files, a cell added from files alone runs, the
reference agrees with the port at a tiny size, and the faults and the
control come out not correct.  The card's own run is the ``gpu`` test.

    python -m pytest portbench/tests -q
"""
import argparse
import ast
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference import control  # noqa: E402

PB = os.path.join(ROOT, "portbench")
TINY = {
    "e2g.scan": {"genome_bp": 60_000, "genes": 2,
                 "intron_bp": {"median": 600, "mean": 800},
                 "invocations": 3},
    "p2g.scan": {"genome_bp": 120_000, "genes": 2, "protein_aa": [90, 130],
                 "exons": [4, 5], "intron_bp": [300, 1200],
                 "invocations": 3},
    # under the native route's cell count, so that the CPU run is quick;
    # --score 2000 still finds both copies
    "e2g.exh_locus": {"query_bp": 540, "window_bp": 1700, "start": 50,
                      "gap": 100, "invocations": 3},
}


def _run(name, trace=0, seed=2 ** 31 + 7, overrides=None, bench=None):
    out, err = io.StringIO(), io.StringIO()
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.1,
                              trace=trace)
    rc = harness.run(args, card=False, out=out, err=err, bench=bench,
                     traffic_overrides=overrides or TINY[name])
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1]), err.getvalue()


def test_every_name_resolves_from_its_files():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"], bench)
        assert cell.limits and cell.config["argv"]
        assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_a_cell_is_added_by_files_alone():
    """A new cell, traffic mix and per-layer metric: new files and a new
    entry in the benchmark's description, no edit of a file there."""
    made = [os.path.join(PB, "traffic", "zz_test_mix.json"),
            os.path.join(PB, "workloads", "zz.test.json"),
            os.path.join(PB, "metrics", "zz_units.test.py")]
    try:
        with open(os.path.join(PB, "traffic", "cdna16_genome1mb.json")) as f:
            mix = json.load(f)
        mix.update(genes=1, invocations=2,
                   intron_bp={"median": 300, "mean": 400})
        with open(made[0], "w") as fh:
            json.dump(mix, fh)
        with open(made[1], "w") as fh:
            json.dump({"limits": {"score_err": 0}}, fh)
        with open(made[2], "w") as fh:
            fh.write("def read(ctx):\n    return float(ctx.units)\n")
        bench = harness.benchmark()
        bench["workloads"].append({"name": "zz.test", "config": "est2genome",
                                   "traffic": "zz_test_mix", "chips": 1,
                                   "why": "test"})
        bench["per_layer"].append({"name": "zz_units.test", "unit": "1",
                                   "better": "higher", "source":
                                   "program_counter", "layer": "test",
                                   "moves": "queries_per_s",
                                   "workloads": ["zz.test"]})
        res, _ = _run("zz.test", trace=1, bench=bench,
                      overrides={"genome_bp": 40_000})
        assert res["correct"]
        assert res["metrics"]["zz_units.test"]["value"] >= 1
    finally:
        for f in made:
            if os.path.exists(f):
                os.unlink(f)


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_agrees_with_the_port_on_the_cpu(name):
    res, err = _run(name)
    assert res["correct"], err[-2000:]
    assert res["checks"]["score_err"]["value"] == 0
    assert res["checks"]["truth_gap_pct"]["value"] <= 0
    assert res["checks"]["alignments"] >= res["checks"]["queries"] > 0
    assert list(res)[-1] == "checks"
    cell = harness.resolve(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced, _ = _run(name, trace=1)
    assert traced["correct"]
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    if name.endswith(".scan"):
        assert "seed_ms.scan" in traced["metrics"]
    assert "device_idle_pct.scan" not in traced["metrics"]   # no device


def _half_left_out(text):
    lines = text.splitlines(keepends=True)
    keep = [ln for ln in lines if ln.startswith("vulgar:")]
    drop = {ln.split()[1] for ln in keep[::2]}
    return "".join(ln for ln in lines
                   if not (ln.startswith("vulgar:") and ln.split()[1] in drop))


def _answer_altered(text):
    """One printed score off by one."""
    lines = text.splitlines(keepends=True)
    k = next(i for i, ln in enumerate(lines) if ln.startswith("vulgar:"))
    w = lines[k].split()
    w[9] = str(int(w[9]) + 1)
    lines[k] = " ".join(w) + "\n"
    return "".join(lines)


def _stopped_at_first_intron(text):
    """The DP's state handed on unchanged past its first exon: each
    alignment ends where its first intron would start, its score kept."""
    out = []
    for ln in text.splitlines(keepends=True):
        w = ln.split()
        if ln.startswith("vulgar:") and "5" in w[10::3]:
            k = 10 + 3 * w[10::3].index("5")
            q = sum(int(x) for x in w[11:k:3])
            t = sum(int(x) for x in w[12:k:3])
            w[3] = str(int(w[2]) + q)
            w[7] = str(int(w[6]) + t)
            ln = " ".join(w[:k]) + "\n"
        out.append(ln)
    return "".join(out)


def _vulgar(text):
    lines = text.splitlines(keepends=True)
    return lines, [i for i, ln in enumerate(lines)
                   if ln.startswith("vulgar:")]


def _second_repeats_first(text):
    """The masked scan ignores its mask: the second alignment is the
    first again."""
    lines, k = _vulgar(text)
    lines[k[1]] = lines[k[0]]
    return "".join(lines)


def _second_dropped(text):
    lines, k = _vulgar(text)
    del lines[k[1]]
    return "".join(lines)


def _fasta(path):
    with open(path) as fh:
        return "".join(ln.strip() for ln in fh if not ln.startswith(">"))


def _second_cut_to_its_first_exon(text, query, target):
    """The masked scan finds a poorer second alignment: the second's
    first exon alone, scored exactly."""
    from portbench.reference import judge
    lines, k = _vulgar(text)
    aln = judge.parse_vulgar(lines[k[1]])[0]
    label, qa, ta = aln.ops[0]
    assert label == "M"
    aln.ops, aln.q_end, aln.t_end = [aln.ops[0]], aln.q_start + qa, \
        aln.t_start + ta
    aln.score = judge.path_score("est2genome", query, target, aln, 200_000)
    w = lines[k[1]].split()[:10]
    w[3], w[7], w[9] = str(aln.q_end), str(aln.t_end), str(aln.score)
    lines[k[1]] = " ".join(w + ["M", str(qa), str(ta)]) + "\n"
    return "".join(lines)


FAULTS = [("e2g.scan", _half_left_out, "missing"),
          ("e2g.scan", _answer_altered, "score_err"),
          ("e2g.scan", _stopped_at_first_intron, "score_err"),
          ("e2g.exh_locus", _second_repeats_first, "overlap"),
          ("e2g.exh_locus", _second_dropped, "missing"),
          ("e2g.exh_locus", _second_cut_to_its_first_exon,
           "second_gap_pct")]


@pytest.mark.parametrize("name,fault,caught", FAULTS,
                         ids=[f[1].__name__ for f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, name, fault,
                                                  caught):
    from exonerate_tpu_torch.cli import exonerate as cli
    real = cli.main

    def main(argv, out):
        buf = io.StringIO()
        real(argv, out=buf)
        seqs = [_fasta(f) for f in argv[-2:]]
        out.write(fault(buf.getvalue(), *seqs)
                  if fault is _second_cut_to_its_first_exon
                  else fault(buf.getvalue()))
        return 0
    monkeypatch.setattr(cli, "main", main)
    res, err = _run(name)
    assert not res["correct"]
    check = res["checks"][caught]
    assert check["value"] > check["limit"], err[-2000:]


@pytest.mark.parametrize("name", ["e2g.scan", "p2g.scan", "e2g.exh_locus"])
def test_the_control_is_not_correct(name):
    limits = harness.resolve(name).limits
    for seed in (1, 2, 2 ** 31 + 3):
        v = control.readings(name, seed, 2, TINY.get(name))
        assert v.queries > 0 and v.numbers["score_err"] == 0
        assert any(v.numbers[n] > limits[n] for n in limits)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(PB):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom)
                         and node.module and not node.level else [])
                for n in names:
                    top = n.split(".")[0]
                    assert top not in harness.FORBIDDEN, (path, n)
                    if os.sep + "reference" + os.sep in path:
                        assert top != "exonerate_tpu_torch", (path, n)


def test_a_run_without_the_program_fails(tmp_path):
    """A checkout that holds only the benchmark's files cannot run."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "e2g.scan", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.gpu
def test_every_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    for w in harness.benchmark()["workloads"]:
        r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            w["name"], "--seed", "5", "--seconds", "5",
                            "--trace", "0"], cwd=ROOT, capture_output=True,
                           text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-2000:]
        assert json.loads(r.stdout.splitlines()[-1])["correct"]
