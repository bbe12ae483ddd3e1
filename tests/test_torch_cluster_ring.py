"""The cluster wavefront's ring route and the route to it (CPU).

The cluster kernel of ``csrc/wavefront.cu`` (kernel K2, and K4 on a
cluster) keeps a batch's carry ring in shared memory where it fits a
CTA's shared memory beside its mask bytes and block reduce
(``cuda_wavefront.ring_in_smem``), else in global memory; a chunk,
masked (kernel K3) or not, runs on the cluster when its B clusters, of
two CTAs or more, are all resident on the card at once
(``cuda_wavefront.on_cluster`` / ``fits_on_cluster``).  These tests
run on the CPU:

- the fit rule on the models at calm's width (Qp 2304: 2176 rows);
- the Python mirror of the kernel's shared-memory formulas against the
  formulas themselves, read from ``csrc/wavefront.cu`` and compiled by
  the host's C++ compiler;
- the routing rule with the card's capacity passed in;
- ``find_batched`` / ``find_path_batched`` runs taken through the
  cluster route (its wrappers run the plain version on the CPU), equal
  to the JAX package's XLA engine over three Waterman-Eggert iterations,
  and mask-free chunks routed by the capacity patched in;
- the diagonal counters of ``_launch`` by kernel and mode.

Scores, cells and byte counts are integers: the tolerance is 0.
"""
import contextlib
import dataclasses
import os
import re
import subprocess

import pytest
import torch

from exonerate_tpu.engine import optimal as jopt
from exonerate_tpu.engine import wavefront as jwf
from exonerate_tpu.engine.subopt import SubOpt as JSubOpt
from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal as topt
from exonerate_tpu_torch.engine import wavefront as twf
from exonerate_tpu_torch.engine.subopt import SubOpt
from test_torch_subopt import JOBS
from torch_twins import JAX, PORT, dp_key, split_job

CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(cw.__file__), os.pardir, "csrc",
                   "wavefront.cu")
CALM_ROWS = 2176          # calm's 2175 rows + 1, padded to Qp 2304
ALL4 = os.path.join(os.path.dirname(__file__), "golden", "data", "all4.fa")


def _model(name):
    if name == "est2genome":
        return PORT.est2genome_create()
    A = PORT.AlphabetType
    return PORT.get_model(PORT.ModelType[name.upper()],
                          A.PROTEIN if name == "protein2genome" else A.DNA,
                          A.DNA)


def _ki_at(name, mode, rows):
    """KernelInputs of ``name`` in ``mode`` on the CPU (est2genome: calm's
    first 60 x 80 cells; the split models: their small split pair), its
    widest diagonal set to ``rows``: the fit rule reads the model's and
    the mode's numbers, and the width."""
    if name == "est2genome":
        model = PORT.est2genome_create()
        calm = next(iter(PORT.iter_fasta(ALL4)))
        region, data = PORT.Region(0, 0, 60, 80), PORT.AlignData(calm, calm)
    else:
        model, region, data = split_job(PORT, name.upper())
    pads = (twf._bucket(region.query_length),
            twf._bucket(region.target_length))
    inputs, kinds = twf.prepare_inputs(model, region, data, pad_to=pads,
                                       for_pallas=True)
    ki = cw.to_kernel_inputs(model, inputs, kinds, CPU, mode)
    return dataclasses.replace(ki, qmax=rows - 1)


@pytest.mark.parametrize("name,mode,fits", [
    ("est2genome", "score", True), ("est2genome", "region", True),
    ("est2genome", "path", True), ("protein2genome", "region", False),
    ("coding2genome", "region", False)])
def test_ring_fit_rule_at_calms_width(name, mode, fits):
    """est2genome keeps its ring in shared memory in every mode at calm's
    width; protein2genome and coding2genome region do not (their rings
    alone are over a CTA's shared memory, the cell state being
    registers) and take the global ring.  The rule is the byte count at
    the cluster size the launch runs (on the CPU ceil(rows / THREADS) up
    to MAX_CLUSTER: one row per thread here), asked through the function
    the launches call."""
    ki = _ki_at(name, mode, CALM_ROWS)
    assert cw.cluster_size(ki) == 9
    assert cw.ring_in_smem(ki) is fits
    total = (cw.smem_bytes()
             + cw.ring_smem_bytes(ki.K + 1, max(ki.NR, 1), max(ki.NL, 1), 1,
                                  True, True))
    assert (total <= cw.SMEM_BYTES) is fits
    # past 2 x MAX_CLUSTER x THREADS rows a thread owns three rows: the
    # ring triples, and est2genome's region ring no longer fits
    wide = _ki_at(name, mode, 2 * cw.MAX_CLUSTER * cw.THREADS + 1)
    assert cw.cluster_size(wide) == cw.MAX_CLUSTER
    if (name, mode) == ("est2genome", "region"):
        assert not cw.ring_in_smem(wide)
    if (name, mode) == ("est2genome", "score"):
        assert cw.ring_in_smem(wide)
    # at a cluster size given to the launcher (a card that admits only
    # PORTABLE_CLUSTER, or a size asked for): C CTAs of ceil(rows / (C x
    # THREADS)) rows per thread (est2genome region: two rows at C = 8
    # fit, five at C = 2 do not)
    if (name, mode) == ("est2genome", "region"):
        assert cw.ring_in_smem(ki, cw.PORTABLE_CLUSTER)
        assert not cw.ring_in_smem(ki, 2)


def _extract(src: str, head: str) -> str:
    """The text of the top-level C++ definition that starts with
    ``head``, up to its closing brace at the start of a line."""
    start = src.index(head)
    end = src.index("\n}", start) + 2
    return src[start:end]


def _compiled_formulas(tmp_path):
    """csrc/wavefront.cu's constants, smem_bytes and ring_smem_bytes,
    compiled by the host's C++ compiler into a program that reads ``mode
    S L n_plan R NR NL k masked smem_ring`` lines and prints both byte
    counts (the plan's S, L and rows, and the mode, are compiled into the
    kernel and no longer size its shared memory)."""
    with open(SRC) as fh:
        src = fh.read()
    consts = "\n".join(re.findall(
        r"^constexpr (?:int|size_t|int32_t) \w+ = [^;]+;", src, re.M))
    smem = _extract(src, "size_t smem_bytes(")
    ring = _extract(src, "size_t ring_smem_bytes(")
    prog = tmp_path / "smem.cpp"
    prog.write_text(
        "#include <cstdint>\n#include <cstddef>\n#include <cstdio>\n"
        f"{consts}\n{smem}\n{ring}\n"
        "int main() {\n"
        "  int mode, S, L, n, R, NR, NL, k, masked, smem_ring;\n"
        "  while (scanf(\"%d %d %d %d %d %d %d %d %d %d\", &mode, &S, &L,"
        " &n, &R, &NR, &NL, &k, &masked, &smem_ring) == 10) {\n"
        "    printf(\"%zu %zu\\n\", smem_bytes(),"
        " ring_smem_bytes(R, NR, NL, k, masked, smem_ring));\n"
        "  }\n}\n")
    exe = tmp_path / "smem"
    subprocess.run(["c++", "-std=c++17", "-O1", "-o", str(exe), str(prog)],
                   check=True, capture_output=True, timeout=120)
    return exe


def test_smem_mirror_equals_the_kernels_formulas(tmp_path):
    """``cuda_wavefront.smem_bytes`` and ``ring_smem_bytes`` give the
    bytes that the kernel's launcher asks for: the .cu's own functions,
    compiled on the host, on every model and mode of the zoo at one and
    two rows per thread, masked and mask-free, the ring in shared and in
    global memory, and on corner values."""
    exe = _compiled_formulas(tmp_path)
    modes = {"score": 0, "region": 1, "path": 2}
    cases = []
    for name in ("est2genome", "protein2genome", "coding2genome",
                 "cdna2genome"):
        model = _model(name)
        for mode in modes:
            ring_states, lane_slots, _ = cw._storage(model, mode)
            L = model.total_shadow_designations + (
                2 if mode == "region" else 0)
            for k in (1, 2):
                for masked in (0, 1):
                    for smem_ring in (0, 1):
                        cases.append((mode, len(model.states), L,
                                      len(cw._plan_transitions(model)),
                                      cw._max_advance(model) + 1,
                                      max(len(ring_states), 1),
                                      max(len(lane_slots), 1), k, masked,
                                      smem_ring))
    cases += [("score", 1, 0, 0, 2, 1, 1, 1, 0, 1),
              ("path", 24, 6, 64, 7, 24, 60, 3, 1, 1),
              ("region", 24, 6, 64, 7, 24, 60, 3, 1, 0)]
    lines = "".join(f"{modes[c[0]]} " + " ".join(map(str, c[1:])) + "\n"
                    for c in cases)
    got = subprocess.run([str(exe)], input=lines, capture_output=True,
                         text=True, check=True, timeout=60).stdout.split("\n")
    assert len(cases) == 99
    for case, line in zip(cases, got):
        mode, S, L, n, R, NR, NL, k, masked, smem_ring = case
        want = (cw.smem_bytes(),
                cw.ring_smem_bytes(R, NR, NL, k, bool(masked),
                                   bool(smem_ring)))
        assert tuple(map(int, line.split())) == want, case


def _kinds(masked: bool):
    """The bucket kinds of an est2genome job, with the mask or without."""
    model = PORT.est2genome_create()
    calm = next(iter(PORT.iter_fasta(ALL4)))
    data = PORT.AlignData(calm, calm)
    region = PORT.Region(0, 0, 60, 80)
    sub = None
    if masked:
        sub = SubOpt()
        sub.points.add((10, 12))
        sub.by_row[12] = {10}
    return twf.prepare_inputs(model, region, data, subopt=sub,
                              pad_to=(256, 256), for_pallas=True)[1]


@pytest.mark.parametrize("masked", [True, False],
                         ids=["masked", "mask-free"])
def test_cluster_routing_rule(masked):
    """The same rule masked and mask-free: a chunk at the -E run's shape
    (Qp 2304 x Tp 30208, C = 9) goes to the cluster when its B clusters
    are all resident; a chunk of more pairs than the card holds clusters
    follows the JAX package's streaming test; none resident, K1; a
    chromosome-scale B=1 scan goes to the cluster whatever the count; at
    one CTA a pair (C = 1) a chunk stays on K1 unless it streams."""
    kinds = _kinds(masked)
    assert cw._masked(kinds) == masked
    assert not cw.streams(kinds, 1, 2304, 30208)
    assert cw.on_cluster(kinds, 1, 2304, 30208, (9, 1))
    assert cw.on_cluster(kinds, 7, 2304, 30208, (9, 7))
    assert not cw.on_cluster(kinds, 8, 2304, 30208, (9, 7))
    assert not cw.on_cluster(kinds, 1, 2304, 30208, (9, 0))
    for B, Tp in ((8, 30208), (8, 1356288), (64, 92928)):
        assert cw.on_cluster(kinds, B, 2304, Tp, (9, 7)) \
            == cw.streams(kinds, B, 2304, Tp)
    assert cw.streams(kinds, 8, 2304, 1356288)
    for resident in (0, 1, 64):
        assert cw.on_cluster(kinds, 1, 2304, 1356288, (9, resident))
    assert not cw.on_cluster(kinds, 1, 256, 30208, (1, 264))
    assert cw.on_cluster(kinds, 1, 256, 30208, (2, 264))
    assert cw.on_cluster(kinds, 64, 2304, 1356288, (1, 264))


def test_fits_on_cluster():
    assert cw.MIN_ROUTED_CLUSTER == 2
    assert cw.fits_on_cluster(1, (2, 1))
    assert not cw.fits_on_cluster(2, (2, 1))
    assert not cw.fits_on_cluster(0, (9, 4))
    assert not cw.fits_on_cluster(1, (1, 264))
    assert cw.fits_on_cluster(16, (16, 16))


def test_cluster_capacity_on_the_cpu():
    """On the CPU no cluster is resident (masked chunks stay on K1), and
    C is the kernel's rule: ceil(rows / THREADS) up to MAX_CLUSTER."""
    model = PORT.est2genome_create()
    calm = next(iter(PORT.iter_fasta(ALL4)))
    data = PORT.AlignData(calm, calm)
    for qlen, want in ((100, 1), (600, 3), (2175, 9)):
        inputs, kinds = twf.prepare_inputs(
            model, PORT.Region(0, 0, qlen, 50), data,
            pad_to=(twf._bucket(qlen), 256), for_pallas=True)
        ki = cw.to_kernel_inputs(model, inputs, kinds, CPU, "region")
        assert cw.cluster_capacity(ki) == (want, 0)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(cw, name)

    def spy(*args, **kwargs):
        calls.append(kwargs.get("cluster", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(cw, name, spy)
    return calls


@pytest.mark.parametrize("name", sorted(JOBS))
def test_masked_runs_on_the_cluster_route_equal_jax(name, monkeypatch):
    """Three Waterman-Eggert iterations with one cluster of two CTAs
    resident: each region DP, the mask-free first and the masked
    re-runs, runs through K2's wrapper and each path DP through K4's on
    the cluster (their plain versions on the CPU); every result equals
    the JAX package's XLA engine (scores, cells, paths)."""
    monkeypatch.setattr(cw, "cluster_capacity", lambda ki: (2, 1))
    k1 = _spy(monkeypatch, "wavefront_scan")
    k2 = _spy(monkeypatch, "wavefront_stream_scan")
    k4 = _spy(monkeypatch, "wavefront_path")
    model, region, data = JOBS[name](PORT)
    jmodel, jregion, jdata = JOBS[name](JAX)
    sub, jsub = SubOpt(), JSubOpt()
    masked_runs = 0
    for it in range(3):
        got = cw.find_batched(model, [(region, data)], "region",
                              device=CPU, subopt=sub)[0]
        want = jwf.find_region(jmodel, jregion, jdata, jsub)
        assert dp_key(got)[:5] == dp_key(want)[:5], f"iteration {it}"
        path = cw.find_path_batched(model, [(region, data)], subopt=sub,
                                    device=CPU)[0]
        ref = jwf.find_path(jmodel, jregion, jdata, jsub)
        assert dp_key(path) == dp_key(ref), f"iteration {it}"
        if it:
            masked_runs += 1
        alignment = topt._to_alignment(model, region, path)
        if alignment is None or not alignment.ops:
            break
        sub.add_alignment(alignment)
        jsub.add_alignment(jopt._to_alignment(jmodel, jregion, ref))
    assert masked_runs >= 1
    assert len(k1) == 0 and len(k2) == 1 + masked_runs
    assert k4 == [True] * (1 + masked_runs)


ROUTES = {  # case: (capacity, pairs, on the cluster)
    "fits": ((2, 2), 1, True),
    "more pairs than resident": ((2, 2), 3, False),
    "one CTA a pair": ((1, 264), 1, False),
    "none resident": ((9, 0), 1, False)}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_mask_free_chunks_take_the_cluster_where_they_fit(case,
                                                          monkeypatch):
    """A mask-free est2genome chunk, with the card's capacity patched in:
    B=1 of clusters of two CTAs, one resident or more, goes to the
    cluster entry points (K2's wrapper in region mode, K4's with
    ``cluster=True`` in path mode); more pairs than resident clusters,
    one CTA a pair or none resident go to K1 and K4.  The results equal
    the forced K1 route's."""
    capacity, pairs, want = ROUTES[case]
    monkeypatch.setattr(cw, "cluster_capacity", lambda ki: capacity)
    k1 = _spy(monkeypatch, "wavefront_scan")
    k2 = _spy(monkeypatch, "wavefront_stream_scan")
    k4 = _spy(monkeypatch, "wavefront_path")
    model = PORT.est2genome_create()
    calm = next(iter(PORT.iter_fasta(ALL4)))
    data = PORT.AlignData(calm, calm)
    jobs = [(PORT.Region(5 * k, 3 * k, 60, 80), data)
            for k in range(pairs)]
    got = cw.find_batched(model, jobs, "region", device=CPU)
    assert (len(k1), len(k2)) == ((0, 1) if want else (1, 0))
    assert k4 == []
    paths = cw.find_path_batched(model, jobs, device=CPU)
    assert k4 == [want]
    del k1[:]
    assert got == cw.find_batched(model, jobs, "region", device=CPU,
                                  stream=False)
    assert len(k1) == 1
    assert [(p.score, p.query_end, p.target_end) for p in paths] == [
        (r.score, r.query_end, r.target_end) for r in got]


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("mode", ["score", "region", "path"])
@pytest.mark.parametrize("cluster", [None, 0], ids=["plan", "ring"])
def test_launch_counts_diagonals_by_kernel_and_mode(mode, cluster,
                                                    monkeypatch):
    """``_launch`` adds each launch's swept diagonals to its kernel's
    counter and to that kernel's counter of the mode: scan (score and
    region) or path.  The launch itself is patched out (no card)."""
    added = {}

    def add(counter, n=1):
        added[counter] = added.get(counter, 0) + n

    monkeypatch.setattr(cw.observe, "add", add)
    monkeypatch.setattr(cw, "_lib", lambda *a, **k: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    model = PORT.est2genome_create()
    calm = next(iter(PORT.iter_fasta(ALL4)))
    data = PORT.AlignData(calm, calm)
    inputs, kinds = twf.prepare_inputs(model, PORT.Region(0, 0, 60, 80),
                                       data, pad_to=(256, 256),
                                       for_pallas=True)
    ki = cw.to_kernel_inputs(model, [inputs], kinds, CPU, mode)
    cw._launch(ki, cluster)
    kernel = "plan" if cluster is None else "ring"
    by_mode = "path" if mode == "path" else "scan"
    swept = 60 + 80 + 1
    want = {f"{kernel}.diagonals": swept,
            f"{kernel}.{by_mode}_diagonals": swept}
    if cluster is not None:
        want["ring.smem_launches"] = 1
    assert added == want
