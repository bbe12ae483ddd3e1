"""The seeded band scan on hand-written CUDA kernels, and its host side.

Counterpart of ``exonerate_tpu/engine/sdp_pallas.py``.  Two kernels of
``csrc/sdp_band.cu``, each behind a wrapper with a launch counter:

- K6 ``band_reverse`` replaces the reverse pass of ``build_sdp_kernel``
  (``make_kernel(False)``, ``pallas_call`` ``sdp_pallas.py:974``): seed
  injection, the backward recurrence, the boundary bits and ``live``;
- K7 ``band_forward`` replaces the forward pass (``make_kernel(True)``,
  ``pallas_call`` ``:996``): boundary injection, span registers, the
  per-column best end score, ``live`` and ``xband``.

A non-boundary model (ungapped, affine, protein2dna, coding2coding:
``model_uses_boundary`` False) runs the same two kernels built with the
plan's ``TRACK_SID`` flag: the reverse pass carries a seed id per state
and hands each seed's best start score to the forward pass, which seeds
its START state from them (the JAX package's XLA ``build_pass`` with
``track_sid``, ``sdp_device.py:297``; its Pallas kernel refuses these
models, ``sdp_pallas.py:77``).  ``seed_id_rows`` adds the seed ids to
the seed layers.

K8, the cross-chip band scan (``build_sdp_kernel(cross=True)``,
``pallas_call`` ``:904`` / ``:929``, driven by ``run_kernel_cross_chip``
``:1220``), is the CROSS instantiation of the same source behind
``band_reverse_cross`` / ``band_forward_cross``: one comparison's W axis
cut into chunks (``cross_chunks``), each chunk a launch of its own on its
own device, chained through ``sdp_device.Halo``
(``run_kernel_cross_chip``).

``to_band_inputs`` flattens ``_plan_transitions`` into an int32
candidate table per pass, and the per-pair arrays of
``prepare_kernel_inputs`` into packed q-axis, W-axis and scalar tensors.
The kernels run the tables compiled in: ``plan_cuda.band_header`` writes
both passes' tables into a C++ header (``BandInputs.header``) and
``csrc/sdp_band.cu`` is built once per header (``_cudabuild.load``).
Each comparison (or K8 chunk) runs on a thread-block cluster whose CTAs
split its query lanes, the carry ring in shared memory where the .cu's
fit rule (``band_fit``) says it fits, else in global memory;
``BAND_SMEM`` and ``BAND_GLOBAL`` count the launches by ring route.  The
TPU frame of the Pallas kernel (reversed 128-aligned windows, 31
diagonals per boundary word, the flipped column-best plane) is layout
and is not kept: a kernel reads column ``j = d - i`` of a plain
``(Wp+1)`` vector and keeps one boundary bit per cell, 32 lanes per
word.  A wrapper given CPU tensors runs the plain PyTorch version
(``sdp_device.plain_band_reverse`` / ``plain_band_forward``); given CUDA
tensors it launches the kernel or raises: a failed build or launch
raises, and no plan falls back to an interpreter.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import numpy as np
import torch

from . import sdp_bands
from .sdp import model_uses_boundary
from .sdp_native import _lane_for
from ..model.ir import Model

from . import plan_cuda
from . import sdp_device as sd
from .. import device as default_device
from .cuda_wavefront import K9, _LaunchCount, _lib, count
from .wavefront import _bucket
from .sdp_device import (BF_EVENT, BF_P_OVER, BF_P_UNDER, BF_SH_Q, BF_SH_T,
                         BP_AQ, BP_AT, BP_C0, BP_C1, BP_C2, BP_C3, BP_C4,
                         BP_C5, BP_C6, BP_CALC, BP_COLS, BP_CONTIG, BP_FLAGS,
                         BP_NSTART, BP_READ, BP_SH_LANE_Q, BP_SH_LANE_T,
                         BP_SH_MAX, BP_SH_MIN, BP_ST_DES0, BP_ST_SRC0,
                         BP_WRITE, K_FACTORED, K_NONE, K_QT, K_QVEC,
                         K_SCALAR, K_SPLIT, K_TVEC, MAX_STARTS, NEG,
                         SP_COLS, ST_QUERY, ST_TARGET, ST_TVEC, BandInputs)

MAX_SEED_LAYERS = 4

# maxima of csrc/sdp_band.cu (the plans of the registry's boundary models
# are within them: cdna2genome has 22 states and 49 candidates)
MAX_S = 24
MAX_SH = 4
MAX_SPANS = 6
MAX_CAND = 64

# kernel K8 (the cross-chip band scan): CROSS launches of either pass,
# one per chunk of a comparison
K8 = _LaunchCount()

# the launches of K6 / K7 built with TRACK_SID (a non-boundary model's
# passes; band_reverse / band_forward count them too)
K6_SID = _LaunchCount()
K7_SID = _LaunchCount()

# the band kernels' launches (K6, K7, K8) by the home of their carry ring:
# shared memory (each CTA its lanes', band_fit), or global memory where it
# does not fit
BAND_SMEM = _LaunchCount()
BAND_GLOBAL = _LaunchCount()

# device-memory budget of one launch pair: boundary bits, W-axis inputs,
# column-best plane and the carry/span planes of every pair of the batch
BAND_BYTES = 2 << 30


# ---------------------------------------------------------------------------
# host prep — copies of the Pallas module's host-side functions
# ---------------------------------------------------------------------------

def kernel_supported(model: Model, use_boundary: bool, n_layers: int,
                     pair=None) -> bool:
    """Is the band kernel applicable?  (``sdp_pallas.py:73``, but for
    non-boundary models too, which the kernels' ``TRACK_SID``
    instantiation serves; callers also require
    ``sdp_device.supported(model)``.)"""
    if n_layers > MAX_SEED_LAYERS:
        return False
    for c in model.calcs:
        if c.pallas_fn is not None:
            if c.kernel_inputs_fn is None:
                return False
        elif c.shadow_fn is not None and pair is not None:
            if any(np.ndim(v) != 0 for v in
                   pair.shadow_inputs.get(id(c), {}).values()):
                return False
    return True


def count_seed_layers(pair, plan) -> int:
    """Max seeds sharing one compressed column (= seed-vector layers)."""
    cnt: Counter = Counter()
    band_ix = 0
    for s in pair.seeds:
        while not (plan.bands[band_ix].t0 <= s.t_cobs
                   <= plan.bands[band_ix].t1):
            band_ix += 1
        cnt[plan.to_v(band_ix, s.t_cobs)] += 1
    return max(cnt.values(), default=1)


def prepare_kernel_inputs(model: Model, pair, plan, Qp: int, Wp: int,
                          n_layers: int):
    """Compact host arrays (flat name->array) + static meta, as
    ``sdp_pallas.prepare_kernel_inputs:108`` builds them, the split-codon
    calcs' ``kc`` inputs included (q-axis rows shifted by the
    transition's query advance, target rows recompressed through
    ``plan.abs_t``).  ``meta["tnames"]`` names the W-axis vectors."""
    inputs, kinds = sd.prepare_inputs(model, pair, plan, pad_to=(Qp, Wp))
    kind_map = dict(kinds)
    flat: dict = {}
    meta: dict = {}
    tnames: list = []
    for ci, c in enumerate(model.calcs):
        key = f"c{ci}"
        kind = kind_map.get(key)
        if kind == "qt":
            flat[key + ":q"] = np.asarray(inputs[key]["q"], np.int32)
            flat[key + ":t"] = np.asarray(inputs[key]["t"], np.int32)
            tnames.append(key + ":t")
        elif kind == "factored":
            v = inputs[key]
            C = int(v["table"].shape[1])
            meta[key] = C
            qi = np.asarray(v["q_idx"])
            for cc in range(C):
                flat[f"{key}:P{cc}"] = np.asarray(v["table"])[
                    qi, cc].astype(np.int32)
            flat[key + ":tj"] = np.asarray(v["t_idx"], np.int32)
            tnames.append(key + ":tj")
            qo = np.asarray(v["q_over"], np.int32)
            has_ov = bool(qo.any())
            meta[key + ":ov"] = has_ov
            if has_ov:
                flat[key + ":ov"] = qo
        elif kind == "scalar":
            flat[key] = np.asarray(inputs[key], np.int32).reshape(1)
        elif kind == "qvec":
            flat[key] = np.asarray(inputs[key], np.int32)
        elif kind == "tvec":
            flat[key] = np.asarray(inputs[key], np.int32)
            tnames.append(key)
        if c.pallas_fn is not None and c.kernel_inputs_fn is not None:
            Q = pair.region.query_length
            tr = next(t for t in model.transitions if t.calc is c)
            si = np.clip(np.arange(Q + 1) - tr.advance_query, 0, Q)
            for nm, (kkind, arr) in sorted(c.kernel_inputs_fn(
                    pair.region, pair.data).items()):
                kkey = f"kc{ci}:{nm}"
                arr = np.asarray(arr, np.int32)
                if kkind == "qvec":
                    v = np.zeros(Qp + 1, np.int32)
                    v[:Q + 1] = arr[si]
                else:
                    v = np.zeros(Wp + 1, np.int32)
                    v[:plan.W + 1] = arr[plan.abs_t]
                    tnames.append(kkey)
                flat[kkey] = v
        elif f"sh{ci}" in inputs:
            for n2, v2 in sorted(inputs[f"sh{ci}"].items()):
                flat[f"sh{ci}/{n2}"] = np.asarray(v2, np.int32).reshape(1)
    for sx in range(len(model.shadows)):
        if f"shv{sx}" in inputs:
            flat[f"shv{sx}"] = np.asarray(inputs[f"shv{sx}"], np.int32)
            tnames.append(f"shv{sx}")
    for name in ("_abs_t", "_edge", "_seg"):
        flat[name] = np.asarray(inputs[name], np.int32)
        tnames.append(name)
    flat["_qlen"] = np.asarray(inputs["_qlen"], np.int32).reshape(1)
    flat["_wlen"] = np.asarray(inputs["_wlen"], np.int32).reshape(1)
    W = plan.W
    for at in sorted({t.advance_target for t in model.transitions
                      if t.advance_target}):
        m = np.zeros(Wp + 1, np.int32)
        m[:W + 1] = sdp_bands.contig_mask(plan.abs_t, at).astype(np.int32)
        flat[f"_contig{at}"] = m
        tnames.append(f"_contig{at}")
    # column-indexed seed layers: the reverse pass injects
    # sc[end][q] = hsp_score >> 1 at (q_cobs, v_cobs); lane i of diagonal
    # d reads column v = d - i, so seed_q[v] - 1 == i fires exactly at
    # d = q + v (q is stored + 1 so that 0 means empty)
    by_v: dict = {}
    band_ix = 0
    for s in pair.seeds:
        while not (plan.bands[band_ix].t0 <= s.t_cobs
                   <= plan.bands[band_ix].t1):
            band_ix += 1
        v = plan.to_v(band_ix, s.t_cobs)
        slot = by_v.setdefault(v, {})
        slot[s.q_cobs] = max(slot.get(s.q_cobs, NEG), s.hsp_score >> 1)
    need = max((len(d) for d in by_v.values()), default=1)
    assert need <= n_layers, (need, n_layers)
    sq = np.zeros((n_layers, Wp + 1), np.int32)
    sv = np.zeros((n_layers, Wp + 1), np.int32)
    for v, dd in by_v.items():
        for lx, (q, val) in enumerate(sorted(dd.items())):
            sq[lx, v] = q + 1
            sv[lx, v] = val
    for lx in range(n_layers):
        flat[f"_seedq{lx}"] = sq[lx]
        tnames.append(f"_seedq{lx}")
        flat[f"_seedv{lx}"] = sv[lx]
        tnames.append(f"_seedv{lx}")
    meta["n_layers"] = n_layers
    meta["tnames"] = tuple(sorted(tnames))
    return flat, kinds, meta


def seed_id_rows(pair, plan, Wp: int, n_layers: int) -> dict:
    """A non-boundary model's seed ids, in the layers of
    ``prepare_kernel_inputs`` (at column v the seeds' distinct query
    positions, sorted): ``_seedi{lx}``, the largest seed index among the
    seeds at that cell, which the reverse pass's END state carries
    whatever their half scores (``sdp_device.py:408-413``), and
    ``_seedh{lx}``, that seed's half score, which the forward pass
    takes off its start score (``:384-397``)."""
    by_v: dict = {}
    band_ix = 0
    for k, s in enumerate(pair.seeds):
        while not (plan.bands[band_ix].t0 <= s.t_cobs
                   <= plan.bands[band_ix].t1):
            band_ix += 1
        v = plan.to_v(band_ix, s.t_cobs)
        slot = by_v.setdefault(v, {})
        slot[s.q_cobs] = max(slot.get(s.q_cobs, -1), k)
    si = np.zeros((n_layers, Wp + 1), np.int32)
    sh = np.zeros((n_layers, Wp + 1), np.int32)
    for v, dd in by_v.items():
        for lx, (q, k) in enumerate(sorted(dd.items())):
            si[lx, v] = k
            sh[lx, v] = pair.seeds[k].hsp_score >> 1
    out = {}
    for lx in range(n_layers):
        out[f"_seedi{lx}"] = si[lx]
        out[f"_seedh{lx}"] = sh[lx]
    return out


def _ring_plan(model: Model, is_forward: bool) -> list:
    """States needing carry-ring rows: the reads of advancing candidates."""
    adv_plan, _ = sd._plan_transitions(model, is_forward)
    return sorted({e["read"] for e in adv_plan})


def _max_target_advance(model: Model) -> int:
    """MAXAT: how many columns into a neighbouring chunk a source lies
    (``sdp_pallas.py:256-257``)."""
    return max(max((t.advance_target for t in model.transitions),
                   default=1), 1)


def _max_advance(model: Model) -> int:
    return max(max((t.advance_query + t.advance_target
                    for t in model.transitions), default=1), 1)


def unsupported_reason(model: Model, pair=None, plan=None) -> Optional[str]:
    """Why the band kernels cannot run this model (and pair), naming the
    missing piece; None when they can."""
    if not sd.supported(model):
        return "model not expressible by the band scan"
    for c in model.calcs:
        if c.pallas_fn is not None:
            if c.kernel_inputs_fn is None:
                return f"split-codon calc {c.name!r} without kernel inputs"
            continue
        kind = (getattr(c, "native_shadow", None) or (None,))[0]
        if kind == "split_codon":
            return (f"query-side or joint split codon {c.name!r} "
                    f"(genome2genome): a shadow calc with array inputs, "
                    f"off the kernels as in the JAX package")
        if c.shadow_fn is not None and kind != "intron_window":
            return f"shadow calc {c.name!r} is not an intron window"
    adv, silent = sd._plan_transitions(model, True)
    for e in adv + silent:
        if len(e["shadow_starts"]) > MAX_STARTS:
            return f"more than {MAX_STARTS} shadow starts"
        c = e["calc"]
        if c is not None and c.shadow_fn is not None \
                and c.pallas_fn is None:
            params = c.native_shadow[1]
            for side, prefix in (("on_query", "query intron"),
                                 ("on_target", "target intron")):
                if params.get(side) and _lane_for(e["t"], prefix) is None:
                    return f"no {prefix!r} lane for {e['t'].name!r}"
    if len(model.states) > MAX_S:
        return f"{len(model.states)} states > {MAX_S}"
    if model.total_shadow_designations > MAX_SH:
        return (f"{model.total_shadow_designations} shadow lanes > "
                f"{MAX_SH}")
    if len(model.spans) > MAX_SPANS:
        return f"{len(model.spans)} spans > {MAX_SPANS}"
    if len(adv) + len(silent) > MAX_CAND:
        return f"{len(adv) + len(silent)} candidates > {MAX_CAND}"
    if pair is not None and plan is not None:
        n_layers = count_seed_layers(pair, plan)
        if n_layers > MAX_SEED_LAYERS:
            return (f"{n_layers} seeds in one column > {MAX_SEED_LAYERS} "
                    f"seed layers")
        if not kernel_supported(model, pair.use_boundary, n_layers, pair):
            return "array shadow inputs"
    return None


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------

def _plan_table(model: Model, forward: bool, qrow: dict, trow: dict,
                srow: dict, kind_map: dict, ncls: dict,
                track_sid: bool) -> tuple:
    """The int32 candidate table of one pass (advancing rows first) and
    the number of advancing rows.  BF_EVENT marks the forward pass's
    writes of the END state and, with ``track_sid``, the reverse pass's
    writes of the START state (the seeds' start events)."""
    adv, silent = sd._plan_transitions(model, forward)
    rows = np.zeros((len(adv) + len(silent), BP_COLS), np.int32)
    for r, e in enumerate(adv + silent):
        row = rows[r]
        row[BP_AQ], row[BP_AT] = e["aq"], e["at"]
        row[BP_READ], row[BP_WRITE] = e["read"], e["write"]
        row[BP_C0] = row[BP_C1] = row[BP_C2] = row[BP_CONTIG] = -1
        flags = ((BF_P_UNDER if e["p_under"] else 0)
                 | (BF_P_OVER if e["p_over"] else 0)
                 | (BF_EVENT if e["event"] and (forward or track_sid)
                    else 0))
        if e["at"]:
            row[BP_CONTIG] = trow[f"_contig{e['at']}"]
        c = e["calc"]
        if c is not None and not e["rev_shadowed"]:
            ci = model.calcs.index(c)
            key = f"c{ci}"
            kind = kind_map[key]
            if forward and c.pallas_fn is not None:
                phase = c.native_shadow[1]["phase"]

                def lane(prefix):
                    return next(des for name, des in e["dst_shadows"]
                                if name.startswith(prefix))
                row[BP_CALC] = K_SPLIT
                row[BP_C0] = qrow[f"kc{ci}:R0"]
                row[BP_C1] = trow[f"kc{ci}:E1p0" if phase == 1
                                  else f"kc{ci}:N4"]
                row[BP_C2] = phase
                row[BP_C3] = lane("target intron")
                if phase == 1:
                    row[BP_C4] = lane("split c1")
                else:
                    row[BP_C4], row[BP_C5], row[BP_C6] = (
                        lane(f"split p2k{k}") for k in range(3))
            elif kind == "qt":
                row[BP_CALC], row[BP_C0], row[BP_C1] = (
                    K_QT, qrow[key + ":q"], trow[key + ":t"])
            elif kind == "factored":
                row[BP_CALC], row[BP_C0], row[BP_C1] = (
                    K_FACTORED, qrow[key + ":P0"], trow[key + ":tj"])
                row[BP_C2] = qrow.get(key + ":ov", -1)
                row[BP_C3] = ncls[key]
            elif kind == "scalar":
                row[BP_CALC], row[BP_C0] = K_SCALAR, srow[key]
            elif kind == "qvec":
                row[BP_CALC], row[BP_C0] = K_QVEC, qrow[key]
            else:
                row[BP_CALC], row[BP_C1] = K_TVEC, trow[key]
            if forward and c.shadow_fn is not None and c.pallas_fn is None:
                params = c.native_shadow[1]
                if params.get("on_query"):
                    flags |= BF_SH_Q
                    row[BP_SH_LANE_Q] = _lane_for(e["t"], "query intron")
                if params.get("on_target"):
                    flags |= BF_SH_T
                    row[BP_SH_LANE_T] = _lane_for(e["t"], "target intron")
                row[BP_SH_MIN] = srow[f"sh{ci}/min_intron"]
                row[BP_SH_MAX] = srow[f"sh{ci}/max_intron"]
        else:
            row[BP_CALC] = K_NONE
        row[BP_FLAGS] = flags
        row[BP_NSTART] = len(e["shadow_starts"])
        for k, (des, start_kind, shvix) in enumerate(e["shadow_starts"]):
            row[BP_ST_DES0 + 2 * k] = des
            row[BP_ST_SRC0 + 2 * k] = (
                ST_TVEC + trow[f"shv{shvix}"] if shvix is not None
                else ST_QUERY if start_kind == "query_pos" else ST_TARGET)
    return rows, len(adv)


def to_band_inputs(model: Model, flats: list, kinds: tuple, metas: list,
                   Qp: int, Wp: int, dropoff: int,
                   device: torch.device, ctx: Optional[list] = None
                   ) -> BandInputs:
    """Pack the ``prepare_kernel_inputs`` outputs of a batch (same Qp, Wp,
    kinds and seed layers) and the candidate tables of ``model`` onto
    ``device``.  A name some pairs lack (an all-zero override plane)
    ships zeros for them.  ``ctx`` (K8's chunks): per pair, each W-axis
    vector's values at columns -1 .. -maxat.  A non-boundary model's
    flats also hold its ``seed_id_rows``, and its metas ``n_seed``, the
    pair's seed count."""
    reason = unsupported_reason(model)
    if reason is not None:
        raise ValueError(f"cuda_sdp cannot run {model.name}: {reason}")
    use_boundary = model_uses_boundary(model)
    if not use_boundary and ctx is not None:
        raise ValueError(f"cuda_sdp: the cross-chip band scan takes "
                         f"boundary models only, not {model.name}")
    if not use_boundary and any("_seedi0" not in f for f in flats):
        raise ValueError(f"cuda_sdp: {model.name} is a non-boundary model "
                         f"and needs its seed ids (seed_id_rows)")
    B = len(flats)
    n_layers = metas[0]["n_layers"]
    tnames = set(metas[0]["tnames"])
    names = sorted({n for f in flats for n in f})
    kind_map = dict(kinds)
    ncls = {k: v for k, v in metas[0].items()
            if k in kind_map and kind_map[k] == "factored"}

    def column(name):
        proto = next((f[name] for f in flats if name in f),
                     np.zeros(Qp + 1, np.int32))
        return np.stack([np.asarray(f.get(name, np.zeros_like(proto)),
                                    np.int32) for f in flats])

    # a factored calc always ships its override row (zeros where no pair
    # has one), so that its candidate rows, and the compiled plan, do not
    # depend on the batch
    names = sorted(set(names) | {k + ":ov" for k in ncls})

    # factored class planes and the split codon's query rows stay
    # consecutive rows (P0, P1, ..., R0, R1, ..., not the lexicographic
    # P0, P1, P10, P2); its target rows E1p0..2 sort consecutively
    kc_ci = sorted({int(n[2:n.index(":")]) for n in names
                    if n.startswith("kc") and n not in tnames})
    qnames, tnames_l, snames = [], [], []
    for n in names:
        if n.startswith("kc") and n not in tnames:
            continue
        a = flats[0].get(n)
        if a is None:
            a = next((f[n] for f in flats if n in f),
                     np.zeros(Qp + 1, np.int32))
        if n in tnames:
            tnames_l.append(n)
        elif a.shape == (1,):
            if n not in ("_qlen", "_wlen"):
                snames.append(n)
        elif ":P" not in n:
            qnames.append(n)
    for key in sorted(ncls):
        qnames += [f"{key}:P{c}" for c in range(ncls[key])]
    for ci in kc_ci:
        qnames += [f"kc{ci}:R{a}" for a in range(25)]
    # the seed layers last, so that the other rows' numbers, which the
    # compiled plan holds, do not depend on the batch's layer count
    seed_rows = [f"_seed{x}{lx}" for x in ("qv" if use_boundary else "qvih")
                 for lx in range(n_layers)]
    tnames_l = [n for n in tnames_l if n not in seed_rows] + seed_rows
    qrow = {n: r for r, n in enumerate(qnames)}
    trow = {n: r for r, n in enumerate(tnames_l)}
    srow = {n: r for r, n in enumerate(snames)}

    def stacked(ns, width):
        if not ns:
            return np.zeros((B, 1, width), np.int32)
        return np.ascontiguousarray(np.stack([column(n) for n in ns],
                                             axis=1))

    rev_plan, n_adv_rev = _plan_table(model, False, qrow, trow, srow,
                                      kind_map, ncls, not use_boundary)
    fwd_plan, n_adv_fwd = _plan_table(model, True, qrow, trow, srow,
                                      kind_map, ncls, not use_boundary)
    spans = sd._span_plan(model)
    span_tab = np.zeros((max(len(spans), 1), SP_COLS), np.int32)
    for k, sp in enumerate(spans):
        span_tab[k] = (sp["state"], sp["max_target"], sp["max_query"],
                       sp["submit_post_thaw"])
    S = len(model.states)
    rings = []
    for forward in (False, True):
        ring = np.full(S, -1, np.int32)
        states = _ring_plan(model, forward)
        ring[states] = np.arange(len(states))
        rings.append((ring, len(states)))
    dims = np.concatenate([column("_qlen"), column("_wlen")], axis=1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    maxat = _max_target_advance(model) if ctx is not None else 0
    tctx = None
    if ctx is not None:
        tctx = put(np.stack([np.stack([c.get(n, np.zeros(maxat, np.int32))
                                       for n in tnames_l]) for c in ctx]))

    # the spans' windows (--maxintron) stay run-time data: the compiled
    # plan holds only whether a span has a target (and a query) window
    header = plan_cuda.band_header(
        model.name, rev_plan, n_adv_rev, fwd_plan, n_adv_fwd,
        plan_cuda.span_shape(span_tab),
        len(spans), rings[0][0], rings[1][0], S=S,
        n_sh=model.total_shadow_designations, K=_max_advance(model),
        NR_rev=rings[0][1], NR_fwd=rings[1][1],
        start_id=model.start_state.state.id,
        end_id=model.end_state.state.id, row_abs_t=trow["_abs_t"],
        row_edge=trow["_edge"], row_seg=trow["_seg"],
        track_sid=not use_boundary)
    return BandInputs(
        rev_plan=put(rev_plan), fwd_plan=put(fwd_plan), spans=put(span_tab),
        rev_ring=put(rings[0][0]), fwd_ring=put(rings[1][0]),
        dims=put(dims), qvecs=put(stacked(qnames, Qp + 1)),
        tvecs=put(stacked(tnames_l, Wp + 1)),
        scalars=put(np.concatenate([column(n) for n in snames], axis=1)
                    if snames else np.zeros((B, 1), np.int32)),
        n_adv_rev=n_adv_rev, n_adv_fwd=n_adv_fwd, n_spans=len(spans),
        Qp=Qp, Wp=Wp, S=S, n_sh=model.total_shadow_designations,
        K=_max_advance(model), NR_rev=rings[0][1], NR_fwd=rings[1][1],
        start_id=model.start_state.state.id,
        end_id=model.end_state.state.id, dropoff=int(dropoff),
        row_abs_t=trow["_abs_t"], row_edge=trow["_edge"],
        row_seg=trow["_seg"], row_seedq=trow["_seedq0"],
        row_seedv=trow["_seedv0"], n_layers=n_layers,
        use_boundary=use_boundary,
        row_seedi=trow.get("_seedi0", -1), row_seedh=trow.get("_seedh0", -1),
        n_seed=max([1] + [m.get("n_seed", 0) for m in metas]),
        split=bool((fwd_plan[:, BP_CALC] == K_SPLIT).any()),
        tctx=tctx, maxat=maxat,
        span_joint=tuple(sp["max_query"] > 0 for sp in spans),
        qmax=int(dims[:, 0].max()), header=header)


def pair_bytes(model: Model, Qp: int, Wp: int, n_tvec: int) -> int:
    """Device bytes one pair of a launch pair holds: boundary bits,
    W-axis inputs and column best, the carry rings of both passes (a
    non-boundary model's reverse ring with its seed-id plane) and the
    span registers."""
    W = Qp + 1
    S, n_sh, R = len(model.states), model.total_shadow_designations, \
        _max_advance(model) + 1
    n_spans = len(model.spans)
    sid = 0 if model_uses_boundary(model) else 1
    return 4 * ((Qp + Wp + 1) * ((Qp + 32) // 32)
                + (n_tvec + 1) * (Wp + 1)
                + R * S * (2 + n_sh + sid) * W
                + 3 * n_spans * (4 + n_sh) * W)


def max_batch(model: Model, Qp: int, Wp: int, n_tvec: int) -> int:
    """Largest batch within BAND_BYTES (at least 1)."""
    return max(1, BAND_BYTES // pair_bytes(model, Qp, Wp, n_tvec))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 15 + [_I] * 14 + [ctypes.POINTER(_I), _P]
_CROSS_ARGTYPES = ([_P] * 15 + [_I] * 14 + [ctypes.POINTER(_I)] + [_P] * 7
                   + [_I, _P])


def _check_inputs(bi: BandInputs) -> None:
    dev = bi.dims.device
    B, W, WT = bi.batch, bi.Qp + 1, bi.Wp + 1
    shapes = {"rev_plan": (None, BP_COLS), "fwd_plan": (None, BP_COLS),
              "spans": (None, SP_COLS), "rev_ring": (bi.S,),
              "fwd_ring": (bi.S,), "dims": (B, 2), "qvecs": (B, None, W),
              "tvecs": (B, None, WT), "scalars": (B, None)}
    for name, want in shapes.items():
        t = getattr(bi, name)
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"BandInputs.{name}: want contiguous int32 "
                             f"on {dev}, got {t.dtype} on {t.device}")
        if t.dim() != len(want) or any(w is not None and w != g
                                       for w, g in zip(want, t.shape)):
            raise ValueError(f"BandInputs.{name}: shape {tuple(t.shape)}"
                             f" does not match {want}")
    n_cand = max(bi.rev_plan.shape[0], bi.fwd_plan.shape[0])
    if bi.S > MAX_S or bi.n_sh > MAX_SH or bi.n_spans > MAX_SPANS \
            or n_cand > MAX_CAND or bi.n_layers > MAX_SEED_LAYERS:
        raise ValueError(
            f"model over the kernel maxima: S={bi.S} (max {MAX_S}), "
            f"shadow lanes {bi.n_sh} (max {MAX_SH}), spans {bi.n_spans} "
            f"(max {MAX_SPANS}), candidates {n_cand} (max {MAX_CAND}), "
            f"seed layers {bi.n_layers} (max {MAX_SEED_LAYERS})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no band-scan engine for device {dev}")


def _launch(bi: BandInputs, forward: bool, carry: torch.Tensor,
            halo: Optional[sd.Halo] = None):
    """Launch one pass of csrc/sdp_band.cu, built with the plan of
    ``bi.header``, on the current stream of the tensors' card: K6 / K7,
    or with ``halo`` K8's pass over one chunk, whose outgoing Halo comes
    last.  ``carry`` is what K6 hands K7: the boundary bits, or a
    non-boundary model's per-seed start scores (B, n_seed), which K6
    raises and K7 reads.  Counts the launch by its ring route
    (``BAND_SMEM`` / ``BAND_GLOBAL``)."""
    name = "sdp_band_forward" if forward else "sdp_band_reverse"
    fn = (_lib("sdp_band", name, _ARGTYPES, bi.header) if halo is None
          else _lib("sdp_band", name + "_cross", _CROSS_ARGTYPES,
                    bi.header))
    dev = bi.dims.device
    B, W, R = bi.batch, bi.Qp + 1, bi.K + 1
    NR = max(bi.NR_fwd if forward else bi.NR_rev, 1)
    bits, start = (None, carry) if bi.track_sid else (carry, None)
    i32 = dict(dtype=torch.int32, device=dev)
    ring_sc = torch.empty((B, R, NR, W), **i32)
    ring_pm = torch.empty((B, R, NR, W), **i32)
    ring_ln = span_st = span_cu = colbest = xband = None
    nsr = 4 + bi.n_sh
    if bi.track_sid and not forward:
        # the reverse ring's seed-id plane, a row per ring state
        ring_ln = torch.empty((B, R, NR, W), **i32)
    if forward:
        ring_ln = torch.empty((B, R, max(NR * bi.n_sh, 1), W), **i32)
        span_st = torch.zeros((B, max(bi.n_spans, 1), nsr, W), **i32)
        span_st[:, :, 0] = NEG
        span_cu = torch.zeros((B, 2, max(bi.n_spans, 1), nsr, W), **i32)
        span_cu[:, :, :, 0] = NEG
        colbest = torch.full((B, bi.Wp + 1), NEG, **i32)
        xband = torch.zeros(B, **i32)
        if halo is not None and halo.span is not None:
            # the left chunk's registers, copied (the kernel updates them
            # in place): stored, and curr in both buffers (a lane's first
            # cell reads the buffer of d's parity)
            span_st = halo.span[None, :, 0].clone()
            span_cu = halo.span[:, 1][None, None].expand(
                1, 2, *halo.span[:, 1].shape).contiguous()
    live = torch.zeros(B, **i32)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    cross = []
    if halo is not None:
        out = sd.Halo(torch.full_like(halo.sc, NEG),
                      torch.full_like(halo.pm, NEG),
                      torch.zeros_like(halo.ln) if halo.ln is not None
                      else None, None)
        cross = [ptr(bi.tctx), ptr(halo.sc), ptr(halo.pm), ptr(halo.ln),
                 ptr(out.sc), ptr(out.pm), ptr(out.ln), bi.maxat]

    fit = (_I * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(bi.spans), ptr(bi.dims), ptr(bi.qvecs), ptr(bi.tvecs),
                ptr(bi.scalars),
                ptr(bits), ptr(ring_sc), ptr(ring_pm), ptr(ring_ln),
                ptr(span_st), ptr(span_cu), ptr(colbest), ptr(live),
                ptr(xband), ptr(start), bi.qvecs.shape[1],
                bi.tvecs.shape[1], bi.scalars.shape[1], B, bi.Qp, bi.Wp,
                bi.dropoff, bi.row_seedq, bi.row_seedv, bi.n_layers,
                bi.row_seedi, bi.row_seedh, bi.n_seed,
                (bi.qmax or bi.Qp) + 1, fit, *cross, stream)
    if rc != 0:
        which = "forward" if forward else "reverse"
        kernel = "cross-chip band" if halo is not None else "band"
        raise RuntimeError(f"{kernel} kernel ({which}) launch failed: CUDA "
                           f"error {rc}")
    count(BAND_SMEM if fit[2] else BAND_GLOBAL)
    last_fit[forward] = tuple(fit)
    if halo is None:
        return (colbest, live != 0, xband != 0) if forward else live != 0
    if forward and halo.span is not None:
        # each lane's curr register from the buffer its last cell wrote
        par = (torch.arange(W, device=dev) + bi.dims[0, 1]) & 1
        cu = torch.where(par == 0, span_cu[0, 0], span_cu[0, 1])
        out.span = sd._unjoint(torch.stack([span_st[0], cu], dim=1),
                               bi.span_joint)
    if forward:
        return colbest, live != 0, xband != 0, out
    return live != 0, out


# the cluster of each pass's last launch (C, T, ring in shared memory),
# by pass (True: forward), for reports
last_fit: dict = {}


def band_reverse(bi: BandInputs):
    """K6: the reverse pass of a batch.  Returns (bits (B, Dp, NW) int32,
    bit i & 31 of word i >> 5 set where lane i of diagonal d is a
    boundary cell; live (B,) bool); for a non-boundary model (start (B,
    n_seed) int32, each seed's best start score, NEG where none;
    live)."""
    _check_inputs(bi)
    if bi.dims.device.type == "cpu":
        return sd.plain_band_reverse(bi)
    if bi.track_sid:
        start = torch.full((bi.batch, bi.n_seed), sd.NEG, dtype=torch.int32,
                           device=bi.dims.device)
        live = _launch(bi, False, start)
        count(band_reverse)
        count(K6_SID)
        return start, live
    bits = torch.zeros((bi.batch, bi.Dp, bi.n_words), dtype=torch.int32,
                       device=bi.dims.device)
    live = _launch(bi, False, bits)
    count(band_reverse)
    return bits, live


band_reverse.launches = 0


def band_forward(bi: BandInputs, bits: torch.Tensor):
    """K7: the forward pass of a batch from K6's boundary bits (a
    non-boundary model: from K6's start scores).  Returns (colbest (B,
    Wp+1) int32, live (B,) bool, xband (B,) bool)."""
    _check_inputs(bi)
    want = ((bi.batch, bi.n_seed) if bi.track_sid
            else (bi.batch, bi.Dp, bi.n_words))
    if bits.device != bi.dims.device or bits.dtype != torch.int32 \
            or not bits.is_contiguous() or tuple(bits.shape) != want:
        what = "start scores" if bi.track_sid else "bits"
        raise ValueError(f"band_forward: {what} must be contiguous int32 "
                         f"{want} on {bi.dims.device}")
    if bi.dims.device.type == "cpu":
        return sd.plain_band_forward(bi, bits)
    out = _launch(bi, True, bits)
    count(band_forward)
    count(K7_SID, bi.track_sid)
    count(K9, bi.split)
    return out


band_forward.launches = 0


def _check_halo(bi: BandInputs, halo: sd.Halo, forward: bool) -> None:
    if bi.batch != 1 or bi.tctx is None:
        raise ValueError("the cross-chip band kernel runs one chunk of one "
                         "comparison: BandInputs of batch 1 with tctx")
    want = sd.blank_halo(bi, forward)
    dev = bi.dims.device
    for name in ("sc", "pm", "ln", "span"):
        a, w = getattr(halo, name), getattr(want, name)
        if (a is None) != (w is None) or a is not None and (
                a.device != dev or a.dtype != torch.int32
                or not a.is_contiguous() or a.shape != w.shape):
            raise ValueError(f"Halo.{name}: want "
                             f"{None if w is None else tuple(w.shape)} "
                             f"contiguous int32 on {dev}")


def band_reverse_cross(bi: BandInputs, halo: sd.Halo):
    """K8's reverse pass over one chunk: K6 with the right neighbour's
    edge planes in ``halo``.  Returns (bits, live, the Halo of this
    chunk's first columns for its left neighbour)."""
    _check_inputs(bi)
    _check_halo(bi, halo, False)
    if bi.dims.device.type == "cpu":
        return sd.plain_band_reverse(bi, halo)
    bits = torch.zeros((bi.batch, bi.Dp, bi.n_words), dtype=torch.int32,
                       device=bi.dims.device)
    live, out = _launch(bi, False, bits, halo)
    count(K8)
    return bits, live, out


def band_forward_cross(bi: BandInputs, bits: torch.Tensor, halo: sd.Halo):
    """K8's forward pass over one chunk: K7 from the chunk's boundary bits
    with the left neighbour's edge planes and span registers in
    ``halo``.  Returns (colbest, live, xband, the Halo of this chunk's
    last columns and registers for its right neighbour)."""
    _check_inputs(bi)
    _check_halo(bi, halo, True)
    want = (bi.batch, bi.Dp, bi.n_words)
    if bits.device != bi.dims.device or bits.dtype != torch.int32 \
            or not bits.is_contiguous() or tuple(bits.shape) != want:
        raise ValueError(f"band_forward_cross: bits must be contiguous "
                         f"int32 {want} on {bi.dims.device}")
    if bi.dims.device.type == "cpu":
        return sd.plain_band_forward(bi, bits, halo)
    out = _launch(bi, True, bits, halo)
    count(K8)
    count(K9, bi.split)
    return out


# ---------------------------------------------------------------------------
# batched API (mirrors sdp_pallas.run_kernel)
# ---------------------------------------------------------------------------

def engine_name(dev: torch.device) -> str:
    return "cuda-sdp" if dev.type == "cuda" else "torch-sdp"


def _pow2(n: int) -> int:
    p = 1024
    while p < n:
        p <<= 1
    return p


def locus_best(colbest: np.ndarray, plan) -> np.ndarray:
    """Segment-reduce one pair's column best to each locus's best end
    score (``sdp_pallas.py:1199-1206``)."""
    n_loci = len(plan.loci)
    band_end = np.full(max(n_loci, 1), NEG, np.int64)
    if n_loci:
        np.maximum.at(band_end, plan.locus_of_v,
                      colbest[:plan.W + 1].astype(np.int64))
    return band_end


def _pads(pair, plan) -> tuple:
    """(Qp, Wp) of one job: the query bucket, W to a power of two from
    1024 (``sdp_pallas.py:1114-1115``)."""
    return _bucket(pair.region.query_length), _pow2(max(plan.W, 1023))


def band_inputs(model: Model, jobs: list, dropoff: int,
                device: torch.device) -> BandInputs:
    """One K6/K7 batch of (pair, plan) jobs on ``device``, padded to the
    largest job's (Qp, Wp) and seed layers (a non-boundary model's with
    its seed ids)."""
    Qp = max(_pads(*job)[0] for job in jobs)
    Wp = max(_pads(*job)[1] for job in jobs)
    n_layers = max(count_seed_layers(pair, plan) for pair, plan in jobs)
    preps = [prepare_kernel_inputs(model, pair, plan, Qp, Wp, n_layers)
             for pair, plan in jobs]
    if not model_uses_boundary(model):
        for (flat, _k, meta), (pair, plan) in zip(preps, jobs):
            ids = seed_id_rows(pair, plan, Wp, n_layers)
            flat.update(ids)
            meta["tnames"] += tuple(ids)
            meta["n_seed"] = len(pair.seeds)
    kinds = preps[0][1]
    if any(p[1] != kinds for p in preps):
        raise ValueError("band_inputs: the jobs' calc kinds differ")
    return to_band_inputs(model, [p[0] for p in preps], kinds,
                          [p[2] for p in preps], Qp, Wp, dropoff, device)


def launch_batches(model: Model, jobs: list) -> list:
    """The K6/K7 launches of ``run_kernel`` over jobs [(pair, plan)]:
    the job indices of each, bucketed by (Qp, Wp) and capped by
    BAND_BYTES."""
    buckets: dict = {}
    for ix, job in enumerate(jobs):
        buckets.setdefault(_pads(*job), []).append(ix)
    out = []
    for (Qp, Wp), ixs in buckets.items():
        cap = max_batch(model, Qp, Wp, 8 + 2 * len(model.calcs))
        out += [ixs[k:k + cap] for k in range(0, len(ixs), cap)]
    return out


def run_kernel(model: Model, jobs: list, dropoff: int,
               device: torch.device, devices: Optional[list] = None
               ) -> list:
    """jobs: [(pair, plan)], launched as ``launch_batches`` groups them.
    Runs K6 then K7 per batch on ``device``'s current stream (their plain
    versions on the CPU).  With ``devices``, each batch is split into that
    many contiguous shards, one per device (the JAX package's batch over
    a mesh, ``sdp_pallas.py:1033-1042``), all launched before any result
    is fetched.  Returns per-job dicts {"band_end": [n_loci] int64,
    "live": bool, "xband": bool}, and for a non-boundary model
    "start_scores": [n_seeds] int64, each seed's best start score (NEG
    where none)."""
    out: list = [None] * len(jobs)
    pending = []
    for chunk in launch_batches(model, jobs):
        n_sh = len(devices) if devices else 1
        step = -(-len(chunk) // n_sh)
        for k in range(0, len(chunk), step):
            shard = chunk[k:k + step]
            dev = devices[k // step] if devices else device
            bi = band_inputs(model, [jobs[ix] for ix in shard], dropoff, dev)
            carry, live_r = band_reverse(bi)
            colbest, live_f, xband = band_forward(bi, carry)
            start = carry if bi.track_sid else None
            del carry
            pending.append((shard, colbest, live_r | live_f, xband, start))
    for shard, colbest, live, xband, start in pending:
        colbest = colbest.cpu().numpy()
        live = live.cpu().numpy()
        xband = xband.cpu().numpy()
        if start is not None:
            start = start.cpu().numpy().astype(np.int64)
        for b, ix in enumerate(shard):
            out[ix] = {"band_end": locus_best(colbest[b], jobs[ix][1]),
                       "live": bool(live[b]), "xband": bool(xband[b])}
            if start is not None:
                out[ix]["start_scores"] = start[b, :len(jobs[ix][0].seeds)]
    return out


def cross_chunks(model: Model, pair, plan, dropoff: int, n_chips: int,
                 devices: Optional[list] = None) -> list:
    """K8's chunks of one comparison (``run_kernel_cross_chip:1220-1290``):
    the compressed W axis cut into ceil((W+1)/n) columns each, padded to
    Wpc = pow2(chunk + MAXAT); every W-axis vector but the seed layers
    also gets the MAXAT columns past each end (the right ones in the row,
    the left ones as ``tctx``).  Returns [(v0, v1, BandInputs)], chunk c
    on ``devices[c % len(devices)]`` (the port's device when None)."""
    Qp = _bucket(pair.region.query_length)
    W = plan.W
    maxat = _max_target_advance(model)
    n_layers = count_seed_layers(pair, plan)
    flat_g, kinds, meta = prepare_kernel_inputs(
        model, pair, plan, Qp, _pow2(max(W, 1023)), n_layers)
    tnames = set(meta["tnames"])
    no_seed = {f"_seed{x}{lx}" for x in "qv" for lx in range(n_layers)}
    chunk = -(-(W + 1) // n_chips)
    Wpc = _pow2(chunk + maxat)
    out = []
    c = 0
    while c * chunk <= W:
        v0 = c * chunk
        v1 = min(v0 + chunk - 1, W)
        wlen = v1 - v0
        flat, ctx = {}, {}
        for n, g in flat_g.items():
            g = np.asarray(g)
            if n == "_wlen":
                flat[n] = np.array([wlen], np.int32)
            elif n in tnames:
                vec = np.zeros(Wpc + 1, np.int32)
                vec[:wlen + 1] = g[v0:v1 + 1]
                left = np.zeros(maxat, np.int32)
                if n not in no_seed:
                    kr = min(maxat, W - v1)
                    vec[wlen + 1:wlen + 1 + kr] = g[v1 + 1:v1 + 1 + kr]
                    kl = min(maxat, v0)
                    left[:kl] = g[v0 - 1::-1][:kl]
                flat[n], ctx[n] = vec, left
            else:
                flat[n] = g
        dev = devices[c % len(devices)] if devices else default_device()
        out.append((v0, v1, to_band_inputs(model, [flat], kinds, [meta],
                                           Qp, Wpc, dropoff, dev,
                                           ctx=[ctx])))
        c += 1
    return out


def run_kernel_cross_chip(model: Model, pair, plan, dropoff: int,
                          n_chips: int, devices: Optional[list] = None
                          ) -> dict:
    """ONE comparison across devices on K8 (``sdp_pallas.py:1220``): its
    chunks (``cross_chunks``) run the reverse pass right to left, then
    the forward pass left to right, each chunk on its own device, and
    the halo tensors are the only thing moved between devices.  Returns
    ``run_kernel``'s dict for the job, equal to its single launch."""
    chunks = cross_chunks(model, pair, plan, dropoff, n_chips, devices)
    bits: list = [None] * len(chunks)
    lives, xbands, cols = [], [], []
    halo = sd.blank_halo(chunks[-1][2], False)
    for cx in range(len(chunks) - 1, -1, -1):
        bi = chunks[cx][2]
        bits[cx], live, halo = band_reverse_cross(bi,
                                                  halo.to(bi.dims.device))
        lives.append(live)
    halo = sd.blank_halo(chunks[0][2], True)
    for cx, (v0, v1, bi) in enumerate(chunks):
        col, live, xband, halo = band_forward_cross(
            bi, bits[cx], halo.to(bi.dims.device))
        bits[cx] = None
        cols.append(col[0, :v1 - v0 + 1])
        lives.append(live)
        xbands.append(xband)
    colbest = np.concatenate([c.cpu().numpy() for c in cols])
    return {"band_end": locus_best(colbest, plan),
            "live": any(bool(v.any()) for v in lives),
            "xband": any(bool(v.any()) for v in xbands)}
