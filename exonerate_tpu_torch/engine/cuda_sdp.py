"""The seeded band scan on hand-written CUDA kernels, and its host side.

Counterpart of ``exonerate_tpu/engine/sdp_pallas.py``.  Two kernels of
``csrc/sdp_band.cu``, each behind a wrapper with a launch counter:

- K6 ``band_reverse`` replaces the reverse pass of ``build_sdp_kernel``
  (``make_kernel(False)``, ``pallas_call`` ``sdp_pallas.py:974``): seed
  injection, the backward recurrence, the boundary bits and ``live``;
- K7 ``band_forward`` replaces the forward pass (``make_kernel(True)``,
  ``pallas_call`` ``:996``): boundary injection, span registers, the
  per-column best end score, ``live`` and ``xband``.

The model is not compiled into the kernels: ``to_band_inputs`` flattens
``_plan_transitions`` into an int32 candidate table per pass, and the
per-pair arrays of ``prepare_kernel_inputs`` into packed q-axis, W-axis
and scalar tensors; the kernels interpret the tables cell by cell.  The
TPU frame of the Pallas kernel (reversed 128-aligned windows, 31
diagonals per boundary word, the flipped column-best plane) is layout
and is not kept: a kernel reads column ``j = d - i`` of a plain
``(Wp+1)`` vector and keeps one boundary bit per cell, 32 lanes per
word.  A wrapper given CPU tensors runs the plain PyTorch version
(``sdp_device.plain_band_reverse`` / ``plain_band_forward``); given CUDA
tensors it launches the kernel or raises.
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

from . import sdp_device as sd
from .cuda_wavefront import K9, _lib
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

# compile-time maxima of csrc/sdp_band.cu: the kernels are instantiated
# for up to SMALL_S states (est2genome's 10) and up to MAX_S (cdna2genome's
# 22), so that the per-thread cell state of the smaller models does not
# grow with the larger bound
SMALL_S = 16
MAX_S = 24
MAX_SH = 4
MAX_SPANS = 6
MAX_CAND = 64

# device-memory budget of one launch pair: boundary bits, W-axis inputs,
# column-best plane and the carry/span planes of every pair of the batch
BAND_BYTES = 2 << 30


# ---------------------------------------------------------------------------
# host prep — copies of the Pallas module's host-side functions
# ---------------------------------------------------------------------------

def kernel_supported(model: Model, use_boundary: bool, n_layers: int,
                     pair=None) -> bool:
    """Is the band kernel applicable?  (``sdp_pallas.py:73``; callers also
    require ``sdp_device.supported(model)``.)"""
    if not use_boundary:
        return False
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


def _ring_plan(model: Model, is_forward: bool) -> list:
    """States needing carry-ring rows: the reads of advancing candidates."""
    adv_plan, _ = sd._plan_transitions(model, is_forward)
    return sorted({e["read"] for e in adv_plan})


def _max_advance(model: Model) -> int:
    return max(max((t.advance_query + t.advance_target
                    for t in model.transitions), default=1), 1)


def unsupported_reason(model: Model, pair=None, plan=None) -> Optional[str]:
    """Why the band kernels cannot run this model (and pair), naming the
    missing piece; None when they can."""
    if not sd.supported(model):
        return "model not expressible by the band scan"
    if not model_uses_boundary(model):
        return ("non-boundary model: the start-score attribution scan "
                "(track_sid) is not ported")
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
                srow: dict, kind_map: dict, ncls: dict) -> tuple:
    """The int32 candidate table of one pass (advancing rows first) and
    the number of advancing rows."""
    adv, silent = sd._plan_transitions(model, forward)
    rows = np.zeros((len(adv) + len(silent), BP_COLS), np.int32)
    for r, e in enumerate(adv + silent):
        row = rows[r]
        row[BP_AQ], row[BP_AT] = e["aq"], e["at"]
        row[BP_READ], row[BP_WRITE] = e["read"], e["write"]
        row[BP_C0] = row[BP_C1] = row[BP_C2] = row[BP_CONTIG] = -1
        flags = ((BF_P_UNDER if e["p_under"] else 0)
                 | (BF_P_OVER if e["p_over"] else 0)
                 | (BF_EVENT if forward and e["event"] else 0))
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
                   device: torch.device) -> BandInputs:
    """Pack the ``prepare_kernel_inputs`` outputs of a batch (same Qp, Wp,
    kinds and seed layers) and the candidate tables of ``model`` onto
    ``device``.  A name some pairs lack (an all-zero override plane)
    ships zeros for them."""
    reason = unsupported_reason(model)
    if reason is not None:
        raise ValueError(f"cuda_sdp cannot run {model.name}: {reason}")
    B = len(flats)
    n_layers = metas[0]["n_layers"]
    tnames = set(metas[0]["tnames"])
    names = sorted({n for f in flats for n in f})
    kind_map = dict(kinds)
    ncls = {k: v for k, v in metas[0].items()
            if k in kind_map and kind_map[k] == "factored"}

    def column(name):
        proto = next(f[name] for f in flats if name in f)
        return np.stack([np.asarray(f.get(name, np.zeros_like(proto)),
                                    np.int32) for f in flats])

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
            a = next(f[n] for f in flats if n in f)
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
    qrow = {n: r for r, n in enumerate(qnames)}
    trow = {n: r for r, n in enumerate(tnames_l)}
    srow = {n: r for r, n in enumerate(snames)}

    def stacked(ns, width):
        if not ns:
            return np.zeros((B, 1, width), np.int32)
        return np.ascontiguousarray(np.stack([column(n) for n in ns],
                                             axis=1))

    rev_plan, n_adv_rev = _plan_table(model, False, qrow, trow, srow,
                                      kind_map, ncls)
    fwd_plan, n_adv_fwd = _plan_table(model, True, qrow, trow, srow,
                                      kind_map, ncls)
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
        split=bool((fwd_plan[:, BP_CALC] == K_SPLIT).any()))


def pair_bytes(model: Model, Qp: int, Wp: int, n_tvec: int) -> int:
    """Device bytes one pair of a launch pair holds: boundary bits,
    W-axis inputs and column best, the carry rings of both passes and
    the span registers."""
    W = Qp + 1
    S, n_sh, R = len(model.states), model.total_shadow_designations, \
        _max_advance(model) + 1
    n_spans = len(model.spans)
    return 4 * ((Qp + Wp + 1) * ((Qp + 32) // 32)
                + (n_tvec + 1) * (Wp + 1)
                + R * S * (2 + n_sh) * W
                + 3 * n_spans * (4 + n_sh) * W)


def max_batch(model: Model, Qp: int, Wp: int, n_tvec: int) -> int:
    """Largest batch within BAND_BYTES (at least 1)."""
    return max(1, BAND_BYTES // pair_bytes(model, Qp, Wp, n_tvec))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 16 + [_I] * 22 + [_P]


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


def _launch(bi: BandInputs, forward: bool, bits: torch.Tensor):
    """Launch one pass of csrc/sdp_band.cu on the current stream of the
    tensors' card."""
    fn = _lib("sdp_band", "sdp_band_forward" if forward
              else "sdp_band_reverse", _ARGTYPES)
    dev = bi.dims.device
    B, W, R = bi.batch, bi.Qp + 1, bi.K + 1
    NR = max(bi.NR_fwd if forward else bi.NR_rev, 1)
    i32 = dict(dtype=torch.int32, device=dev)
    ring_sc = torch.empty((B, R, NR, W), **i32)
    ring_pm = torch.empty((B, R, NR, W), **i32)
    ring_ln = span_st = span_cu = colbest = xband = None
    nsr = 4 + bi.n_sh
    if forward:
        ring_ln = torch.empty((B, R, max(NR * bi.n_sh, 1), W), **i32)
        span_st = torch.zeros((B, max(bi.n_spans, 1), nsr, W), **i32)
        span_st[:, :, 0] = NEG
        span_cu = torch.zeros((B, 2, max(bi.n_spans, 1), nsr, W), **i32)
        span_cu[:, :, :, 0] = NEG
        colbest = torch.full((B, bi.Wp + 1), NEG, **i32)
        xband = torch.zeros(B, **i32)
    live = torch.zeros(B, **i32)
    plan = bi.fwd_plan if forward else bi.rev_plan

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(plan), ptr(bi.spans),
                ptr(bi.fwd_ring if forward else bi.rev_ring), ptr(bi.dims),
                ptr(bi.qvecs), ptr(bi.tvecs), ptr(bi.scalars), ptr(bits),
                ptr(ring_sc), ptr(ring_pm), ptr(ring_ln), ptr(span_st),
                ptr(span_cu), ptr(colbest), ptr(live), ptr(xband),
                plan.shape[0], bi.n_adv_fwd if forward else bi.n_adv_rev,
                bi.n_spans, bi.qvecs.shape[1], bi.tvecs.shape[1],
                bi.scalars.shape[1], B, bi.Qp, bi.Wp, bi.S, bi.n_sh, bi.K,
                NR, bi.start_id, bi.end_id, bi.dropoff, bi.row_abs_t,
                bi.row_edge, bi.row_seg, bi.row_seedq, bi.row_seedv,
                bi.n_layers, stream)
    if rc != 0:
        which = "forward" if forward else "reverse"
        raise RuntimeError(f"band kernel ({which}) launch failed: CUDA "
                           f"error {rc}")
    if forward:
        return colbest, live != 0, xband != 0
    return live != 0


def band_reverse(bi: BandInputs):
    """K6: the reverse pass of a batch.  Returns (bits (B, Dp, NW) int32,
    bit i & 31 of word i >> 5 set where lane i of diagonal d is a
    boundary cell; live (B,) bool)."""
    _check_inputs(bi)
    if bi.dims.device.type == "cpu":
        return sd.plain_band_reverse(bi)
    bits = torch.zeros((bi.batch, bi.Dp, bi.n_words), dtype=torch.int32,
                       device=bi.dims.device)
    live = _launch(bi, False, bits)
    band_reverse.launches += 1
    return bits, live


band_reverse.launches = 0


def band_forward(bi: BandInputs, bits: torch.Tensor):
    """K7: the forward pass of a batch from K6's boundary bits.  Returns
    (colbest (B, Wp+1) int32, live (B,) bool, xband (B,) bool)."""
    _check_inputs(bi)
    want = (bi.batch, bi.Dp, bi.n_words)
    if bits.device != bi.dims.device or bits.dtype != torch.int32 \
            or not bits.is_contiguous() or tuple(bits.shape) != want:
        raise ValueError(f"band_forward: bits must be contiguous int32 "
                         f"{want} on {bi.dims.device}")
    if bi.dims.device.type == "cpu":
        return sd.plain_band_forward(bi, bits)
    out = _launch(bi, True, bits)
    band_forward.launches += 1
    K9.launches += bi.split
    return out


band_forward.launches = 0


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
    largest job's (Qp, Wp) and seed layers."""
    Qp = max(_pads(*job)[0] for job in jobs)
    Wp = max(_pads(*job)[1] for job in jobs)
    n_layers = max(count_seed_layers(pair, plan) for pair, plan in jobs)
    preps = [prepare_kernel_inputs(model, pair, plan, Qp, Wp, n_layers)
             for pair, plan in jobs]
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
               device: torch.device) -> list:
    """jobs: [(pair, plan)], launched as ``launch_batches`` groups them.
    Runs K6 then K7 per batch on ``device``'s current stream (their plain
    versions on the CPU).  Returns per-job dicts {"band_end": [n_loci]
    int64, "live": bool, "xband": bool}."""
    out: list = [None] * len(jobs)
    for chunk in launch_batches(model, jobs):
        bi = band_inputs(model, [jobs[ix] for ix in chunk], dropoff,
                         device)
        bits, live_r = band_reverse(bi)
        colbest, live_f, xband = band_forward(bi, bits)
        del bits
        colbest = colbest.cpu().numpy()
        live = (live_r | live_f).cpu().numpy()
        xband = xband.cpu().numpy()
        for b, ix in enumerate(chunk):
            out[ix] = {"band_end": locus_best(colbest[b], jobs[ix][1]),
                       "live": bool(live[b]), "xband": bool(xband[b])}
    return out
