"""The exhaustive wavefront on hand-written CUDA kernels, and its host side.

Counterpart of ``exonerate_tpu/engine/pallas_wavefront.py``.  Three
kernels, each behind a wrapper with a launch counter:

- K1 ``wavefront_scan`` (``csrc/wavefront.cu``, modes score/region)
  replaces ``build_pallas_wavefront`` (``pallas_wavefront.py:427``);
- K4 ``wavefront_path`` (the same source, mode path) replaces its path
  mode (``:1147``), which writes each state's winning plan id per cell;
- ``walkback`` (``csrc/walkback.cu``) replaces ``_build_walkback:1550``.

Kernel K9, the split-codon score of protein2genome, coding2genome and
cdna2genome (``_make_split_pallas_fn``, ``model/phase.py:305``), is not
a launch of its own: it is the plan's ``C_SPLIT`` calc kind, evaluated
inside K1 and K4 (and inside the band kernel K7, ``cuda_sdp``), with the
shadow start vectors as start lanes read from a target vector.
``K9.launches`` counts the K1/K4/K7 launches whose plan holds it (the
reverse band pass K6 scores split codons as 0 and carries no lanes).

Kernel K3, the SubOpt mask of Waterman-Eggert re-runs (``_blocked``,
``pallas_wavefront.py:1129``), is not a launch of its own either: a
batch whose pairs carry a mask ships it as packed bits by destination
cell (``KernelInputs.blocked``) and runs the masked instantiation of
K1/K4, which bars the plan's match rows (``F_MATCH``) at blocked cells.
``find_batched`` and ``find_path_batched`` take ``subopt`` as one mask
or a per-job list, like the JAX package's; masked and mask-free jobs
fall into different buckets.  ``K3.launches`` counts the K1/K4 launches
that carry a mask plane.

The model is not compiled into the kernels: ``to_kernel_inputs``
flattens ``_build_plan(model)`` into an int32 plan table and the
per-pair arrays of ``prepare_inputs`` into four packed tensors, and the
kernels interpret the table cell by cell.  A wrapper given CPU tensors
runs the plain PyTorch version (``wavefront.plain_wavefront`` /
``plain_walkback``); given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import observe
from .reference import DPResult
from .sdp_native import _lane_for
from ..model.ir import Model, Protect, Scope

from .. import _cudabuild
from .. import device as default_device
from . import wavefront as wf
from .wavefront import (C_FACTORED, C_QVEC, C_SCALAR, C_SPLIT, C_TVEC,
                        F_FROM_START, F_MATCH, F_P_OVER, F_P_UNDER, F_SH_Q,
                        F_SH_T, F_TO_END, MAX_START_LANES, NEG, P_AQ, P_AT,
                        P_C0, P_C1, P_C2, P_C3, P_C4, P_C5, P_C6, P_CALC,
                        P_FLAGS, P_IN, P_NSTART, P_OUT, P_SH_LANE_Q,
                        P_SH_LANE_T,
                        P_SH_MAX, P_SH_MIN, P_ST_DES0, P_ST_SRC0, PLAN_COLS,
                        ST_QUERY, ST_TARGET, ST_TVEC, KernelInputs)

# maxima of csrc/wavefront.cu: lanes per state (MAX_L, compile-time), and
# the states and plan rows whose per-thread cell state and plan table fit
# the shared memory of a block (S * (2 + L) + plan, checked per launch)
MAX_S = 24
MAX_L = 6
MAX_PLAN = 64
THREADS = 256
SMEM_BYTES = 232_448          # shared memory a block may use on Hopper


class _LaunchCount:
    launches = 0


# kernel K9 (the split-codon calc kind): launches of K1/K4 (here) and of
# K7 (cuda_sdp) whose plan holds a split-codon row
K9 = _LaunchCount()

# kernel K3 (the SubOpt mask): launches of K1/K4 with a mask plane
K3 = _LaunchCount()

# device-memory budgets of one launch: the global carry rings, and in
# path mode the uint8 traceback cube (D x S x (Qp+1) bytes per pair)
RING_BYTES = 2 << 30
PATH_TB_BYTES = 4 << 30

# extra walk-back steps beyond one per diagonal (silent transitions)
WALK_SLACK = 256

_SCOPES = {Scope.ANYWHERE: wf.SCOPE_ANYWHERE, Scope.EDGE: wf.SCOPE_EDGE,
           Scope.QUERY: wf.SCOPE_QUERY, Scope.TARGET: wf.SCOPE_TARGET,
           Scope.CORNER: wf.SCOPE_CORNER}
_KERNEL_KINDS = ("factored", "qvec", "tvec", "scalar", "blocked")


# ---------------------------------------------------------------------------
# plan (copies of the Pallas module's host-side planners)
# ---------------------------------------------------------------------------

def _build_plan(model: Model) -> list:
    """Static per-transition execution plan (model order, minus pure
    start/end bookkeeping transitions)."""
    start_state = model.start_state.state
    end_state = model.end_state.state
    plan = []
    for t in model.transitions:
        if t.input is end_state or t.output is start_state:
            continue
        shadow_starts = model.src_shadows(t.input)
        plan.append(dict(
            t=t,
            is_match=t.is_match,
            key=wf._grid_key(model, t) if t.calc is not None else None,
            shkey=(f"sh{model.calcs.index(t.calc)}"
                   if t.calc is not None and t.calc.shadow_fn is not None
                   and t.calc.pallas_fn is None else None),
            pallas_ci=(model.calcs.index(t.calc)
                       if t.calc is not None
                       and t.calc.pallas_fn is not None else None),
            start_lanes=[(sh.designation, sh.start,
                          (f"shv{model.shadows.index(sh)}"
                           if sh.start_vec_fn is not None else None))
                         for sh in shadow_starts],
            dst_shadows=[(sh.name, sh.designation)
                         for sh in t.dst_shadows],
        ))
    return plan


def _storage_plan(model: Model, plan: list, region_lanes: tuple):
    """Carry-ring storage layout: which states need ring rows and
    which (state, lane) slots are live.  ``region_lanes`` are the extra
    lane ids carrying the region start (none for score mode)."""
    start_state = model.start_state.state
    end_state = model.end_state.state
    ring_states = sorted({p["t"].input.id for p in plan
                          if p["t"].advance_query
                          + p["t"].advance_target > 0
                          and p["t"].input is not start_state})
    live = {s.id: set() for s in model.states}
    if region_lanes:
        live[end_state.id] = set(region_lanes)
    changed = True
    while changed:
        changed = False
        for p in plan:
            t = p["t"]
            if t.input is start_state:
                continue
            consumed = ({d for _, d in p["dst_shadows"]}
                        if (p["shkey"] is not None
                            or p["pallas_ci"] is not None) else set())
            set_by = {d for d, _k, _v in p["start_lanes"]}
            need = consumed | (live[t.output.id] - set_by)
            if not need <= live[t.input.id]:
                live[t.input.id] |= need
                changed = True
    lane_slots = sorted((s, ln) for s in ring_states for ln in live[s])
    return ring_states, lane_slots, live


def _plan_transitions(model: Model) -> list:
    """The kernel's plan order (must match _build_plan)."""
    start_state = model.start_state.state
    end_state = model.end_state.state
    return [t for t in model.transitions
            if t.input is not end_state and t.output is not start_state]


def _storage(model: Model, mode: str):
    """_storage_plan for a mode: region mode carries the start cell in
    two extra lanes after the shadow designations."""
    n = model.total_shadow_designations
    lanes = (n, n + 1) if mode == "region" else ()
    return _storage_plan(model, _build_plan(model), lanes)


def _max_advance(model: Model) -> int:
    return max(max((t.advance_query + t.advance_target
                    for t in model.transitions), default=1), 1)


def unsupported_reason(model: Model, kinds: tuple = ()) -> Optional[str]:
    """Why the kernels cannot run this model (None when they can)."""
    plan_ts = _plan_transitions(model)
    for sh in model.shadows:
        if sh.start_vec_fn is not None and sh.start != "target_pos":
            return f"shadow start vector {sh.name!r} on the query axis"
    for t in plan_ts:
        if len(model.src_shadows(t.input)) > MAX_START_LANES:
            return f"more than {MAX_START_LANES} shadow starts"
        c = t.calc
        if c is None:
            continue
        if c.pallas_fn is not None:
            if c.kernel_inputs_fn is None:
                return f"split-codon calc {c.name!r} without kernel inputs"
            continue
        if c.qt_fn is not None and c.factored_fn is None:
            return f"2-D calc grid {c.name!r}"
        if c.shadow_fn is not None:
            kind, params = c.native_shadow or (None, {})
            if kind == "split_codon":
                return (f"query-side or joint split codon {c.name!r} "
                        f"(genome2genome): a shadow calc with array "
                        f"inputs, off the kernels as in the JAX package")
            if kind != "intron_window":
                return f"shadow calc {c.name!r} is not an intron window"
            for side, prefix in (("on_query", "query intron"),
                                 ("on_target", "target intron")):
                if params.get(side) and _lane_for(t, prefix) is None:
                    return f"no {prefix!r} lane for {t.name!r}"
    for key, kind in kinds:
        if kind not in _KERNEL_KINDS:
            return f"{kind} input {key}"
    if len(model.states) > MAX_S:
        return f"{len(model.states)} states > {MAX_S}"
    if model.total_shadow_designations + 2 > MAX_L:
        return (f"{model.total_shadow_designations} shadow lanes + 2 "
                f"region lanes > {MAX_L}")
    if len(plan_ts) > MAX_PLAN:
        return f"{len(plan_ts)} transitions > {MAX_PLAN}"
    if smem_bytes(len(model.states), model.total_shadow_designations + 2,
                  len(plan_ts), "path") > SMEM_BYTES:
        return "per-thread cell state over the shared memory of a block"
    return None


def smem_bytes(S: int, L: int, n_plan: int, mode: str) -> int:
    """Shared memory of one K1/K4 block (``launch`` in csrc/wavefront.cu):
    the plan table, the storage map and S scores, S*L lanes (and S plan
    ids in path mode) per thread."""
    cell_vars = max(S + S * L + (S if mode == "path" else 0), 5)
    return 4 * (n_plan * PLAN_COLS + S + S * max(L, 1) + cell_vars * THREADS)


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------

def _padded_shape(per_pair: list, kinds: tuple) -> tuple[int, int]:
    p = per_pair[0]
    Qp = Tp = None
    for key, kind in kinds:
        v = p[key]
        if kind == "factored":
            Qp, Tp = len(v["q_idx_s"]) - 1, len(v["t_idx"]) - 1
        elif kind == "qvec":
            Qp = len(v) - 1
        elif kind == "tvec":
            Tp = len(v) - 1
    if Qp is None:
        Qp = max(int(q["_qlen"]) for q in per_pair)
    if Tp is None:
        Tp = max(int(q["_tlen"]) for q in per_pair)
    return Qp, Tp


def to_kernel_inputs(model: Model, inputs, kinds: tuple,
                     device: torch.device,
                     mode: str = "region") -> KernelInputs:
    """Pack ``prepare_inputs(..., pad_to=(Qp, Tp), for_pallas=True)``
    dicts (one, or a list for a batch) and the plan table of ``model``
    onto ``device``.  The dicts are plain NumPy, so they may come from
    this package's prep or from the JAX package's
    (``exonerate_tpu.engine.wavefront.prepare_inputs``) for the same
    model: that is how the tests feed one input to both packages."""
    if mode not in ("score", "region", "path"):
        raise ValueError(f"unknown wavefront mode {mode!r}")
    per_pair = [inputs] if isinstance(inputs, dict) else list(inputs)
    reason = unsupported_reason(model, kinds)
    if reason is not None:
        raise ValueError(f"cuda_wavefront cannot run {model.name}: {reason}")
    B = len(per_pair)
    Qp, Tp = _padded_shape(per_pair, kinds)
    qcols: list = []
    tcols: list = []
    scols: list = []
    tabs: list = []
    slot: dict = {}

    def add(cols, name, get):
        slot[name] = len(cols)
        cols.append(np.stack([np.asarray(get(p), np.int32)
                              for p in per_pair]))

    ntab = 0
    kind_map = dict(kinds)
    plan = _build_plan(model)
    # the split-codon rows: R0..R24 and E1p0..2 consecutive, in that order
    for ci in sorted({p["pallas_ci"] for p in plan
                      if p["pallas_ci"] is not None}):
        for a in range(25):
            add(qcols, f"kc{ci}:R{a}", lambda p, k=f"kc{ci}:R{a}": p[k])
        for nm in ("E1p0", "E1p1", "E1p2", "N4"):
            if f"kc{ci}:{nm}" in kind_map:
                add(tcols, f"kc{ci}:{nm}", lambda p, k=f"kc{ci}:{nm}": p[k])
    for key, kind in kinds:
        if key in slot or kind == "blocked":
            continue
        if kind == "factored":
            add(qcols, (key, "q_idx_s"), lambda p: p[key]["q_idx_s"])
            add(qcols, (key, "q_override_s"),
                lambda p: p[key]["q_override_s"])
            add(tcols, (key, "t_idx"), lambda p: p[key]["t_idx"])
            tab = np.stack([np.asarray(p[key]["table"], np.int32)
                            for p in per_pair])
            slot[(key, "table")] = (ntab, tab.shape[2])
            tabs.append(tab.reshape(B, -1))
            ntab += tabs[-1].shape[1]
        elif kind == "qvec":
            add(qcols, key, lambda p: p[key])
        elif kind == "tvec":
            add(tcols, key, lambda p: p[key])
        else:
            add(scols, key, lambda p: p[key])
    for key, v in per_pair[0].items():
        # intron windows' scalars (a split codon's shadow inputs are the
        # arrays of its host form: the kernels read its kc rows instead)
        if key.startswith("sh") and isinstance(v, dict) \
                and model.calcs[int(key[2:])].pallas_fn is None:
            for name in sorted(v):
                add(scols, (key, name), lambda p: p[key][name])

    start, end = model.start_state.state, model.end_state.state
    rows = np.zeros((len(plan), PLAN_COLS), np.int32)
    for r, p in enumerate(plan):
        t, row = p["t"], rows[r]
        row[P_AQ], row[P_AT] = t.advance_query, t.advance_target
        row[P_IN], row[P_OUT] = t.input.id, t.output.id
        flags = ((F_FROM_START if t.input is start else 0)
                 | (F_TO_END if t.output is end else 0)
                 | (F_MATCH if p["is_match"] else 0))
        c = t.calc
        if c is not None:
            if c.protect & Protect.UNDERFLOW:
                flags |= F_P_UNDER
            if c.protect & Protect.OVERFLOW:
                flags |= F_P_OVER
            key = p["key"]
            kind = kind_map[key]
            if p["pallas_ci"] is not None:
                ci = p["pallas_ci"]
                phase = c.native_shadow[1]["phase"]

                def lane(prefix):
                    return next(des for name, des in p["dst_shadows"]
                                if name.startswith(prefix))
                row[P_CALC] = C_SPLIT
                row[P_C0] = slot[f"kc{ci}:R0"]
                row[P_C1] = slot[f"kc{ci}:E1p0" if phase == 1
                                 else f"kc{ci}:N4"]
                row[P_C2] = phase
                row[P_C3] = lane("target intron")
                if phase == 1:
                    row[P_C4] = lane("split c1")
                else:
                    row[P_C4], row[P_C5], row[P_C6] = (
                        lane(f"split p2k{k}") for k in range(3))
            elif kind == "factored":
                row[P_CALC] = C_FACTORED
                row[P_C0] = slot[(key, "q_idx_s")]
                row[P_C1] = slot[(key, "t_idx")]
                row[P_C2], row[P_C3] = slot[(key, "table")]
                row[P_C4] = slot[(key, "q_override_s")]
            else:
                row[P_CALC] = {"qvec": C_QVEC, "tvec": C_TVEC,
                               "scalar": C_SCALAR}[kind]
                row[P_C0] = slot[key]
            if p["shkey"] is not None:
                params = c.native_shadow[1]
                if params.get("on_query"):
                    flags |= F_SH_Q
                    row[P_SH_LANE_Q] = _lane_for(t, "query intron")
                if params.get("on_target"):
                    flags |= F_SH_T
                    row[P_SH_LANE_T] = _lane_for(t, "target intron")
                row[P_SH_MIN] = slot[(p["shkey"], "min_intron")]
                row[P_SH_MAX] = slot[(p["shkey"], "max_intron")]
        row[P_FLAGS] = flags
        row[P_NSTART] = len(p["start_lanes"])
        for k, (des, kind, vec) in enumerate(p["start_lanes"]):
            row[P_ST_DES0 + 2 * k] = des
            row[P_ST_SRC0 + 2 * k] = (
                ST_TVEC + slot[vec] if vec is not None
                else ST_QUERY if kind == "query_pos" else ST_TARGET)

    n_shadow = model.total_shadow_designations
    S = len(model.states)
    L = n_shadow + (2 if mode == "region" else 0)
    ring_states, lane_slots, _ = _storage(model, mode)
    ring_row = np.full(S, -1, np.int32)
    ring_row[ring_states] = np.arange(len(ring_states))
    lane_row = np.full((S, max(L, 1)), -1, np.int32)
    for n, (s, ln) in enumerate(lane_slots):
        lane_row[s, ln] = n
    plan_ts = _plan_transitions(model)
    walk = np.asarray(
        [[0] + [t.advance_query for t in plan_ts],
         [0] + [t.advance_target for t in plan_ts],
         [0] + [t.input.id for t in plan_ts],
         [1] + [int(t.input is start) for t in plan_ts]], np.int32)

    def stacked(cols, width):
        if not cols:
            return np.zeros((B, 1, width), np.int32)
        return np.ascontiguousarray(np.stack(cols, axis=1))

    dims = np.asarray([[p["_qstart"], p["_tstart"], p["_qlen"], p["_tlen"]]
                       for p in per_pair], np.int32)

    def put(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    # the SubOpt mask bits, (Qp+1, ceil((Tp+1)/8)) per pair after
    # _pad_inputs; a bucket is masked in all its pairs or in none
    blocked = (np.stack([p["_blocked"] for p in per_pair])
               if "_blocked" in kind_map else np.zeros(0, np.uint8))

    return KernelInputs(
        plan=put(rows), ring_row=put(ring_row), lane_row=put(lane_row),
        dims=put(dims),
        qvecs=put(stacked(qcols, Qp + 1)),
        tvecs=put(stacked(tcols, Tp + 1)),
        tables=put(np.concatenate(tabs, axis=1) if tabs
                   else np.zeros((B, 1), np.int32)),
        scalars=put(np.stack(scols, axis=1) if scols
                    else np.zeros((B, 1), np.int32)),
        walk=put(walk), blocked=put(blocked, np.uint8), Qp=Qp, Tp=Tp, S=S,
        L=L, n_shadow=n_shadow,
        K=_max_advance(model), NR=len(ring_states), NL=len(lane_slots),
        start_id=start.id, end_id=end.id,
        start_scope=_SCOPES[model.start_state.scope],
        end_scope=_SCOPES[model.end_state.scope], mode=mode,
        split=bool((rows[:, P_CALC] == C_SPLIT).any()
                   or (rows[:, P_ST_SRC0::2] >= ST_TVEC).any()))


def max_batch(model: Model, Qp: int, Tp: int, mode: str,
              masked: bool = False) -> int:
    """Largest batch whose carry rings (and, in path mode, traceback
    cubes), each with a pair's SubOpt mask plane when ``masked``, fit the
    device-memory budgets; 0 when one pair's cube does not fit."""
    ring_states, lane_slots, _ = _storage(model, mode)
    W = Qp + 1
    plane = W * ((Tp + 8) // 8) if masked else 0
    ring = ((_max_advance(model) + 1)
            * (max(len(ring_states), 1) + max(len(lane_slots), 1)) * W * 4)
    n = RING_BYTES // (ring + plane)
    if mode == "path":
        n = min(n, PATH_TB_BYTES // ((Qp + Tp + 1) * len(model.states) * W
                                     + plane))
    return n


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_typed: set = set()


def _lib(stem: str, fn: str, argtypes: list):
    """Entry point ``fn`` of csrc/<stem>.cu, typed once per (stem, fn):
    a library with several entry points types each of them."""
    lib = _cudabuild.load(stem)
    if (stem, fn) not in _typed:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
        _typed.add((stem, fn))
    return getattr(lib, fn)


def _check_inputs(ki: KernelInputs) -> None:
    dev = ki.dims.device
    B, W, WT = ki.batch, ki.Qp + 1, ki.Tp + 1
    shapes = {"plan": (None, PLAN_COLS), "ring_row": (ki.S,),
              "lane_row": (ki.S, max(ki.L, 1)), "dims": (B, 4),
              "qvecs": (B, None, W), "tvecs": (B, None, WT),
              "tables": (B, None), "scalars": (B, None),
              "walk": (4, None)}
    for name, want in shapes.items():
        t = getattr(ki, name)
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"KernelInputs.{name}: want contiguous int32 "
                             f"on {dev}, got {t.dtype} on {t.device}")
        if t.dim() != len(want) or any(w is not None and w != g
                                       for w, g in zip(want, t.shape)):
            raise ValueError(f"KernelInputs.{name}: shape {tuple(t.shape)}"
                             f" does not match {want}")
    if ki.masked and (ki.blocked.dtype != torch.uint8
                      or ki.blocked.device != dev
                      or not ki.blocked.is_contiguous()
                      or tuple(ki.blocked.shape) != (B, W, (WT + 7) // 8)):
        raise ValueError(f"KernelInputs.blocked: want contiguous uint8 "
                         f"{(B, W, (WT + 7) // 8)} on {dev}, got "
                         f"{ki.blocked.dtype} {tuple(ki.blocked.shape)} on "
                         f"{ki.blocked.device}")
    if ki.S > MAX_S or ki.L > MAX_L or ki.plan.shape[0] > MAX_PLAN \
            or smem_bytes(ki.S, ki.L, ki.plan.shape[0],
                          ki.mode) > SMEM_BYTES:
        raise ValueError(f"model over the kernel maxima: S={ki.S} "
                         f"(max {MAX_S}), L={ki.L} (max {MAX_L}), plan "
                         f"{ki.plan.shape[0]} (max {MAX_PLAN}), shared "
                         f"memory {smem_bytes(ki.S, ki.L, ki.plan.shape[0], ki.mode)}"
                         f" B (max {SMEM_BYTES})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no wavefront engine for device {dev}")


def _launch(ki: KernelInputs):
    """Launch csrc/wavefront.cu on the current stream of the tensors'
    card.  Returns (out (5, B) int32, tb or None)."""
    fn = _lib("wavefront", "wavefront_launch",
              [_I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I,
               _P, _P, _P, _P] + [_I] * 15 + [_P, _P])
    dev = ki.dims.device
    B, W, D, R = ki.batch, ki.Qp + 1, ki.Qp + ki.Tp + 1, ki.K + 1
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    ring = torch.empty((B, R, max(ki.NR, 1), W), dtype=torch.int32,
                       device=dev)
    lring = torch.empty((B, R, max(ki.NL, 1), W), dtype=torch.int32,
                        device=dev)
    tb = (torch.empty((B, D, ki.S, W), dtype=torch.uint8, device=dev)
          if ki.mode == "path" else None)
    mode = {"score": 0, "region": 1, "path": 2}[ki.mode]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(mode, ki.plan.data_ptr(), ki.ring_row.data_ptr(),
                ki.lane_row.data_ptr(), ki.dims.data_ptr(),
                ki.qvecs.data_ptr(), ki.qvecs.shape[1],
                ki.tvecs.data_ptr(), ki.tvecs.shape[1],
                ki.tables.data_ptr(), ki.tables.shape[1],
                ki.scalars.data_ptr(), ki.scalars.shape[1],
                ring.data_ptr(), lring.data_ptr(),
                tb.data_ptr() if tb is not None else None, out.data_ptr(),
                ki.plan.shape[0], B, ki.Qp, ki.Tp, ki.S, ki.L,
                max(ki.NR, 1), max(ki.NL, 1), R, ki.n_shadow, ki.start_id,
                ki.end_id, ki.start_scope, ki.end_scope, int(ki.split),
                ki.blocked.data_ptr() if ki.masked else None, stream)
    if rc != 0:
        raise RuntimeError(f"wavefront kernel ({ki.mode}) launch failed: "
                           f"CUDA error {rc}")
    return out, tb


def wavefront_scan(ki: KernelInputs) -> torch.Tensor:
    """K1: the whole wavefront of a batch in score or region mode.
    Returns (5, B) int32: score, query_end, target_end, query_start,
    target_start (starts are 0 in score mode)."""
    if ki.mode not in ("score", "region"):
        raise ValueError(f"wavefront_scan runs score/region, not {ki.mode}")
    _check_inputs(ki)
    if ki.dims.device.type == "cpu":
        return wf.plain_wavefront(ki)[0]
    out, _ = _launch(ki)
    wavefront_scan.launches += 1
    K9.launches += ki.split
    K3.launches += ki.masked
    return out


wavefront_scan.launches = 0


def wavefront_path(ki: KernelInputs):
    """K4: the wavefront in path mode.  Returns (out, tb): out as for
    wavefront_scan (starts 0), tb the (B, Qp+Tp+1, S, Qp+1) uint8 cube
    of winning plan ids (row + 1; 0 = unset)."""
    if ki.mode != "path":
        raise ValueError(f"wavefront_path runs path mode, not {ki.mode}")
    _check_inputs(ki)
    if ki.dims.device.type == "cpu":
        return wf.plain_wavefront(ki)
    out, tb = _launch(ki)
    wavefront_path.launches += 1
    K9.launches += ki.split
    K3.launches += ki.masked
    return out, tb


wavefront_path.launches = 0


def walkback(tb: torch.Tensor, stats: torch.Tensor, walk: torch.Tensor,
             end_id: int, cap: int):
    """Walk-back of every pair from its end cell (rows 1, 2 of
    ``stats``) to a transition from START.  Returns (ops (B, cap) int32
    plan ids end->start, res (3, B) int32: n_ops, query_start,
    target_start)."""
    dev = tb.device
    if tb.dtype != torch.uint8 or tb.dim() != 4 or not tb.is_contiguous():
        raise ValueError("walkback: tb must be a contiguous (B, D, S, W) "
                         "uint8 tensor")
    B, D, S, W = tb.shape
    for name, t, shape in (("stats", stats, (5, B)),
                           ("walk", walk, (4, walk.shape[-1]))):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"walkback: {name} must be contiguous int32 "
                             f"{shape} on {dev}")
    if dev.type == "cpu":
        return wf.plain_walkback(tb, stats, walk, end_id, cap)
    if dev.type != "cuda":
        raise ValueError(f"no walk-back engine for device {dev}")
    fn = _lib("walkback", "walkback_launch",
              [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    ops = torch.empty((B, cap), dtype=torch.int32, device=dev)
    res = torch.empty((3, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(tb.data_ptr(), stats.data_ptr(), walk.data_ptr(),
                walk.shape[1], end_id, B, D, S, W, cap, ops.data_ptr(),
                res.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"walk-back kernel launch failed: CUDA error {rc}")
    walkback.launches += 1
    return ops, res


walkback.launches = 0


# ---------------------------------------------------------------------------
# batched API (mirrors pallas_wavefront.find_batched / find_path_batched)
# ---------------------------------------------------------------------------

def engine_name(dev: torch.device) -> str:
    return "cuda-wavefront" if dev.type == "cuda" else "torch-wavefront"


def _buckets(model: Model, jobs: list, subopt=None) -> dict:
    """Jobs by (Qp, Tp, kinds); ``subopt`` is one SubOpt for every job or
    a per-job list.  A job whose mask blocks no cell of its region has no
    ``_blocked`` kind, so it shares the mask-free buckets."""
    out: dict = {}
    for n, (region, data) in enumerate(jobs):
        sub = subopt[n] if isinstance(subopt, (list, tuple)) else subopt
        Qp = wf._bucket(region.query_length)
        Tp = wf._bucket(region.target_length)
        inputs, kinds = wf.prepare_inputs(model, region, data, subopt=sub,
                                          pad_to=(Qp, Tp), for_pallas=True)
        out.setdefault((Qp, Tp, kinds), []).append((n, inputs))
    return out


def _masked(kinds: tuple) -> bool:
    return ("_blocked", "blocked") in kinds


def find_batched(model: Model, jobs: list, mode: str = "region",
                 device: Optional[torch.device] = None,
                 subopt=None) -> list:
    """Score or region DP of (region, data) jobs on K1, under ``subopt``
    (one SubOpt mask or a per-job list) when given.  Returns one DPResult
    per job (starts are 0 in score mode)."""
    dev = device if device is not None else default_device()
    out: list = [None] * len(jobs)
    for (Qp, Tp, kinds), items in _buckets(model, jobs, subopt).items():
        cap = max(1, max_batch(model, Qp, Tp, mode, _masked(kinds)))
        for lo in range(0, len(items), cap):
            chunk = items[lo:lo + cap]
            ki = to_kernel_inputs(model, [inp for _, inp in chunk], kinds,
                                  dev, mode)
            res = wavefront_scan(ki).cpu().tolist()
            observe.count_engine(engine_name(dev), len(chunk))
            for b, (n, _) in enumerate(chunk):
                out[n] = DPResult(score=res[0][b], query_end=res[1][b],
                                  target_end=res[2][b],
                                  query_start=res[3][b],
                                  target_start=res[4][b])
    return out


def find_path_batched(model: Model, jobs: list, subopt=None,
                      device: Optional[torch.device] = None) -> list:
    """Full-path DP on K4 plus the walk-back, under ``subopt`` (one SubOpt
    mask or a per-job list) when given.  Returns DPResults with ``.path``;
    an entry is None when the job's traceback cube is over the budget or
    its path is longer than the walk cap (the caller then runs it on the
    host)."""
    dev = device if device is not None else default_device()
    out: list = [None] * len(jobs)
    plan_ts = _plan_transitions(model)
    for (Qp, Tp, kinds), items in _buckets(model, jobs, subopt).items():
        cap_b = max_batch(model, Qp, Tp, "path", _masked(kinds))
        if cap_b < 1:
            observe.count_fallback(
                f"{engine_name(dev)}->host: traceback cube over "
                f"{PATH_TB_BYTES >> 20} MB", len(items))
            continue
        wcap = Qp + Tp + 1 + WALK_SLACK
        for lo in range(0, len(items), cap_b):
            chunk = items[lo:lo + cap_b]
            ki = to_kernel_inputs(model, [inp for _, inp in chunk], kinds,
                                  dev, "path")
            stats, tb = wavefront_path(ki)
            ops, res = walkback(tb, stats, ki.walk, ki.end_id, wcap)
            del tb
            stats, ops, res = (stats.cpu().numpy(), ops.cpu().numpy(),
                               res.cpu().numpy())
            observe.count_engine(engine_name(dev), len(chunk))
            for b, (n, _) in enumerate(chunk):
                k = int(res[0, b])
                if k >= wcap:
                    observe.count_fallback(
                        f"{engine_name(dev)}->host: path over the walk cap")
                    continue
                sc = int(stats[0, b])
                if sc <= NEG:
                    # no alignment: keep the empty-path contract
                    r = DPResult(score=NEG, query_end=0, target_end=0,
                                 query_start=0, target_start=0)
                    r.path = []
                    out[n] = r
                    continue
                r = DPResult(score=sc, query_end=int(stats[1, b]),
                             target_end=int(stats[2, b]),
                             query_start=int(res[1, b]),
                             target_start=int(res[2, b]))
                r.path = [plan_ts[tid - 1] for tid in ops[b, :k][::-1]]
                out[n] = r
    return out
