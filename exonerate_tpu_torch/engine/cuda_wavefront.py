"""The exhaustive wavefront on hand-written CUDA kernels, and its host side.

Counterpart of ``exonerate_tpu/engine/pallas_wavefront.py``.  Four
kernels, each behind a wrapper with a launch counter:

- K1 ``wavefront_scan`` (``csrc/wavefront.cu``, modes score/region)
  replaces ``build_pallas_wavefront`` (``pallas_wavefront.py:427``);
- K2 ``wavefront_stream_scan`` (the same source, its cluster kernel)
  replaces the streamed build (``stream=True``, ``:438``): the same
  function, each pair run by a thread-block cluster of several CTAs, for
  the batches whose clusters all fit the card at once and, of the larger
  ones, those the JAX package streams (``stream_bytes`` over
  ``STREAM_VMEM_BYTES``, the rule of ``find_batched``, ``:1437-1445``):
  ``on_cluster``; its carry ring lives in shared memory where it fits
  (``ring_in_smem``), else in global memory;
- K4 ``wavefront_path`` (the same source, mode path) replaces its path
  mode (``:1147``), which writes each state's winning plan id per cell;
- ``walkback`` (``csrc/walkback.cu``) replaces ``_build_walkback:1550``;
  ``walk_segment``, its entry point from a given cell and state over a
  segment's planes, walks the checkpointed traceback on the card.

K5, the sharded locus prescan (``find_batched_sharded``,
``pallas_wavefront.py:1470``), is K1 data-parallel over a list of
devices in one process: each device's shard of a batch is built and
launched there.  It has no source of its own.

A bucket the kernels refuse (``fallback_reason``: genome2genome's
query-side and joint split codons) runs on the generic wavefront
(``generic_wavefront``, the JAX package's XLA engine as torch ops), as
``pallas_wavefront.find_batched:1396-1420`` sends it to XLA.

``wavefront_segment`` runs a span of a batch's diagonals on the cluster
kernel, continuing the carry rings the span before it left: K2 in score
mode, K4 on a cluster in path mode.  It serves the checkpointed
traceback (``optimal.find_path_checkpointed``), whose traceback cube
does not fit the card.

Kernel K9, the split-codon score of protein2genome, coding2genome and
cdna2genome (``_make_split_pallas_fn``, ``model/phase.py:305``), is not
a launch of its own: it is the plan's ``C_SPLIT`` calc kind, evaluated
inside K1 and K4 (and inside the band kernel K7, ``cuda_sdp``), with the
shadow start vectors as start lanes read from a target vector.
``K9.launches`` counts the K1/K2/K4/K7 launches whose plan holds it (the
reverse band pass K6 scores split codons as 0 and carries no lanes).

Kernel K3, the SubOpt mask of Waterman-Eggert re-runs (``_blocked``,
``pallas_wavefront.py:1129``), is not a launch of its own either: a
batch whose pairs carry a mask ships it as packed bits by destination
cell (``KernelInputs.blocked``) and runs the masked instantiation of
K1/K2/K4, which bars the plan's match rows (``F_MATCH``) at blocked
cells.
``find_batched`` and ``find_path_batched`` take ``subopt`` as one mask
or a per-job list, like the JAX package's; masked and mask-free jobs
fall into different buckets.  A chunk, masked or not, runs on the
cluster kernel (score/region, and path mode over all its diagonals) when
its B clusters, of two CTAs or more, are all resident on the card at
once (``cluster_capacity``, ``fits_on_cluster``), else on K1/K4
(score/region: K2 where the JAX package streams it).  ``K3.launches``
counts the K1/K2/K4 launches that carry a mask plane; ``RING_SMEM`` and
``RING_GLOBAL`` count the cluster kernel's launches by where their carry
ring lives.

``to_kernel_inputs`` flattens ``_build_plan(model)`` into an int32 plan
table and the per-pair arrays of ``prepare_inputs`` into four packed
tensors.  Every kernel of ``csrc/wavefront.cu`` runs the table compiled
in: ``plan_cuda.wave_header`` writes it into a C++ header
(``KernelInputs.header``) and the source is built once per header
(``_cudabuild.load``); K1/K4 and the cluster kernel (K2, and K4 on a
cluster) share one cell body, unrolled over the plan's rows.  A wrapper given
CPU tensors runs the plain PyTorch version (``wavefront.plain_wavefront``
/ ``plain_walkback``); given CUDA tensors it launches the kernel or
raises: a failed build or launch raises, and no plan falls back to an
interpreter.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from .. import observe
from .reference import DPResult
from .sdp_native import _lane_for
from ..model.ir import Model, Protect, Scope

from .. import _cudabuild
from .. import device as default_device
from . import generic_wavefront as gw
from . import plan_cuda
from . import wavefront as wf
from .wavefront import (C_FACTORED, C_QVEC, C_SCALAR, C_SPLIT, C_TVEC,
                        F_FROM_START, F_MATCH, F_P_OVER, F_P_UNDER, F_SH_Q,
                        F_SH_T, F_TO_END, MAX_START_LANES, NEG, P_AQ, P_AT,
                        P_C0, P_C1, P_C2, P_C3, P_C4, P_C5, P_C6, P_CALC,
                        P_FLAGS, P_IN, P_NSTART, P_OUT, P_SH_LANE_Q,
                        P_SH_LANE_T,
                        P_SH_MAX, P_SH_MIN, P_ST_DES0, P_ST_SRC0, PLAN_COLS,
                        ST_QUERY, ST_TARGET, ST_TVEC, KernelInputs)

# maxima of csrc/wavefront.cu: lanes per state (MAX_L, checked against
# the header at compile time), and the states and plan rows of a plan
# whose unrolled cell keeps its state (S * (1 + L) scores and lanes, S plan
# ids) in the registers of a thread
MAX_S = 24
MAX_L = 6
MAX_PLAN = 64
THREADS = 256                 # the cluster kernel's threads per CTA
SMEM_BYTES = 232_448          # shared memory a block may use on Hopper
# K2's thread-block clusters: CTAs per pair at most (a non-portable size),
# and the largest size every Hopper part admits
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
# the smallest cluster the route gives a chunk whose clusters fit the card:
# at one CTA a pair (a query of at most 256 rows) K1/K4, up to 1024
# threads a CTA, sweep a diagonal 3-42% faster than the cluster kernel's
# 256 (B=1, est2genome and protein2genome, region and path, on an H100)
MIN_ROUTED_CLUSTER = 2


class _LaunchCount:
    launches = 0


# the launch counters are read-modify-writes: under --cores several worker
# threads launch at once, so every count goes through ``count``
_count_lock = threading.Lock()


def count(counter, n: int = 1) -> None:
    """Add ``n`` launches to ``counter`` (a wrapper or a _LaunchCount)."""
    if n:
        with _count_lock:
            counter.launches += n


# kernel K9 (the split-codon calc kind): launches of K1/K4 (here) and of
# K7 (cuda_sdp) whose plan holds a split-codon row
K9 = _LaunchCount()

# kernel K3 (the SubOpt mask): launches of K1/K2/K4 with a mask plane
K3 = _LaunchCount()

# kernel K2 (the streamed wavefront): launches of the cluster kernel in
# score and region modes (whole scans, batches whose clusters fit the card
# and the checkpointed traceback's forward segments)
K2 = _LaunchCount()

# the cluster kernel's launches (every mode) by the home of their carry
# ring: shared memory (``ring_in_smem``), or global memory where the ring
# is over the shared memory of a CTA (the trace counters
# ``ring.smem_launches`` and ``ring.global_launches`` count the same
# routes, every launch of ``_launch``)
RING_SMEM = _LaunchCount()
RING_GLOBAL = _LaunchCount()

# above this many bytes of reversed target vectors per call the JAX
# package streams them from HBM (``pallas_wavefront.STREAM_VMEM_BYTES``);
# here it routes a batch to K2
STREAM_VMEM_BYTES = 24 << 20

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
    return None


def smem_bytes() -> int:
    """Shared memory of one cluster-kernel CTA beside its ring and mask
    bytes (``smem_bytes`` in csrc/wavefront.cu): the block reduce, five
    int32 a thread.  The cell's state is registers."""
    return 4 * 5 * THREADS


def ring_smem_bytes(R: int, NR: int, NL: int, rows_per_thread: int,
                    masked: bool, smem_ring: bool) -> int:
    """The cluster kernel's shared memory beyond ``smem_bytes``
    (``ring_smem_bytes`` in csrc/wavefront.cu): each row's mask byte (an
    int32) when ``masked``, and with ``smem_ring`` R slots of the NR + NL
    ring rows over a CTA's ``rows_per_thread * THREADS`` rows and the R -
    1 halo rows below them."""
    rb = rows_per_thread * THREADS
    return 4 * ((rb if masked else 0)
                + (R * (NR + NL) * (rb + R - 1) if smem_ring else 0))


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


@observe.traced("wave.prep")
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

    # the SubOpt mask bits, (Qp+1, ceil((Tp+1)/8)) per pair; a bucket is
    # masked in all its pairs or in none (one pair's plane is not copied)
    blocked = (np.zeros(0, np.uint8) if "_blocked" not in kind_map
               else per_pair[0]["_blocked"][None] if B == 1
               else np.stack([p["_blocked"] for p in per_pair]))

    K = _max_advance(model)
    header = plan_cuda.wave_header(
        model.name, mode, rows, ring_row, lane_row, S=S, L=L,
        NR=len(ring_states), NL=len(lane_slots), K=K, n_shadow=n_shadow,
        start_id=start.id, end_id=end.id)
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
        K=K, NR=len(ring_states), NL=len(lane_slots),
        start_id=start.id, end_id=end.id,
        start_scope=_SCOPES[model.start_state.scope],
        end_scope=_SCOPES[model.end_state.scope], mode=mode,
        split=bool((rows[:, P_CALC] == C_SPLIT).any()
                   or (rows[:, P_ST_SRC0::2] >= ST_TVEC).any()),
        qmax=int(dims[:, 2].max()), header=header,
        n_diag=int(dims[:, 2:].sum(axis=1).max()) + 1)


def with_mode(ki: KernelInputs, mode: str) -> KernelInputs:
    """The batch of ``ki`` in ``mode``, score or path: the two modes keep
    the same lanes and carry rings (region mode adds two lanes), so the
    checkpointed traceback's forward pass runs its path batch in score
    mode on the same tensors, with that mode's compiled plan."""
    if ki.mode not in ("score", "path") or mode not in ("score", "path"):
        raise ValueError(f"with_mode: score and path modes share a plan's "
                         f"storage, not {ki.mode} and {mode}")
    return dataclasses.replace(ki, mode=mode, header=plan_cuda.wave_header_in(
        ki.header, mode))


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


def _qv(Qp: int) -> int:
    """The TPU kernel's lane-aligned width of the i axis
    (``pallas_wavefront._qv``)."""
    return ((Qp + 1 + 127) // 128) * 128


def n_rev(kinds: tuple) -> int:
    """The reversed (target-indexed) vectors the JAX package ships for a
    bucket of ``kinds`` (``pack_batched_inputs``' ``meta["wire"]``): one
    per factored calc (its target classes) and one per target vector."""
    return sum(1 for _key, kind in kinds if kind in ("factored", "tvec"))


def stream_bytes(kinds: tuple, B: int, Qp: int, Tp: int) -> int:
    """Bytes of a batch's reversed, padded int32 target vectors in the
    TPU kernel's VMEM (``pallas_wavefront.find_batched``, ``:1437-1443``),
    for ``B`` pairs rounded up to a power of two, as the JAX package pads
    each chunk (``_chunk_pow2``)."""
    Bp = 1 << max(B - 1, 0).bit_length()
    return n_rev(kinds) * Bp * (2 * _qv(Qp) + 128 + Tp + 1 + 264) * 4


def streams(kinds: tuple, B: int, Qp: int, Tp: int) -> bool:
    """Whether the JAX package streams this batch (K2): its footprint is
    over ``STREAM_VMEM_BYTES``."""
    return stream_bytes(kinds, B, Qp, Tp) > STREAM_VMEM_BYTES


def fits_on_cluster(B: int, capacity: tuple) -> bool:
    """A chunk of ``B`` pairs, masked or not, runs on the cluster kernel
    when each pair's cluster spans ``MIN_ROUTED_CLUSTER`` CTAs or more and
    its B clusters are all resident on the card at once (``capacity``, the
    (C, resident) of ``cluster_capacity``): each pair then has C SMs,
    where K1/K4 give it one."""
    C, resident = capacity
    return C >= MIN_ROUTED_CLUSTER and 0 < B <= resident


def on_cluster(kinds: tuple, B: int, Qp: int, Tp: int,
               capacity: tuple) -> bool:
    """Whether ``find_batched`` runs a chunk on the cluster kernel (K2):
    its clusters all fit the card (``fits_on_cluster``), or, for any
    other chunk, the JAX package's streaming test (``streams``)."""
    return fits_on_cluster(B, capacity) or streams(kinds, B, Qp, Tp)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_typed: set = set()
_typed_lock = threading.Lock()


def _lib(stem: str, fn: str, argtypes: list, header: Optional[str] = None):
    """Entry point ``fn`` of csrc/<stem>.cu (built with the compiled plan
    ``header`` when given), typed once per (library, fn): a library with
    several entry points types each of them (under a lock: worker threads
    may reach an entry point first together)."""
    lib = (_cudabuild.load(stem) if header is None
           else _cudabuild.load(stem, header))
    name = _cudabuild.name(stem, header)
    with _typed_lock:
        if (name, fn) not in _typed:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _typed.add((name, fn))
    return getattr(lib, fn)


def plan_threads(ki: KernelInputs) -> int:
    """The threads per CTA of K1/K4 on the plan of ``ki`` (its launcher's
    rule, ``plan_threads`` in csrc/wavefront.cu: as many as the register
    file holds at the plan's cell state); builds the plan's library."""
    return _lib("wavefront", "wavefront_plan_threads", [],
                ki.header)()


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
    if ki.S > MAX_S or ki.L > MAX_L or ki.plan.shape[0] > MAX_PLAN:
        raise ValueError(f"model over the kernel maxima: S={ki.S} "
                         f"(max {MAX_S}), L={ki.L} (max {MAX_L}), plan "
                         f"{ki.plan.shape[0]} (max {MAX_PLAN})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no wavefront engine for device {dev}")


def ring_buffers(ki: KernelInputs) -> tuple:
    """The (ring, lring) carry rings of a batch, (B, K+1, rows, Qp+1)
    int32 on its device: what a launch leaves and the next segment of
    the checkpointed traceback continues."""
    B, W, R = ki.batch, ki.Qp + 1, ki.K + 1
    dev = ki.dims.device
    return (torch.full((B, R, max(ki.NR, 1), W), NEG, dtype=torch.int32,
                       device=dev),
            torch.zeros((B, R, max(ki.NL, 1), W), dtype=torch.int32,
                        device=dev))


def _rows(ki: KernelInputs) -> int:
    """The widest diagonal of the batch: its largest qlen + 1."""
    return (ki.qmax if ki.qmax else int(ki.dims[:, 2].max())) + 1


_capacity: dict = {}
_capacity_lock = threading.Lock()


def _stream_capacity(ki: KernelInputs, smem_ring: bool,
                     cluster: int) -> tuple:
    """(C, resident) from the cluster kernel's launcher in the library of
    ``ki.header``: the cluster size it takes for the batch of ``ki``
    (``cluster``, or its rule for 0) and how many clusters of that size
    are resident on the card at once (``cudaOccupancyMaxActiveClusters``
    at the launch's shared memory); cached per plan, instantiation and
    shape."""
    dev = ki.dims.device
    key = (dev.index, ki.header, int(ki.masked), int(smem_ring), _rows(ki),
           cluster)
    with _capacity_lock:
        hit = _capacity.get(key)
    if hit is not None:
        return hit
    fn = _lib("wavefront", "wavefront_stream_capacity",
              [_I] * 4 + [ctypes.POINTER(_I)] * 2, ki.header)
    used, resident = _I(0), _I(0)
    with torch.cuda.device(dev):
        rc = fn(*key[2:], ctypes.byref(used), ctypes.byref(resident))
    if rc != 0:
        raise RuntimeError(f"cluster kernel ({ki.mode}): no cluster size "
                           f"launches: CUDA error {rc}")
    with _capacity_lock:
        _capacity[key] = (used.value, resident.value)
    return used.value, resident.value


def cluster_size(ki: KernelInputs) -> int:
    """The CTAs per pair that the cluster kernel runs the batch of ``ki``
    on: min(ceil(rows / THREADS), the larger of MAX_CLUSTER and
    PORTABLE_CLUSTER that the card admits), rows its widest diagonal (the
    launcher's rule, asked of its global-ring instantiation; MAX_CLUSTER
    on the CPU).  A launch passes this size to the launcher, so that the
    ring route is chosen at the size it runs."""
    if ki.dims.device.type != "cuda":
        return min(max(-(-_rows(ki) // THREADS), 1), MAX_CLUSTER)
    return _stream_capacity(ki, False, 0)[0]


def ring_in_smem(ki: KernelInputs, cluster: int = 0) -> bool:
    """Where the cluster kernel keeps the carry ring of the batch of
    ``ki`` at ``cluster`` CTAs per pair (0: ``cluster_size``): in shared
    memory (True; each CTA its rows' ring, the neighbour's rows read
    through distributed shared memory) when, at ceil(rows / (C *
    THREADS)) rows per thread, a CTA's ring, its mask bytes and block
    reduce included, fits its shared memory; else in global memory.  A
    capacity route, chosen per launch: est2genome fits in every mode at
    Qp 2304, protein2genome and coding2genome in score and path modes;
    their region modes, and cdna2genome's every mode, do not."""
    k = max(-(-_rows(ki) // ((cluster or cluster_size(ki)) * THREADS)), 1)
    return (smem_bytes()
            + ring_smem_bytes(ki.K + 1, max(ki.NR, 1), max(ki.NL, 1), k,
                              True, True)) <= SMEM_BYTES


def cluster_capacity(ki: KernelInputs) -> tuple:
    """(C, resident): ``cluster_size`` for the batch of ``ki``, and how
    many clusters of that size are resident on the card at once on its
    ring route (``ring_in_smem``).  On the CPU no cluster is resident:
    (C, 0)."""
    C = cluster_size(ki)
    if ki.dims.device.type != "cuda":
        return C, 0
    return C, _stream_capacity(ki, ring_in_smem(ki, C), C)[1]


def _launch(ki: KernelInputs, cluster: Optional[int] = None, span=None,
            ring=None):
    """Launch csrc/wavefront.cu, the library of ``ki.header``, on the
    current stream of the tensors' card: K1/K4 (``wavefront_plan_launch``),
    or the cluster kernel (``wavefront_stream_launch``) when ``cluster``
    is given, with that many CTAs per pair (0: ``cluster_size``), over the
    diagonals ``span`` = (d0, d1) continuing the carry rings ``ring`` when
    given (and leaving its last diagonals in them), the ring in shared
    memory where it fits at that size (``ring_in_smem``).  Returns (out
    (5, B) int32, tb or None, CTAs per pair)."""
    dev = ki.dims.device
    B, W, D, R = ki.batch, ki.Qp + 1, ki.Qp + ki.Tp + 1, ki.K + 1
    d0, d1 = span if span is not None else (0, D)
    # the diagonals the launch sweeps: its pairs run side by side, so it
    # lasts the loop of its longest pair
    swept = max(min(d1, ki.n_diag or D) - d0, 0)
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    # a launch given rings loads its carry from them and leaves its last
    # diagonals in them (the shared ring's bits 1, 2 of ring_io)
    ring_io = 0 if ring is None else 3
    if ring is None:
        ring = (torch.empty((B, R, max(ki.NR, 1), W), dtype=torch.int32,
                            device=dev),
                torch.empty((B, R, max(ki.NL, 1), W), dtype=torch.int32,
                            device=dev))
    tb = (torch.empty((B, d1 - d0, ki.S, W), dtype=torch.uint8, device=dev)
          if ki.mode == "path" else None)
    # the per-pair arguments of both entry points (the plan is compiled in)
    pair = [{"score": 0, "region": 1, "path": 2}[ki.mode], ki.dims.data_ptr(),
            ki.qvecs.data_ptr(), ki.qvecs.shape[1], ki.tvecs.data_ptr(),
            ki.tvecs.shape[1], ki.tables.data_ptr(), ki.tables.shape[1],
            ki.scalars.data_ptr(), ki.scalars.shape[1], ring[0].data_ptr(),
            ring[1].data_ptr(), tb.data_ptr() if tb is not None else None,
            out.data_ptr(), B, ki.Qp, ki.Tp, ki.start_scope, ki.end_scope,
            ki.blocked.data_ptr() if ki.masked else None]
    types = [_I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P] \
        + [_I] * 5 + [_P]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cluster is None:
            fn = _lib("wavefront", "wavefront_plan_launch", types + [_P],
                      ki.header)
            rc = fn(*pair, stream)
        else:
            C = cluster or cluster_size(ki)
            smem_ring = ring_in_smem(ki, C)
            used = _I(1)
            fn = _lib("wavefront", "wavefront_stream_launch",
                      types + [_I] * 6 + [ctypes.POINTER(_I), _P],
                      ki.header)
            rc = fn(*pair, C, _rows(ki), d0, d1, int(smem_ring), ring_io,
                    ctypes.byref(used), stream)
    if rc != 0:
        kernel = "wavefront kernel" if cluster is None else "cluster kernel"
        raise RuntimeError(f"{kernel} ({ki.mode}) launch failed: CUDA error "
                           f"{rc}")
    if cluster is None:
        observe.add("plan.diagonals", swept)
        observe.add("plan.path_diagonals" if ki.mode == "path"
                    else "plan.scan_diagonals", swept)
        return out, tb, 1
    observe.add("ring.diagonals", swept)
    observe.add("ring.path_diagonals" if ki.mode == "path"
                else "ring.scan_diagonals", swept)
    observe.add("ring.smem_launches" if smem_ring else "ring.global_launches")
    return out, tb, used.value


def wavefront_scan(ki: KernelInputs) -> torch.Tensor:
    """K1: the whole wavefront of a batch in score or region mode.
    Returns (5, B) int32: score, query_end, target_end, query_start,
    target_start (starts are 0 in score mode)."""
    if ki.mode not in ("score", "region"):
        raise ValueError(f"wavefront_scan runs score/region, not {ki.mode}")
    _check_inputs(ki)
    if ki.dims.device.type == "cpu":
        return wf.plain_wavefront(ki)[0]
    out, _, _ = _launch(ki)
    count(wavefront_scan)
    count(K9, ki.split)
    count(K3, ki.masked)
    return out


wavefront_scan.launches = 0


def wavefront_stream_scan(ki: KernelInputs) -> torch.Tensor:
    """K2: the whole wavefront of a batch in score or region mode, each
    pair on a thread-block cluster of C CTAs: as many as the widest
    diagonal fills, up to the largest cluster the card admits (a size
    that cannot launch raises).  The same function as
    ``wavefront_scan``, and the same output."""
    if ki.mode not in ("score", "region"):
        raise ValueError(f"wavefront_stream_scan runs score/region, not "
                         f"{ki.mode}")
    _check_inputs(ki)
    if ki.dims.device.type == "cpu":
        return wf.plain_wavefront(ki)[0]
    out, _, _ = _launch(ki, 0)
    count(K2)
    _count_cluster(ki)
    return out


def _count_cluster(ki: KernelInputs) -> None:
    """The counters of a cluster kernel launch beside its mode's: its ring
    route, K9 and K3."""
    count(RING_SMEM if ring_in_smem(ki) else RING_GLOBAL)
    count(K9, ki.split)
    count(K3, ki.masked)


def wavefront_segment(ki: KernelInputs, ring: tuple, span: tuple):
    """One segment of the checkpointed traceback on the cluster kernel:
    the diagonals ``span`` = (d0, d1) of a batch, continuing the carry
    rings ``ring`` (``ring_buffers(ki)`` as the segment before left
    them; updated in place).  Score mode is K2 (the forward pass); path
    mode is K4 on a cluster (the walk back), its tb the (B, d1 - d0, S,
    Qp+1) planes of the span.  Returns (out, tb or None): out the best
    end cell within the span, as for ``wavefront_scan``."""
    if ki.mode not in ("score", "path"):
        raise ValueError(f"wavefront_segment runs score/path, not "
                         f"{ki.mode}")
    d0, d1 = span
    if not 0 <= d0 <= d1 <= ki.Qp + ki.Tp + 1:
        raise ValueError(f"span {span} outside the {ki.Qp + ki.Tp + 1} "
                         f"diagonals of the batch")
    _check_inputs(ki)
    want = (ki.batch, ki.K + 1, max(ki.NR, 1), ki.Qp + 1)
    for t, rows in zip(ring, (ki.NR, ki.NL)):
        if t.dtype != torch.int32 or t.device != ki.dims.device \
                or not t.is_contiguous() \
                or tuple(t.shape) != want[:2] + (max(rows, 1), want[3]):
            raise ValueError("wavefront_segment: ring must be the pair "
                             "ring_buffers(ki) makes")
    if ki.dims.device.type == "cpu":
        return wf.plain_wavefront(ki, span, ring)
    out, tb, _ = _launch(ki, 0, span, ring)
    count(wavefront_path if ki.mode == "path" else K2)
    _count_cluster(ki)
    return out, tb


def wavefront_path(ki: KernelInputs, cluster: bool = False):
    """K4: the wavefront in path mode, on the cluster kernel over all the
    diagonals when ``cluster`` (a chunk whose clusters fit the card).
    Returns (out, tb): out as for wavefront_scan (starts 0), tb the (B,
    Qp+Tp+1, S, Qp+1) uint8 cube of winning plan ids (row + 1; 0 =
    unset)."""
    if ki.mode != "path":
        raise ValueError(f"wavefront_path runs path mode, not {ki.mode}")
    _check_inputs(ki)
    if ki.dims.device.type == "cpu":
        return wf.plain_wavefront(ki)
    out, tb, _ = _launch(ki, 0 if cluster else None)
    count(wavefront_path)
    if cluster:
        _count_cluster(ki)
    else:
        count(K9, ki.split)
        count(K3, ki.masked)
    return out, tb


wavefront_path.launches = 0


def _check_walk(name: str, tb: torch.Tensor, **rows) -> tuple:
    """(B, D, S, W) of ``tb``, a contiguous uint8 cube or segment's
    planes; each of ``rows`` (name=(tensor, rows)) must be a contiguous
    int32 (rows, B) tensor on its device (the id table: (4, ids))."""
    if tb.dtype != torch.uint8 or tb.dim() != 4 or not tb.is_contiguous():
        raise ValueError(f"{name}: tb must be a contiguous (B, D, S, W) "
                         f"uint8 tensor")
    B = tb.shape[0]
    for arg, (t, n) in rows.items():
        shape = (n, t.shape[-1] if arg == "walk" else B)
        if t.device != tb.device or t.dtype != torch.int32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be contiguous int32 "
                             f"{shape} on {tb.device}")
    if tb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no walk-back engine for device {tb.device}")
    return tuple(tb.shape)


def walkback(tb: torch.Tensor, stats: torch.Tensor, walk: torch.Tensor,
             end_id: int, cap: int):
    """Walk-back of every pair from its end cell (rows 1, 2 of
    ``stats``) to a transition from START.  Returns (ops (B, cap) int32
    plan ids end->start, res (3, B) int32: n_ops, query_start,
    target_start)."""
    B, D, S, W = _check_walk("walkback", tb, stats=(stats, 5),
                             walk=(walk, 4))
    dev = tb.device
    if dev.type == "cpu":
        return wf.plain_walkback(tb, stats, walk, end_id, cap)
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
    count(walkback)
    return ops, res


def walk_segment(planes: torch.Tensor, d0: int, cell: torch.Tensor,
                 walk: torch.Tensor, cap: int):
    """The walk-back over one segment of the checkpointed traceback: each
    pair from ``cell`` ((3, B) int32 rows i, j, state) over ``planes``,
    the (B, D, S, W) uint8 planes of diagonals [d0, d0 + D) that
    ``wavefront_segment`` returns, until id 0, a transition from START,
    ``cap`` steps or a cell below d0.  Returns (ops (B, cap) int32 plan
    ids end->start, res (5, B) int32: n_ops, i, j, state and status, the
    ``wavefront.WALK_*`` code of why it stopped), both on the planes'
    device.  Counted as a ``walkback`` launch."""
    B, D, S, W = _check_walk("walk_segment", planes, cell=(cell, 3),
                             walk=(walk, 4))
    dev = planes.device
    if dev.type == "cpu":
        return wf.plain_walk_segment(planes, d0, cell, walk, cap)
    fn = _lib("walkback", "walk_segment_launch",
              [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    ops = torch.empty((B, cap), dtype=torch.int32, device=dev)
    res = torch.empty((5, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(planes.data_ptr(), d0, cell.data_ptr(), walk.data_ptr(),
                walk.shape[1], B, D, S, W, cap, ops.data_ptr(),
                res.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"walk-back kernel launch failed: CUDA error {rc}")
    count(walkback)
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


def _shadows_supported(model: Model, inputs: dict) -> bool:
    """Shadow calc inputs are scalars, or the calc has the kernels' split
    codon form (``pallas_wavefront._shadows_supported:70``)."""
    for k, v in inputs.items():
        if k.startswith("sh") and not k.startswith("shv") \
                and isinstance(v, dict):
            if model.calcs[int(k[2:])].pallas_fn is not None:
                continue
            if any(np.ndim(x) != 0 for x in v.values()):
                return False
    return True


def fallback_reason(model: Model, kinds: tuple, inputs: dict
                    ) -> Optional[str]:
    """Why a bucket goes to the generic wavefront (None when the kernels
    run it), in the JAX package's words (``pallas_wavefront.py:1400-1413``)
    where its Pallas kernel refuses the bucket too."""
    reason = unsupported_reason(model, kinds)
    if reason is None:
        return None
    if any(kind not in _KERNEL_KINDS for _key, kind in kinds):
        return "pallas->xla: unsupported input kinds"
    if not _shadows_supported(model, inputs):
        return "pallas->xla: unsupported shadow lanes"
    return f"pallas->xla: {reason}"


def _sub(subopt, n: int):
    return subopt[n] if isinstance(subopt, (list, tuple)) else subopt


# kernel K5 (the sharded locus prescan): the shards find_batched runs over
# a device list, one K1 launch each (no CUDA source of its own)
K5 = _LaunchCount()


def find_batched(model: Model, jobs: list, mode: str = "region",
                 device: Optional[torch.device] = None,
                 subopt=None, stream: Optional[bool] = None,
                 devices: Optional[list] = None) -> list:
    """Score or region DP of (region, data) jobs, under ``subopt`` (one
    SubOpt mask or a per-job list) when given.  Each chunk of a bucket
    runs on K2 when ``stream`` is True, on K1 when it is False, and by
    ``on_cluster`` when it is None (on K2 when its clusters all fit the
    card, else by the JAX package's streaming test); a bucket the kernels
    refuse runs the generic wavefront in region mode.

    With ``devices`` (kernel K5, ``find_batched_sharded``) a chunk holds up
    to ``max_batch * len(devices)`` pairs, padded to a device multiple
    with copies of its last pair and cut into contiguous shards, shard k
    run by K1 on ``devices[k]`` (its current stream).  Every launch is
    made before any result is fetched.  Returns one DPResult per job
    (starts are 0 in score mode on the kernels)."""
    devs = devices or [device if device is not None else default_device()]
    dev = devs[0]
    out: list = [None] * len(jobs)
    pending = []
    for (Qp, Tp, kinds), items in _buckets(model, jobs, subopt).items():
        reason = fallback_reason(model, kinds, items[0][1])
        if reason is not None:
            # the generic wavefront in region mode, one batch per mask,
            # as the JAX package sends such a bucket to its XLA engine
            observe.count_fallback(reason, len(items))
            observe.count_engine(gw.engine_name(dev), len(items))
            groups: dict = {}
            for n, _ in items:
                groups.setdefault(id(_sub(subopt, n)), []).append(n)
            for ns in groups.values():
                res = gw.find_region_batched(model, [jobs[n] for n in ns],
                                             subopt=_sub(subopt, ns[0]),
                                             device=dev)
                for n, r in zip(ns, res):
                    out[n] = r
            continue
        cap = max(1, max_batch(model, Qp, Tp, mode, _masked(kinds)))
        cap *= len(devs)
        for lo in range(0, len(items), cap):
            chunk = items[lo:lo + cap]
            per_pair = [inp for _, inp in chunk]
            per_pair += [per_pair[-1]] * ((-len(per_pair)) % len(devs))
            step = len(per_pair) // len(devs)
            shards = []
            for k, d in enumerate(devs):
                ki = to_kernel_inputs(model, per_pair[k * step:(k + 1) * step],
                                      kinds, d, mode)
                if devices:
                    scan = wavefront_scan
                    count(K5)
                else:
                    use_stream = stream
                    if use_stream is None:
                        use_stream = on_cluster(kinds, len(chunk), Qp, Tp,
                                                cluster_capacity(ki))
                    scan = (wavefront_stream_scan if use_stream
                            else wavefront_scan)
                shards.append(scan(ki))
                n_real = len(chunk[k * step:(k + 1) * step])
                if n_real:
                    observe.count_engine(engine_name(d), n_real)
            pending.append((chunk, shards))
    for chunk, shards in pending:
        res = torch.cat([s.cpu() for s in shards], dim=1).tolist()
        for b, (n, _) in enumerate(chunk):
            out[n] = DPResult(score=res[0][b], query_end=res[1][b],
                              target_end=res[2][b], query_start=res[3][b],
                              target_start=res[4][b])
    return out


def find_batched_sharded(model: Model, jobs: list, devices: list,
                         mode: str = "region") -> list:
    """K1's score/region DP data-parallel over ``devices``
    (``pallas_wavefront.find_batched_sharded:1470``, the JAX package's
    ``shard_map`` over a ``dp`` mesh): ``find_batched`` on K1 with the
    device list.  Mask-free, like the locus pool's first generation that
    calls it."""
    return find_batched(model, jobs, mode, stream=False, devices=devices)


def find_path_batched(model: Model, jobs: list, subopt=None,
                      device: Optional[torch.device] = None) -> list:
    """Full-path DP on K4 plus the walk-back, under ``subopt`` (one SubOpt
    mask or a per-job list) when given, a chunk whose clusters all fit
    the card on the cluster kernel (``fits_on_cluster``); a bucket the
    kernels refuse runs the generic wavefront's path DP.  Returns
    DPResults with ``.path``;
    an entry is None when the job's traceback cube is over the budget or
    its path is longer than the walk cap (the caller then runs it on the
    host, or on the checkpointed traceback)."""
    dev = device if device is not None else default_device()
    out: list = [None] * len(jobs)
    plan_ts = _plan_transitions(model)
    for (Qp, Tp, kinds), items in _buckets(model, jobs, subopt).items():
        reason = fallback_reason(model, kinds, items[0][1])
        if reason is not None:
            # the generic wavefront's path DP, checkpointed past
            # --dpmemory (the JAX package leaves these jobs to the same
            # XLA routes through its optimal.find_path)
            from .optimal import DP_MEMORY_LIMIT
            observe.count_fallback(reason, len(items))
            observe.count_engine(gw.engine_name(dev), len(items))
            for n, _ in items:
                region, data = jobs[n]
                out[n] = gw.find_path_checkpointed(
                    model, region, data, _sub(subopt, n),
                    budget_bytes=DP_MEMORY_LIMIT, device=dev)
            continue
        cap_b = max_batch(model, Qp, Tp, "path", _masked(kinds))
        if cap_b < 1:
            # the caller runs the checkpointed traceback (as the JAX
            # package's find_path_batched leaves these jobs to XLA's)
            continue
        wcap = Qp + Tp + 1 + WALK_SLACK
        for lo in range(0, len(items), cap_b):
            chunk = items[lo:lo + cap_b]
            ki = to_kernel_inputs(model, [inp for _, inp in chunk], kinds,
                                  dev, "path")
            stats, tb = wavefront_path(ki, cluster=fits_on_cluster(
                ki.batch, cluster_capacity(ki)))
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
