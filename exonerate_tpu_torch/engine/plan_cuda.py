"""Compiles a model's plan into the kernels: the generated C++ headers.

The Pallas kernels unroll the model's plan while tracing
(``pallas_wavefront.py:832``, ``sdp_pallas.py:624`` and ``:771``), so every
source state, output state, calc kind and ring row is a constant of the
TPU's code; the reference C tool generates C per model for the same reason.
The port does the same on the card: the tables that ``to_kernel_inputs``
and ``to_band_inputs`` build are written into a small C++ header that
holds nothing but data, and the kernels are templates whose cell body
reads each row through a ``constexpr`` accessor, unrolled in plan order:

- ``wave_header``: K1/K4 and the cluster kernel K2 (``csrc/wavefront.cu``,
  built with ``COMPILED_PLAN``): the plan table
  (``cuda_wavefront._build_plan`` / ``_storage_plan``, ``PLAN_COLS``
  columns a row), the ring and lane maps, S, L, NR, NL, R = K + 1, the
  shadow count, the start and end states, the mode, and ``FULL``: the
  plan holds kernel K9's pieces or more than ``LEAN_L`` lanes;
- ``band_header``: K6/K7/K8 (``csrc/sdp_band.cu``): both passes'
  candidate tables (advancing rows first), the span table's shape
  (``span_shape``), the ring maps, S, the shadow lanes, K, the start and
  end states, the W-axis rows of ``_abs_t``, ``_edge`` and ``_seg``, and
  ``TRACK_SID``: a non-boundary model, whose reverse pass attributes
  start scores to seeds in place of the boundary bits.

What stays run-time data is per pair or per run: dims, the q-axis and
W-axis vectors, tables, scalars, the seed layers, the mask plane, the
scopes and the spans' window lengths (``--maxintron``), so that one
library serves a model whatever its options.
``_cudabuild.load(stem, header)`` builds one library per header at first
use, keyed by the header's text with the sources.  The header is derived
only from the port's own model code.
"""
from __future__ import annotations

import re

import numpy as np

from .sdp_device import SP_MAX_Q, SP_MAX_T
from .wavefront import C_SPLIT, P_CALC, P_ST_SRC0, ST_TVEC

_HEAD = ("// A model's plan, compiled in (exonerate_tpu_torch/engine/"
         "plan_cuda.py).\n// Data only: the kernels read it through "
         "these constexpr accessors.\n#pragma once\n")


def _fmt(a: np.ndarray) -> str:
    """A C initializer of an int array (nested braces per dimension)."""
    if a.ndim == 1:
        return "{" + ", ".join(str(int(x)) for x in a) + "}"
    return "{" + ",\n         ".join(_fmt(x) for x in a) + "}"


def _table(name: str, a: np.ndarray) -> str:
    """A constexpr accessor ``name(r, c)`` (or ``name(s)`` for a vector)
    over the int32 array ``a``: a local constexpr array, so that device
    code reads it only in constant expressions."""
    a = np.asarray(a, np.int64)
    if a.ndim == 1:
        a = a if a.size else np.zeros(1, np.int64)
        return (f"    __host__ __device__ static constexpr int {name}(int r) "
                f"{{\n        constexpr int t[{a.shape[0]}] = {_fmt(a)};\n"
                f"        return t[r];\n    }}\n")
    if a.shape[0] == 0:
        a = np.zeros((1, a.shape[1]), np.int64)
    return (f"    __host__ __device__ static constexpr int {name}(int r, "
            f"int c) {{\n        constexpr int t[{a.shape[0]}]"
            f"[{a.shape[1]}] = {_fmt(a)};\n        return t[r][c];\n    }}\n")


def _struct(name: str, comment: str, ints: dict, tables: dict) -> str:
    body = "".join(f"    static constexpr int {k} = {int(v)};\n"
                   for k, v in ints.items())
    body += "".join(_table(k, v) for k, v in tables.items())
    return f"{_HEAD}// {comment}\nstruct {name} {{\n{body}}};\n"


# lanes per state of a plan that is not FULL (``LEAN_L`` in
# csrc/wavefront.cu)
LEAN_L = 4


def plan_is_full(plan: np.ndarray, L: int) -> bool:
    """Whether a wavefront plan table holds kernel K9's pieces (a
    ``C_SPLIT`` row, or a start lane read from a target vector) or more
    than ``LEAN_L`` lanes per state."""
    plan = np.asarray(plan)
    return bool(L > LEAN_L or (plan[:, P_CALC] == C_SPLIT).any()
                or (plan[:, P_ST_SRC0::2] >= ST_TVEC).any())


def wave_header(model_name: str, mode: str, plan: np.ndarray,
                ring_row: np.ndarray, lane_row: np.ndarray, *, S: int,
                L: int, NR: int, NL: int, K: int, n_shadow: int,
                start_id: int, end_id: int) -> str:
    """The wavefront kernels' ``struct WavePlan`` for one model and
    mode: the numbers ``to_kernel_inputs`` keeps beside the plan (NR, NL
    at least 1, as the carry rings are allocated) and ``FULL``
    (``plan_is_full``), which the kernel checks against the table."""
    modes = {"score": 0, "region": 1, "path": 2}
    return _struct(
        "WavePlan", f"{model_name}, {mode} mode",
        dict(MODE=modes[mode], S=S, L=L, NR=max(NR, 1), NL=max(NL, 1),
             R=K + 1, N_PLAN=len(plan), N_SHADOW=n_shadow,
             START_ID=start_id, END_ID=end_id,
             FULL=int(plan_is_full(plan, L))),
        dict(plan=plan, ring_row=ring_row, lane_row=lane_row))


def wave_header_in(header: str, mode: str) -> str:
    """A ``wave_header`` for another mode of the same plan table and
    storage: its ``MODE`` and the comment that names the mode.  Only score
    and path modes share a plan's storage (region mode adds two lanes);
    the caller checks that."""
    modes = {"score": 0, "region": 1, "path": 2}
    header = re.sub(r", (score|region|path) mode\n", f", {mode} mode\n",
                    header, count=1)
    return re.sub(r"static constexpr int MODE = \d+;",
                  f"static constexpr int MODE = {modes[mode]};", header,
                  count=1)


def span_shape(spans: np.ndarray) -> np.ndarray:
    """The span table as the band plan holds it: each span's state and
    post-thaw flag, and only whether it has a target window (SP_MAX_T)
    and a query window (SP_MAX_Q), whose lengths (--maxintron) the
    kernels read at run time."""
    out = np.array(spans, np.int32, copy=True)
    for col in (SP_MAX_T, SP_MAX_Q):
        out[:, col] = out[:, col] > 0
    return out


def band_header(model_name: str, rev_plan: np.ndarray, n_adv_rev: int,
                fwd_plan: np.ndarray, n_adv_fwd: int, spans: np.ndarray,
                n_spans: int, rev_ring: np.ndarray, fwd_ring: np.ndarray, *,
                S: int, n_sh: int, K: int, NR_rev: int, NR_fwd: int,
                start_id: int, end_id: int, row_abs_t: int, row_edge: int,
                row_seg: int, track_sid: bool) -> str:
    """The band scan's ``struct BandPlan``: both passes' candidate tables
    and the numbers ``to_band_inputs`` passes the launcher (NR at least
    1, as the carry rings are allocated)."""
    return _struct(
        "BandPlan", f"{model_name}, both passes of the band scan",
        dict(S=S, N_SH=n_sh, K=K, N_REV=len(rev_plan), N_ADV_REV=n_adv_rev,
             N_FWD=len(fwd_plan), N_ADV_FWD=n_adv_fwd, N_SPANS=n_spans,
             NR_REV=max(NR_rev, 1), NR_FWD=max(NR_fwd, 1),
             START_ID=start_id, END_ID=end_id, ROW_ABS_T=row_abs_t,
             ROW_EDGE=row_edge, ROW_SEG=row_seg, TRACK_SID=int(track_sid)),
        dict(rev=rev_plan, fwd=fwd_plan, spans=spans, rev_ring=rev_ring,
             fwd_ring=fwd_ring))
