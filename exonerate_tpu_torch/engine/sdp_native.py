"""ctypes driver for the native (C++) SDP scheduler pass.

Builds structure-of-arrays descriptors for native/sdplib.cpp from a
model + pair, runs one forward/reverse pass and converts the results
back into the Python SDP structures (seed terminals with _TB chains,
boundary rows).  engine/sdp.py routes passes here when the model is
expressible in the native calc vocabulary; the Python _Pass remains the
behavioural specification and fallback.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..model.ir import Label, Model, Protect

NEG = -987654321

from .._nativebuild import build_lib

_lock = threading.Lock()
_lib = None
_failed = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_pp = ctypes.POINTER(ctypes.c_void_p)


def get_lib():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = build_lib("sdplib.cpp")
        if so is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.sdp_run_pass.restype = ctypes.c_void_p
            lib.sdp_run_pass.argtypes = [_i64p, _i32p] + [_pp] * 6 + [
                _i64p, _i32p, _i32p, _pp] + [_i32p] * 6 + [
                _i64p] * 3 + [_i64p] * 4 + [_i64p] * 4
            lib.sdp_result_boundary_size.restype = ctypes.c_int64
            lib.sdp_result_boundary_size.argtypes = [ctypes.c_void_p]
            lib.sdp_result_boundary_copy.restype = None
            lib.sdp_result_boundary_copy.argtypes = [ctypes.c_void_p,
                                                     _i64p]
            lib.sdp_result_tb_size.restype = ctypes.c_int64
            lib.sdp_result_tb_size.argtypes = [ctypes.c_void_p]
            lib.sdp_result_tb_copy.restype = None
            lib.sdp_result_tb_copy.argtypes = [ctypes.c_void_p, _i32p,
                                               _i64p, _i64p]
            lib.sdp_result_free.restype = None
            lib.sdp_result_free.argtypes = [ctypes.c_void_p]
            lib.c4_viterbi.restype = ctypes.c_int64
            lib.c4_viterbi.argtypes = [_i64p, _i32p] + [_pp] * 6 + [
                _i32p, _i32p, _pp] + [_i32p] * 6 + [_i64p] * 3 + [
                _i64p, _i64p, _i32p, ctypes.c_int64]
            _lib = lib
        except OSError:
            _failed = True
        return _lib


# transition flags (keep in sync with sdplib.cpp)
F_SPAN_LOOP = 1
F_MATCH = 2
F_P_UNDER = 4
F_P_OVER = 8
F_REV_SHADOWED = 16
F_FROM_START = 32
F_TO_END = 64

G_CONST = 0
G_QVEC = 1
G_TVEC = 2
G_FACTORED = 4
G_NONE = 5
G_QTSUM = 6

SK_NONE = 0
SK_INTRON_WINDOW = 1
SK_SPLIT_CODON = 2

_TMETA_STRIDE = 27


def _lane_for(trans, prefix: str) -> Optional[int]:
    """First dst shadow whose name starts with prefix (matches
    _shadow_value's dict-order semantics)."""
    for sh in trans.dst_shadows:
        if sh.name.startswith(prefix):
            return sh.designation
    return None


def supported(model: Model) -> bool:
    """Can the native scheduler express every calc in this model?"""
    if get_lib() is None:
        return False
    for t in model.transitions:
        c = t.calc
        if c is None:
            continue
        if c.shadow_fn is not None and c.native_shadow is None:
            return False
        if c.native_shadow is not None:
            kind, params = c.native_shadow
            if kind == "intron_window":
                if params.get("on_query") \
                        and _lane_for(t, "query intron") is None:
                    return False
                if params.get("on_target") \
                        and _lane_for(t, "target intron") is None:
                    return False
            elif kind == "split_codon":
                if params.get("on_query") and params.get("q_is_dna") \
                        and _lane_for(t, "query intron") is None:
                    return False
                if params.get("on_target") and params.get("t_is_dna") \
                        and _lane_for(t, "target intron") is None:
                    return False
            else:
                return False
    return True


_MIN_MEMO: dict = {}


def _min_memo(a) -> int:
    """min() of a (memoized) array, cached by identity; the value keeps
    the array alive so id() stays unambiguous."""
    a = np.asarray(a)
    hit = _MIN_MEMO.get(id(a))
    if hit is not None:
        return hit[1]
    v = int(np.min(a)) if a.size else 0
    if len(_MIN_MEMO) > 512:
        _MIN_MEMO.clear()
    _MIN_MEMO[id(a)] = (a, v)
    return v


class _Keep:
    """Holds numpy arrays alive across the ctypes call."""

    def __init__(self):
        self.arrays = []

    def add(self, a):
        a = np.ascontiguousarray(a)
        self.arrays.append(a)
        return a


class _TransTables:
    """Structure-of-arrays transition descriptors shared by the
    scheduler pass and the dense Viterbi (same calc vocabulary)."""

    def __init__(self, model: Model, trans_list, region, data, grids,
                 factored, qt, shadow_inputs, keep: "_Keep"):
        k = keep
        orig_index = {id(t): i for i, t in enumerate(model.transitions)}
        n_trans = len(trans_list)
        self.tmeta = np.zeros(n_trans * _TMETA_STRIDE, dtype=np.int32)
        self.t_qvec = (ctypes.c_void_p * n_trans)()
        self.t_tvec = (ctypes.c_void_p * n_trans)()
        self.t_table = (ctypes.c_void_p * n_trans)()
        self.t_qidx = (ctypes.c_void_p * n_trans)()
        self.t_tidx = (ctypes.c_void_p * n_trans)()
        self.t_qover = (ctypes.c_void_p * n_trans)()
        starts_des: list[int] = []
        starts_onq: list[int] = []
        starts_vec_arrays: list = []
        span_index = {id(sp): i for i, sp in enumerate(model.spans)}
        # split-codon shared arrays (filled lazily from shadow inputs)
        self.sc_arrays = None
        for i, t in enumerate(trans_list):
            m = self.tmeta[i * _TMETA_STRIDE:(i + 1) * _TMETA_STRIDE]
            m[0] = t.advance_query
            m[1] = t.advance_target
            m[2] = t.input.id
            m[3] = t.output.id
            flags = 0
            is_span_loop = t.input is t.output and t.calc is None
            if is_span_loop:
                flags |= F_SPAN_LOOP
            if t.label == Label.MATCH:
                flags |= F_MATCH
            c = t.calc
            if c is not None and (c.protect & Protect.UNDERFLOW):
                flags |= F_P_UNDER
            if c is not None and (c.protect & Protect.OVERFLOW):
                flags |= F_P_OVER
            if t.dst_shadows:
                flags |= F_REV_SHADOWED
            if t.input is model.start_state.state:
                flags |= F_FROM_START
            if t.output is model.end_state.state:
                flags |= F_TO_END
            m[4] = flags
            # score mode
            if c is None:
                m[5] = G_NONE
            elif qt is not None and id(c) in qt:
                m[5] = G_QTSUM
                qv = k.add(qt[id(c)][0].astype(np.int32, copy=False))
                tv = k.add(qt[id(c)][1].astype(np.int32, copy=False))
                self.t_qvec[i] = qv.ctypes.data
                self.t_tvec[i] = tv.ctypes.data
            elif id(c) in factored:
                m[5] = G_FACTORED
                table, q_idx, t_idx, q_over = factored[id(c)]
                table = k.add(table.astype(np.int32, copy=False))
                q_idx = k.add(q_idx.astype(np.int32, copy=False))
                t_idx = k.add(t_idx.astype(np.int32, copy=False))
                self.t_table[i] = table.ctypes.data
                self.t_qidx[i] = q_idx.ctypes.data
                self.t_tidx[i] = t_idx.ctypes.data
                m[7] = table.shape[1]
                if q_over is not None:
                    q_over = k.add(q_over.astype(np.int32, copy=False))
                    self.t_qover[i] = q_over.ctypes.data
            else:
                g = grids[id(c)]
                if g.ndim == 0:
                    m[5] = G_CONST
                    m[6] = int(g)
                elif g.shape[0] > 1 and g.shape[1] > 1:
                    raise ValueError("full 2-D grid not native")
                elif g.shape[0] > 1:
                    m[5] = G_QVEC
                    v = k.add(np.ascontiguousarray(g[:, 0], dtype=np.int32))
                    self.t_qvec[i] = v.ctypes.data
                else:
                    m[5] = G_TVEC
                    v = k.add(np.ascontiguousarray(g[0, :], dtype=np.int32))
                    self.t_tvec[i] = v.ctypes.data
            # shadow kind
            if c is not None and c.native_shadow is not None:
                kind, params = c.native_shadow
                inputs = shadow_inputs.get(id(c), {})
                if kind == "intron_window":
                    m[8] = SK_INTRON_WINDOW
                    m[9] = 1 if params.get("on_query") else 0
                    m[10] = 1 if params.get("on_target") else 0
                    m[11] = (_lane_for(t, "query intron")
                             if params.get("on_query") else 0)
                    m[12] = (_lane_for(t, "target intron")
                             if params.get("on_target") else 0)
                    m[13] = int(inputs["min_intron"])
                    m[14] = int(inputs["max_intron"])
                else:  # split_codon
                    m[8] = SK_SPLIT_CODON
                    m[15] = params["phase"]
                    m[16] = 1 if params["q_is_dna"] else 0
                    m[17] = 1 if params["t_is_dna"] else 0
                    m[18] = 1 if params["on_query"] else 0
                    m[19] = 1 if params["on_target"] else 0
                    lq = _lane_for(t, "query intron")
                    lt = _lane_for(t, "target intron")
                    m[20] = lq if lq is not None else -1
                    m[21] = lt if lt is not None else -1
                    if self.sc_arrays is None:
                        self.sc_arrays = {
                            "q_nt4": k.add(np.asarray(
                                inputs["q_nt4"], dtype=np.int32)),
                            "t_nt4": k.add(np.asarray(
                                inputs["t_nt4"], dtype=np.int32)),
                            "q_sym": k.add(np.asarray(
                                inputs["q_sym"], dtype=np.int32)),
                            "t_sym": k.add(np.asarray(
                                inputs["t_sym"], dtype=np.int32)),
                            "trans_idx": k.add(np.asarray(
                                inputs["trans_idx"], dtype=np.int32)),
                            "psub": k.add(np.asarray(
                                inputs["psub"], dtype=np.int32)),
                        }
            # shadow starts
            tstarts = model.src_shadows(t.input)
            m[22] = len(tstarts)
            m[23] = len(starts_des)
            for sh in tstarts:
                starts_des.append(sh.designation)
                starts_onq.append(1 if sh.start == "query_pos" else 0)
                if sh.start_vec_fn is not None:
                    vec = k.add(np.asarray(
                        sh.start_vec_fn(region, data), dtype=np.int32))
                    starts_vec_arrays.append(vec)
                else:
                    starts_vec_arrays.append(None)
            # span whose state == output (for freeze at the loop)
            m[24] = -1
            if is_span_loop:
                for sp in model.spans:
                    if sp.span_state is t.output:
                        m[24] = span_index[id(sp)]
                        break
            m[25] = orig_index[id(t)]
            # m[26]: minimum calc value can wrap an IMPOSSIBLY_LOW
            # source past INT32_MIN into a large positive gint (stacked
            # splice penalties, e.g. --forcegtag joint introns); the
            # native pass must then process NEG sources like the
            # reference (see sdplib.cpp TransDesc.can_wrap).  The mins
            # memoize per array identity: the vectors come from
            # content-keyed memos, so every pair of a scan reuses them
            min_calc = 0
            if c is not None:
                if qt is not None and id(c) in qt:
                    min_calc = (_min_memo(qt[id(c)][0])
                                + _min_memo(qt[id(c)][1]))
                elif id(c) in factored:
                    min_calc = _min_memo(factored[id(c)][0])
                else:
                    min_calc = _min_memo(grids[id(c)])
            m[26] = 1 if min_calc < (-(1 << 31) + 987654321) else 0
        self.tmeta = k.add(self.tmeta)
        self.starts_des = k.add(np.asarray(starts_des, dtype=np.int32))
        self.starts_onq = k.add(np.asarray(starts_onq, dtype=np.int32))
        self.starts_vec = (ctypes.c_void_p * max(1, len(
            starts_vec_arrays)))()
        for j, v in enumerate(starts_vec_arrays):
            self.starts_vec[j] = v.ctypes.data if v is not None else None


class NativeDescriptor:
    """Per (model, pair) descriptor, reusable across the two passes.

    Built from the same grids/factored/shadow-input data the Python
    _Pass consumes, so both engines score identically."""

    def __init__(self, model: Model, region, grids, factored,
                 shadow_inputs, data, subopt, dropoff: int, qt=None):
        self.model = model
        self.region = region
        self.dropoff = dropoff
        self.keep = _Keep()
        k = self.keep
        orig_index = {id(t): i for i, t in enumerate(model.transitions)}
        tt = _TransTables(model, list(model.transitions)[::-1], region,
                          data, grids, factored, qt, shadow_inputs, k)
        self.tmeta = tt.tmeta
        self.t_qvec = tt.t_qvec
        self.t_tvec = tt.t_tvec
        self.t_table = tt.t_table
        self.t_qidx = tt.t_qidx
        self.t_tidx = tt.t_tidx
        self.t_qover = tt.t_qover
        self.starts_des = tt.starts_des
        self.starts_onq = tt.starts_onq
        self.starts_vec = tt.starts_vec
        self.sc_arrays = tt.sc_arrays
        # spans
        self.smeta = np.zeros(max(1, len(model.spans)) * 7,
                              dtype=np.int64)
        for i, sp in enumerate(model.spans):
            qloop = tloop = -1
            for t in model.transitions:
                if t.input is t.output is sp.span_state \
                        and t.calc is None:
                    if t.advance_query:
                        qloop = orig_index[id(t)]
                    if t.advance_target:
                        tloop = orig_index[id(t)]
            self.smeta[i * 7:(i + 1) * 7] = [
                sp.span_state.id, sp.min_query, sp.max_query,
                sp.min_target, sp.max_target, qloop, tloop]
        self.smeta = k.add(self.smeta)
        # subopt blocked CSR (built per next_path loop iteration)
        self.subopt = subopt
        self._subopt_count = -1
        self._blk = None

    def _blocked_csr(self):
        if self.subopt is None or not self.subopt.by_row:
            z = np.zeros(1, dtype=np.int64)
            return 0, z, z, z
        if self._blk is not None \
                and self._subopt_count == self.subopt.path_count:
            return self._blk
        rows = sorted(self.subopt.by_row)
        offs = [0]
        qs: list[int] = []
        for r in rows:
            qs.extend(sorted(self.subopt.by_row[r]))
            offs.append(len(qs))
        blk = (len(rows), np.asarray(rows, dtype=np.int64),
               np.asarray(offs, dtype=np.int64),
               np.asarray(qs, dtype=np.int64) if qs
               else np.zeros(1, dtype=np.int64))
        self._blk = blk
        self._subopt_count = self.subopt.path_count
        return blk

    def run_pass(self, *, is_forward: bool, use_boundary: bool,
                 seeds, n_reg_seeds: int, want_start: bool,
                 want_end: bool, n_shadow: int):
        """Run one pass; returns (term arrays, boundary triplets,
        tb arena) with tb indices into the arena."""
        lib = get_lib()
        model = self.model
        region = self.region
        n_blk, blk_rows, blk_off, blk_q = self._blocked_csr()
        sc = self.sc_arrays or {}
        zero32 = np.zeros(1, dtype=np.int32)

        def p32(a):
            return a.ctypes.data_as(_i32p)

        def p64(a):
            return a.ctypes.data_as(_i64p)

        if isinstance(seeds, tuple):
            # preassembled (pt, pq, sid, score) arrays
            seed_pt, seed_pq, seed_id, seed_sc = [
                np.ascontiguousarray(a, dtype=np.int64) for a in seeds]
            n_seeds = len(seed_pt)
        else:
            n_seeds = len(seeds)
            seed_pt = np.asarray([s[0] for s in seeds], dtype=np.int64)
            seed_pq = np.asarray([s[1] for s in seeds], dtype=np.int64)
            seed_id = np.asarray([s[2] for s in seeds], dtype=np.int64)
            seed_sc = np.asarray([s[3] for s in seeds], dtype=np.int64)
        if n_seeds == 0:
            seed_pt = seed_pq = seed_id = seed_sc = np.zeros(
                1, dtype=np.int64)
        has_traceback = is_forward or not use_boundary
        params = np.asarray([
            len(model.states), n_shadow, len(model.transitions),
            len(model.spans), int(is_forward), int(use_boundary),
            int(has_traceback), region.query_length,
            region.target_length, region.query_start,
            region.target_start, self.dropoff,
            max(model.max_target_advance, 1), n_blk, n_seeds,
            int(want_start), int(want_end),
            model.start_state.state.id, model.end_state.state.id,
            n_reg_seeds,
            sc["q_nt4"].shape[0] if sc else 0,
            sc["t_nt4"].shape[0] if sc else 0,
            sc["q_sym"].shape[0] if sc else 0,
            sc["t_sym"].shape[0] if sc else 0,
            sc["psub"].shape[1] if sc else 0,
        ], dtype=np.int64)
        term_score = np.full(max(1, n_reg_seeds), NEG, dtype=np.int64)
        term_q = np.zeros(max(1, n_reg_seeds), dtype=np.int64)
        term_t = np.zeros(max(1, n_reg_seeds), dtype=np.int64)
        term_tb = np.full(max(1, n_reg_seeds), -1, dtype=np.int64)
        handle = lib.sdp_run_pass(
            p64(params), p32(self.tmeta),
            ctypes.cast(self.t_qvec, _pp),
            ctypes.cast(self.t_tvec, _pp),
            ctypes.cast(self.t_table, _pp),
            ctypes.cast(self.t_qidx, _pp),
            ctypes.cast(self.t_tidx, _pp),
            ctypes.cast(self.t_qover, _pp),
            p64(self.smeta), p32(self.starts_des),
            p32(self.starts_onq), ctypes.cast(self.starts_vec, _pp),
            p32(sc["q_nt4"] if sc else zero32),
            p32(sc["t_nt4"] if sc else zero32),
            p32(sc["q_sym"] if sc else zero32),
            p32(sc["t_sym"] if sc else zero32),
            p32(sc["trans_idx"] if sc else zero32),
            p32(sc["psub"] if sc else zero32),
            p64(blk_rows), p64(blk_off), p64(blk_q),
            p64(seed_pt), p64(seed_pq), p64(seed_id), p64(seed_sc),
            p64(term_score), p64(term_q), p64(term_t), p64(term_tb))
        try:
            nb = lib.sdp_result_boundary_size(handle)
            boundary = np.zeros(max(1, nb), dtype=np.int64)
            if nb:
                lib.sdp_result_boundary_copy(handle, p64(boundary))
            nt = lib.sdp_result_tb_size(handle)
            tb_trans = np.zeros(max(1, nt), dtype=np.int32)
            tb_len = np.zeros(max(1, nt), dtype=np.int64)
            tb_prev = np.zeros(max(1, nt), dtype=np.int64)
            if nt:
                lib.sdp_result_tb_copy(handle, p32(tb_trans),
                                       p64(tb_len), p64(tb_prev))
        finally:
            lib.sdp_result_free(handle)
        return (term_score, term_q, term_t, term_tb,
                boundary[:nb], (tb_trans, tb_len, tb_prev))


_SCOPES = {"anywhere": 0, "edge": 1, "query": 2, "target": 3,
           "corner": 4}

_vit_supported_cache: dict = {}


def viterbi_supported(model: Model) -> bool:
    key = id(model)
    if key not in _vit_supported_cache:
        ok = supported(model)
        if ok:
            for c in model.calcs:
                if c.qt_fn is not None or c.factored_fn is not None:
                    continue
                # 1-D / scalar grids only (checked at build per region)
            _vit_supported_cache[key] = ok
        else:
            _vit_supported_cache[key] = False
    return _vit_supported_cache[key]


def run_viterbi(model: Model, region, data, mode: str = "score",
                subopt=None):
    """Dense native Viterbi (ref: Viterbi_interpreted).  Returns a
    DPResult-compatible object or None when the model/grids are not
    expressible natively."""
    from .reference import DPResult
    lib = get_lib()
    if lib is None or not viterbi_supported(model):
        return None
    keep = _Keep()
    k = keep
    grids = {}
    factored = {}
    qt = {}
    for c in model.calcs:
        if c.qt_fn is not None:
            qv, tv = c.qt_fn(region, data)
            qt[id(c)] = (np.asarray(qv), np.asarray(tv))
        elif c.factored_fn is not None:
            f = c.factored_fn(region, data)
            ov = f.get("q_override")
            if ov is not None and not np.any(ov):
                ov = None
            factored[id(c)] = (np.asarray(f["table"]),
                               np.asarray(f["q_idx"]),
                               np.asarray(f["t_idx"]),
                               np.asarray(ov) if ov is not None
                               else None)
        else:
            g = np.asarray(c.materialize(region, data))
            if g.ndim == 2 and g.shape[0] > 1 and g.shape[1] > 1:
                return None  # full 2-D grid: fall back
            grids[id(c)] = g
    shadow_inputs = {id(c): c.shadow_inputs_fn(region, data)
                     for c in model.calcs
                     if c.shadow_inputs_fn is not None}
    try:
        tt = _TransTables(model, list(model.transitions), region, data,
                          grids, factored, qt, shadow_inputs, k)
    except (ValueError, KeyError):
        return None
    sc = tt.sc_arrays or {}
    zero32 = np.zeros(1, dtype=np.int32)

    def p32(a):
        return a.ctypes.data_as(_i32p)

    def p64(a):
        return a.ctypes.data_as(_i64p)

    # subopt blocked CSR
    if subopt is not None and subopt.by_row:
        rows = sorted(subopt.by_row)
        offs = [0]
        qs: list = []
        for r in rows:
            qs.extend(sorted(subopt.by_row[r]))
            offs.append(len(qs))
        n_blk = len(rows)
        blk_rows = np.asarray(rows, dtype=np.int64)
        blk_off = np.asarray(offs, dtype=np.int64)
        blk_q = (np.asarray(qs, dtype=np.int64) if qs
                 else np.zeros(1, dtype=np.int64))
    else:
        n_blk = 0
        blk_rows = blk_off = blk_q = np.zeros(1, dtype=np.int64)
    params = np.zeros(25, dtype=np.int64)
    params[0] = len(model.states)
    params[1] = model.total_shadow_designations
    params[2] = len(model.transitions)
    params[7] = region.query_length
    params[8] = region.target_length
    params[9] = region.query_start
    params[10] = region.target_start
    params[13] = n_blk
    params[20] = sc["q_nt4"].shape[0] if sc else 0
    params[21] = sc["t_nt4"].shape[0] if sc else 0
    params[22] = sc["q_sym"].shape[0] if sc else 0
    params[23] = sc["t_sym"].shape[0] if sc else 0
    params[24] = sc["psub"].shape[1] if sc else 0
    mode_i = {"score": 0, "region": 1, "path": 2}[mode]
    vparams = np.asarray([
        mode_i, _SCOPES[model.start_state.scope.value],
        _SCOPES[model.end_state.scope.value],
        model.start_state.state.id, model.end_state.state.id,
    ], dtype=np.int64)
    res = np.zeros(5, dtype=np.int64)
    cap = ((region.query_length + region.target_length + 2)
           * (len(model.states) + 1)) if mode_i == 2 else 1
    path_out = np.zeros(max(1, cap), dtype=np.int32)
    got = lib.c4_viterbi(
        p64(params), p32(tt.tmeta),
        ctypes.cast(tt.t_qvec, _pp), ctypes.cast(tt.t_tvec, _pp),
        ctypes.cast(tt.t_table, _pp), ctypes.cast(tt.t_qidx, _pp),
        ctypes.cast(tt.t_tidx, _pp), ctypes.cast(tt.t_qover, _pp),
        p32(tt.starts_des), p32(tt.starts_onq),
        ctypes.cast(tt.starts_vec, _pp),
        p32(sc["q_nt4"] if sc else zero32),
        p32(sc["t_nt4"] if sc else zero32),
        p32(sc["q_sym"] if sc else zero32),
        p32(sc["t_sym"] if sc else zero32),
        p32(sc["trans_idx"] if sc else zero32),
        p32(sc["psub"] if sc else zero32),
        p64(blk_rows), p64(blk_off), p64(blk_q),
        p64(vparams), p64(res), p32(path_out), cap)
    if got == -(2**63):  # INT64_MIN: no end state reached
        raise AssertionError("no end state reached")
    out = DPResult(score=int(res[0]), query_end=int(res[3]),
                   target_end=int(res[4]), query_start=int(res[1]),
                   target_start=int(res[2]))
    if mode_i == 2:
        trans = model.transitions
        out.path = [trans[int(x)] for x in path_out[:got][::-1]]
    return out
