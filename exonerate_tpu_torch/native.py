"""Native (C++) runtime components, loaded via ctypes.

The seeding hot loops live in native/seedlib.cpp (the reference's
hspset.c equivalents rewritten in C++); this module compiles the shared
library on first use (g++ -O3) and exposes it behind a NumPy-compatible
API.  Callers fall back to the pure-Python path when the toolchain is
unavailable.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ._nativebuild import build_lib

_lock = threading.Lock()
_lib = None
_failed = False


class _Hsp(ctypes.Structure):
    _fields_ = [("q", ctypes.c_int64), ("t", ctypes.c_int64),
                ("len", ctypes.c_int64), ("score", ctypes.c_int64),
                ("cobs", ctypes.c_int64)]


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = build_lib("seedlib.cpp")
        if so is None:
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _failed = True
            return None
        fn = lib.seedlib_seed_all
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # q_idx
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # t_idx
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # submat
            ctypes.c_void_p,                                  # q_veto
            ctypes.c_void_p, ctypes.c_void_p,                 # masks
            ctypes.c_int,                                     # forbid
            ctypes.c_int64, ctypes.c_int64,                   # advances
            ctypes.c_int64, ctypes.c_int64,                   # seedlen, drop
            ctypes.c_int64, ctypes.c_int64,                   # thr, repeat
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,   # seeds
            ctypes.POINTER(_Hsp), ctypes.c_int64]             # out
        fn = lib.wordhood_neighbours
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,   # matrix, n
            ctypes.c_int64,                                   # wordlen
            ctypes.POINTER(ctypes.c_int32),                   # word
            ctypes.c_int64,                                   # threshold
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]   # out, cap
        _lib = lib
        return _lib


def seed_all(q_idx, t_idx, submat, q_veto, q_mask, t_mask,
             forbid_masked, qadv, tadv, seedlen, dropoff, threshold,
             seed_repeat, seeds_q, seeds_t):
    """Run the native seeding machine; returns
    (q, t, len, score, cobs) int64 arrays or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    q_idx = np.ascontiguousarray(q_idx, dtype=np.int32)
    t_idx = np.ascontiguousarray(t_idx, dtype=np.int32)
    submat = np.ascontiguousarray(submat, dtype=np.int32)
    seeds_q = np.ascontiguousarray(seeds_q, dtype=np.int64)
    seeds_t = np.ascontiguousarray(seeds_t, dtype=np.int64)
    cap = max(len(seeds_q), 16)
    out = (_Hsp * cap)()

    def ptr(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    def optional(arr):
        if arr is None:
            return None
        a = np.ascontiguousarray(arr, dtype=np.uint8)
        optional.keep.append(a)
        return a.ctypes.data_as(ctypes.c_void_p)
    optional.keep = []

    n = lib.seedlib_seed_all(
        ptr(q_idx, ctypes.c_int32), len(q_idx),
        ptr(t_idx, ctypes.c_int32), len(t_idx),
        ptr(submat, ctypes.c_int32), submat.shape[0],
        optional(q_veto), optional(q_mask), optional(t_mask),
        int(forbid_masked), qadv, tadv, seedlen, dropoff, threshold,
        seed_repeat,
        ptr(seeds_q, ctypes.c_int64), ptr(seeds_t, ctypes.c_int64),
        len(seeds_q), out, cap)
    if n == -2:
        # negative initial seed: the reference FATALs (hspset.c:740-743)
        bad = np.ctypeslib.as_array(out, shape=(cap,))[0]
        return ("bad_seed", int(bad["q"]), int(bad["t"]),
                int(bad["len"]), int(bad["score"]))
    res = np.ctypeslib.as_array(out, shape=(cap,))[:n]
    return (res["q"].copy(), res["t"].copy(), res["len"].copy(),
            res["score"].copy(), res["cobs"].copy())


def wordhood_neighbours(matrix, word, threshold):
    """Native word-neighbourhood DFS; returns a list of packed words or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.int32)
    n = matrix.shape[0]
    w = np.ascontiguousarray(word, dtype=np.int32)
    cap = 4096
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib.wordhood_neighbours(
            matrix.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            len(w), w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(threshold),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if got >= 0:
            return [int(x) for x in out[:got]]
        cap *= 8
