"""Faithful RangeTree (ref: src/struct/rangetree.c): an unbalanced
2-D kd-tree fed from a glibc ``tsearch`` "recent" set.

The geneseed server reply's byte order depends on this structure's
iteration order twice over: newly added points sit in a glibc
red-black tree until the next find/traverse, when they are drained by
repeated ROOT eviction (``*(RangeTree_Node **)rt->recent_data`` then
``tdelete`` — rangetree.c:123-130) into the kd-tree, whose shape (and
therefore in-order traversal and find recursion order) depends on that
eviction sequence.  Rather than reimplement glibc's red-black
internals, we call the REAL libc ``tsearch``/``tdelete``/``tfind``
through ctypes — exactly the functions the reference binary links —
so the eviction sequence is identical by construction.
"""
from __future__ import annotations

import ctypes

_libc = ctypes.CDLL(None)
_CMP = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
for _f in ("tsearch", "tdelete", "tfind"):
    _fn = getattr(_libc, _f)
    _fn.restype = ctypes.c_void_p
    _fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, _CMP]


class _CKey(ctypes.Structure):
    _fields_ = [("x", ctypes.c_int), ("y", ctypes.c_int)]


def _wrap32(v: int) -> int:
    v &= 0xffffffff
    return v - (1 << 32) if v >= (1 << 31) else v


@_CMP
def _compare(pa, pb):
    """(ref: RangeTree_recent_data_compare, rangetree.c:21-28):
    descending (x, y), gint subtraction semantics."""
    a = _CKey.from_address(pa)
    b = _CKey.from_address(pb)
    if a.x == b.x:
        return _wrap32(b.y - a.y)
    return _wrap32(b.x - a.x)


class _KdNode:
    __slots__ = ("x", "y", "info", "left", "right")

    def __init__(self, x, y, info):
        self.x = x
        self.y = y
        self.info = info
        self.left = None
        self.right = None


class RangeTree:
    """API mirror of rangetree.h: add / check_pos / find / traverse /
    is_empty."""

    def __init__(self):
        self.root = None
        self._recent = ctypes.c_void_p(None)
        # ckey address -> (ckey object pin, (x, y, info))
        self._pending: dict = {}

    # -- recent (glibc) set ------------------------------------------------

    def _tfind(self, x, y) -> bool:
        key = _CKey(x, y)
        return bool(_libc.tfind(ctypes.byref(key),
                                ctypes.byref(self._recent), _compare))

    def _insert_recent(self):
        """(ref: RangeTree_insert_recent, rangetree.c:123-131): drain
        the glibc tree by root eviction into the kd-tree."""
        while self._recent.value:
            # glibc node layout: the key pointer is the first word
            keyp = ctypes.cast(self._recent.value,
                               ctypes.POINTER(ctypes.c_void_p))[0]
            x, y, info = self._pending.pop(keyp)[1]
            self._kd_insert(_KdNode(x, y, info))
            _libc.tdelete(keyp, ctypes.byref(self._recent), _compare)

    # -- kd-tree -----------------------------------------------------------

    def _kd_insert(self, rtn: _KdNode):
        """(ref: RangeTree_insert, rangetree.c:102-121)."""
        if self.root is None:
            self.root = rtn
            return
        n = self.root
        dim = False
        while n is not None:
            direction = (rtn.x < n.x) if dim else (rtn.y < n.y)
            parent = n
            n = parent.left if direction else parent.right
            dim = not dim
        if direction:
            parent.left = rtn
        else:
            parent.right = rtn

    # -- public API --------------------------------------------------------

    def add(self, x: int, y: int, info):
        """(ref: RangeTree_add, rangetree.c:49-60)."""
        key = _CKey(x, y)
        _libc.tsearch(ctypes.byref(key), ctypes.byref(self._recent),
                      _compare)
        self._pending[ctypes.addressof(key)] = (key, (x, y, info))

    def check_pos(self, x: int, y: int) -> bool:
        """(ref: RangeTree_check_pos, rangetree.c:158-168): consults
        the pending glibc set AND the kd-tree without draining."""
        if self._tfind(x, y):
            return True
        return self._find_internal(x, 1, y, 1, lambda *_a: True)

    def is_empty(self) -> bool:
        self._insert_recent()
        return self.root is None

    def find(self, x_start, x_length, y_start, y_length, report) -> bool:
        """(ref: RangeTree_find, rangetree.c:149-156).  ``report`` is
        called as report(x, y, info) inside the rectangle in the C
        recursion order; returning True stops the search."""
        self._insert_recent()
        return self._find_internal(x_start, x_length, y_start, y_length,
                                   report)

    def _find_internal(self, x_start, x_length, y_start, y_length,
                       report) -> bool:
        tl_x, tl_y = x_start, y_start
        br_x, br_y = x_start + x_length, y_start + y_length
        found = [False]

        def recur(n, direction):
            """(ref: RangeTree_find_recur, rangetree.c:80-100)."""
            if n is None:
                return
            if (tl_x < n.x) if direction else (tl_y < n.y):
                recur(n.left, not direction)
            if found[0]:
                return
            if not (n.x < tl_x or n.y < tl_y
                    or n.x >= br_x or n.y >= br_y):
                if report(n.x, n.y, n.info):
                    found[0] = True
                    return
            if (n.x <= br_x) if direction else (n.y <= br_y):
                recur(n.right, not direction)

        recur(self.root, False)
        return found[0]

    def traverse(self, report) -> bool:
        """In-order kd-tree walk (ref: RangeTree_traverse,
        rangetree.c:179-196).  NOTE: the reference does NOT drain the
        recent set here; callers reach it via is_empty() first
        (Index_Geneseed_collect_hspset does)."""

        def recur(n):
            if n is None:
                return False
            return (recur(n.left) or bool(report(n.x, n.y, n.info))
                    or recur(n.right))

        return recur(self.root)
