"""The least time a DP's work could take on one H100: frozen here, so
that later changes to the program cannot move the yardstick.

Copied from chip_smoke.py (``_bound``, and the counting rule of
``_band_work`` and ``_wave_work``): a DP's bound is the larger of the
bytes it must move once over the HBM bandwidth and its int32 operations,
an add and a compare per model transition per cell, over the int32 peak.
The work is counted from the DP shapes alone (the lengths and the
model's transitions a cell), never from the program's own tables or
launches, so that it reads the same whatever implements the DPs.  Peaks (NVIDIA H100 SXM
data sheet; CUDA C++ Programming Guide, compute capability 9.0): 3.35 TB/s
of HBM3; 132 SMs at 1.98 GHz boost; 32-bit integer adds issue on the
integer pipe (IADD3) and the multiply-add pipe (IMAD.IADD), 64 a clock per
SM each, so 128 int32 operations a clock per SM, 33.5 T/s.  A roofline
share is stated against these published peaks at the card's full 700 W.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
CLOCK_HZ = 1.98e9
SMS = 132
INT32_OPS_S = 128 * SMS * CLOCK_HZ


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take to move ``n_bytes`` once and
    compute ``n_ops`` int32 operations."""
    return max(n_bytes / HBM_BYTES_S, n_ops / INT32_OPS_S)


def dp_work(q_len: int, t_len: int, transitions: int, vectors: int = 2
            ) -> tuple:
    """(bytes, int32 operations) of one dense DP over a (q_len + 1) x
    (t_len + 1) grid: an add and a compare per model transition per cell;
    ``vectors`` int32 vectors of the query's and the target's length read
    once (the sequences, the splice scores), the result written once."""
    cells = (q_len + 1) * (t_len + 1)
    return 4 * vectors * (q_len + t_len + 2), 2 * cells * transitions


def band_work(dims, transitions: int) -> tuple:
    """(bytes, int32 operations) of a band scan over comparisons of
    ``dims`` [(query length, band width)]: its two passes, the reverse one
    and the forward one, each a dense DP over a comparison's (query + 1) x
    (band width + 1) cells (``dp_work``)."""
    n_bytes = n_ops = 0
    for q_len, width in dims:
        b, o = dp_work(q_len, width, transitions)
        n_bytes += 2 * b
        n_ops += 2 * o
    return n_bytes, n_ops
