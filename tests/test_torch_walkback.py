"""The walk-back over segments of traceback planes, on the CPU.

The checkpointed traceback (``optimal.find_path_checkpointed``) walks
each segment it re-runs on the device that holds its planes:
``cuda_wavefront.walk_segment``, the segment entry point of
``csrc/walkback.cu`` on a card, ``wavefront.plain_walk_segment`` on the
CPU.  These tests hold the plain segment walk to the whole cube's walk
(``plain_walkback``, the plain version of ``_build_walkback``), check its
stop rules at a segment's edges, and hold a torch-ops emulation of the
kernel's tiles (load a tile of the planes, the rows of the states the
walk is in, walk inside it, reload on leaving it, the next tile in
flight where the walk's course leaves this one) to the plain walk,
which must fail with a tile one diagonal or one column short.  The
kernel itself runs on a card (``test_torch_cuda_wavefront.py``,
``chip_smoke.py``).

Plan ids, cells and states are integers: the tolerance is 0.
"""
import pytest
import torch

from exonerate_tpu_torch.engine import cuda_wavefront as cw
from exonerate_tpu_torch.engine import optimal as topt
from exonerate_tpu_torch.engine import wavefront as twf
from exonerate_tpu_torch.engine.subopt import SubOpt
from test_torch_subopt import JOBS
from torch_twins import PORT

CPU = torch.device("cpu")


def _path_inputs(name: str, masked: bool):
    """The job's path-mode KernelInputs, under the mask of its best
    alignment when ``masked`` (a second Waterman-Eggert iteration)."""
    model, region, data = JOBS[name](PORT)
    sub = None
    if masked:
        first = cw.find_path_batched(model, [(region, data)], device=CPU)[0]
        sub = SubOpt()
        sub.add_alignment(topt._to_alignment(model, region, first))
    pads = (twf._bucket(region.query_length),
            twf._bucket(region.target_length))
    inputs, kinds = twf.prepare_inputs(model, region, data, subopt=sub,
                                       pad_to=pads, for_pallas=True)
    ki = cw.to_kernel_inputs(model, [inputs], kinds, CPU, "path")
    assert ki.masked == masked
    return ki


@pytest.fixture(scope="module")
def cubes():
    """name, masked -> (ki, stats, tb, the whole cube's walk (ops, res))."""
    out = {}
    for name in sorted(JOBS):
        for masked in (False, True):
            ki = _path_inputs(name, masked)
            stats, tb = twf.plain_wavefront(ki)
            cap = ki.Qp + ki.Tp + 1 + cw.WALK_SLACK
            ops, res = twf.plain_walkback(tb, stats, ki.walk, ki.end_id, cap)
            assert int(res[0, 0]) > 10
            out[name, masked] = (ki, stats, tb, (ops, res))
    return out


def _chain(walk_fn, tb, stats, ki, seg: int):
    """The walk over segments of ``seg`` diagonals, from the last one
    back, each from the cell and state the one after it left: (ops,
    (i, j), last status, walks)."""
    i, j = int(stats[1, 0]), int(stats[2, 0])
    cell = torch.tensor([[i], [j], [ki.end_id]], dtype=torch.int32)
    k, parts, walks = (i + j) // seg, [], 0
    while True:
        d0, d1 = k * seg, min(tb.shape[1], (k + 1) * seg)
        planes = tb[:, d0:d1].contiguous()
        ops, res = walk_fn(planes, d0, cell, ki.walk,
                           d1 - d0 + cw.WALK_SLACK)
        walks += 1
        n, i, j, _s, status = res[:, 0].tolist()
        parts.append(ops[0, :n])
        cell = res[1:4].clone()
        if status != twf.WALK_LEFT:
            return torch.cat(parts), (i, j), status, walks
        assert (i + j) // seg < k
        k = (i + j) // seg


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", sorted(JOBS))
def test_segment_walks_chain_to_the_whole_walk(cubes, name, masked):
    """Segments of 7, 16 and a third of the diagonals, walked one after
    another (through the wrapper, which runs the plain version on the
    CPU), give the whole cube's ops and start cell."""
    ki, stats, tb, (ops, res) = cubes[name, masked]
    k = int(res[0, 0])
    D = tb.shape[1]
    for seg in (7, 16, D // 3):
        got, start, status, walks = _chain(cw.walk_segment, tb, stats, ki,
                                           seg)
        assert torch.equal(got, ops[0, :k]), seg
        assert start == tuple(res[1:, 0].tolist())
        assert status in (twf.WALK_START, twf.WALK_END)
        assert walks > 1 or seg == D // 3


def _table(rows):
    """A walk table from (aq, at, in, from_start) rows of ids 1, 2, ..."""
    cols = [(0, 0, 0, 1)] + list(rows)
    return torch.tensor(list(zip(*cols)), dtype=torch.int32)


def _planes(D, S, W, cells):
    """(1, D, S, W) planes holding ``cells`` {(d, s, i): id}."""
    tb = torch.zeros((1, D, S, W), dtype=torch.uint8)
    for (d, s, i), tid in cells.items():
        tb[0, d, s, i] = tid
    return tb


# ids: 1 a match (1, 1) into state 0, 2 a codon step (1, 2) into state 0,
# 3 an intron step (0, 1) into state 0, 4 from START (1, 1)
WALK = _table([(1, 1, 0, 0), (1, 2, 0, 0), (0, 1, 0, 0), (1, 1, 0, 1)])


def _seg(tb, d0, i, j, s=0, cap=50):
    ops, res = twf.plain_walk_segment(tb[:, d0:].contiguous(), d0,
                                      torch.tensor([[i], [j], [s]],
                                                   dtype=torch.int32),
                                      WALK, cap)
    n = int(res[0, 0])
    return ops[0, :n].tolist(), res[1:, 0].tolist()


def test_a_walk_leaves_its_segment_by_a_two_or_three_diagonal_step():
    """From a segment's first diagonals a match (d - 2) or a codon step
    (d - 3) lands below d0: the walk stops there, the landing cell
    unread, and the next segment goes on from it."""
    # cell (i, j) = (5, 6), d = 11: a codon step to (4, 4), d = 8
    tb = _planes(16, 1, 8, {(11, 0, 5): 2, (8, 0, 4): 1, (6, 0, 3): 0})
    assert _seg(tb, 9, 5, 6) == ([2], [4, 4, 0, twf.WALK_LEFT])
    assert _seg(tb, 10, 5, 6) == ([2], [4, 4, 0, twf.WALK_LEFT])
    assert _seg(tb, 0, 4, 4) == ([1], [3, 3, 0, twf.WALK_END])
    # a match from d = 10 to d = 8, below a segment from 9
    tb = _planes(16, 1, 8, {(10, 0, 5): 1, (8, 0, 4): 3})
    assert _seg(tb, 9, 5, 5) == ([1], [4, 4, 0, twf.WALK_LEFT])
    assert _seg(tb, 0, 5, 5) == ([1, 3], [4, 3, 0, twf.WALK_END])


def test_walk_stops_on_id_zero_the_cap_and_start():
    tb = _planes(16, 1, 8, {(12, 0, 6): 3, (11, 0, 6): 3, (10, 0, 6): 1,
                            (8, 0, 5): 4, (6, 0, 4): 1})
    # id 0 at the first cell: no op
    assert _seg(tb, 0, 3, 3) == ([], [3, 3, 0, twf.WALK_END])
    # the cap: two steps, then on from the exit cell
    assert _seg(tb, 0, 6, 6, cap=2) == ([3, 3], [6, 4, 0, twf.WALK_CAP])
    assert _seg(tb, 0, 6, 4) == ([1, 4], [4, 2, 0, twf.WALK_START])
    # a transition from START on a segment's first diagonal ends the walk
    # there, though its cell is below d0
    assert _seg(tb, 8, 5, 3) == ([4], [4, 2, 0, twf.WALK_START])
    # not a plan id
    bad = _planes(16, 1, 8, {(12, 0, 6): 9})
    assert _seg(bad, 0, 6, 6) == ([], [6, 6, 0, twf.WALK_BAD])
    ops, res = twf.plain_walkback(
        bad, torch.tensor([[0], [6], [6], [0], [0]], dtype=torch.int32),
        WALK, 0, 40)
    assert res[:, 0].tolist() == [40, 6, 6]


def _tile_walk(planes, d0, cell, walk, cap, shape, short_d=0, short_c=0):
    """A torch-ops emulation of ``csrc/walkback.cu``'s segment walk: two
    buffers of TD x S x TC.  A tile is loaded at the cell that needs it
    (its diagonals [d - TD + 1, d], its columns [i - TC + 1, i]), the rows
    of the states the walk visited in the tile before it and the cell's
    own; a state the walk enters inside a tile is loaded then, into the
    tile and the one in flight; the walk runs inside the tile; the next
    tile is loaded into the other buffer where the walk's course through
    the last tile leaves this one (its bottom or its left edge),
    WALK_MARGIN diagonals and columns past it, and taken when the walk
    lands in it.  ``short_d`` / ``short_c`` load that many fewer
    diagonals (at the bottom) or columns (at the left) than the tile's
    extent claims."""
    TD, TC = shape
    M = twf.WALK_MARGIN
    _, D, S, W = planes.shape
    aq_t, at_t, in_t, fs_t = walk.tolist()
    i, j, s = cell[:, 0].tolist()
    bufs = [torch.zeros((TD, S, TC), dtype=torch.uint8) for _ in range(2)]
    cur, tc, tn, ent, seen = 0, None, None, None, set()
    ops = []

    def load(buf, t, states):
        dlo, dhi, c0, c1 = t[:4]
        lo, left = dlo + short_d, c0 + short_c
        for st in states:
            buf[lo - dlo:dhi - dlo + 1, st, left - c0:c1 - c0 + 1] = \
                planes[0, lo:dhi + 1, st, left:c1 + 1]

    def inside(t, dc, ic):
        return t is not None and t[0] <= dc <= t[1] and t[2] <= ic <= t[3]

    while True:
        if i + j < d0:
            return ops, (i, j, s, twf.WALK_LEFT)
        dc, ic = min(max(i + j - d0, 0), D - 1), min(max(i, 0), W - 1)
        if not inside(tc, dc, ic):
            if tc is None:
                ent = (dc, ic)
            run_d, run_i = ent[0] - dc, ent[1] - ic
            want = seen | {s}
            if inside(tn, dc, ic):
                cur, tc = 1 - cur, tn
            else:
                c0 = max(0, ic - TC + 1)
                tc = [max(0, dc - TD + 1), dc, c0, min(W, c0 + TC) - 1,
                      set(want)]
                bufs[cur].zero_()
                load(bufs[cur], tc, want)
            ent, seen = (dc, ic), {s}
            ex_d, ex_i = tc[0] - 1, ic
            if run_d > 0 and run_i > 0:
                fall = (dc - tc[0] + 1) * run_i // run_d
                if ic - fall >= tc[2]:
                    ex_i = ic - fall
                else:
                    ex_i = tc[2] - 1
                    ex_d = dc - ((ic - tc[2] + 1) * run_d + run_i - 1) // run_i
            tn = None
            if ex_d >= 0 and ex_i >= 0:
                dhi, c1 = min(ex_d + M, D - 1), min(ex_i + M, W - 1)
                c0 = max(0, c1 - TC + 1)
                tn = [max(0, dhi - TD + 1), dhi, c0, min(W, c0 + TC) - 1,
                      set(want)]
                bufs[1 - cur].zero_()
                load(bufs[1 - cur], tn, want)
        if s not in tc[4]:
            load(bufs[cur], tc, {s})
            tc[4].add(s)
            if tn is not None:
                load(bufs[1 - cur], tn, {s})
                tn[4].add(s)
        tid = int(bufs[cur][dc - tc[0], s, ic - tc[2]])
        if tid == 0:
            return ops, (i, j, s, twf.WALK_END)
        if len(ops) >= cap:
            return ops, (i, j, s, twf.WALK_CAP)
        if tid >= len(aq_t):
            return ops, (i, j, s, twf.WALK_BAD)
        ops.append(tid)
        i, j, s = i - aq_t[tid], j - at_t[tid], in_t[tid]
        seen.add(s)
        if fs_t[tid]:
            return ops, (i, j, s, twf.WALK_START)


def _emulated_chain(tb, stats, ki, seg, shape, **short):
    i, j = int(stats[1, 0]), int(stats[2, 0])
    cell = torch.tensor([[i], [j], [ki.end_id]], dtype=torch.int32)
    k, ops = (i + j) // seg, []
    while True:
        d0 = k * seg
        planes = tb[:, d0:min(tb.shape[1], d0 + seg)]
        got, (i, j, s, status) = _tile_walk(planes, d0, cell, ki.walk,
                                            planes.shape[1] + cw.WALK_SLACK,
                                            shape, **short)
        ops += got
        cell = torch.tensor([[i], [j], [s]], dtype=torch.int32)
        if status != twf.WALK_LEFT:
            return ops, (i, j)
        k = (i + j) // seg


@pytest.mark.parametrize("name", sorted(JOBS))
def test_the_kernels_tile_rule_equals_the_plain_walk(cubes, name):
    """The emulated tiles at the kernel's shape (``walk_tile``) and at
    small shapes that cross many tiles give the plain walk, over the
    whole cube and over segments; a tile one diagonal or one column
    short reads a cell it never loaded and does not."""
    ki, stats, tb, (ops, res) = cubes[name, True]
    k = int(res[0, 0])
    want = (ops[0, :k].tolist(), tuple(res[1:, 0].tolist()))
    D = tb.shape[1]
    TD, TC = twf.walk_tile(ki.walk, ki.S)
    assert TC == twf.WALK_TC and TD >= 1
    assert TD * ki.S * twf.WALK_ROW_BYTES <= twf.WALK_TILE_BYTES
    shapes = ((TD, TC), (5, 4), (9, 3), (2, 7), (16, 16))
    for shape in shapes:
        for seg in (D, 16):
            assert _emulated_chain(tb, stats, ki, seg, shape) == want, \
                (shape, seg)
    for short in ({"short_d": 1}, {"short_c": 1}):
        fails = [_emulated_chain(tb, stats, ki, D, shape, **short) != want
                 for shape in shapes]
        assert any(fails), short
        # est2genome's path (exons and an intron) reaches both edges of
        # the kernel's own tiles
        assert fails[0] or name != "est2genome_calm", short


def test_walk_tile_follows_the_models_advances(cubes):
    """TD is TC times the most diagonals a step spends per query column
    (2 for est2genome's and affine's matches, 4 for protein2genome's codon
    steps), capped to a buffer's rows."""
    rows = twf.WALK_TILE_BYTES // twf.WALK_ROW_BYTES
    for name, r in (("est2genome_calm", 2), ("affine_local_protein", 2),
                    ("protein2genome_split", 4)):
        ki = cubes[name, False][0]
        assert twf.walk_tile(ki.walk, ki.S) == (
            min(twf.WALK_TC * r, rows // ki.S), twf.WALK_TC)
    assert twf.walk_tile(WALK, 24) == (min(64 * 3, rows // 24), 64)


def test_walk_segment_checks_its_inputs(cubes):
    ki, stats, tb, _ = cubes["est2genome_calm", False]
    cell = torch.tensor([[1], [1], [0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        cw.walk_segment(tb.int(), 0, cell, ki.walk, 10)
    with pytest.raises(ValueError, match="cell"):
        cw.walk_segment(tb, 0, cell.long(), ki.walk, 10)
    with pytest.raises(ValueError, match="cell"):
        cw.walk_segment(tb, 0, cell[:2].contiguous(), ki.walk, 10)
    with pytest.raises(ValueError, match="walk"):
        cw.walk_segment(tb, 0, cell, ki.walk[:3].contiguous(), 10)
    n = cw.walkback.launches
    cw.walk_segment(tb, 0, cell, ki.walk, 10)
    assert cw.walkback.launches == n
