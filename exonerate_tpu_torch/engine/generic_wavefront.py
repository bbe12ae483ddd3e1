"""The generic anti-diagonal wavefront, as PyTorch ops on a device.

Counterpart of the JAX package's XLA engine
(``exonerate_tpu/engine/wavefront.py``: ``build_wavefront:218``, its
entry points ``find_score:558``, ``find_region:566``, ``find_path:579``,
``find_region_batched:664`` and ``find_path_checkpointed:700``).  That
engine is not a Pallas kernel: it traces the model into a ``lax.scan``
over the anti-diagonals d = i + j and evaluates every transition, in
model order, on whole (Q+1)-lane vectors of a diagonal.  Here the scan
is a Python loop over diagonals of per-state ``(B, Q+1)`` int32 tensors
on the caller's device, with the same rules:

- strict ``>`` replacement, so the first maximum in model order wins;
- int32 scores that wrap, the protect clamps and the NEG floor;
- the start and end scope masks (``wavefront.py:185-207``);
- end cells reduced per diagonal by (score desc, j asc, i asc);
- 2-D calc grids and the SubOpt mask plane read per diagonal at the
  source (resp. destination) cell, as the skew (``:419``) lays them out;
- uint8 traceback planes of winning plan ids (row + 1, 0 = unset);
- calcs with a shadow function called as ``shadow_fn(xp, ...)`` with
  ``xp`` a small torch namespace (``asarray``, ``clip``, ``take``,
  ``where``, ``zeros_like``: all the port's models use).

It runs the models the hand-written kernels refuse, genome2genome's
query-side and joint split codons first among them: ``optimal.find_path``
past the host's budget and the refused buckets of
``cuda_wavefront.find_batched`` / ``find_path_batched``.  On the card
each diagonal is a few thousand small launches; it is correct, not fast
(PERF.md times it).
"""
from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as default_device
from ..model.ir import (IMPOSSIBLY_HIGH_SCORE, IMPOSSIBLY_LOW_SCORE, Model,
                        Protect, Scope)
from .reference import DPResult
from .region import Region
from .wavefront import _bucket, _grid_key, prepare_inputs

NEG = IMPOSSIBLY_LOW_SCORE


def engine_name(dev: torch.device) -> str:
    return "cuda-generic" if dev.type == "cuda" else "torch-generic"


class _Xp:
    """The namespace a calc's ``shadow_fn(xp, ...)`` computes with:
    ``np``'s five functions the port's models call, on ``device``."""

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(np.asarray(a), device=self.device)

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)

    @staticmethod
    def take(a, idx):
        return a.reshape(-1)[idx.long()]

    def where(self, c, x, y):
        if not isinstance(c, torch.Tensor):
            c = torch.as_tensor(c, device=self.device)
        return torch.where(c, x, y)

    @staticmethod
    def zeros_like(a):
        return torch.zeros_like(a)


def _shift(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Lane i of the result is lane i - k of ``x`` along its last axis
    (``jnp.roll`` by k with the first k lanes set to ``fill``)."""
    if k == 0:
        return x
    return F.pad(x[..., :-k], (k, 0), value=fill)


def _scope_start(scope: Scope, si, sj):
    if scope == Scope.ANYWHERE:
        return torch.ones_like(si, dtype=torch.bool)
    if scope == Scope.EDGE:
        return (si == 0) | (sj == 0)
    if scope == Scope.QUERY:
        return si == 0
    if scope == Scope.TARGET:
        return sj == 0
    return (si == 0) & (sj == 0)


def _scope_end(scope: Scope, i, j, qlen, tlen):
    if scope == Scope.ANYWHERE:
        return torch.ones_like(j, dtype=torch.bool)
    if scope == Scope.EDGE:
        return (i == qlen) | (j == tlen)
    if scope == Scope.QUERY:
        return i == qlen
    if scope == Scope.TARGET:
        return j == tlen
    return (i == qlen) & (j == tlen)


def _plan(model: Model) -> list:
    """The engine's per-transition plan (``wavefront.py:240-254``)."""
    start_state = model.start_state.state
    end_state = model.end_state.state
    plan = []
    for t in model.transitions:
        if t.input is end_state or t.output is start_state:
            continue
        plan.append(dict(
            t=t, plan_id=len(plan),
            key=_grid_key(model, t) if t.calc is not None else None,
            shkey=(f"sh{model.calcs.index(t.calc)}"
                   if t.calc is not None and t.calc.shadow_fn is not None
                   else None),
            start_lanes=[(sh.designation, sh.start)
                         for sh in model.src_shadows(t.input)],
            dst_shadows=[(sh.name, sh.designation)
                         for sh in t.dst_shadows],
            over=(t.calc is not None
                  and bool(t.calc.protect & Protect.OVERFLOW))))
    return plan


class Inputs:
    """A batch of ``prepare_inputs`` dicts (one bucket: same padded shape
    and kinds) as tensors on one device, with the per-diagonal reads of
    the 2-D planes."""

    def __init__(self, per_pair: list, kinds: tuple, adv_of_key: dict,
                 Q: int, T: int, device: torch.device):
        self.kinds = dict(kinds)
        self._adv = adv_of_key
        self.Q, self.T = Q, T
        self.B = len(per_pair)
        dev = self.device = device
        self.i = torch.arange(Q + 1, dtype=torch.int32, device=dev)

        def put(xs, dtype=torch.int32):
            return torch.as_tensor(np.stack([np.asarray(x) for x in xs]),
                                   dtype=dtype, device=dev)

        first = per_pair[0]
        self.rows: dict = {"_i": self.i}
        self.planes: dict = {}
        for k in first:
            kind = self.kinds.get(k)
            vals = [p[k] for p in per_pair]
            if kind == "factored":
                self.rows[k] = {n: put([v[n] for v in vals])
                                for n in first[k]}
                self.rows[k]["_ncols"] = first[k]["table"].shape[1]
            elif kind == "blocked":
                self.planes[k] = put(vals, torch.uint8)
            elif kind == "grid2d":
                aq, _at = adv_of_key[k]
                plane = put(vals)
                si = torch.clamp(self.i - aq, 0, Q).long()
                self.planes[k] = plane[:, si]       # (B, Q+1, T+1)
            elif k.startswith("sh") and isinstance(first[k], dict):
                self.rows[k] = self._shadow_inputs(vals)
            elif k.startswith("_"):
                self.rows[k] = put(vals).reshape(self.B, 1)
            elif kind in ("qvec", "tvec"):
                self.rows[k] = put(vals)
            elif kind == "scalar":
                self.rows[k] = put(vals).reshape(self.B, 1)
            else:
                # kernel-only inputs (``for_pallas``) are not read here
                continue

    def _shadow_inputs(self, vals: list) -> dict:
        """A shadow calc's inputs: scalars as (B, 1); arrays only for a
        batch of one pair (``scalar_shadows`` splits the others)."""
        out = {}
        for n, v in vals[0].items():
            if np.ndim(v) == 0:
                out[n] = torch.as_tensor(
                    np.asarray([x[n] for x in vals]), device=self.device
                ).reshape(self.B, 1)
            else:
                assert self.B == 1, "array shadow inputs need a batch of 1"
                a = np.asarray(v)
                # int32, as JAX holds every integer array
                out[n] = torch.as_tensor(
                    a.astype(np.int32) if a.dtype.kind in "iu" else a,
                    device=self.device)
        return out

    def at(self, d: int) -> dict:
        """The inputs of diagonal d: the constant rows, the SubOpt mask
        at the destination cells and each 2-D grid at the source cells."""
        if not self.planes:
            return self.rows
        rows = dict(self.rows)
        i, Q, T = self.i, self.Q, self.T
        for k, plane in self.planes.items():
            if k == "_blocked":
                sj = d - i
                ok = (sj >= 0) & (sj <= T)
                sjc = torch.clamp(sj, 0, T)
                byte = plane.gather(
                    2, (sjc >> 3).long().view(1, -1, 1).expand(
                        self.B, Q + 1, 1))[..., 0].int()
                bit = (byte >> (7 - (sjc & 7))) & 1
                rows[k] = (bit != 0) & ok
            else:
                aq, at = self._adv[k]
                sj = d - i - at
                ok = (sj >= 0) & (sj <= T) & (i - aq >= 0)
                v = plane.gather(2, torch.clamp(sj, 0, T).long().view(
                    1, -1, 1).expand(self.B, Q + 1, 1))[..., 0]
                rows[k] = torch.where(ok, v, 0)
        return rows


def scalar_shadows(inputs: dict) -> bool:
    """Whether every shadow calc input of a pair is a scalar (then pairs
    batch; otherwise each runs alone, as ``vmap`` would give it its own
    arrays)."""
    return all(np.ndim(x) == 0 for k, v in inputs.items()
               if k.startswith("sh") and isinstance(v, dict)
               for x in v.values())


class Engine:
    """``build_wavefront(model, Q, T, mode, kinds)``: the step of one
    diagonal over a batch, and the carry it threads."""

    def __init__(self, model: Model, Q: int, T: int, mode: str,
                 kinds: tuple):
        assert not model.is_open
        self.model, self.Q, self.T, self.mode = model, Q, T, mode
        self.kinds = dict(kinds)
        self.want_region = mode in ("region", "path")
        self.want_path = mode == "path"
        self.S = len(model.states)
        self.n_shadow = model.total_shadow_designations
        self.L = self.n_shadow + (2 if self.want_region else 0)
        self.rs_q, self.rs_t = self.n_shadow, self.n_shadow + 1
        self.start_state = model.start_state.state
        self.end_state = model.end_state.state
        self.D = Q + T + 1
        self.K = max(max((t.advance_query + t.advance_target
                          for t in model.transitions), default=1), 1)
        self.plan = _plan(model)
        # each row's statics, unpacked once for the diagonal loop
        self.rows = []
        for p in self.plan:
            t = p["t"]
            aq, at = t.advance_query, t.advance_target
            from_start = t.input is self.start_state
            self.rows.append((
                p, aq, at, aq + at, t.input.id, t.output.id, from_start,
                t.output is self.end_state,
                t.is_match and "_blocked" in self.kinds,
                t.calc.shadow_fn if p["shkey"] is not None else None,
                p["shkey"], p["dst_shadows"], p["start_lanes"],
                IMPOSSIBLY_HIGH_SCORE if p["over"] else None,
                from_start and self.want_region, p["plan_id"] + 1))
        self.adv_of_key = {_grid_key(model, t): (t.advance_query,
                                                 t.advance_target)
                           for t in model.transitions if t.calc is not None}

    def inputs(self, per_pair: list, device: torch.device) -> Inputs:
        return Inputs(per_pair, tuple(self.kinds.items()), self.adv_of_key,
                      self.Q, self.T, device)

    def init_carry(self, B: int, device: torch.device):
        """(prev, best): prev[k] the diagonal d-1-k as (scores (S, B, Q+1),
        lanes (S, L, B, Q+1)); best the (score, i, j, qs, ts) of the best
        end cell so far."""
        W, S = self.Q + 1, self.S
        neg = torch.full((S, B, W), NEG, dtype=torch.int32, device=device)
        zero = torch.zeros((S, self.L, B, W), dtype=torch.int32,
                           device=device)
        prev = ((neg, zero),) * self.K
        z = torch.zeros(B, dtype=torch.int32, device=device)
        return prev, (torch.full_like(z, NEG), z, z, z, z)

    def step(self, carry, d: int, rows: dict, xp: _Xp, keep_tb: bool = True):
        """One diagonal (``wavefront.py:262``).  Returns (carry, tb): tb the
        (B, S, Q+1) uint8 plan ids in path mode when ``keep_tb``, else
        None (the checkpointed forward pass needs no planes)."""
        prev, best = carry
        model, Q, T, S, L = self.model, self.Q, self.T, self.S, self.L
        i = rows["_i"]
        B = rows["_qlen"].shape[0]
        W = Q + 1
        dev = i.device
        j = d - i
        qlen, tlen = rows["_qlen"], rows["_tlen"]
        qstart, tstart = rows["_qstart"], rows["_tstart"]
        cell_ok = (j >= 0) & (j <= tlen) & (i <= qlen)       # (B, W)
        neg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
        zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
        zero_lanes = torch.zeros((L, B, W), dtype=torch.int32, device=dev)
        scores: list = [None] * S
        lanes: list = [None] * S
        tb = ([torch.zeros((B, W), dtype=torch.uint8, device=dev)
               for _ in range(S)] if self.want_path and keep_tb else None)
        reads: dict = {}
        calcs: dict = {}
        masks: dict = {}
        src: dict = {}
        for (p, aq, at, adv, inp_id, out_id, from_start, to_end, match,
             shadow_fn, shkey, dst_shadows, start_lanes, over, region_start,
             tb_id) in self.rows:
            got = src.get((aq, at))
            if got is None:
                got = src[(aq, at)] = (i - aq, j - at)
            si, sj = got
            mkey = (aq, at, from_start, to_end, match)
            src_ok = masks.get(mkey)
            if src_ok is None:
                src_ok = (si >= 0) & (sj >= 0) & cell_ok
                if from_start:
                    src_ok = src_ok & _scope_start(model.start_state.scope,
                                                   si, sj)
                if to_end:
                    src_ok = src_ok & _scope_end(model.end_state.scope, i,
                                                 j, qlen, tlen)
                if match:
                    src_ok = src_ok & ~rows["_blocked"]
                masks[mkey] = src_ok
            if from_start:
                base = zero
                src_lanes = zero_lanes
            elif adv == 0:
                base = scores[inp_id]
                if base is None:
                    continue          # statically unreachable this cell
                src_lanes = lanes[inp_id]
                src_ok = src_ok & (base > NEG)
            else:
                # every state of diagonal d - adv, shifted by aq
                got = reads.get((adv, aq))
                if got is None:
                    p_sc, p_ln = prev[adv - 1]
                    sc = _shift(p_sc, aq, NEG)
                    got = reads[(adv, aq)] = (sc, _shift(p_ln, aq, 0),
                                              sc > NEG)
                base = got[0][inp_id]
                src_lanes = got[1][inp_id]
                src_ok = src_ok & got[2][inp_id]
            calc = self._calc(p, rows, sj, calcs)
            if shadow_fn is not None:
                svals = {name: src_lanes[desig]
                         for name, desig in dst_shadows}
                pos = src.get((aq, at, "abs"))
                if pos is None:
                    pos = src[(aq, at, "abs")] = (si + qstart, sj + tstart)
                calc = shadow_fn(xp, calc, svals, rows[shkey], *pos)
            # the protect clamps, then the NEG floor every value gets
            val = torch.clamp(base + calc, min=NEG, max=over)
            # val > NEG also stands for the reference's "is set" test:
            # an unset cell holds NEG and a taken value is above it
            cur = scores[out_id]
            if cur is None:
                cur = neg
            take = (val > cur) & src_ok
            scores[out_id] = torch.where(take, val, cur)
            if tb is not None:
                tb[out_id] = torch.where(take, tb_id, tb[out_id])
            if L:
                new = src_lanes
                if start_lanes or region_start:
                    new = new.clone()
                    for desig, kind in start_lanes:
                        new[desig] = (si + qstart if kind == "query_pos"
                                      else sj + tstart)
                    if region_start:
                        new[self.rs_q] = si
                        new[self.rs_t] = sj
                old = lanes[out_id]
                lanes[out_id] = torch.where(
                    take, new, zero_lanes if old is None else old)
            elif lanes[out_id] is None:
                lanes[out_id] = zero_lanes

        # end registration with (score desc, j asc, i asc) preference
        e = self.end_state.id
        end_scores = (torch.where(cell_ok, scores[e], NEG)
                      if scores[e] is not None else neg)
        m = end_scores.max(dim=1).values
        ix = torch.argmax(torch.where(end_scores == m[:, None], i, -1),
                          dim=1)
        c_score = m
        c_i = ix.to(torch.int32)
        c_j = d - c_i
        b_score, b_i, b_j, b_qs, b_ts = best
        better = (c_score > b_score) | ((c_score == b_score)
                                        & ((c_j < b_j) | ((c_j == b_j)
                                                          & (c_i < b_i))))
        if self.want_region and lanes[e] is not None:
            c_qs = lanes[e][self.rs_q].gather(1, ix[:, None])[:, 0]
            c_ts = lanes[e][self.rs_t].gather(1, ix[:, None])[:, 0]
            b_qs = torch.where(better, c_qs, b_qs)
            b_ts = torch.where(better, c_ts, b_ts)
        elif self.want_region:
            b_qs = torch.where(better, 0, b_qs)
            b_ts = torch.where(better, 0, b_ts)
        best = (torch.where(better, c_score, b_score),
                torch.where(better, c_i, b_i), torch.where(better, c_j, b_j),
                b_qs, b_ts)

        cur = (torch.stack([neg if v is None else v for v in scores]),
               torch.stack([zero_lanes if v is None else v
                            for v in lanes]))
        prev = (cur,) + prev[:-1]
        tb_out = torch.stack(tb, dim=1) if tb is not None else None
        return (prev, best), tb_out

    def _calc(self, p, rows, sj, memo):
        """The calc score at the source cell, in the form the kind picks."""
        key = p["key"]
        if key is None:
            return 0
        at = p["t"].advance_target
        got = memo.get((key, at))
        if got is not None:
            return got
        kind = self.kinds.get(key, "grid2d")
        v = rows[key]
        T = self.T
        B = rows["_qlen"].shape[0]
        if kind == "factored":
            sjc = torch.clamp(sj, 0, T).long().expand(B, -1)
            tj = v["t_idx"].gather(1, sjc)
            flat = v["q_idx_s"] * v["_ncols"] + tj
            gathered = v["table"].reshape(B, -1).gather(1, flat.long())
            ov = v["q_override_s"]
            calc = torch.where(ov != 0, ov, gathered)
        elif kind == "tvec":
            sjc = torch.clamp(sj, 0, T).long().expand(B, -1)
            calc = v.gather(1, sjc)
        else:     # scalar (B, 1), qvec (B, Q+1) or the grid2d row
            calc = v
        memo[(key, at)] = calc
        return calc


_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def build_wavefront(model: Model, Q: int, T: int, mode: str = "score",
                    kinds: tuple = ()) -> Engine:
    """The engine of (model, Q, T, mode, kinds), kept per model
    fingerprint like the JAX package's jit cache (filled under a lock:
    the --cores worker threads share it)."""
    from ..model.ir import model_fingerprint
    key = (model_fingerprint(model), Q, T, mode, kinds)
    with _CACHE_LOCK:
        if key not in _CACHE:
            _CACHE[key] = Engine(model, Q, T, mode, kinds)
        return _CACHE[key]


def run(engine: Engine, per_pair: list, device: torch.device,
        keep_tb: bool = False):
    """The whole scan of a batch: (best, tb (D, B, S, Q+1) uint8 or None)."""
    inp = engine.inputs(per_pair, device)
    xp = _Xp(device)
    carry = engine.init_carry(inp.B, device)
    tbs = [] if keep_tb else None
    for d in range(engine.D):
        carry, tb = engine.step(carry, d, inp.at(d), xp, keep_tb)
        if keep_tb:
            tbs.append(tb)
    best = [t.tolist() for t in carry[1]]
    return best, (torch.stack(tbs) if keep_tb else None)


def _result(best: list, b: int) -> DPResult:
    return DPResult(score=best[0][b], query_end=best[1][b],
                    target_end=best[2][b], query_start=best[3][b],
                    target_start=best[4][b])


def _dev(device) -> torch.device:
    return device if device is not None else default_device()


def find_score(model: Model, region: Region, data, subopt=None,
               device=None) -> int:
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    eng = build_wavefront(model, region.query_length, region.target_length,
                          "score", kinds)
    best, _ = run(eng, [inputs], _dev(device))
    return best[0][0]


def find_region(model: Model, region: Region, data, subopt=None,
                device=None) -> DPResult:
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    eng = build_wavefront(model, region.query_length, region.target_length,
                          "region", kinds)
    best, _ = run(eng, [inputs], _dev(device))
    return _result(best, 0)


def _walk(model: Model, res: DPResult, tb_at) -> DPResult:
    """Walk back from the best end cell (ref: Viterbi_Data_create_Alignment,
    viterbi.c:342-392); ``tb_at(d)`` is diagonal d's (S, Q+1) plan ids."""
    plan_ts = [p["t"] for p in _plan(model)]
    start_state = model.start_state.state
    i, j = res.query_end, res.target_end
    state = model.end_state.state
    path = []
    while True:
        tid = int(tb_at(i + j)[state.id, i])
        if tid == 0:
            break
        t = plan_ts[tid - 1]
        path.append(t)
        i -= t.advance_query
        j -= t.advance_target
        if t.input is start_state:
            break
        state = t.input
    path.reverse()
    res.path = path
    res.query_start, res.target_start = i, j
    return res


def find_path(model: Model, region: Region, data, subopt=None,
              device=None) -> DPResult:
    """Full path: the (D, S, Q+1) uint8 traceback cube, then the walk back
    on the host (``wavefront.py:579``)."""
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    eng = build_wavefront(model, region.query_length, region.target_length,
                          "path", kinds)
    best, tb = run(eng, [inputs], _dev(device), keep_tb=True)
    tb = tb[:, 0].cpu().numpy()
    return _walk(model, _result(best, 0), lambda d: tb[d])


def find_region_batched(model: Model, jobs: list, subopt=None,
                        device=None) -> list:
    """Region DP of (region, data) jobs in bucketed batches
    (``wavefront.py:664``): pairs padded to the (Qp, Tp) ladder, one scan
    per bucket; a pair whose shadow calcs take arrays runs alone."""
    dev = _dev(device)
    out: list = [None] * len(jobs)
    buckets: dict = {}
    for n, (region, data) in enumerate(jobs):
        Qp = _bucket(region.query_length)
        Tp = _bucket(region.target_length)
        inputs, kinds = prepare_inputs(model, region, data, subopt=subopt,
                                       pad_to=(Qp, Tp))
        buckets.setdefault((Qp, Tp, kinds), []).append((n, inputs))
    for (Qp, Tp, kinds), items in buckets.items():
        eng = build_wavefront(model, Qp, Tp, "region", kinds)
        groups = ([items] if all(scalar_shadows(x) for _, x in items)
                  else [[it] for it in items])
        for group in groups:
            best, _ = run(eng, [x for _, x in group], dev)
            for b, (n, _) in enumerate(group):
                out[n] = _result(best, b)
    return out


def find_path_checkpointed(model: Model, region: Region, data, subopt=None,
                           budget_bytes: int = 32 << 20,
                           device=None) -> DPResult:
    """Full-path DP under a traceback-memory budget
    (``wavefront.py:700``; ref: viterbi.c:128-152, 537-633): a forward
    pass over segments of C diagonals saving the carry before each, then
    a walk back that re-runs only the segments the path crosses, one
    segment's traceback planes at a time."""
    dev = _dev(device)
    Q, T = region.query_length, region.target_length
    D = Q + T + 1
    S = len(model.states)
    if D * (Q + 1) * S <= budget_bytes:
        return find_path(model, region, data, subopt, device=dev)
    C = max(16, min(D, budget_bytes // max((Q + 1) * S, 1)))
    n_seg = (D + C - 1) // C
    inputs, kinds = prepare_inputs(model, region, data, subopt)
    eng = build_wavefront(model, Q, T, "path", kinds)
    inp = eng.inputs([inputs], dev)
    xp = _Xp(dev)

    def segment(carry, s0: int, keep_tb: bool):
        tbs = []
        for d in range(s0 * C, s0 * C + C):
            carry, tb = eng.step(carry, d, inp.at(d), xp, keep_tb)
            if keep_tb:
                tbs.append(tb[0])
        return carry, (torch.stack(tbs).cpu().numpy() if keep_tb else None)

    checkpoints = []
    carry = eng.init_carry(1, dev)
    for s0 in range(n_seg):
        checkpoints.append(carry)
        carry, _ = segment(carry, s0, False)
    res = _result([t.tolist() for t in carry[1]], 0)
    cache: dict = {}

    def tb_at(d):
        s0 = d // C
        if s0 not in cache:
            cache.clear()
            cache[s0] = segment(checkpoints[s0], s0, True)[1]
        return cache[s0][d - s0 * C]

    return _walk(model, res, tb_at)

