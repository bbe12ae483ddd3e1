"""Row-scan SDP device tier: q-major band scans for short-query shapes.

Counterpart of ``exonerate_tpu/engine/sdp_rows.py`` (XLA code there: a
``lax.scan`` over the query rows and a ``lax.while_loop`` per row), as
PyTorch ops on the caller's device.  The same reference SDP recurrence
(ref: src/sdp/sdp.c, src/sdp/scheduler.c) as the anti-diagonal band scan
(``sdp_device.py``, kernels K6/K7), TRANSPOSED: vectors along the
compressed target W, a Python loop over the Qp+1 query rows (the reverse
pass, then the forward pass), so the step count is the short axis and
every step is a full-width vector operation.

Tensors are ``(B, Wp+1)`` int32 planes: B pairs of one bucket, the batch
``jax.vmap`` gives the JAX engine.  Semantics, candidate order and the
documented benign deviations are those of the JAX module's docstring
(``sdp_rows.py:15-61``):

- vertical candidates (advance_query >= 1) read a ring of the last K
  fully-resolved rows, shifted along W by advance_target with
  absolute-target contiguity vetoes;
- within-row candidates make the row a sequential system along t, solved
  as a bounded Jacobi fixpoint: each sweep re-evaluates every candidate in
  the reference's static order, reading within-row sources from the
  previous sweep, and closes self-loop gap chains (delete states) in
  log2 doubling steps with per-chain expiry.  A batch sweeps while any
  pair changed (one host sync per sweep); a pair that has converged keeps
  its carry frozen, so its sweep counts are those it would have alone,
  as under the JAX package's vmapped ``while_loop``;
- target-only spans freeze and thaw within one query row: the stored
  register is an inclusive/exclusive prefix maximum along the row, later
  submits winning ties, computed by log-doubling shifts;
- the reverse pass emits per-row boundary bit words that the forward pass
  consumes as its injection/thaw rows;
- joint/query-window spans are not expressible in a q-major sweep
  (``supported``).

Two changes from the JAX engine, neither of them semantic: a factored
calc reads its score row by an integer gather of the model's table (the
JAX engine's f32 one-hot matmul truncates |score| > 256 where it runs at
bf16), and the function cache is keyed on ``max_sweeps`` and
``EXONERATE_TPU_SDP_ROWS_FIXED`` too.

Like the JAX engine it returns scores only (per-locus best end score,
boundary planes, per-seed start scores for non-boundary models);
positions and tracebacks come from host band re-runs that cross-check
them (``sdp_hybrid.py``), and an unconverged row fixpoint, edge liveness
or a cross-locus thaw falls the comparison back to the host.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..model.ir import (IMPOSSIBLY_LOW_SCORE, IMPOSSIBLY_HIGH_SCORE,
                        Model)
from .sdp_device import _plan_transitions, _span_plan

NEG = IMPOSSIBLY_LOW_SCORE
POS = IMPOSSIBLY_HIGH_SCORE

# Within-row Jacobi sweeps before the unconverged flag trips (-> host
# fallback); the JAX package's default and knob
MAX_SWEEPS = int(os.environ.get("EXONERATE_TPU_SDP_ROWS_SWEEPS", "64"))


class RowUnsupported(Exception):
    """Model/pair not expressible by the row scan; use another tier."""


# ---------------------------------------------------------------------------
# static planning — copies of the JAX module's functions
# ---------------------------------------------------------------------------

def _row_plan(model: Model, is_forward: bool):
    """Candidate plan split for the q-major sweep: (adv candidates in
    static order with 'kind' in {vert, hedge, hself}, silent plan,
    chain map state_id -> self entry)."""
    adv, silent = _plan_transitions(model, is_forward)
    hself: dict[int, dict] = {}
    for k, e in enumerate(adv):
        if e["aq"] == 0 and e["at"] > 0 and e["read"] == e["write"]:
            if e["write"] in hself:
                raise RowUnsupported("two within-row self loops on one "
                                     "state")
            e["kind"] = "hself"
            hself[e["write"]] = e
        elif e["aq"] == 0 and e["at"] > 0:
            e["kind"] = "hedge"
        else:
            e["kind"] = "vert"
        e["order"] = k
    for st, se in hself.items():
        others = [e["order"] for e in adv
                  if e is not se and e["write"] == st]
        self_first = all(se["order"] < k for k in others)
        self_last = all(se["order"] > k for k in others)
        if not (self_first or self_last):
            raise RowUnsupported("chain entries straddle the self loop "
                                 "in candidate order")
        if se["shadow_starts"]:
            raise RowUnsupported("shadow start on a chain self loop")
        if se["p_under"] or se["p_over"]:
            raise RowUnsupported("protect clamp on a chain self loop")
        se["self_first"] = self_first
    return adv, silent, hself


def _silent_chain_reads_final(model: Model, is_forward: bool) -> bool:
    """Silent transitions feeding within-row chain states must read
    sources whose own silent writers all run earlier in the per-cell
    order (the chain entries are evaluated from converged row finals,
    which must equal the mid-cell running value the reference read)."""
    adv, silent, hself = _row_plan(model, is_forward)
    for e in silent:
        if e["write"] not in hself:
            continue
        writers = [s["rix"] for s in silent if s["write"] == e["read"]]
        if any(w > e["rix"] for w in writers):
            return False
        # the self push must also run after the silent write, so the
        # chain reads the silent-fed value (rix = per-cell order)
        if e["rix"] > hself[e["write"]]["rix"]:
            return False
    return True


def supported(model: Model) -> bool:
    """Can the q-major row scan express this model exactly (modulo the
    documented cross-check-caught register deviations)?"""
    from . import sdp_device
    if not sdp_device.supported(model):
        return False
    for sp in model.spans:
        if sp.max_query and sp.max_target:
            return False          # joint spans walk (t, q)-lex curr
    span_states = {sp.span_state.id for sp in model.spans}
    seed_states = {model.start_state.state.id, model.end_state.state.id}
    try:
        for fwd in (True, False):
            adv, silent, hself = _row_plan(model, fwd)
            for st, se in hself.items():
                if se["calc"] is None:
                    return False  # free self loop: unbounded chain
                if st in seed_states:
                    return False  # injection would bypass the closure
            for e in silent:
                if e["write"] in span_states:
                    # a silent write into a span state would be missed
                    # by the loop-position submit (none in the zoo)
                    return False
            if not _silent_chain_reads_final(model, fwd):
                return False
    except RowUnsupported:
        return False
    return True


def chain_ext_values(model: Model, pair) -> tuple:
    """Static scalar extend values per (is_forward, state_id) chain.
    Raises RowUnsupported when a self-loop calc is not a non-positive
    scalar for this pair (the doubling closure needs a static decay)."""
    out = []
    for fwd in (True, False):
        _adv, _silent, hself = _row_plan(model, fwd)
        for st, se in sorted(hself.items()):
            g = pair.grids.get(id(se["calc"]))
            if g is None or np.ndim(g) != 0:
                raise RowUnsupported("chain self calc is not scalar")
            ext = int(g)
            if ext > 0:
                raise RowUnsupported("positive gap extend")
            out.append((fwd, st, ext))
    return tuple(out)


def _lane_liveness(model: Model) -> list[tuple[int, int]]:
    """(state_id, designation) pairs whose shadow lane can carry a
    consumable value (backward closure from shadow_fn readers)."""
    adv, silent = _plan_transitions(model, True)
    need: set[tuple[int, int]] = set()
    for e in adv + silent:
        if e["calc"] is not None and e["calc"].shadow_fn is not None:
            for _name, des in e["dst_shadows"]:
                need.add((e["read"], des))
    changed = True
    while changed:
        changed = False
        for e in adv + silent:
            started = {des for des, _k, _v in e["shadow_starts"]}
            for (s, des) in list(need):
                if s == e["write"] and des not in started \
                        and (e["read"], des) not in need:
                    need.add((e["read"], des))
                    changed = True
    return sorted(need)


def _pack_bits(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """[..., n] bool -> [..., n_words] int64 words of 32 bits each
    (little-endian bit order, ``sdp_device._pack_bits`` of the JAX
    package)."""
    pad = n_words * 32 - bits.shape[-1]
    b = F.pad(bits.to(torch.int64), (0, pad))
    b = b.reshape(bits.shape[:-1] + (n_words, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1)


def _unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].to(torch.bool)


# ---------------------------------------------------------------------------
# batched inputs
# ---------------------------------------------------------------------------

class _Batched:
    """One input array of a batch, as a model's ``shadow_fn`` sees one
    pair's: ``shape`` is the pair's, indexing and ``take`` gather each
    pair's own row (``jax.vmap`` does this for the JAX engine)."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    @property
    def shape(self):
        return tuple(self.t.shape[1:])

    def take(self, idx):
        if not torch.is_tensor(idx):
            return self.t[:, int(idx)][:, None]
        return torch.gather(self.t, 1, idx.long())

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        B = self.t.shape[0]
        rows = torch.arange(B, device=self.t.device)[:, None]
        return self.t[(rows,) + tuple(
            i.long() if torch.is_tensor(i) else int(i) for i in idx)]


class _XP:
    """The array namespace a model's ``shadow_fn`` is called with, on
    (B, W) planes and ``_Batched`` inputs."""

    @staticmethod
    def where(c, a, b):
        if isinstance(c, (bool, np.bool_)):
            return a if c else b
        return torch.where(c, a, b)

    @staticmethod
    def take(a, idx):
        return a.take(idx)

    @staticmethod
    def clip(x, lo, hi):
        if torch.is_tensor(x):
            return torch.clamp(x, lo, hi)
        return min(max(x, lo), hi)

    @staticmethod
    def asarray(x):
        return x


def _to_torch(x, device: torch.device, batched: bool):
    """The numpy input tree on ``device``, with a leading batch axis;
    integers as int32 (the JAX package runs with 64-bit types off)."""
    if isinstance(x, dict):
        return {k: _to_torch(v, device, batched) for k, v in x.items()}
    if torch.is_tensor(x):
        t = x
    else:
        a = np.asarray(x)
        if a.dtype.kind in "iu":
            a = a.astype(np.int32)
        t = torch.as_tensor(a.copy())
    if t.dtype in (torch.int64, torch.int16, torch.int8, torch.uint8):
        t = t.to(torch.int32)
    t = t.to(device)
    return t if batched else t[None]


def _shadow_inputs(x):
    """A calc's shadow inputs as ``shadow_fn`` takes them: per-pair
    scalars as (B, 1) planes, arrays as ``_Batched``."""
    if isinstance(x, dict):
        return {k: _shadow_inputs(v) for k, v in x.items()}
    return x[:, None] if x.dim() == 1 else _Batched(x)


# ---------------------------------------------------------------------------
# the row pass
# ---------------------------------------------------------------------------

def build_row_pass(model: Model, Qp: int, Wp: int, kinds: tuple,
                   use_boundary: bool, n_seed_pad: int, n_seg_pad: int,
                   dropoff: int, chain_exts: tuple,
                   max_sweeps: int = MAX_SWEEPS, fixed: int = 0):
    """The fused reverse+forward q-major band scan of the JAX
    ``build_row_pass``.  Returns run(inputs) over a batch of torch inputs
    (leading axis B) -> {'band_end': (B, n_seg_pad), 'live', 'xband',
    'unconverged', 'sweeps': (B,), 'row_sweeps_rev', 'row_sweeps_fwd':
    (B, Qp+1), 'start_scores': (B, n_seed_pad) (non-boundary only)}.
    ``fixed`` > 0 runs that many sweeps a row with no convergence test."""
    assert not model.is_open
    S = len(model.states)
    start_id = model.start_state.state.id
    end_id = model.end_state.state.id
    K = max(max((t.advance_query for t in model.transitions),
                default=1), 1)
    Wp1 = Wp + 1
    n_words = (Wp1 + 31) // 32
    spans = [sp for sp in _span_plan(model) if sp["max_target"] > 0
             and sp["max_query"] == 0]
    kind_map = dict(kinds)
    track_sid = not use_boundary
    ext_map = dict(((f, s), e) for f, s, e in chain_exts)
    lanes_live = _lane_liveness(model) if use_boundary else []
    lane_keys = {s: tuple(des for (s_l, des) in lanes_live if s_l == s)
                 for s in range(S)}
    prefix_levels = max(1, (Wp1 - 1).bit_length())
    xp = _XP()

    def shift_r(v, n, fill):
        if n == 0:
            return v
        return F.pad(v[:, :-n], (n, 0), value=fill)

    def shift_l(v, n, fill):
        if n == 0:
            return v
        return F.pad(v[:, n:], (0, n), value=fill)

    def chain_levels(ext):
        if ext == 0:
            return prefix_levels
        lmax = dropoff // (-ext)
        return max(1, lmax.bit_length())

    def make_pass(is_forward: bool):
        adv_plan, silent_plan, hself = _row_plan(model, is_forward)
        has_lanes = is_forward and bool(lanes_live)
        has_sid = (not is_forward) and track_sid
        shf = shift_r if is_forward else shift_l

        def contig(ctx, d):
            """Contiguity mask for a within-row move of d columns:
            abs target positions differ by exactly d."""
            m = ctx["contig"].get(d)
            if m is None:
                a = ctx["abs_tv"]
                if is_forward:
                    m = (a - shift_r(a, d, -(1 << 30))) == d
                else:
                    m = (shift_l(a, d, -(1 << 30)) - a) == d
                ctx["contig"][d] = m
            return m

        def calc_vec(ctx, e):
            """Transition score plane (B, Wp1) at the calc position:
            forward = source cell (q - aq, t - at) -> shift by at;
            reverse = destination cell (q, t) -> unshifted.  Memoised
            per row: it does not change between sweeps."""
            c = e["calc"]
            ci = model.calcs.index(c)
            at = e["at"] if is_forward else 0
            qi_off = e["aq"] if is_forward else 0
            key = (ci, at, qi_off)
            got = ctx["cmemo"].get(key)
            if got is not None:
                return got
            kind = kind_map.get(f"c{ci}")
            v = ctx["inputs"][f"c{ci}"]
            qi = min(max(ctx["q"] - qi_off, 0), Qp)
            shape = ctx["abs_tv"].shape
            if kind == "qt":
                out = v["q"][:, qi:qi + 1] + shf(v["t"], at, 0)
            elif kind == "factored":
                # the pair's table row of this query symbol, read at
                # each column's target class: an integer gather
                qsel = v["q_idx"][:, qi].long()
                rows = v["table"][torch.arange(shape[0],
                                               device=qsel.device), qsel]
                g = torch.gather(rows, 1, v["t_idx"].long())
                qo = v["q_over"][:, qi:qi + 1]
                out = torch.where(qo != 0, qo, shf(g, at, 0))
            elif kind == "scalar":
                out = v[:, None].expand(shape)
            elif kind == "qvec":
                out = v[:, qi:qi + 1].expand(shape)
            else:
                out = shf(v, at, 0)
            ctx["cmemo"][key] = out
            return out

        def apply_shadow_fn(ctx, e, base, lanes_src):
            c = e["calc"]
            if not is_forward or c is None or c.shadow_fn is None:
                return base
            ci = model.calcs.index(c)
            zero = ctx["zero"]
            svals = {name: (lanes_src or {}).get(des, zero)
                     for name, des in e["dst_shadows"]}
            at = e["at"]
            qpos = ctx["q"] - e["aq"]
            tpos = shf(ctx["abs_tv"], at, 0)
            out = c.shadow_fn(xp, base, svals, ctx["shadow"][ci], qpos,
                              tpos)
            return out.to(torch.int32)

        def eval_cand(ctx, e, src):
            """src = (s_sc, s_pm, s_sd, s_ln dict) already shifted to
            destination columns.  Returns (val, ok, s_pm, s_sd, s_ln)."""
            s_sc, s_pm, s_sd, s_ln = src
            tsc = 0
            if e["rev_shadowed"]:
                pass                      # reverse scores shadows as 0
            elif e["calc"] is not None:
                tsc = calc_vec(ctx, e)
                tsc = apply_shadow_fn(ctx, e, tsc, s_ln)
            val = s_sc + tsc
            if e["p_under"]:
                val = torch.clamp(val, min=NEG)
            if e["p_over"]:
                val = torch.clamp(val, max=POS)
            ok = ctx["cell_ok"] & (s_sc > NEG)
            if e["at"]:
                ok = ok & contig(ctx, e["at"])
            if e["aq"]:
                if is_forward:
                    if ctx["q"] - e["aq"] < 0:
                        ok = torch.zeros_like(ok)
                else:
                    ok = ok & (ctx["q"] + e["aq"] <= ctx["qlen"])
            if is_forward:
                ok = ok & (val >= 0)
            ok = ok & ((s_pm - val) <= dropoff)
            return val, ok, s_pm, s_sd, s_ln

        def shifted_src(rows, e):
            """Fetch + shift a source state's row tuple for candidate e
            (a previous-rows ring entry for verticals, the current row
            estimate for within-row candidates)."""
            sc_t, pm_t, sd_t, ln_t = rows
            r = e["read"]
            at = e["at"]
            s_sc = shf(sc_t[r], at, NEG)
            s_pm = shf(pm_t[r], at, NEG)
            s_sd = shf(sd_t[r], at, 0) if has_sid else None
            s_ln = None
            if has_lanes:
                s_ln = {des: shf(v, at, 0) for des, v in ln_t[r].items()}
            return s_sc, s_pm, s_sd, s_ln

        def accept(state, e, val, ok, s_pm, s_sd, s_ln, ctx):
            """First-writer-wins merge into the running row state."""
            sc, pm, sd, ln, ev_score, ev_sid = state
            w = e["write"]
            take = ok & (val > sc[w])
            sc[w] = torch.where(take, val, sc[w])
            pm[w] = torch.where(take, torch.maximum(s_pm, val), pm[w])
            if has_sid:
                sd[w] = torch.where(take, s_sd, sd[w])
            if has_lanes:
                new_ln = dict(s_ln) if s_ln else {}
                for des, start_kind, shvix in e["shadow_starts"]:
                    if shvix is not None:
                        vec = ctx["inputs"][f"shv{shvix}"]
                        pos = shf(vec, e["at"], 0)
                    elif start_kind == "query_pos":
                        pos = torch.full_like(ctx["zero"],
                                              ctx["q"] - e["aq"])
                    else:
                        pos = shf(ctx["abs_tv"], e["at"], 0)
                    new_ln[des] = pos
                for des in lane_keys[w]:
                    nv = new_ln.get(des, ctx["zero"])
                    ln[w][des] = torch.where(take, nv, ln[w][des])
            if e["event"]:
                ev = take & (val >= s_pm)
                ev_score = torch.where(ev, val, ev_score)
                if has_sid:
                    ev_sid = torch.where(ev, s_sd, ev_sid)
            return sc, pm, sd, ln, ev_score, ev_sid

        def merge_entry(ctx, ce, cand):
            """Accumulate a chain entry with the same tie rule."""
            val, ok, s_pm, s_sd, s_ln = cand
            take = ok & (val > ce[0])
            n_val = torch.where(take, val, ce[0])
            n_pm = torch.where(take, torch.maximum(s_pm, val), ce[1])
            n_sd = torch.where(take, s_sd, ce[2]) if has_sid else None
            n_ln = ce[3]
            if has_lanes:
                n_ln = {des: torch.where(
                    take, (s_ln or {}).get(des, ctx["zero"]), v)
                    for des, v in ce[3].items()}
            return n_val, n_pm, n_sd, n_ln

        def chain_close(ctx, st, entries):
            """Close a within-row self-loop chain from its entry
            accumulator (val, pm, sd, ln) using log2 doubling with
            per-chain expiry."""
            se = hself[st]
            ext = ext_map[(is_forward, st)]
            at = se["at"]
            levels = chain_levels(ext)
            e_val, e_pm, e_sd, e_ln = entries
            bound = e_pm - dropoff
            if is_forward:
                bound = torch.clamp(bound, min=0)
            cur_v = e_val
            cur_b = torch.where(e_val > NEG, bound, POS)
            # the entry's payloads ride with its value as the column the
            # chain entered at (a taken value is never a shift's fill)
            src = ctx["col"]
            prefer_old = se["self_first"]
            for k in range(levels):
                d = at << k
                if d > Wp:
                    break
                dec = ext * (1 << k)
                sv = shf(cur_v, d, NEG)
                sb = shf(cur_b, d, POS)
                nv = sv + dec
                okm = contig(ctx, d) & (sv > NEG) & (nv >= sb) \
                    & (nv > NEG)
                nv = torch.where(okm, nv, NEG)
                if prefer_old:
                    take = (nv > cur_v) | ((nv == cur_v) & (nv > NEG))
                else:
                    take = nv > cur_v
                cur_v = torch.where(take, nv, cur_v)
                cur_b = torch.where(take, sb, cur_b)
                src = torch.where(take, shf(src, d, 0), src)
            src = src.long()
            cur_p = torch.gather(e_pm, 1, src)
            cur_s = torch.gather(e_sd, 1, src) if has_sid else e_sd
            cur_l = e_ln
            if has_lanes:
                cur_l = {des: torch.gather(v, 1, src)
                         for des, v in e_ln.items()}
            return cur_v, cur_p, cur_s, cur_l

        def span_phase(ctx, state, h_final, thaw_row):
            """Target-only span freeze/thaw within the row
            (ref: scheduler.c:567-645).  Stored register == prefix max
            over submits (later-wins ties = the in-place copy of
            scheduler.c:631-638); thaw raises strictly."""
            sc, pm, sd, ln, ev_score, ev_sid = state
            xb = ctx["false"]
            if not (is_forward and use_boundary and spans):
                return state, xb
            abs_tv = ctx["abs_tv"]
            seg_row = ctx["seg_row"]
            h_sc, h_pm, _h_sd, h_ln = h_final
            for sp in spans:
                st = sp["state"]
                if sp["submit_post_thaw"]:
                    sub_sc, sub_pm = h_sc[st], h_pm[st]
                    sub_ln = h_ln[st] if has_lanes else {}
                else:
                    sub_sc, sub_pm = sc[st], pm[st]
                    sub_ln = ln[st] if has_lanes else {}
                cand = ctx["cell_ok"] & (sub_sc >= 0)
                v = torch.where(cand, sub_sc, NEG)
                # inclusive prefix max, later submit wins ties; the
                # payloads ride with the maximum as the column it came
                # from (a taken value is never a shift's fill)
                src = ctx["col"]
                for k in range(prefix_levels):
                    d = 1 << k
                    if d > Wp:
                        break
                    sv = shift_r(v, d, NEG)
                    take = sv > v
                    v = torch.where(take, sv, v)
                    src = torch.where(take, shift_r(src, d, 0), src)
                if sp["submit_post_thaw"]:
                    # thaw precedes the loop submit in the per-cell
                    # order: same-cell submits are invisible
                    v = shift_r(v, 1, NEG)
                    src = shift_r(src, 1, 0)
                src = src.long()
                pay = {"te": abs_tv, "sg": seg_row, "pm": sub_pm}
                if has_lanes:
                    for des in lane_keys[st]:
                        pay[f"l{des}"] = sub_ln.get(des, ctx["zero"])
                pay = {n: torch.gather(p, 1, src) for n, p in pay.items()}
                ok = (v > NEG) & ((pay["te"] + sp["max_target"]) >= abs_tv)
                th = thaw_row & ok & (sc[st] < v)
                xb = xb | (th & (pay["sg"] != seg_row)).any(dim=1)
                sc[st] = torch.where(th, v, sc[st])
                pm[st] = torch.where(th, pay["pm"], pm[st])
                if has_lanes:
                    for des in list(ln[st]):
                        ln[st][des] = torch.where(th, pay[f"l{des}"],
                                                  ln[st][des])
            return (sc, pm, sd, ln, ev_score, ev_sid), xb

        def sweep(ctx, h_final, ring, inj, thaw_row):
            """One Jacobi sweep: full candidate-order merge reading
            within-row sources from h_final (previous sweep finals)."""
            neg, zero = ctx["neg"], ctx["zero"]
            inj_sc, inj_sid = inj
            sc = [neg] * S
            pm = [neg] * S
            sd = [zero] * S if has_sid else [None] * S
            ln = [{des: zero for des in lane_keys[s]}
                  for s in range(S)] if has_lanes else [None] * S
            seed_state = start_id if is_forward else end_id
            sc[seed_state] = inj_sc
            pm[seed_state] = inj_sc
            if has_sid:
                sd[seed_state] = inj_sid
            state = (sc, pm, sd, ln, neg, zero)
            chain_entries = {st: (neg, neg,
                                  zero if has_sid else None,
                                  ({des: zero for des in lane_keys[st]}
                                   if has_lanes else None))
                             for st in hself}
            # --- advancing merge (static candidate order) --------------
            for e in adv_plan:
                if e["kind"] == "hself":
                    continue     # folded into the chain closure
                if e["kind"] == "vert":
                    # reads only the ring of earlier rows: the same in
                    # every sweep of the row
                    cand = ctx["vmemo"].get(e["order"])
                    if cand is None:
                        cand = ctx["vmemo"][e["order"]] = eval_cand(
                            ctx, e, shifted_src(ring[e["aq"] - 1], e))
                else:
                    cand = eval_cand(ctx, e, shifted_src(h_final, e))
                if e["write"] in hself:
                    chain_entries[e["write"]] = merge_entry(
                        ctx, chain_entries[e["write"]], cand)
                else:
                    state = accept(state, e, *cand, ctx)
            # silent-sourced chain entries (reverse gap closes), reading
            # h_final sources, after the advancing ones
            for e in silent_plan:
                if e["write"] not in hself:
                    continue
                src = (h_final[0][e["read"]], h_final[1][e["read"]],
                       h_final[2][e["read"]] if has_sid else None,
                       h_final[3][e["read"]] if has_lanes else None)
                chain_entries[e["write"]] = merge_entry(
                    ctx, chain_entries[e["write"]], eval_cand(ctx, e, src))
            # --- chain closures ---------------------------------------
            sc, pm, sd, ln, ev_score, ev_sid = state
            for st in hself:
                cv, cp, cs, cl = chain_close(ctx, st, chain_entries[st])
                take = cv > sc[st]
                sc[st] = torch.where(take, cv, sc[st])
                pm[st] = torch.where(take, cp, pm[st])
                if has_sid:
                    sd[st] = torch.where(take, cs, sd[st])
                if has_lanes and cl is not None:
                    for des in list(ln[st]):
                        ln[st][des] = torch.where(take, cl[des],
                                                  ln[st][des])
            state = (sc, pm, sd, ln, ev_score, ev_sid)
            # --- span thaw (before the silent sweep, as sdp_device) ---
            state, xb = span_phase(ctx, state, h_final, thaw_row)
            # --- silent sweep (reverse model order, running values) ---
            sc, pm, sd, ln, ev_score, ev_sid = state
            for e in silent_plan:
                src = (sc[e["read"]], pm[e["read"]],
                       sd[e["read"]] if has_sid else None,
                       ln[e["read"]] if has_lanes else None)
                cand = eval_cand(ctx, e, src)
                sc, pm, sd, ln, ev_score, ev_sid = accept(
                    (sc, pm, sd, ln, ev_score, ev_sid), e, *cand, ctx)
            # --- finalize ---------------------------------------------
            sc = [torch.where(ctx["cell_ok"], v, NEG) for v in sc]
            return (sc, pm, sd, ln, ev_score, ev_sid, xb)

        def leaves(h):
            sc, pm, sd, ln = h
            out = list(sc) + list(pm)
            if has_sid:
                out += list(sd)
            if has_lanes:
                for d in ln:
                    out += [d[k] for k in sorted(d)]
            return out

        def select(active, new, old):
            """The new carry for the pairs still sweeping, the old one
            (frozen) for the rest."""
            a = active[:, None]
            sel = [torch.where(a, x, y) for x, y in zip(new, old)]
            return sel

        def rebuild(h, flat):
            """``h``'s structure filled from its ``leaves`` order."""
            it = iter(flat)
            sc = [next(it) for _ in range(S)]
            pm = [next(it) for _ in range(S)]
            sd = [next(it) for _ in range(S)] if has_sid else [None] * S
            ln = [None] * S
            if has_lanes:
                ln = [{k: next(it) for k in sorted(d)} for d in h[3]]
            return sc, pm, sd, ln

        def row_fixpoint(ctx, ring, inj, thaw_row):
            neg, zero = ctx["neg"], ctx["zero"]
            B = neg.shape[0]
            dev = neg.device
            h = ([neg] * S, [neg] * S,
                 [zero] * S if has_sid else [None] * S,
                 [{des: zero for des in lane_keys[s]} for s in range(S)]
                 if has_lanes else [None] * S)
            ev_score, ev_sid = neg, zero
            n_it = torch.zeros(B, dtype=torch.int32, device=dev)
            changed = torch.ones(B, dtype=torch.bool, device=dev)
            xb = ctx["false"]

            def body(h):
                sc, pm, sd, ln, ev_s, ev_i, xb_new = sweep(
                    ctx, (list(h[0]), list(h[1]), list(h[2]),
                          [dict(d) if d is not None else None
                           for d in h[3]]),
                    ring, inj, thaw_row)
                new_h = (sc, pm, sd, ln)
                diff = ctx["false"]
                for a, b in zip(leaves(h), leaves(new_h)):
                    diff = diff | (a != b).any(dim=1)
                return new_h, ev_s, ev_i, diff, xb_new

            if fixed:
                for _ in range(fixed):
                    h, ev_score, ev_sid, changed, xb = body(h)
                n_it = torch.full_like(n_it, fixed)
            else:
                while True:
                    active = changed & (n_it < max_sweeps)
                    # one host sync per sweep
                    any_on, all_on = torch.stack(
                        [active.any(), active.all()]).tolist()
                    if not any_on:
                        break
                    new_h, ev_s, ev_i, diff, xb_new = body(h)
                    if all_on:
                        h, ev_score, ev_sid, xb = new_h, ev_s, ev_i, xb_new
                        changed = diff
                    else:
                        h = rebuild(new_h, select(active, leaves(new_h),
                                                  leaves(h)))
                        ev_score, ev_sid = select(active, (ev_s, ev_i),
                                                  (ev_score, ev_sid))
                        xb = torch.where(active, xb_new, xb)
                        changed = torch.where(active, diff, changed)
                    n_it = n_it + active.to(torch.int32)
            unconverged = changed            # hit max_sweeps still hot
            return h, ev_score, ev_sid, xb, unconverged, n_it

        def step(carry, q, inj_words, inputs, shadow):
            ring, acc, live, xband, unconv = carry
            qlen = inputs["_qlen"][:, None]
            wlen = inputs["_wlen"][:, None]
            B = qlen.shape[0]
            dev = qlen.device
            col = torch.arange(Wp1, dtype=torch.int32, device=dev)
            neg = torch.full((B, Wp1), NEG, dtype=torch.int32, device=dev)
            zero = torch.zeros((B, Wp1), dtype=torch.int32, device=dev)
            cell_ok = (col[None, :] <= wlen) & (q <= qlen)
            ctx = dict(q=q, qlen=qlen, wlen=wlen, cell_ok=cell_ok,
                       col=col[None, :].expand(B, Wp1),
                       abs_tv=inputs["_abs_t"], seg_row=inputs["_seg"],
                       contig={}, cmemo={}, vmemo={}, inputs=inputs,
                       shadow=shadow,
                       neg=neg, zero=zero,
                       false=torch.zeros(B, dtype=torch.bool, device=dev))
            # --- injection row ----------------------------------------
            thaw_row = torch.zeros((B, Wp1), dtype=torch.bool, device=dev)
            sdq = inputs["_seed_q"]
            sdv = inputs["_seed_d"] - sdq
            hit = (sdq == q) & (inputs["_seed_d"] >= 0)
            if is_forward:
                if use_boundary:
                    bits = _unpack_bits(inj_words, Wp1) & cell_ok
                    inj_sc = torch.where(bits, 0, NEG).to(torch.int32)
                    thaw_row = bits
                else:
                    sscore = acc["rev_start"] - inputs["_seed_half"]
                    valid = hit & (acc["rev_start"] > NEG)
                    val = torch.where(valid, sscore, NEG)
                    inj_sc = neg.scatter_reduce(
                        1, torch.where(valid, sdv, 0).long(), val, "amax")
                inj_sid = zero
            else:
                idx = torch.where(hit, sdv, 0).long()
                val = torch.where(hit, inputs["_seed_half"], NEG)
                inj_sc = neg.scatter_reduce(1, idx, val, "amax")
                if has_sid:
                    sids = torch.arange(n_seed_pad, dtype=torch.int32,
                                        device=dev).expand(B, -1)
                    sids = torch.where(hit, sids, -1)
                    inj_sid = zero.scatter_reduce(1, idx, sids, "amax")
                    inj_sid = torch.clamp(inj_sid, min=0)
                else:
                    inj_sid = zero
            # --- the row ----------------------------------------------
            (sc, pm, sd, ln), ev_score, ev_sid, xb, unc, n_it = \
                row_fixpoint(ctx, ring, (inj_sc, inj_sid), thaw_row)
            # --- liveness, events, boundary ---------------------------
            any_live = sc[0] > NEG
            for s in range(1, S):
                any_live = any_live | (sc[s] > NEG)
            edge = inputs["_edge"] & cell_ok
            live = live | (any_live & edge).any(dim=1)
            acc = dict(acc)
            acc["sweeps"] = torch.maximum(acc["sweeps"], n_it)
            words = None
            if is_forward:
                acc["col_end"] = torch.maximum(acc["col_end"], ev_score)
            else:
                if track_sid:
                    hot = ev_score > NEG
                    acc["rev_start"] = acc["rev_start"].scatter_reduce(
                        1, torch.where(hot, ev_sid, 0).long(),
                        torch.where(hot, ev_score, NEG), "amax")
                flag = sc[start_id] >= 0
                for sp in spans:
                    flag = flag | (sc[sp["state"]] > 0)
                flag = flag & cell_ok
                words = _pack_bits(flag, n_words)
            row_final = (tuple(sc), tuple(pm),
                         tuple(sd) if has_sid else (),
                         tuple(dict(d) if d is not None else {}
                               for d in ln))
            ring = (row_final,) + ring[:-1]
            return (ring, acc, live, xband | xb, unconv | unc), \
                (words, n_it)

        return step

    step_rev = make_pass(False)
    step_fwd = make_pass(True)

    def init_ring(is_forward, B, dev):
        neg = torch.full((B, Wp1), NEG, dtype=torch.int32, device=dev)
        zero = torch.zeros((B, Wp1), dtype=torch.int32, device=dev)
        has_lanes = is_forward and bool(lanes_live)
        has_sid = (not is_forward) and track_sid
        row = (tuple(neg for _ in range(S)),
               tuple(neg for _ in range(S)),
               tuple(zero for _ in range(S)) if has_sid else (),
               tuple({des: zero for des in lane_keys[s]}
                     if has_lanes else {} for s in range(S)))
        return tuple(row for _ in range(K))

    def run(inputs):
        qlen = inputs["_qlen"]
        B, dev = qlen.shape[0], qlen.device
        shadow = {ci: _shadow_inputs(inputs[f"sh{ci}"])
                  for ci in range(len(model.calcs)) if f"sh{ci}" in inputs}
        false = torch.zeros(B, dtype=torch.bool, device=dev)
        acc = {"col_end": torch.full((B, Wp1), NEG, dtype=torch.int32,
                                     device=dev),
               "sweeps": torch.zeros(B, dtype=torch.int32, device=dev)}
        if track_sid:
            acc["rev_start"] = torch.full((B, n_seed_pad), NEG,
                                          dtype=torch.int32, device=dev)
        # a row past every pair's query holds no cell: its sweep leaves
        # the all-NEG carry as it was, and it counts one sweep (or the
        # fixed number)
        qmax = int(qlen.max()) if fixed or max_sweeps >= 1 else Qp
        idle = torch.full((B,), fixed or 1, dtype=torch.int32, device=dev)
        carry = (init_ring(False, B, dev), acc, false, false, false)
        words: list = [None] * (Qp + 1)
        rev_its: list = [idle] * (Qp + 1)
        for q in range(min(qmax, Qp), -1, -1):
            carry, (words[q], rev_its[q]) = step_rev(carry, q, None,
                                                     inputs, shadow)
        _ring, acc, live_r, _xb, unc_r = carry
        carry = (init_ring(True, B, dev), acc, false, false, false)
        fwd_its: list = [idle] * (Qp + 1)
        for q in range(min(qmax, Qp) + 1):
            carry, (_w, fwd_its[q]) = step_fwd(
                carry, q, words[q] if use_boundary else None, inputs,
                shadow)
        _ring, acc, live_f, xband, unc_f = carry
        col_end = acc["col_end"]
        band_end = torch.full((B, n_seg_pad), NEG, dtype=torch.int32,
                              device=dev).scatter_reduce(
            1, torch.where(col_end > NEG, inputs["_seg"],
                           n_seg_pad - 1).long(), col_end, "amax")
        out = {"band_end": band_end, "live": live_r | live_f,
               "xband": xband, "unconverged": unc_r | unc_f,
               "sweeps": acc["sweeps"],
               "row_sweeps_rev": torch.stack(rev_its, dim=1),
               "row_sweeps_fwd": torch.stack(fwd_its, dim=1)}
        if track_sid:
            out["start_scores"] = acc["rev_start"]
        return out

    return run


_CACHE: dict = {}


def get_fn(model: Model, Qp: int, Wp: int, kinds: tuple,
           use_boundary: bool, n_seed_pad: int, n_seg_pad: int,
           dropoff: int, chain_exts: tuple, batched: bool = False):
    """The row pass for one bucket: ``fn(inputs, device=None)`` runs it
    on ``device`` (default: the port's device) over ``inputs``, one
    pair's numpy input dict (``sdp_device.prepare_inputs`` plus
    ``prepare_seeds``), or with ``batched`` the dicts stacked along a
    leading axis, and returns the JAX ``run``'s dict as torch tensors on
    that device (with the leading axis when ``batched``).  Keyed on
    ``MAX_SWEEPS`` and ``EXONERATE_TPU_SDP_ROWS_FIXED`` as well."""
    from ..model.ir import model_fingerprint
    fixed = int(os.environ.get("EXONERATE_TPU_SDP_ROWS_FIXED", "0"))
    key = (model_fingerprint(model), Qp, Wp, kinds, use_boundary,
           n_seed_pad, n_seg_pad, dropoff, chain_exts, batched,
           MAX_SWEEPS, fixed)
    if key not in _CACHE:
        passes: dict = {}

        def fn(inputs, device: Optional[torch.device] = None):
            if device is None:
                from .. import device as default_device
                device = default_device()
            t = _to_torch(inputs, device, batched)
            # columns past every pair's band hold no cell and change no
            # output: the pass runs over the bucket's widest band only
            wn = min(Wp, -(-int(t["_wlen"].max()) // 64) * 64)
            run = passes.get(wn)
            if run is None:
                run = passes[wn] = build_row_pass(
                    model, Qp, wn, kinds, use_boundary, n_seed_pad,
                    n_seg_pad, dropoff, chain_exts, max_sweeps=MAX_SWEEPS,
                    fixed=fixed)
            out = run(_trim(t, kinds, wn + 1))
            return out if batched else {k: v[0] for k, v in out.items()}

        _CACHE[key] = fn
    return _CACHE[key]


def _trim(inputs: dict, kinds: tuple, n: int) -> dict:
    """The inputs with their target-column (Wp+1) axes cut to ``n``."""
    out = dict(inputs)
    for k in ("_abs_t", "_edge", "_seg"):
        out[k] = inputs[k][:, :n]
    for k in inputs:
        if k.startswith("shv"):
            out[k] = inputs[k][:, :n]
    for k, kind in kinds:
        if kind == "tvec":
            out[k] = inputs[k][:, :n]
        elif kind in ("qt", "factored"):
            sub = "t" if kind == "qt" else "t_idx"
            out[k] = dict(inputs[k], **{sub: inputs[k][sub][:, :n]})
    return out
