"""The alignment-model IR: declarative weighted finite-state automata.

TPU-native equivalent of the reference C4 DSL (ref: src/c4/c4.{h,c}).
A Model is a graph of states and transitions; every transition advances the
query/target by 0..3 symbols, carries a label (MATCH/GAP/INTRON/...) and an
optional Calc. Where the reference's Calc is a C callback plus a codegen macro
string, ours is a *grid provider*: a function that materializes the
transition's scores for a whole region as an int32 array (constant, per-row,
per-column or full 2-D), which is what lets the generic engines below run the
same model as vectorized NumPy, as a jitted JAX wavefront, or as a Pallas
kernel — the IR plays the role of the reference's model description and the
engines play the role of its interpreter/codegen pair.

Graph ops (make_stereo, insert, derive) and the closing topological sort
reproduce the reference semantics exactly (ref: src/c4/c4.c:681-770,
C4_Model_topological_sort c4.c:1418-1486) because transition evaluation order
is parity-critical for tie-breaking (SURVEY.md §8.2).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

IMPOSSIBLY_LOW_SCORE = -987654321
IMPOSSIBLY_HIGH_SCORE = 987654321


class Scope(enum.Enum):
    """Where a start/end state is reachable (ref: src/c4/c4.h:91-99)."""
    ANYWHERE = "anywhere"
    EDGE = "edge"        # query edge or target edge
    QUERY = "query"      # query edge only
    TARGET = "target"    # target edge only
    CORNER = "corner"    # both


class Label(enum.Enum):
    """Transition labels driving output formats (ref: src/c4/c4.h:114-124)."""
    NONE = "none"
    MATCH = "match"
    GAP = "gap"
    NER = "ner"
    SS5 = "5'ss"
    SS3 = "3'ss"
    INTRON = "intron"
    SPLIT_CODON = "split_codon"
    FRAMESHIFT = "frameshift"


class Protect(enum.IntFlag):
    NONE = 0
    OVERFLOW = 1
    UNDERFLOW = 2


class State:
    # in_add/out_add mirror the reference's per-state
    # input/output_transition_lists: append-only in ADD order, never
    # reordered by close() (unlike Model.transitions).  C4_Model_select
    # iterates THESE lists, so derived-model construction order — and
    # with it every Viterbi tie-break inside BSDP terminals/joins —
    # depends on them (ref: c4.c:444-445, 2247-2275).
    __slots__ = ("name", "id", "in_add", "out_add")

    def __init__(self, name: str):
        self.name = name
        self.id = -1
        self.in_add = []
        self.out_add = []

    def __repr__(self):
        return f"State({self.name!r})"


@dataclass
class Calc:
    """A score calculator for transitions.

    ``grid_fn(region, data) -> np.ndarray`` materializes scores addressed by
    the *source* position of the transition, broadcastable to
    [query_length+1, target_length+1]: shape () for constants, [Q+1, 1] for
    query-position-dependent scores, [1, T+1] for target-position scores and
    [Q+1, T+1] for full grids (e.g. substitution-matrix matches).  Grids are
    indexed by region-local offsets: entry [i, j] is the score of taking the
    transition whose source cell is (i, j).

    ``shadow_fn(xp, grid, shadow_vals, inputs, qpos, tpos)``, when set,
    post-combines the grid score with the source cell's shadow lanes (e.g.
    the intron length-window check, ref: src/model/intron.c:149-157).  It is
    written against the array module ``xp`` (numpy or jax.numpy) and pure
    array ``inputs`` produced by ``shadow_inputs_fn(region, data)``, so the
    same function runs scalar in the reference interpreter and vectorized /
    traced in the JAX engines without retracing per sequence pair.

    ``factored_fn(region, data)``, when set, returns a compact factored
    form ``{"q_idx": [Q+1] int32, "t_idx": [T+1] int32,
    "table": [k, k] int32, "q_add": optional [Q+1] int32}`` such that
    grid[i, j] == table[q_idx[i], t_idx[j]] + q_add[i].  The JAX engines
    prefer it over grid_fn: it ships O(Q+T) data to the device instead of
    O(Q*T) — the device-side equivalent of the reference's per-cell
    Submat_lookup macro expansion (ref: viterbi.c:869-984).

    max_score is the admissible upper bound used by heuristics
    (ref: src/c4/c4.h:75-89).  When the bound depends on runtime flag
    values that only live in AlignData (gap penalties, frameshift
    penalty), ``max_score_fn(data) -> int`` supplies it instead.
    """
    name: str
    max_score: int = 0
    grid_fn: Optional[Callable] = None
    shadow_fn: Optional[Callable] = None
    shadow_inputs_fn: Optional[Callable] = None
    factored_fn: Optional[Callable] = None
    protect: Protect = Protect.NONE
    id: int = -1
    # gather-free formulation for the fused Pallas kernel: pallas_fn(ctx)
    # computes the transition score from shadow lanes + kernel inputs
    # (ctx.lane / ctx.tslice / ctx.qvec / ctx.xp); kernel_inputs_fn
    # returns {name: ("qvec"|"tvec", np.ndarray)} region-local vectors
    pallas_fn: Optional[Callable] = None
    kernel_inputs_fn: Optional[Callable] = None
    max_score_fn: Optional[Callable] = None
    # native-engine descriptor for shadow-dependent calcs: a
    # (kind, params) tag the C++ scheduler understands
    # ("intron_window" | "split_codon"; see native/sdplib.cpp)
    native_shadow: Optional[tuple] = None
    # separable 2-D grids (joint introns): qt_fn(region, data) ->
    # (qvec[Q+1], tvec[T+1]) with grid[i,j] == qvec[i] + tvec[j];
    # keeps genome-scale pairs O(Q+T)
    qt_fn: Optional[Callable] = None

    def effective_max_score(self, data) -> int:
        """The admissible bound, resolving flag-dependent calcs
        (ref: C4_Calc_score with empty calc_func returns max_score,
        c4.c:321-333)."""
        if self.max_score_fn is not None:
            return int(self.max_score_fn(data))
        return int(self.max_score)

    def materialize(self, region, data) -> np.ndarray:
        if self.grid_fn is None:
            return np.asarray(self.max_score, dtype=np.int32)
        return self.grid_fn(region, data)


class Transition:
    __slots__ = ("name", "id", "input", "output", "advance_query",
                 "advance_target", "calc", "label", "label_data",
                 "dst_shadows")

    def __init__(self, name, input, output, advance_query, advance_target,
                 calc, label=Label.NONE, label_data=None):
        self.name = name
        self.id = -1
        self.input: State = input
        self.output: State = output
        self.advance_query = advance_query
        self.advance_target = advance_target
        self.calc: Optional[Calc] = calc
        self.label = label
        self.label_data = label_data
        self.dst_shadows: list[Shadow] = []

    @property
    def is_match(self):
        return self.label == Label.MATCH

    @property
    def is_silent(self):
        return self.advance_query == 0 and self.advance_target == 0

    def __repr__(self):
        return (f"Transition({self.name!r}, {self.input.name}->"
                f"{self.output.name}, +q{self.advance_query}"
                f"+t{self.advance_target}, {self.label.value})")


@dataclass
class Shadow:
    """A side-channel int lane carried through DP cells
    (ref: src/c4/c4.h:139-149).

    ``start`` names what the lane is set to when a transition leaves any
    src_state: "query_pos" or "target_pos" (the source position of that
    transition) — this covers every shadow in the reference model zoo.
    dst_transitions are where the lane is consumed (the consuming calc reads
    it via Calc.shadow_fn).
    """
    name: str
    src_states: list = field(default_factory=list)
    dst_transitions: list = field(default_factory=list)
    start: str = "target_pos"
    id: int = -1
    designation: int = -1
    # when set, the lane records vec[pos] instead of pos at start, where
    # vec = start_vec_fn(region, data) is region-local over the axis
    # named by ``start`` — lets consuming calcs avoid per-cell gathers
    # (packed split-codon data, see model/phase.py)
    start_vec_fn: Optional[Callable] = None


@dataclass
class Portal:
    """HSP entry/exit point for heuristics (ref: src/c4/c4.h:151-158)."""
    name: str
    calc: Calc
    advance_query: int
    advance_target: int
    transitions: list = field(default_factory=list)
    id: int = -1


@dataclass
class Span:
    """Unbounded-gap state with min/max ranges (ref: src/c4/c4.h:160-170)."""
    name: str
    span_state: State
    min_query: int = 0
    max_query: int = 0
    min_target: int = 0
    max_target: int = 0
    id: int = -1


class _Terminus:
    """Start or end state configuration (ref: src/c4/c4.h:100-112)."""

    def __init__(self, state: State, scope: Scope):
        self.state = state
        self.scope = scope


def _fn_key(f):
    """Identity of a calc's traced-in code: qualname + plain-value
    closure cells (the per-model parameters like phase/on_target that
    pick the code path; numeric score data ships as arrays and is NOT
    part of the trace)."""
    if f is None:
        return None
    cells = tuple(
        c.cell_contents if isinstance(c.cell_contents,
                                      (int, bool, str, type(None)))
        else type(c.cell_contents).__name__
        for c in (f.__closure__ or ()))
    return (getattr(f, "__qualname__", str(f)), cells)


def model_fingerprint(model: "Model") -> tuple:
    """Stable structural identity of a closed model: everything an
    engine bakes into a traced/compiled kernel (graph shape, advances,
    labels, calc code identity, span windows, shadow wiring, scopes).
    Numeric score parameters (submats, penalties) ship as runtime
    arrays, so two models equal under this key trace identically —
    jit/kernel caches keyed on it survive model re-construction across
    CLI runs instead of retracing per `id()` (the runtime analogue of
    the reference bootstrapper's name->function archive,
    ref: src/model/bootstrapper.c:199-265)."""
    fp = getattr(model, "_fingerprint", None)
    if fp is not None:
        return fp
    assert not model.is_open
    t_ix = {id(t): k for k, t in enumerate(model.transitions)}
    fp = (
        model.name,
        tuple(s.name for s in model.states),
        tuple((t.name, t.input.id if t.input else -1,
               t.output.id if t.output else -1,
               t.advance_query, t.advance_target,
               (model.calcs.index(t.calc) if t.calc is not None
                else -1),
               t.label.value, bool(t.is_silent))
              for t in model.transitions),
        tuple((c.name, c.protect.value, _fn_key(c.shadow_fn),
               _fn_key(c.pallas_fn), _fn_key(c.kernel_inputs_fn),
               c.factored_fn is not None, c.qt_fn is not None)
              for c in model.calcs),
        tuple((sp.span_state.id, sp.min_query, sp.max_query,
               sp.min_target, sp.max_target) for sp in model.spans),
        tuple((sh.name, sh.designation, sh.start,
               _fn_key(sh.start_vec_fn),
               tuple(s.id for s in sh.src_states),
               tuple(t_ix[id(t)] for t in sh.dst_transitions))
              for sh in model.shadows),
        (model.start_state.state.id, model.start_state.scope.value,
         model.end_state.state.id, model.end_state.scope.value),
        model.total_shadow_designations,
    )
    model._fingerprint = fp
    return fp


class Model:
    """A declarative DP model (ref: C4_Model, src/c4/c4.h:172-194)."""

    def __init__(self, name: str):
        self.name = name
        self.is_open = True
        self.states: list[State] = []
        self.transitions: list[Transition] = []
        self.calcs: list[Calc] = []
        self.shadows: list[Shadow] = []
        self.portals: list[Portal] = []
        self.spans: list[Span] = []
        start = State("START")
        end = State("END")
        self.states = [start, end]
        self.start_state = _Terminus(start, Scope.ANYWHERE)
        self.end_state = _Terminus(end, Scope.ANYWHERE)
        self.max_query_advance = 0
        self.max_target_advance = 0
        self.total_shadow_designations = 0

    # -- construction ------------------------------------------------------

    def add_state(self, name: str) -> State:
        assert self.is_open
        s = State(name)
        self.states.append(s)
        return s

    def add_calc(self, name, max_score=0, grid_fn=None, shadow_fn=None,
                 shadow_inputs_fn=None, factored_fn=None,
                 protect=Protect.NONE, pallas_fn=None,
                 kernel_inputs_fn=None, max_score_fn=None) -> Calc:
        assert self.is_open
        c = Calc(name, max_score, grid_fn, shadow_fn, shadow_inputs_fn,
                 factored_fn, protect,
                 pallas_fn=pallas_fn, kernel_inputs_fn=kernel_inputs_fn,
                 max_score_fn=max_score_fn)
        self.calcs.append(c)
        return c

    def add_transition(self, name, input, output, advance_query,
                       advance_target, calc=None, label=Label.NONE,
                       label_data=None) -> Transition:
        assert self.is_open
        if input is None:
            input = self.start_state.state
        if output is None:
            output = self.end_state.state
        t = Transition(name, input, output, advance_query, advance_target,
                       calc, label, label_data)
        self.transitions.append(t)
        input.out_add.append(t)
        output.in_add.append(t)
        return t

    def add_shadow(self, name, src: Optional[State],
                   dst: Optional[Transition], start: str) -> Shadow:
        """NULL src implies START; NULL dst implies all transitions to END
        (ref: src/c4/c4.c:450-483)."""
        assert self.is_open
        sh = Shadow(name, start=start)
        sh.src_states.append(src if src is not None else self.start_state.state)
        if dst is not None:
            sh.dst_transitions.append(dst)
        else:
            ends = [t for t in self.transitions
                    if t.output is self.end_state.state]
            assert ends
            sh.dst_transitions.extend(ends)
        self.shadows.append(sh)
        return sh

    def add_portal(self, name, calc, advance_query, advance_target) -> Portal:
        assert self.is_open
        p = Portal(name, calc, advance_query, advance_target)
        self.portals.append(p)
        return p

    def add_span(self, name, span_state, min_query=0, max_query=0,
                 min_target=0, max_target=0) -> Span:
        assert self.is_open
        sp = Span(name, span_state, min_query, max_query,
                  min_target, max_target)
        self.spans.append(sp)
        return sp

    def configure_start(self, scope: Scope):
        self.start_state.scope = scope

    def configure_end(self, scope: Scope):
        self.end_state.scope = scope

    def rename(self, name: str):
        self.name = name

    # -- queries -----------------------------------------------------------

    def input_transitions(self, state: State) -> list[Transition]:
        return [t for t in self.transitions if t.output is state]

    def output_transitions(self, state: State) -> list[Transition]:
        return [t for t in self.transitions if t.input is state]

    def select_transitions(self, label: Label) -> list[Transition]:
        return [t for t in self.transitions if t.label == label]

    def select_single_transition(self, label: Label) -> Transition:
        sel = self.select_transitions(label)
        assert len(sel) == 1, f"expected 1 {label} transition, got {len(sel)}"
        return sel[0]

    def src_shadows(self, state: State) -> list[Shadow]:
        return [sh for sh in self.shadows if state in sh.src_states]

    @property
    def is_global(self) -> bool:
        return (self.start_state.scope == Scope.CORNER
                and self.end_state.scope == Scope.CORNER)

    @property
    def is_local(self) -> bool:
        return (self.start_state.scope == Scope.ANYWHERE
                and self.end_state.scope == Scope.ANYWHERE)

    # -- open / close ------------------------------------------------------

    def open(self):
        self.is_open = True

    def close(self):
        assert self.is_open
        self._validate()
        self._topological_sort()
        self._designate_shadows()
        self._set_ids()
        self.max_query_advance = max(
            (t.advance_query for t in self.transitions), default=0)
        self.max_target_advance = max(
            (t.advance_target for t in self.transitions), default=0)
        self.is_open = False

    def _validate(self):
        start, end = self.start_state.state, self.end_state.state
        for s in self.states:
            ins = self.input_transitions(s)
            outs = self.output_transitions(s)
            if s is start:
                assert not ins, f"start state {s.name} has inputs"
            else:
                assert ins, f"state {s.name} has no input transitions"
            if s is end:
                assert not outs, f"end state {s.name} has outputs"
            else:
                assert outs, f"state {s.name} has no output transitions"

    def _topological_sort(self):
        """Reproduce the reference transition ordering exactly
        (ref: src/c4/c4.c:1418-1486): per-cell evaluation order is all
        advancing transitions in reverse construction order, then silent
        (0,0) transitions in dependency order (producers before consumers).
        """
        trans = self.transitions
        for i, t in enumerate(trans):
            t.id = i
        dependent = [0] * len(trans)
        for t in trans:
            if t.is_silent:
                for u in self.input_transitions(t.input):
                    if u.is_silent:
                        dependent[u.id] += 1
        ordered: list[Transition] = []
        removed = True
        while removed:
            removed = False
            for t in trans:
                if dependent[t.id] != 0 or not t.is_silent:
                    continue
                removed = True
                dependent[t.id] = -1
                ordered.append(t)
                for u in self.input_transitions(t.input):
                    if u.is_silent:
                        dependent[u.id] -= 1
        for t in trans:
            if not t.is_silent:
                ordered.append(t)
        ordered.reverse()
        assert len(ordered) == len(trans), "cycle of silent transitions"
        self.transitions = ordered

    def _designate_shadows(self):
        """Assign shadow lanes, SHARING a designation between shadows
        whose live regions are disjoint — an exact port of the
        reference's greedy colouring (ref: C4_Model_designate_shadows,
        c4.c:1564-1668).  A shadow's region is the backward transition
        cone from its dst transitions, stopped at its own dsts.  Lane
        sharing is parity-critical: models with many shadows
        (genome2genome) rely on — and inherit the quirks of — this
        packing, including lane collisions between shadows the fits
        predicate judges disjoint."""
        for t in self.transitions:
            t.dst_shadows = []
        for sh in self.shadows:
            for t in sh.dst_transitions:
                t.dst_shadows.append(sh)
        s_idx = {id(s): i for i, s in enumerate(self.states)}
        t_idx = {id(t): i for i, t in enumerate(self.transitions)}
        n_t = len(self.transitions)
        n_s = len(self.states)

        def get_designation(shadow):
            des = [False] * n_t
            visited = [False] * n_s

            def recur(transition):
                state = transition.input
                if visited[s_idx[id(state)]]:
                    return
                visited[s_idx[id(state)]] = True
                # stop at the shadow's own dst transitions
                if shadow in transition.dst_shadows:
                    return
                for t in self.input_transitions(state):
                    des[t_idx[id(t)]] = True
                    recur(t)

            for t in shadow.dst_transitions:
                des[t_idx[id(t)]] = True
                recur(t)
            return des

        def fits(des_a, des_b):
            for i in range(n_t):
                if des_a[i] and des_b[i]:
                    return False
            # fail if any des_a output states are des_b inputs
            used = [False] * n_s
            for i in range(n_t):
                if des_a[i]:
                    used[s_idx[id(self.transitions[i].output)]] = True
            for i in range(n_t):
                if des_b[i] and \
                        used[s_idx[id(self.transitions[i].input)]]:
                    return False
            used = [False] * n_s
            for i in range(n_t):
                if des_b[i]:
                    used[s_idx[id(self.transitions[i].output)]] = True
            for i in range(n_t):
                if des_a[i] and \
                        used[s_idx[id(self.transitions[i].input)]]:
                    return False
            return True

        designation_list: list[list[bool]] = []
        for sh in self.shadows:
            curr = get_designation(sh)
            sh.designation = -1
            for j, des in enumerate(designation_list):
                if fits(des, curr):
                    for i in range(n_t):
                        if curr[i]:
                            des[i] = True
                    sh.designation = j
                    break
            if sh.designation == -1:
                sh.designation = len(designation_list)
                designation_list.append(curr)
        self.total_shadow_designations = len(designation_list)

    def _set_ids(self):
        for i, s in enumerate(self.states):
            s.id = i
        for i, t in enumerate(self.transitions):
            t.id = i
        for i, c in enumerate(self.calcs):
            c.id = i
        for i, sh in enumerate(self.shadows):
            sh.id = i
        for i, p in enumerate(self.portals):
            p.id = i
            p.transitions = [t for t in self.transitions
                             if t.calc is p.calc and t.input is t.output]
        for i, sp in enumerate(self.spans):
            sp.id = i

    # -- graph surgery (ref: src/c4/c4.c:681-770) -------------------------

    def make_stereo(self, suffix_a: str, suffix_b: str):
        """Duplicate all non-terminal states/transitions/shadows, suffixing
        originals with suffix_a and copies with suffix_b
        (ref: C4_Model_make_stereo, src/c4/c4.c:681-770)."""
        assert self.is_open
        start, end = self.start_state.state, self.end_state.state
        prev_states = list(self.states)
        prev_trans = list(self.transitions)
        prev_shadows = list(self.shadows)
        state_map: dict[int, State] = {}
        for s in prev_states:
            if s is start or s is end:
                state_map[id(s)] = s
            else:
                state_map[id(s)] = self.add_state(f"{s.name} {suffix_b}")
        trans_map: dict[int, Transition] = {}
        for t in prev_trans:
            trans_map[id(t)] = self.add_transition(
                f"{t.name} {suffix_b}",
                state_map[id(t.input)], state_map[id(t.output)],
                t.advance_query, t.advance_target,
                t.calc, t.label, t.label_data)
        for sh in prev_shadows:
            new_sh = Shadow(f"{sh.name} {suffix_b}", start=sh.start, start_vec_fn=sh.start_vec_fn)
            new_sh.src_states = [state_map[id(s)] for s in sh.src_states]
            new_sh.dst_transitions = [trans_map[id(t)]
                                      for t in sh.dst_transitions]
            self.shadows.append(new_sh)
        for s in prev_states:
            if s is not start and s is not end:
                s.name = f"{s.name} {suffix_a}"
        for t in prev_trans:
            t.name = f"{t.name} {suffix_a}"
        for sh in prev_shadows:
            sh.name = f"{sh.name} {suffix_a}"
        # spans/portals of the original are not duplicated by the reference
        # stereo op for spans? — they are: copy spans over mapped states
        prev_spans = list(self.spans)
        for sp in prev_spans:
            mapped = state_map[id(sp.span_state)]
            if mapped is not sp.span_state:
                self.spans.append(Span(f"{sp.name} {suffix_b}", mapped,
                                       sp.min_query, sp.max_query,
                                       sp.min_target, sp.max_target))
                sp.name = f"{sp.name} {suffix_a}"

    def insert(self, insert: "Model", src: State, dst: State):
        """Splice ``insert`` into self between src and dst: the inserted
        model's START merges with src and END with dst
        (ref: C4_Model_insert, src/c4/c4.c:772-900)."""
        assert self.is_open
        if src is None:
            src = self.start_state.state
        if dst is None:
            dst = self.end_state.state
        ins_start = insert.start_state.state
        ins_end = insert.end_state.state
        calc_map: dict[int, Calc] = {}
        for c in insert.calcs:
            existing = next((tc for tc in self.calcs if tc.name == c.name
                             and tc.grid_fn is c.grid_fn), None)
            if existing is None:
                existing = self.add_calc(c.name, c.max_score, c.grid_fn,
                                         c.shadow_fn, c.shadow_inputs_fn,
                                         c.factored_fn, c.protect,
                                         c.pallas_fn, c.kernel_inputs_fn,
                                         c.max_score_fn)
                existing.native_shadow = c.native_shadow
                existing.qt_fn = c.qt_fn
            calc_map[id(c)] = existing
        state_map: dict[int, State] = {id(ins_start): src, id(ins_end): dst}
        for s in insert.states:
            if s is not ins_start and s is not ins_end:
                state_map[id(s)] = self.add_state(s.name)
        trans_map: dict[int, Transition] = {}
        for t in insert.transitions:
            trans_map[id(t)] = self.add_transition(
                t.name, state_map[id(t.input)], state_map[id(t.output)],
                t.advance_query, t.advance_target,
                calc_map[id(t.calc)] if t.calc else None,
                t.label, t.label_data)
        for sh in insert.shadows:
            new_sh = Shadow(sh.name, start=sh.start, start_vec_fn=sh.start_vec_fn)
            new_sh.src_states = [state_map[id(s)] for s in sh.src_states]
            new_sh.dst_transitions = [trans_map[id(t)]
                                      for t in sh.dst_transitions]
            self.shadows.append(new_sh)
        for p in insert.portals:
            self.portals.append(Portal(p.name, calc_map[id(p.calc)],
                                       p.advance_query, p.advance_target))
        for sp in insert.spans:
            self.spans.append(Span(sp.name, state_map[id(sp.span_state)],
                                   sp.min_query, sp.max_query,
                                   sp.min_target, sp.max_target))

    def copy(self) -> "Model":
        """Deep-copy the graph (states/transitions fresh, calcs shared
        structurally like the reference's C4_Model_copy)."""
        m = Model(self.name)
        state_map = {id(self.start_state.state): m.start_state.state,
                     id(self.end_state.state): m.end_state.state}
        for s in self.states:
            if id(s) not in state_map:
                state_map[id(s)] = m.add_state(s.name)
        calc_map: dict[int, Calc] = {}
        for c in self.calcs:
            calc_map[id(c)] = m.add_calc(c.name, c.max_score, c.grid_fn,
                                         c.shadow_fn, c.shadow_inputs_fn,
                                         c.factored_fn, c.protect,
                                         c.pallas_fn, c.kernel_inputs_fn,
                                         c.max_score_fn)
            calc_map[id(c)].native_shadow = c.native_shadow
            calc_map[id(c)].qt_fn = c.qt_fn
        trans_map: dict[int, Transition] = {}
        for t in self.transitions:
            trans_map[id(t)] = m.add_transition(
                t.name, state_map[id(t.input)], state_map[id(t.output)],
                t.advance_query, t.advance_target,
                calc_map[id(t.calc)] if t.calc else None,
                t.label, t.label_data)
        for sh in self.shadows:
            new_sh = Shadow(sh.name, start=sh.start, start_vec_fn=sh.start_vec_fn)
            new_sh.src_states = [state_map[id(s)] for s in sh.src_states]
            new_sh.dst_transitions = [trans_map[id(t)]
                                      for t in sh.dst_transitions]
            m.shadows.append(new_sh)
        for p in self.portals:
            m.portals.append(Portal(p.name, calc_map[id(p.calc)],
                                    p.advance_query, p.advance_target))
        for sp in self.spans:
            m.spans.append(Span(sp.name, state_map[id(sp.span_state)],
                                sp.min_query, sp.max_query,
                                sp.min_target, sp.max_target))
        m.configure_start(self.start_state.scope)
        m.configure_end(self.end_state.scope)
        if not self.is_open:
            m.close()
        return m

    # -- scope / layout (ref: src/c4/layout.c:20-150) ---------------------

    def state_active(self, state: State, qpos: int, tpos: int,
                     qlen: int, tlen: int) -> bool:
        """Is `state` in scope at (qpos, tpos)? (ref: layout.c:20-87)."""
        if qpos < 0 or tpos < 0 or qpos > qlen or tpos > tlen:
            return False
        if state is self.start_state.state:
            sc = self.start_state.scope
            if sc == Scope.EDGE and qpos != 0 and tpos != 0:
                return False
            if sc == Scope.QUERY and qpos != 0:
                return False
            if sc == Scope.TARGET and tpos != 0:
                return False
            if sc == Scope.CORNER and (qpos != 0 or tpos != 0):
                return False
        if state is self.end_state.state:
            sc = self.end_state.scope
            if sc == Scope.EDGE and qpos != qlen and tpos != tlen:
                return False
            if sc == Scope.QUERY and qpos != qlen:
                return False
            if sc == Scope.TARGET and tpos != tlen:
                return False
            if sc == Scope.CORNER and (qpos != qlen or tpos != tlen):
                return False
        return True

    def transition_valid(self, t: Transition, i: int, j: int,
                         qlen: int, tlen: int) -> bool:
        """Is transition t valid into destination cell (i, j)?
        (ref: Layout_transition_is_valid, layout.c:120-150)."""
        return (self.state_active(t.input, i - t.advance_query,
                                  j - t.advance_target, qlen, tlen)
                and self.state_active(t.output, i, j, qlen, tlen))

    def __repr__(self):
        return (f"Model({self.name!r}, {len(self.states)} states, "
                f"{len(self.transitions)} transitions, "
                f"{'open' if self.is_open else 'closed'})")


class DerivedModel:
    """A sub-model between chosen src/dst states with a transition map back
    to the original (ref: C4_DerivedModel, src/c4/c4.h:337-355; the
    src/dst-as-new-terminals construction of C4_Model_select,
    c4.c:2217-2290).  The new START takes over src's outgoing transitions
    and the new END takes over dst's incoming transitions, while all
    interior states (including interior copies of src/dst when they loop)
    keep the full graph between them.  Used by the heuristics to run DP on
    fragments of the full model."""

    def __init__(self, original: Model, src: State, dst: State,
                 start_scope: Scope, end_scope: Scope):
        self.original = original
        m = Model(f"derived:{original.name}:{src.name}:{dst.name}")
        o_start = original.start_state.state
        o_end = original.end_state.state
        # Faithful port of C4_Model_select (ref: c4.c:2217-2290): add
        # order is (1) src's output transitions in per-state ADD order
        # filtered on path-to-dst, (2) dst's input transitions filtered
        # on path-from-src, (3) a DFS flood from every mapped state over
        # output ADD order, skipping only transitions into the original
        # END.  The same original transition may be copied several times
        # (e.g. a src->dst transition becomes both START->dstcopy and
        # srccopy->END) and the flood keeps forward-reachable states
        # even when they cannot reach dst — both quirks shape the
        # derived close()'s transition order and with it every
        # BSDP terminal/join Viterbi tie-break.
        state_map: dict[int, State] = {}
        calc_map: dict[int, Calc] = {}
        # proto shadows (ref: C4_ProtoShadow): per original shadow,
        # the new src states / dst transitions in encounter order
        proto: dict[int, tuple[list, list]] = {}

        def proto_of(sh):
            if id(sh) not in proto:
                proto[id(sh)] = ([], [])
            return proto[id(sh)]

        shadows_of_state: dict[int, list] = {}
        for sh in original.shadows:
            for st in sh.src_states:
                shadows_of_state.setdefault(id(st), []).append(sh)

        def reuse_state(s: State) -> None:
            # (ref: C4_Model_segment_reuse_state, c4.c:2045-2069)
            if s is o_start or s is o_end or id(s) in state_map:
                return
            ns = m.add_state(s.name)
            state_map[id(s)] = ns
            for sh in shadows_of_state.get(id(s), ()):
                proto_of(sh)[0].append(ns)

        def map_calc(c):
            if c is None:
                return None
            if id(c) not in calc_map:
                calc_map[id(c)] = m.add_calc(
                    c.name, c.max_score, c.grid_fn, c.shadow_fn,
                    c.shadow_inputs_fn, c.factored_fn, c.protect,
                    c.pallas_fn, c.kernel_inputs_fn, c.max_score_fn)
                calc_map[id(c)].native_shadow = c.native_shadow
                calc_map[id(c)].qt_fn = c.qt_fn
            return calc_map[id(c)]

        self.transition_map: dict[int, Transition] = {}

        def seg_add(t: Transition, from_start: bool, to_end: bool):
            # (ref: C4_Model_segment_add_transition, c4.c:2071-2120)
            if not from_start:
                reuse_state(t.input)
            if not to_end:
                reuse_state(t.output)
            nt = m.add_transition(
                t.name,
                None if from_start else state_map[id(t.input)],
                None if to_end else state_map[id(t.output)],
                t.advance_query, t.advance_target,
                map_calc(t.calc), t.label, t.label_data)
            self.transition_map[id(nt)] = t
            for sh in t.dst_shadows:
                proto_of(sh)[1].append(nt)
            return nt

        def path_possible(a: State, b: State) -> bool:
            # (ref: C4_Model_path_is_possible, c4.c:1307-1340): plain
            # forward reachability a->b; a==b needs a real cycle
            seen = {id(a)}
            stack = [a]
            while stack:
                s = stack.pop()
                for t in s.out_add:
                    if t.output is b:
                        return True
                    if id(t.output) not in seen:
                        seen.add(id(t.output))
                        stack.append(t.output)
            return False

        # shadows rooted at src propagate from the new START
        # (ref: c4.c:2241-2246)
        for sh in shadows_of_state.get(id(src), ()):
            proto_of(sh)[0].append(m.start_state.state)
        # transitions from src
        for t in src.out_add:
            if not path_possible(t.output, dst):
                continue
            seg_add(t, True, False)
        # transitions to dst
        for t in dst.in_add:
            if not path_possible(src, t.input):
                continue
            seg_add(t, False, True)
        # other transitions: DFS flood (ref: C4_Model_segment_recur)
        visited: set[int] = set()

        def recur(s: State) -> None:
            if id(s) not in state_map or id(s) in visited:
                return
            if s is o_start or s is o_end:
                return
            visited.add(id(s))
            for t in s.out_add:
                if t.output is o_end:
                    continue
                seg_add(t, False, False)
                recur(t.output)

        for s in list(original.states):
            recur(s)
        # generate shadows in original shadow order
        # (ref: C4_ProtoShadow_generate, c4.c:2019-2042; the reference
        # asserts both sides nonempty — a one-sided proto never occurs
        # there.  We keep a one-sided lane alive rather than crash: a
        # setter with no interior consumer still records positions that
        # cross a span boundary, and a consumer with no setter reads the
        # lane seeded from the init cell (ref: heuristic.c:412-443).)
        for sh in original.shadows:
            p = proto.get(id(sh))
            if p is None:
                continue
            states, dts = p
            new_sh = Shadow(sh.name, start=sh.start,
                            start_vec_fn=sh.start_vec_fn)
            new_sh.src_states = list(states)
            new_sh.dst_transitions = list(dts)
            m.shadows.append(new_sh)
        m.configure_start(start_scope)
        m.configure_end(end_scope)
        m.close()
        self.derived = m
