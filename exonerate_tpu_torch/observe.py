"""Engine observability: selection/fallback traces, per-run counts, and the
program's spans and counters under a profiler.

The reference's verbosity discipline (`Argument_info`, g_message traces
gated by -V, ref: src/hub/analysis.c:172-174) extended with what a
multi-engine runtime needs: every DP records which engine computed it
('cuda-sdp', 'torch-sdp', 'native-sdp', 'sdp-rows', 'cuda-wavefront',
'cuda-generic', 'native', 'oracle', ...), fallback decisions are logged
at -V 2+ with the reason, and a per-run engine summary prints at exit at
-V 1+ so a user can always tell which engine produced a result and why
a run got slower.

Spans and counters (``span``, ``traced``, ``add``) record only while a
``torch.profiler`` session records in the process; otherwise a span is
one flag check and a shared no-op.  A span records its name, thread,
start and end on ``time.perf_counter``, its parent (the span open on the
same thread, or the one a ``carry``-wrapped function was handed from),
the request it belongs to (the id of its root span: one per
``cli.exonerate.main`` invocation, whose root is ``run``) and its self
time (its duration less its children's on its own thread).  Each span
also opens ``torch.profiler.record_function(name)``, so the program's
layers appear in the profiler's trace above the kernels they launch.
``trace()`` returns what was recorded; ``clear_trace()`` empties it;
``reset()`` clears only the per-invocation -V counts.
"""
from __future__ import annotations

import functools
import itertools
import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Optional

from torch.autograd import profiler as _profiler

verbosity = 0

engine_counts: Counter = Counter()
fallback_counts: Counter = Counter()
# gam's pooled result loops run on a thread pool; counter updates are
# read-modify-write and need the lock to stay exact
_lock = threading.Lock()


def set_verbosity(v: int) -> None:
    global verbosity
    verbosity = v


def note(level: int, msg: str) -> None:
    """g_message-style trace, gated by -V level."""
    if verbosity >= level:
        sys.stderr.write(f"Message: {msg}\n")


def count_engine(engine: str, n: int = 1) -> None:
    """Record that `engine` computed n DP jobs."""
    with _lock:
        engine_counts[engine] += n
    add("engine." + engine, n)


def count_fallback(reason: str, n: int = 1) -> None:
    with _lock:
        fallback_counts[reason] += n
    add("fallback." + reason, n)
    note(2, f"engine fallback: {reason} ({n} job{'s' if n != 1 else ''})")


def reset() -> None:
    engine_counts.clear()
    fallback_counts.clear()


def report(min_level: int = 1) -> None:
    """Per-run engine summary (printed to stderr at exit, -V 1+)."""
    if verbosity < min_level or not engine_counts:
        return
    parts = ", ".join(f"{k}={v}" for k, v in sorted(engine_counts.items()))
    sys.stderr.write(f"Message: DP engines used: {parts}\n")
    if fallback_counts:
        parts = ", ".join(f"{k}={v}"
                          for k, v in sorted(fallback_counts.items()))
        sys.stderr.write(f"Message: engine fallbacks: {parts}\n")


# -- spans and counters, recorded while a profiler records -----------------

@dataclass
class Span:
    """One closed span; times in seconds of ``time.perf_counter``."""
    name: str
    id: int
    parent: Optional[int]    # the id of the span it ran under
    request: int             # the id of its root span
    thread: int              # threading.get_ident() of the thread it ran on
    start: float
    end: float
    self_s: float            # end - start less its children on its thread
    attrs: dict


@dataclass
class Trace:
    spans: list              # Span, in the order they closed
    counters: dict           # name -> total


_spans: list = []
_counters: Counter = Counter()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded (the context manager ``span`` returns)."""
    __slots__ = ("name", "attrs", "id", "up", "request", "thread", "start",
                 "child_s", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.up = stack[-1] if stack else None
        self.id = next(_ids)
        self.request = self.up.request if self.up is not None else self.id
        self.thread = threading.get_ident()
        self.child_s = 0.0
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _stack().pop()
        self._rf.__exit__(*exc)
        dur = end - self.start
        up = self.up
        if up is not None and up.thread == self.thread:
            up.child_s += dur
        rec = Span(self.name, self.id, up.id if up is not None else None,
                   self.request, self.thread, self.start, end,
                   dur - self.child_s, self.attrs)
        with _lock:
            _spans.append(rec)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager recording the span ``name`` (with ``attrs``) while
    a profiler records; the shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Open(name, attrs)


def traced(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Open(name, {}):
                return fn(*args, **kwargs)
        return run
    return wrap


def carry(fn):
    """``fn`` to run on another thread under the span open here now: the
    spans it opens there take that span as their parent and its request.
    ``fn`` itself when no span is open."""
    stack = _stack() if _profiler._is_profiler_enabled else None
    if not stack:
        return fn
    parent = stack[-1]

    @functools.wraps(fn)
    def run(*args, **kwargs):
        mine = _stack()
        mine.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            mine.pop()
    return run


def add(counter: str, n: int = 1) -> None:
    """Add ``n`` to the trace counter ``counter`` while a profiler
    records."""
    if n and _profiler._is_profiler_enabled:
        with _lock:
            _counters[counter] += n


def trace() -> Trace:
    """The spans and counters recorded since the last ``clear_trace``."""
    with _lock:
        return Trace(list(_spans), dict(_counters))


def clear_trace() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
