"""The phase tracer of one run: nested spans and counters on every thread,
on the clock of ``torch.profiler``'s exported trace.

Each ``pipeline.Run`` owns one :class:`Tracer`.  Its ``TreeRuntime``, its
placers (on every thread they start) and its SPR passes record into it.

Spans.  ``tracer.span(name)`` times a block; ``tracer.add(name, seconds)``
reports a span after the fact, as one that ends now
(``TreeRuntime.add_phase_time``, whose call sites time themselves).  Spans
nest by time: a span's children are the spans of its own thread that closed
inside it, and its exclusive seconds are its inclusive seconds less its
children's.  A span reported after the fact takes as children the closed
spans of its thread that ended after it began.  For each (name, thread) the
tracer always keeps the count, the inclusive and the exclusive seconds, and
for each counter (``count``) its sum.  Spans sit at batch, pass and phase
level, never one per node or per sample.

The trace switch.  ``MAPLE_DEBUG_DEVBATCH`` (set and not empty) is the
port's trace switch.  With it each span is also kept in a bounded timeline
(:meth:`Tracer.timeline`: ``(name, thread, start_ns, end_ns)``; past
``TIMELINE_CAP`` spans the oldest go, counted in ``dropped``), and each
span opened with ``span`` opens a range of ``torch.profiler``
(:func:`profiler_range`, torch's ``record_function``), so that the spans
of the thread that runs the profiler appear in its trace under their own
names (the profiler keeps no others).  ``start_ns`` and
``end_ns`` are Unix-epoch nanoseconds (``time.time_ns()``), the clock of the
exported trace: an event's ``ts * 1000 + baseTimeNanoseconds``.  The switch
also turns on the placers' debug prints.  Without it no timeline is kept
and no profiler range opens.

When ``Run.run`` returns it closes its tracer, which joins the last
``RECENT_CAP`` closed tracers of the process (:func:`recent`).
"""
from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from collections.abc import Mapping

TRACE_ENV = "MAPLE_DEBUG_DEVBATCH"
TIMELINE_CAP = 1 << 16     # spans kept in the timeline
RECENT_CAP = 64            # closed tracers kept by recent()
CLOSED_CAP = 4096          # closed spans a frame keeps for adoption
# the spans TreeRuntime.add_phase_time reports, under TreeRuntime.phase_times
PHASES = ("tree_lk", "recalculate", "em", "blen", "root_search")

_recent = deque(maxlen=RECENT_CAP)
_recent_lock = threading.Lock()


def profiler_range(name: str):
    """A range of ``torch.profiler``'s trace named ``name``: torch's C++
    ``RecordFunctionFast`` where it has one (no operator dispatch: about
    1 us a range where ``record_function`` takes 15 us, with no profiler
    running, on the CPU), else ``torch.profiler.record_function``."""
    import torch
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    return torch.profiler.record_function(name)


def recent() -> list:
    """The last ``RECENT_CAP`` closed tracers of the process, oldest
    first."""
    with _recent_lock:
        return list(_recent)


def method_span(name: str):
    """Decorator: the method runs as span ``name`` of its object's
    ``tracer``."""
    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, **kwargs):
            with self.tracer.span(name):
                return fn(self, *args, **kwargs)
        return method
    return wrap


class _Frame:
    """An open span of one thread (or the thread's root, named None): the
    inclusive nanoseconds of the spans closed directly inside it, and the
    last of them as (start_ns, end_ns), for a span reported after the fact
    to adopt."""
    __slots__ = ("name", "child_ns", "closed")

    def __init__(self, name=None):
        self.name = name
        self.child_ns = 0
        self.closed = []


class Span:
    """One span opened by :meth:`Tracer.span`; ``seconds`` is its length
    once it has closed.  Opened directly inside an open span of the same
    name it records nothing: it is part of that span."""
    __slots__ = ("tracer", "name", "start_ns", "end_ns", "_frame", "_rf")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.name = name
        self.start_ns = self.end_ns = 0
        self._frame = None
        self._rf = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        if stack[-1].name == self.name:
            self.start_ns = time.time_ns()
            return self
        self._frame = _Frame(self.name)
        stack.append(self._frame)
        if tr.traced:
            # the range stamps its start at the end of its __enter__, which
            # can take tens of us under the profiler: read the clock after
            self._rf = profiler_range(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._frame is None:
            return False
        tr = self.tracer
        stack = tr._stack()
        stack.pop()
        tr._record(self.name, self.start_ns, self.end_ns,
                   self._frame.child_ns, stack[-1])
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        return False


class _Totals(Mapping):
    """A live view of a tracer's inclusive seconds by span name: the names
    in ``names``, or those that start with ``prefix`` (without it)."""

    def __init__(self, tracer, names=None, prefix=None):
        self._tracer = tracer
        self._names = None if names is None else frozenset(names)
        self._prefix = prefix

    def _items(self):
        out = {}
        for (name, _), (count, incl, _) in self._tracer._snapshot():
            if self._names is not None:
                if name not in self._names:
                    continue
                key = name
            elif name.startswith(self._prefix):
                key = name[len(self._prefix):]
            else:
                continue
            if count:
                out[key] = out.get(key, 0.0) + incl * 1e-9
        return out

    def __getitem__(self, key):
        return self._items()[key]

    def __iter__(self):
        return iter(self._items())

    def __len__(self):
        return len(self._items())


class Tracer:
    """Spans and counters of one run (module docstring).  ``traced``
    (a timeline and profiler ranges) defaults to the trace switch."""

    def __init__(self, traced: bool = None, timeline_cap: int = TIMELINE_CAP):
        self.traced = bool(os.environ.get(TRACE_ENV)) if traced is None \
            else bool(traced)
        self.closed = False
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._stats = {}            # (name, thread) -> [count, incl, excl]
        self._counters = {}
        self._timeline = deque(maxlen=timeline_cap) if self.traced else None

    # -- recording -------------------------------------------------------
    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = [_Frame()]
            self._local.thread = threading.current_thread().name
        return stack

    def span(self, name: str) -> Span:
        """A context manager that records the block as span ``name``."""
        return Span(self, name)

    def add(self, name: str, seconds: float):
        """Record span ``name`` of ``seconds`` that ends now; the closed
        spans of this thread that ended after it began are its children."""
        end = time.time_ns()
        start = end - round(seconds * 1e9)
        stack = self._stack()
        frame = stack[-1]
        child_ns = 0
        closed = frame.closed
        while closed and closed[-1][1] > start:
            s, e = closed.pop()
            child_ns += e - s
        frame.child_ns -= child_ns
        self._record(name, start, end, child_ns, frame)

    def _record(self, name, start, end, child_ns, parent):
        incl = end - start
        parent.child_ns += incl
        parent.closed.append((start, end))
        if len(parent.closed) > CLOSED_CAP:
            del parent.closed[:CLOSED_CAP // 2]
        thread = self._local.thread
        with self._lock:
            st = self._stats.get((name, thread))
            if st is None:
                st = self._stats[(name, thread)] = [0, 0, 0]
            st[0] += 1
            st[1] += incl
            st[2] += max(0, incl - child_ns)
            if self._timeline is not None:
                if len(self._timeline) == self._timeline.maxlen:
                    self.dropped += 1
                self._timeline.append((name, thread, start, end))

    def count(self, name: str, n: int = 1):
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def close(self):
        """Mark the run finished and keep the tracer in :func:`recent`."""
        self.closed = True
        with _recent_lock:
            _recent.append(self)

    # -- reading ---------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            return [(k, tuple(v)) for k, v in self._stats.items()]

    def rows(self):
        """(name, thread, count, inclusive s, exclusive s) of every span
        name and thread, by name."""
        return sorted((name, thread, c, i * 1e-9, x * 1e-9)
                      for (name, thread), (c, i, x) in self._snapshot())

    def names(self):
        return sorted({name for (name, _), _ in self._snapshot()})

    def calls(self, name: str) -> int:
        return sum(c for (n, _), (c, _, _) in self._snapshot() if n == name)

    def inclusive(self, name: str) -> float:
        """Seconds in spans ``name``, on every thread, children included."""
        return sum(i for (n, _), (_, i, _) in self._snapshot()
                   if n == name) * 1e-9

    def exclusive(self, name: str) -> float:
        """Seconds in spans ``name``, on every thread, less their
        children's."""
        return sum(x for (n, _), (_, _, x) in self._snapshot()
                   if n == name) * 1e-9

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def totals(self, names=None, prefix=None) -> Mapping:
        """A live view of the inclusive seconds of the spans in ``names``,
        or of those whose names start with ``prefix``, keyed without it."""
        return _Totals(self, names=names, prefix=prefix)

    def timeline(self) -> list:
        """The kept spans, ``(name, thread, start_ns, end_ns)`` in the
        order they closed; empty without the trace switch."""
        with self._lock:
            return [] if self._timeline is None else list(self._timeline)

    def breakdown(self) -> str:
        """Exclusive seconds by span name and the counters, on one line."""
        excl = {}
        for (name, _), (_, _, x) in self._snapshot():
            excl[name] = excl.get(name, 0) + x
        spans = ", ".join(f"{k}={v * 1e-9:.2f}s"
                          for k, v in sorted(excl.items()))
        counts = ", ".join(f"{k}={v}"
                           for k, v in sorted(self.counters().items()))
        return f"{spans}; {counts}" if counts else spans
