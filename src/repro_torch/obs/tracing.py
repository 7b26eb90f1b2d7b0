"""Span tracing: nested wall-time spans with per-request trace IDs.

A *span* is one timed region (``scanner.compile``, ``construct_bank.bucket``,
``store.artifact.get`` …) with free-form attributes; spans nest through a
``contextvars`` stack, so a span opened inside another records its parent and
inherits its **trace id** — the correlation key that lets
:meth:`repro_torch.scanservice.ScanService.metrics` reassemble one request's path
through scheduler → scanner → construction → store from the flat ring buffer.

Trace-id propagation is *explicit across threads*: ``contextvars`` don't
cross the scan service's worker thread, so :meth:`BatchScheduler.submit`
captures ``current_trace_id()`` at submit time and ``_run_batch`` re-roots
its spans with ``span(..., trace_id=captured)``. Anything running on the
caller's thread inherits implicitly.

Finished spans land in a bounded ring buffer (default 4096) — enough to
reconstruct recent requests without ever growing unbounded in a long-lived
service. :func:`trace_summary` filters and orders it by trace id.

**Per-span totals.** The tracer adds three integer counters to its registry
as each span closes: ``span.<name>.calls``, ``span.<name>.ns`` (the
span's duration) and ``span.<name>.self_ns`` (the duration less that of its
direct children on the same thread). A span's time thus reaches any reader
of :meth:`MetricsRegistry.snapshot` as a before/after delta. The
``torch.profiler`` bridge's own cost stays out of every total: a span's
interval starts after its annotation is entered and ends before it is left,
and what the annotations of the spans inside it cost is taken off its
``ns``. The profiler also slows the host work inside the spans (it records
every host operation), so a traced run's totals are larger than an
untraced run's, and not by one factor for every span: size host work from
untraced totals.

**Loop spans.** :meth:`Tracer.loop_span` is a span site for a hot loop: made
once inside an open span and entered once an iteration (``with launch:``),
it adds to the same ``span.<name>.*`` totals, counts as a direct child of
that span, and is bridged into the profiler like a span, but it keeps no
record in the ring buffer and carries no attributes. It adds up its
intervals itself and hands them to the registry when the enclosing span
closes, so a loop of many iterations costs a few clock reads each and
cannot push a request's own spans out of the ring.

**Clock.** Spans time themselves in monotonic integer nanoseconds
(``time.perf_counter_ns``; ``t_start``/``t_end``/``wall_s`` are the same
clock in float seconds, as ``time.perf_counter`` reads it). The tracer keeps
the offset from that clock to Unix nanoseconds, sampled at import and again
whenever the ``torch.profiler`` bridge is turned on, so a span's
``t_start_unix_ns``/``t_end_unix_ns`` lie on the clock a ``torch.profiler``
trace stamps its events with (``trace_start_ns() + time_range · 1000``):
an exported span, attributes and all, can be laid on the device trace.

When disabled, :func:`span` and :meth:`Tracer.loop_span` return a shared
no-op context manager: no object allocation, no clock reads, no contextvar
writes, no counter touched.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque

from .registry import Counter, MetricsRegistry

_now_ns = time.perf_counter_ns
_thread_id = threading.get_ident

#: Current open span, per task/thread (None at top level).
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None
)

_trace_counter = itertools.count(1)


def _mint_trace_id() -> str:
    # pid disambiguates several processes writing one JSONL.
    return f"t{os.getpid():x}-{next(_trace_counter):06x}"


def _sample_unix_offset(tries: int = 5) -> int:
    """Unix ns minus monotonic ns, from the tightest of a few bracketed
    reads."""
    best = None
    for _ in range(tries):
        a = _now_ns()
        u = time.time_ns()
        b = _now_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


#: Unix ns = monotonic ns + this (see :meth:`Tracer.sync_clock`).
_unix_offset_ns = _sample_unix_offset()

#: ``torch.profiler.record_function``, imported at the bridge's first use.
_record_function = None


#: The lock of every ``span.<name>.*`` counter (see :class:`_SpanTotal`).
_TOTALS_LOCK = threading.Lock()


class _SpanTotal(Counter):
    """A ``span.<name>.*`` counter. They all share one lock, so the tracer
    adds a span to its three totals in one acquisition (three ``inc``
    calls cost about as much as the rest of a span) and a reset or a read
    takes the same lock."""

    __slots__ = ()

    def __init__(self, name: str, state):
        super().__init__(name, state)
        self._lock = _TOTALS_LOCK


class Span:
    """One timed region: its own context manager while open, a record in
    the tracer's ring buffer once closed."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t_start_ns", "t_end_ns", "_tracer", "_parent", "_thread",
                 "_child_ns", "_bridge_ns", "_own_bridge_ns", "_token",
                 "_annotation", "_loops")

    def __init__(self, name: str, trace_id: str, span_id: int,
                 parent_id: int | None, attrs: dict, tracer: "Tracer",
                 parent: "Span | None" = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t_start_ns = 0
        self.t_end_ns = 0
        self._tracer = tracer
        self._parent = parent
        self._thread = _thread_id()
        self._child_ns = 0       # direct children's totals
        self._bridge_ns = 0      # the bridge's cost inside this span
        self._annotation = None
        self._loops = None       # loop spans made inside it

    @property
    def t_start(self) -> float:
        return self.t_start_ns * 1e-9

    @property
    def t_end(self) -> float:
        return self.t_end_ns * 1e-9

    @property
    def wall_s(self) -> float:
        return (self.t_end_ns - self.t_start_ns) * 1e-9

    @property
    def t_start_unix_ns(self) -> int:
        return self.t_start_ns + _unix_offset_ns

    @property
    def t_end_unix_ns(self) -> int:
        return self.t_end_ns + _unix_offset_ns

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "attrs": dict(self.attrs),
            "t_start": self.t_start,
            "wall_s": self.wall_s,
            "t_start_unix_ns": self.t_start_unix_ns,
            "t_end_unix_ns": self.t_end_unix_ns,
        }

    # The bridge's own cost stays out of the span: the start is read after
    # entering the annotation, the end before leaving it. What it costs
    # around the span is timed too, and the tracer takes it out of the
    # totals of the spans that enclose it.
    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        if self._tracer.state.profiler_annotations:
            t0 = _now_ns()
            self._annotation = self._tracer._enter_annotation(self.name)
            self.t_start_ns = _now_ns()
            self._own_bridge_ns = self.t_start_ns - t0
        else:
            self.t_start_ns = _now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t_end_ns = _now_ns()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        bridge = 0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
            bridge = self._own_bridge_ns + _now_ns() - self.t_end_ns
        _current_span.reset(self._token)
        self._tracer._record(self, bridge)
        return False


class LoopSpan:
    """A span site inside a hot loop (see the module docstring): enter it
    once an iteration on the thread that made it. Its intervals go to
    ``span.<name>.*`` when the span that was open where it was made
    closes, or at each exit if none was."""

    __slots__ = ("name", "_tracer", "_parent", "calls", "ns", "self_ns",
                 "_t0", "_child0", "_bridge0", "_own_bridge_ns",
                 "_annotation")

    def __init__(self, name: str, tracer: "Tracer", parent: Span | None):
        self.name = name
        self._tracer = tracer
        self._parent = parent
        self.calls = self.ns = self.self_ns = 0
        self._annotation = None

    def __enter__(self) -> "LoopSpan":
        p = self._parent
        if p is not None:
            self._child0 = p._child_ns
            self._bridge0 = p._bridge_ns
        if self._tracer.state.profiler_annotations:
            t = _now_ns()
            self._annotation = self._tracer._enter_annotation(self.name)
            self._t0 = _now_ns()
            self._own_bridge_ns = self._t0 - t
        else:
            self._t0 = _now_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = _now_ns()
        dur = t1 - self._t0
        bridge = 0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
            bridge = self._own_bridge_ns + _now_ns() - t1
        inner = 0
        p = self._parent
        if p is not None:
            # Spans closed inside it were counted as the parent's children;
            # they are its own, and it is the parent's child in their place.
            dur -= p._bridge_ns - self._bridge0
            inner = p._child_ns - self._child0
            p._child_ns = self._child0 + dur
            p._bridge_ns += bridge
        self.calls += 1
        self.ns += dur
        self.self_ns += dur - inner
        if p is None:
            self._flush()
        return False

    def _flush(self) -> None:
        if self.calls:
            self._tracer._add_totals(self.name, self.calls, self.ns,
                                     self.self_ns)
            self.calls = self.ns = self.self_ns = 0


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Owns the finished-span ring buffer and adds the per-span totals to
    ``registry``, whose on/off state it shares; usually one per process."""

    def __init__(self, registry: MetricsRegistry, max_spans: int = 4096):
        self.state = registry.state
        self.registry = registry
        self._spans: deque = deque(maxlen=max_spans)
        self._span_counter = itertools.count(1)
        #: name -> its (calls, ns, self_ns) counters, bound at its first close
        self._totals: dict = {}

    def span(self, name: str, trace_id: str | None = None, **attrs):
        """Open a span. ``trace_id=None`` inherits from the enclosing span
        (minting a fresh id at top level); pass it explicitly to re-root a
        trace on another thread."""
        if not self.state.enabled:
            return _NOOP_SPAN
        parent = _current_span.get()
        if parent is None:
            return Span(name,
                        _mint_trace_id() if trace_id is None else trace_id,
                        next(self._span_counter), None, attrs, self)
        return Span(name, parent.trace_id if trace_id is None else trace_id,
                    next(self._span_counter), parent.span_id, attrs, self,
                    parent)

    def current_trace_id(self) -> str | None:
        s = _current_span.get()
        return s.trace_id if s is not None else None

    def sync_clock(self) -> int:
        """Resample the monotonic-to-Unix offset (see the module
        docstring); -> the offset in ns."""
        global _unix_offset_ns
        _unix_offset_ns = _sample_unix_offset()
        return _unix_offset_ns

    def loop_span(self, name: str):
        """A :class:`LoopSpan` for the span open on this thread (the shared
        no-op span when disabled)."""
        if not self.state.enabled:
            return _NOOP_SPAN
        parent = _current_span.get()
        if parent is not None and parent._thread != _thread_id():
            parent = None
        loop = LoopSpan(name, self, parent)
        if parent is not None:
            if parent._loops is None:
                parent._loops = [loop]
            else:
                parent._loops.append(loop)
        return loop

    def _record(self, span: Span, bridge: int) -> None:
        """Keep a closed span and add it to its totals; ``bridge`` is what
        its own annotation cost around it."""
        dur = span.t_end_ns - span.t_start_ns - span._bridge_ns
        parent = span._parent
        if parent is not None:
            span._parent = None
            if parent._thread == span._thread:
                parent._child_ns += dur
                parent._bridge_ns += span._bridge_ns + bridge
        # deque.append is atomic; readers copy the deque in one C call.
        self._spans.append(span)
        if span._loops is not None:
            for loop in span._loops:
                loop._parent = None      # later uses flush at their exit
                loop._flush()
            span._loops = None
        if self.state.enabled:
            self._add_totals(span.name, 1, dur, dur - span._child_ns)

    def _add_totals(self, name: str, calls: int, ns: int,
                    self_ns: int) -> None:
        c = self._totals.get(name) or self._bind(name)
        with _TOTALS_LOCK:
            c[0]._value += calls
            c[1]._value += ns
            c[2]._value += self_ns

    def _bind(self, name: str) -> tuple:
        """-> ``name``'s (calls, ns, self_ns) counters. Registering is
        idempotent: two threads binding one name at once get the same
        counters."""
        get = self.registry._get
        c = self._totals[name] = (
            get(f"span.{name}.calls", _SpanTotal,
                help=f"closed {name} spans"),
            get(f"span.{name}.ns", _SpanTotal,
                help=f"{name} span nanoseconds"),
            get(f"span.{name}.self_ns", _SpanTotal,
                help=f"{name} span nanoseconds outside its direct children "
                     "on the same thread"),
        )
        return c

    def _enter_annotation(self, name: str):
        global _record_function
        if _record_function is None:
            try:
                from torch.profiler import record_function
            except Exception:  # pragma: no cover - torch always present
                return None
            _record_function = record_function
        a = _record_function(name)
        a.__enter__()
        return a

    # -- reading ---------------------------------------------------------------

    def recent_spans(self, limit: int = 100) -> list:
        """Most recent finished spans, newest last."""
        spans = list(self._spans)
        return spans[-limit:]

    def trace_summary(self, trace_id: str | None = None) -> dict:
        """All retained spans for one trace, in start order.

        ``trace_id=None`` summarizes the most recently finished trace.
        Wall attribution: ``wall_s`` is the duration of the trace's earliest
        root span-start to its latest span-end (spans on other threads count).
        """
        spans = list(self._spans)
        if trace_id is None:
            if not spans:
                return {"trace_id": None, "spans": [], "wall_s": 0.0}
            trace_id = spans[-1].trace_id
        mine = sorted((s for s in spans if s.trace_id == trace_id),
                      key=lambda s: s.t_start_ns)
        wall = (max(s.t_end_ns for s in mine)
                - min(s.t_start_ns for s in mine)) * 1e-9 if mine else 0.0
        return {
            "trace_id": trace_id,
            "spans": [s.to_json() for s in mine],
            "wall_s": wall,
        }

    def reset(self) -> None:
        self._spans.clear()
