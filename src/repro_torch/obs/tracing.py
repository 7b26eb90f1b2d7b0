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

When disabled, :func:`span` returns a shared no-op context manager: no
object allocation, no clock reads, no contextvar writes.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from .registry import ObsState

#: Current open span, per task/thread (None at top level).
_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None
)

_trace_counter = itertools.count(1)


def _mint_trace_id() -> str:
    # pid disambiguates several processes writing one JSONL.
    return f"t{os.getpid():x}-{next(_trace_counter):06x}"


@dataclass
class Span:
    """One finished (or open) timed region."""

    name: str
    trace_id: str
    span_id: int
    parent_id: int | None
    attrs: dict = field(default_factory=dict)
    t_start: float = 0.0
    t_end: float = 0.0

    @property
    def wall_s(self) -> float:
        return self.t_end - self.t_start

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "attrs": dict(self.attrs),
            "t_start": self.t_start,
            "wall_s": self.wall_s,
        }


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def set_attr(self, **attrs):  # parity with _LiveSpan's handle
        pass


_NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    """Context manager that times one region and records it on exit."""

    __slots__ = ("tracer", "span", "_token", "_annotation")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer = tracer
        self.span = span
        self._token = None
        self._annotation = None

    def __enter__(self) -> Span:
        self._token = _current_span.set(self.span)
        if self.tracer.state.profiler_annotations:
            self._annotation = self.tracer._enter_annotation(self.span.name)
        self.span.t_start = time.perf_counter()
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.span.t_end = time.perf_counter()
        if exc_type is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        _current_span.reset(self._token)
        self.tracer._record(self.span)
        return False


class Tracer:
    """Owns the finished-span ring buffer; usually one per process."""

    def __init__(self, state: ObsState | None = None, max_spans: int = 4096):
        self.state = state or ObsState()
        self._spans: deque = deque(maxlen=max_spans)
        self._span_counter = itertools.count(1)
        self._lock = threading.Lock()

    def span(self, name: str, trace_id: str | None = None, **attrs):
        """Open a span. ``trace_id=None`` inherits from the enclosing span
        (minting a fresh id at top level); pass it explicitly to re-root a
        trace on another thread."""
        if not self.state.enabled:
            return _NOOP_SPAN
        parent = _current_span.get()
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None \
                else _mint_trace_id()
        s = Span(
            name=name,
            trace_id=trace_id,
            span_id=next(self._span_counter),
            parent_id=parent.span_id if parent is not None else None,
            attrs=attrs,
        )
        return _LiveSpan(self, s)

    def current_trace_id(self) -> str | None:
        s = _current_span.get()
        return s.trace_id if s is not None else None

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def _enter_annotation(self, name: str):
        try:
            from torch.profiler import record_function
        except Exception:  # pragma: no cover - torch always present here
            return None
        a = record_function(name)
        a.__enter__()
        return a

    # -- reading ---------------------------------------------------------------

    def recent_spans(self, limit: int = 100) -> list:
        """Most recent finished spans, newest last."""
        with self._lock:
            spans = list(self._spans)
        return spans[-limit:]

    def trace_summary(self, trace_id: str | None = None) -> dict:
        """All retained spans for one trace, in start order.

        ``trace_id=None`` summarizes the most recently finished trace.
        Wall attribution: ``wall_s`` is the duration of the trace's earliest
        root span-start to its latest span-end (spans on other threads count).
        """
        with self._lock:
            spans = list(self._spans)
        if trace_id is None:
            if not spans:
                return {"trace_id": None, "spans": [], "wall_s": 0.0}
            trace_id = spans[-1].trace_id
        mine = sorted((s for s in spans if s.trace_id == trace_id),
                      key=lambda s: s.t_start)
        wall = (max(s.t_end for s in mine) - min(s.t_start for s in mine)) \
            if mine else 0.0
        return {
            "trace_id": trace_id,
            "spans": [s.to_json() for s in mine],
            "wall_s": wall,
        }

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
