"""Unified observability: process-wide metrics + span tracing.

One registry and one tracer per process, addressed through module-level
helpers so instrumentation sites stay one-liners::

    from repro_torch import obs

    obs.counter("cache.sfa.hits").inc()
    with obs.span("construct_bank", patterns=P):
        ...
    print(obs.render_prometheus(obs.snapshot()))

Observability is **enabled by default** (overhead is a handful of counter
increments and clock reads per span). Every span closed adds to three
counters of the registry, ``span.<name>.calls``, ``span.<name>.ns`` and
``span.<name>.self_ns`` (:mod:`repro_torch.obs.tracing`), so a span's time
reaches any reader of :func:`snapshot`; :func:`loop_span` adds to the same
counters from inside a hot loop, keeping no record of each pass.
``obs.disable()`` turns every mutator into a single attribute-check early
return and ``obs.span`` and ``obs.loop_span`` into a shared no-op context
manager; scan/construct results are
bit-identical either way (asserted in ``tests/test_torch_obs.py``).

``obs.configure(profiler_annotations=True)`` additionally bridges each span
into ``torch.profiler.record_function`` so spans appear on the host
timeline of ``torch.profiler`` traces (``chip_smoke.py --profile`` turns
this on), and resamples the offset that puts exported spans
(``t_start_unix_ns``, ``t_end_unix_ns``) on the profiler's clock.

The ``kernels.<op>.calls`` counters count wrapper calls that launched a
kernel or ran its plain version, one per call. The reference package's
counters of the same names count jit trace events, not executions, so the
two packages' ``kernels.*`` values are not comparable.

Metric namespace (see README "Observability" for the full table):

==============================  ============================================
prefix                          owner
==============================  ============================================
``engine.*``                    ``repro_torch.engine.scanner`` compile/scan path
``construction.*``              ``repro_torch.construction.batched`` round loop
``cache.sfa.*``                 ``repro_torch.construction.cache.SFACache``
``store.artifact.*``            ``repro_torch.scanservice.store.ArtifactStore``
``scheduler.*``                 ``repro_torch.scanservice.scheduler``
``speculative.*``               speculative validate/repair executor
``jobs.*``                      ``repro_torch.scanservice.jobs.CorpusJob``
``kernels.*``                   ``repro_torch.kernels.ops`` dispatch wrappers
``span.<name>.*``               the tracer: ``calls``, ``ns``, ``self_ns``
==============================  ============================================
"""

from __future__ import annotations

from .export import (  # noqa: F401
    parse_prometheus,
    read_jsonl,
    snapshot_record,
    span_records,
    write_jsonl,
)
from .export import render_prometheus as _render_prometheus
from .registry import (  # noqa: F401
    DEFAULT_EDGES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ObsState,
    snapshot_delta,
)
from .tracing import LoopSpan, Span, Tracer  # noqa: F401

#: Shared on/off state — the registry and tracer check the same flag.
_state = ObsState()
registry = MetricsRegistry(_state)
tracer = Tracer(registry)

# Fleet-layer helpers build on the globals above, so they import after.
from .flight import FlightRecorder, read_flight  # noqa: E402,F401

#: Lazily re-exported from :mod:`repro_torch.obs.aggregate` (PEP 562): eager
#: package import would trip runpy's double-import warning every time the
#: aggregation CLI runs as ``python -m repro_torch.obs.aggregate``.
_AGGREGATE_NAMES = ("DEFAULT_GAUGE_POLICIES", "merge_records",
                    "merge_snapshots")


def __getattr__(name: str):
    if name in _AGGREGATE_NAMES:
        from . import aggregate
        return getattr(aggregate, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


def enabled() -> bool:
    return _state.enabled


def configure(*, enabled: bool | None = None,
              profiler_annotations: bool | None = None) -> None:
    if enabled is not None:
        _state.enabled = enabled
    if profiler_annotations is not None:
        _state.profiler_annotations = profiler_annotations
        if profiler_annotations:
            tracer.sync_clock()


def counter(name: str, help: str | None = None) -> Counter:
    return registry.counter(name, help=help)


def gauge(name: str, help: str | None = None) -> Gauge:
    return registry.gauge(name, help=help)


def histogram(name: str, edges=None, help: str | None = None) -> Histogram:
    return registry.histogram(name, edges, help=help)


def render_prometheus(snapshot: dict, help_texts: dict | None = None) -> str:
    """Prometheus text for ``snapshot``; ``# HELP`` lines default to the
    live registry's registered descriptions (pass ``help_texts={}`` to
    suppress, or an explicit mapping to override)."""
    if help_texts is None:
        help_texts = registry.help_texts()
    return _render_prometheus(snapshot, help_texts)


#: ``span(name, trace_id=None, **attrs)``: :meth:`Tracer.span` of the
#: process's tracer (bound once: a span site pays no extra call).
span = tracer.span

#: ``loop_span(name)``: :meth:`Tracer.loop_span`, a span site for a hot
#: loop (totals and the bridge, no record in the ring buffer).
loop_span = tracer.loop_span


def current_trace_id() -> str | None:
    return tracer.current_trace_id()


def snapshot(prefix: str | None = None) -> dict:
    return registry.snapshot(prefix)


def trace_summary(trace_id: str | None = None) -> dict:
    return tracer.trace_summary(trace_id)


def recent_spans(limit: int = 100) -> list:
    return tracer.recent_spans(limit)


def reset() -> None:
    """Zero all metrics (the span totals too) and drop retained spans
    (enabled flag unchanged)."""
    registry.reset()
    tracer.reset()
