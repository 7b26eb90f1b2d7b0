"""The process-wide metrics registry: counters, gauges, histograms.

Every subsystem reports through one flat, hierarchically-*named* namespace
(``construction.rounds``, ``cache.sfa.hits``, ``scheduler.coalesced_requests``,
``speculative.hit_chunks`` …) so a single :meth:`MetricsRegistry.snapshot`
answers "what has this process done" across engine, construction, and the
scan service at once — the substrate :meth:`repro_torch.scanservice.ScanService.metrics`
reads its correlated report from.

Design constraints, in order:

* **Exactness of the scan engine is untouchable.** Metrics only ever
  *observe* host-side quantities (counts, walls); nothing here feeds back
  into any computation, so results are bit-identical with observability on
  or off (pinned by tests).
* **Disabled means free.** Every mutator starts with one attribute read of
  the module-wide :class:`ObsState`; when disabled it returns immediately —
  no allocation, no lock, no dict lookup. A service that turns observability
  off pays a single predicted branch per call site.
* **Thread-safe increments.** The scan service's thread driver increments
  the same counters as caller threads; each metric carries its own lock
  (increments are ns-scale, contention is per-metric, and a snapshot takes
  the registry lock plus each metric's lock briefly).

Metric kinds:

* :class:`Counter` — monotonically increasing integer (``inc``).
* :class:`Gauge` — last-write-wins float (``set``), for levels and rates.
* :class:`Histogram` — fixed bucket edges chosen **at creation** (changing
  edges mid-flight would corrupt aggregation); ``observe`` bisects into the
  first bucket whose edge is >= the value, with an implicit +Inf bucket.
  Exported cumulatively (Prometheus ``le`` convention) by
  :mod:`repro_torch.obs.export`.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass

#: Default histogram bucket edges (seconds): spans walls from microsecond
#: kernel dispatches to minute-scale cold constructions. Callers measuring
#: non-time quantities should pass explicit edges.
DEFAULT_EDGES = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


@dataclass
class ObsState:
    """The one flag every hot-path mutator checks first."""

    enabled: bool = True
    #: bridge spans into ``torch.profiler.record_function`` (profiler traces)
    profiler_annotations: bool = False


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "_value", "_lock", "_state")

    def __init__(self, name: str, state: ObsState):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        self._state = state

    def inc(self, n: int = 1) -> None:
        if not self._state.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("name", "_value", "_lock", "_state")

    def __init__(self, name: str, state: ObsState):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()
        self._state = state

    def set(self, v: float) -> None:
        if not self._state.enabled:
            return
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-edge histogram with an implicit +Inf overflow bucket.

    ``edges`` must be strictly increasing; ``observe(v)`` lands ``v`` in the
    first bucket whose edge is >= v (Prometheus ``le`` semantics).
    ``counts`` are per-bucket (*not* cumulative) with ``counts[-1]`` the
    +Inf bucket; the exporters cumulate.
    """

    __slots__ = ("name", "edges", "_counts", "_sum", "_count", "_lock",
                 "_state")

    def __init__(self, name: str, state: ObsState, edges=DEFAULT_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        if any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"histogram edges must be strictly increasing, "
                             f"got {edges}")
        self.name = name
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._state = state

    def observe(self, v: float) -> None:
        if not self._state.enabled:
            return
        v = float(v)
        i = bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def counts(self) -> tuple:
        with self._lock:
            return tuple(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._sum = 0.0
            self._count = 0


class MetricsRegistry:
    """One process's metric namespace. See module docstring.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    for a name fixes its kind (and a histogram's edges); later calls return
    the same object, and a kind mismatch raises — two subsystems silently
    aggregating into one name with different semantics is the bug this
    guards against.
    """

    def __init__(self, state: ObsState | None = None):
        self.state = state or ObsState()
        self._metrics: dict = {}
        self._help: dict = {}
        self._lock = threading.Lock()

    # -- get-or-create --------------------------------------------------------

    def _get(self, name: str, kind, help=None, **kwargs):
        with self._lock:
            if help is not None:
                # First description wins; later sites may omit it freely.
                self._help.setdefault(name, str(help))
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, self.state, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {kind.__name__}"
            )
        if kwargs.get("edges") is not None and \
                tuple(float(e) for e in kwargs["edges"]) != m.edges:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{m.edges}; edges are fixed at creation"
            )
        return m

    def counter(self, name: str, help: str | None = None) -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str | None = None) -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, edges=None,
                  help: str | None = None) -> Histogram:
        if edges is None:
            with self._lock:
                if help is not None:
                    self._help.setdefault(name, str(help))
                m = self._metrics.get(name)
            if isinstance(m, Histogram):
                return m
            edges = DEFAULT_EDGES
            help = None   # already registered above
        return self._get(name, Histogram, help=help, edges=edges)

    def help_texts(self) -> dict:
        """Registered metric descriptions (name -> ``# HELP`` text)."""
        with self._lock:
            return dict(self._help)

    # -- reading --------------------------------------------------------------

    def snapshot(self, prefix: str | None = None) -> dict:
        """Point-in-time copy of every metric (optionally under ``prefix.``),
        as plain JSON-serializable values:

        * counter -> int
        * gauge -> float
        * histogram -> {"edges": [...], "counts": [...], "sum": s, "count": n}
        """
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for name, m in items:
            if prefix and not (name == prefix or name.startswith(prefix + ".")):
                continue
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            else:
                out[name] = {
                    "edges": list(m.edges),
                    "counts": list(m.counts),
                    "sum": m.sum,
                    "count": m.count,
                }
        return out

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every metric (names, kinds, and histogram edges survive —
        a reset is a new measurement window, not a new schema)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()


def snapshot_delta(before: dict, after: dict) -> dict:
    """What moved between two :meth:`MetricsRegistry.snapshot` calls.

    Counters and gauges subtract; histograms subtract counts/sum per bucket.
    Names only in ``after`` pass through; names whose values did not change
    are dropped — the "what did this step actually touch" view.
    """
    out = {}
    for name, a in after.items():
        b = before.get(name)
        if isinstance(a, dict):  # histogram
            if b is None:
                d = dict(a)
            else:
                d = {
                    "edges": a["edges"],
                    "counts": [x - y for x, y in zip(a["counts"], b["counts"])],
                    "sum": a["sum"] - b["sum"],
                    "count": a["count"] - b["count"],
                }
            if d["count"]:
                out[name] = d
        else:
            d = a if b is None else a - b
            if d:
                out[name] = d
    return out
