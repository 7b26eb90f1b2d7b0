"""Coalescing batch scheduler: many concurrent scan requests, one bank.

A serving process sees a stream of small, overlapping requests — a few
patterns each against a few documents. Compiling and scanning each request
alone wastes exactly what the paper says to amortize: automaton setup and
per-call dispatch. The scheduler coalesces every request that lands inside a
micro-batch window into **one** compile of the union pattern bank (all cache
misses constructed in a single :func:`repro_torch.construction.construct_bank`
call, size-bucketed through the plan's chunking policy) and **one** fused
bank scan over the union document set, then demultiplexes the hit matrix
back per request. Since every backend computes the same exact automaton
semantics and documents scan independently, the demuxed slices are
bit-identical to per-request ``Scanner.scan`` — coalescing is pure
amortization, never an approximation.

Two drivers share the batching core:

* ``driver="sync"`` — requests queue until :meth:`BatchScheduler.flush`
  (or a full ``max_batch``, or ``Ticket.result()``) processes them on the
  calling thread. No threads anywhere — the deterministic driver the test
  suite uses.
* ``driver="thread"`` — a worker thread closes each batch ``window_s``
  after its first request (earlier when ``max_batch`` fills);
  ``submit`` returns immediately and ``Ticket.result()`` blocks.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace

import numpy as np

from .. import obs
from ..construction import dfa_cache_key
from ..core.dfa import DFA
from ..engine import ChunkPolicy, ConstructionPolicy, ScanPlan, Scanner

DRIVERS = ("sync", "thread")


def _default_plan() -> ScanPlan:
    # Union banks coalesce many requests' patterns, so they are exactly the
    # big, size-skewed banks size-bucketed construction exists for — submit
    # them bucketed explicitly rather than leaning on the "auto" heuristic.
    return ScanPlan(
        chunking=ChunkPolicy(bucket=True),
        construction=ConstructionPolicy(method="batched", bucketing="size"),
    )


@dataclass(frozen=True)
class RequestResult:
    """One request's demuxed slice of a coalesced batch scan."""

    hits: np.ndarray      # (P_req, D_req) bool
    ids: tuple            # this request's pattern ids
    batch_size: int       # requests that shared the flush

    @property
    def counts(self) -> np.ndarray:
        return np.sum(self.hits, axis=1, dtype=np.int32)


class Ticket:
    """Handle for one submitted request; redeem with :meth:`result`.

    ``trace_id`` is the request's observability correlation key (captured
    at submit time, None with tracing disabled): every span the request's
    flush produces — scheduler.flush, scanner.compile, construct_bank
    rounds, store gets — carries it, so ``obs.trace_summary(t.trace_id)``
    reconstructs where this request's time went.
    """

    def __init__(self, scheduler: "BatchScheduler",
                 trace_id: str | None = None):
        self._scheduler = scheduler
        self.trace_id = trace_id
        self._event = threading.Event()
        self._result: RequestResult | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> RequestResult:
        """The request's :class:`RequestResult`. Under the sync driver an
        unflushed ticket flushes the scheduler first; under the thread
        driver this blocks until the worker closes the batch."""
        if not self._event.is_set() and self._scheduler.driver == "sync":
            self._scheduler.flush()
        if not self._event.wait(timeout):
            raise TimeoutError("scan request still pending")
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result: RequestResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


@dataclass
class SchedulerStats:
    """Point-in-time scheduler counters.

    ``BatchScheduler.stats`` returns an **atomic copy** taken under the
    scheduler's stats lock — under the thread driver, the worker increments
    these concurrently with readers, and a field-by-field read of a live
    object could see e.g. ``flushes`` from one flush and ``union_docs``
    from the next. Every mutation also mirrors into the process-wide
    ``scheduler.*`` registry metrics.
    """

    requests: int = 0
    flushes: int = 0
    max_coalesced: int = 0
    union_patterns: int = 0   # pattern columns actually compiled/scanned
    union_docs: int = 0       # documents actually scanned
    scanner_memo_hits: int = 0   # union batches answered by the scanner memo
    scanner_evictions: int = 0   # scanners dropped by the memo's LRU lid
    speculative_patterns: int = 0  # union columns routed to speculation


#: ``# HELP`` text for the mirrored ``scheduler.*`` counters (the gauge
#: describes itself at its callsite).
_STAT_HELP = {
    "requests": "scan requests submitted",
    "flushes": "coalesced batch flushes executed",
    "union_patterns": "distinct pattern columns compiled/scanned in "
                      "union banks",
    "union_docs": "distinct documents scanned in union batches",
    "scanner_memo_hits": "union batches answered by the memoized scanner",
    "scanner_evictions": "scanners dropped by the memo's LRU lid",
    "speculative_patterns": "union columns routed through speculation",
}


class _Request:
    __slots__ = ("keys", "ids", "specs", "doc_keys", "docs", "ticket")

    def __init__(self, keys, ids, specs, doc_keys, docs, ticket):
        self.keys = keys
        self.ids = ids
        self.specs = specs
        self.doc_keys = doc_keys
        self.docs = docs
        self.ticket = ticket


def _spec_key(spec) -> tuple:
    if isinstance(spec, str):
        return ("str", spec)
    if isinstance(spec, DFA):
        return ("dfa", dfa_cache_key(spec))
    raise TypeError(
        f"scheduler pattern specs must be str or DFA, got {type(spec).__name__}"
    )


def _doc_key(doc) -> tuple:
    if isinstance(doc, str):
        return ("str", doc)
    arr = np.asarray(doc, dtype=np.int32)
    return ("arr", arr.tobytes())


class BatchScheduler:
    """Coalesce concurrent ``submit(patterns, docs)`` calls into fused
    bank compiles + scans (see module docstring)."""

    def __init__(self, plan: ScanPlan | None = None, *, driver: str = "sync",
                 window_s: float = 0.002, max_batch: int = 64,
                 max_scanners: int = 32):
        if driver not in DRIVERS:
            raise ValueError(f"driver must be one of {DRIVERS}, got {driver!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if window_s < 0:
            raise ValueError("window_s must be >= 0")
        if max_scanners < 1:
            raise ValueError("max_scanners must be >= 1")
        self.plan = (plan or _default_plan()).validate()
        self.driver = driver
        self.window_s = window_s
        self.max_batch = max_batch
        self.max_scanners = max_scanners
        # All counter mutations go through _bump under this lock; the
        # ``stats`` property copies atomically under it (satisfying the
        # thread-driver snapshot-consistency contract).
        self._stats = SchedulerStats()
        self._stats_lock = threading.Lock()
        #: trace id of the most recent flush (None before any, or with
        #: tracing disabled) — what ``ScanService.metrics`` correlates on.
        self.last_trace_id: str | None = None
        self._pending: list = []
        self._cond = threading.Condition()
        self._first_ts: float | None = None
        self._stop = False
        # LRU memo of union-bank Scanners, bounded by ``max_scanners`` like
        # the SFA cache is bounded: a long-lived service sees an unbounded
        # stream of distinct union keys, and each Scanner pins device tables.
        # Guarded by its own lock — ``_run_batch`` runs outside ``_cond``.
        self._scanners: OrderedDict = OrderedDict()
        self._scanners_lock = threading.Lock()
        self._worker = None
        if driver == "thread":
            self._worker = threading.Thread(
                target=self._worker_loop, name="scan-batcher", daemon=True
            )
            self._worker.start()

    # -- stats ---------------------------------------------------------------

    @property
    def stats(self) -> SchedulerStats:
        """An atomic copy of the counters (see :class:`SchedulerStats`)."""
        with self._stats_lock:
            return replace(self._stats)

    @property
    def closed(self) -> bool:
        """True once :meth:`close` ran — new submits are refused. The
        telemetry ``/healthz`` endpoint reports this as the status."""
        with self._cond:
            return self._stop

    def _bump(self, **deltas) -> None:
        """Apply counter deltas atomically and mirror them into the
        ``scheduler.*`` registry namespace (``max_coalesced`` is a running
        max, exported as a gauge)."""
        with self._stats_lock:
            for name, d in deltas.items():
                if name == "max_coalesced":
                    self._stats.max_coalesced = max(
                        self._stats.max_coalesced, d
                    )
                    obs.gauge("scheduler.max_coalesced",
                              help="largest request count coalesced into "
                                   "one flush (running max; fleet merges "
                                   "by max)").set(
                        self._stats.max_coalesced
                    )
                else:
                    setattr(self._stats, name, getattr(self._stats, name) + d)
                    obs.counter(f"scheduler.{name}",
                                help=_STAT_HELP.get(name)).inc(d)

    # -- submission ----------------------------------------------------------

    def submit(self, patterns, docs) -> Ticket:
        """Enqueue one request: ``patterns`` is a str/DFA or a sequence of
        them, ``docs`` a str/encoded array or a sequence. -> :class:`Ticket`.
        """
        if isinstance(patterns, (str, DFA)):
            patterns = [patterns]
        patterns = list(patterns)
        if isinstance(docs, str) or (
            isinstance(docs, np.ndarray) and docs.ndim == 1
        ):
            docs = [docs]
        docs = list(docs)
        if not patterns or not docs:
            raise ValueError("submit needs at least one pattern and one doc")
        keys = tuple(_spec_key(p) for p in patterns)
        ids = tuple(
            p if isinstance(p, str) else f"pattern_{i}"
            for i, p in enumerate(patterns)
        )
        # Capture the request's trace id on the *caller's* thread: the
        # thread driver's worker has its own context, so _run_batch re-roots
        # its spans with this id explicitly.
        with obs.span("scheduler.submit", patterns=len(patterns),
                      docs=len(docs)) as sub_span:
            trace_id = sub_span.trace_id if sub_span is not None else None
        req = _Request(
            keys, ids, patterns, tuple(_doc_key(d) for d in docs), docs,
            Ticket(self, trace_id),
        )
        with self._cond:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            self._pending.append(req)
            # Nested under _cond deliberately: the request must be counted
            # before any flush that could serve it counts its own stats.
            self._bump(requests=1)
            if self._first_ts is None:
                self._first_ts = time.monotonic()
            self._cond.notify_all()
            full = len(self._pending) >= self.max_batch
        if self.driver == "sync" and full:
            self.flush()
        return req.ticket

    def flush(self) -> int:
        """Process everything pending as one coalesced batch (on the calling
        thread). -> number of requests served."""
        with self._cond:
            batch, self._pending = self._pending, []
            self._first_ts = None
        if batch:
            self._run_batch(batch)
        return len(batch)

    # -- the coalescing core -------------------------------------------------

    def _run_batch(self, batch: list) -> None:
        try:
            # Union patterns and docs, deduplicated by content.
            col_of: dict = {}
            union_specs: list = []
            for req in batch:
                for key, spec in zip(req.keys, req.specs):
                    if key not in col_of:
                        col_of[key] = len(union_specs)
                        union_specs.append(spec)
            doc_of: dict = {}
            union_docs: list = []
            for req in batch:
                for key, doc in zip(req.doc_keys, req.docs):
                    if key not in doc_of:
                        doc_of[key] = len(union_docs)
                        union_docs.append(doc)

            # Re-root the flush's spans on the first request's trace id
            # (submit captured it on the caller's thread; the thread
            # driver's worker doesn't inherit contextvars). The other
            # coalesced requests ride along as an attribute.
            trace_ids = [
                r.ticket.trace_id for r in batch
                if r.ticket.trace_id is not None
            ]
            with obs.span(
                "scheduler.flush",
                trace_id=trace_ids[0] if trace_ids else None,
                requests=len(batch),
                coalesced_trace_ids=tuple(trace_ids[1:]),
            ):
                self.last_trace_id = obs.current_trace_id()
                scanner = self._scanner_for(tuple(col_of), union_specs)
                result = scanner.scan(union_docs)   # ONE fused bank scan

            self._bump(
                flushes=1,
                max_coalesced=len(batch),
                union_patterns=len(union_specs),
                union_docs=len(union_docs),
                # Over-budget patterns route to the speculative tier through
                # the plan's auto mode (see repro_torch.speculative); count what
                # this batch actually served speculatively.
                speculative_patterns=sum(
                    1 for m in scanner.pattern_modes.values()
                    if m == "speculative"
                ),
            )
            obs.counter("scheduler.coalesced_requests",
                        help="requests answered by a coalesced union-bank "
                             "flush").inc(len(batch))

            for req in batch:
                rows = np.asarray([col_of[k] for k in req.keys])
                cols = np.asarray([doc_of[k] for k in req.doc_keys])
                req.ticket._resolve(RequestResult(
                    hits=result.hits[np.ix_(rows, cols)].copy(),
                    ids=req.ids,
                    batch_size=len(batch),
                ))
        except BaseException as exc:  # propagate to every waiter
            for req in batch:
                req.ticket._fail(exc)
            if self.driver == "sync":
                raise

    def _scanner_for(self, key_tuple: tuple, specs: list) -> Scanner:
        """LRU-memoized union-bank compile. Cold pattern sets still answer
        most construction from the plan's SFA cache tiers; this memo
        additionally skips re-stacking device tables for repeat batches. An
        evicted key recompiles (cheaply, through the SFA and round-compile
        caches) on its next batch."""
        with self._scanners_lock:
            sc = self._scanners.get(key_tuple)
            if sc is not None:
                self._scanners.move_to_end(key_tuple)
                hit = True
            else:
                hit = False
        if hit:
            self._bump(scanner_memo_hits=1)
            return sc
        sc = Scanner.compile(specs, self.plan)   # compile outside the lock
        evicted = 0
        with self._scanners_lock:
            self._scanners[key_tuple] = sc
            self._scanners.move_to_end(key_tuple)
            while len(self._scanners) > self.max_scanners:
                self._scanners.popitem(last=False)
                evicted += 1
        if evicted:
            self._bump(scanner_evictions=evicted)
        return sc

    # -- thread driver -------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if not self._pending and self._stop:
                    return
                # Window: wait for stragglers until the deadline/batch cap.
                while not self._stop and len(self._pending) < self.max_batch:
                    remaining = self._first_ts + self.window_s - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch, self._pending = self._pending, []
                self._first_ts = None
            self._run_batch(batch)

    def close(self) -> None:
        """Serve any queued requests, then stop accepting new ones."""
        if self.driver == "thread":
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._worker.join()
        else:
            self.flush()
            self._stop = True

    def __enter__(self) -> "BatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
