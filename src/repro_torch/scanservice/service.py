"""The :class:`ScanService` facade: store + scheduler + jobs as one object.

This is the serving layer's front door (also reachable as
``Scanner.service(...)``). It owns:

* an :class:`~repro_torch.scanservice.ArtifactStore` (when ``store_dir`` is
  given) attached as the persistent tier under one
  :class:`~repro_torch.construction.SFACache`, so every compile the service
  performs — direct, coalesced, or inside a corpus job — reads and writes
  the same two-tier cache. A fresh process pointed at the same store
  compiles previously-seen patterns with zero construction rounds;
  :meth:`ScanService.warm_start` bulk-promotes the store into memory up
  front so even first requests skip the disk tier.
* a :class:`~repro_torch.scanservice.BatchScheduler` coalescing concurrent
  ``submit`` calls into fused bank compiles + scans;
* a :class:`~repro_torch.scanservice.CorpusJob` factory binding jobs to the
  service's plan (and therefore its cache tiers).
"""

from __future__ import annotations

from dataclasses import asdict

from .. import obs
from ..construction import SFACache
from ..engine import ChunkPolicy, ConstructionPolicy, ScanPlan, Scanner
from .corpus import CorpusManifest
from .jobs import CorpusJob
from .scheduler import BatchScheduler, Ticket
from .store import ArtifactStore
from .telemetry import TelemetryServer


class ScanService:
    """A scan-serving endpoint. See module docstring."""

    def __init__(self, store_dir=None, plan: ScanPlan | None = None, *,
                 cache: SFACache | None = None,
                 store_max_bytes: int = 1 << 30,
                 driver: str = "sync", window_s: float = 0.002,
                 max_batch: int = 64, max_scanners: int = 32):
        if store_dir is None:
            self.store = None
        elif isinstance(store_dir, ArtifactStore):
            self.store = store_dir
        else:
            self.store = ArtifactStore(store_dir, max_bytes=store_max_bytes)
        self.cache = cache if cache is not None else SFACache()
        self.cache.attach_backing(self.store)
        if plan is not None:
            # Respect the caller's plan, but reroute it through the
            # service's cache tiers — including its store: a plan naming a
            # *different* store would silently rebind the service's cache
            # away from `self.store` on the first compile.
            overrides = {"cache": self.cache}
            if self.store is not None:
                overrides["store"] = self.store
            self.plan = plan.with_(
                construction=plan.construction.with_(**overrides)
            )
        else:
            self.plan = ScanPlan(
                chunking=ChunkPolicy(bucket=True),
                construction=ConstructionPolicy(
                    cache=self.cache, method="batched"
                ),
            ).validate()
        if self.store is not None and \
                self.plan.speculation.profile_source == "sample":
            # A persistent store upgrades speculation to persisted hot-state
            # profiles (keyed like the SFA artifacts): patterns profiled by
            # any earlier process speculate well from the first request.
            self.plan = self.plan.with_(
                speculation=self.plan.speculation.with_(profile_source="store")
            )
        self.scheduler = BatchScheduler(
            self.plan, driver=driver, window_s=window_s, max_batch=max_batch,
            max_scanners=max_scanners,
        )
        self.telemetry: TelemetryServer | None = None

    # -- cache tiers ---------------------------------------------------------

    def warm_start(self, max_entries: int | None = None) -> int:
        """Preload the persistent tier into memory. -> entries promoted."""
        return self.cache.preload(max_entries)

    def scanner(self, patterns, **overrides) -> Scanner:
        """Compile patterns through the service's plan and cache tiers."""
        return Scanner.compile(patterns, self.plan, **overrides)

    # -- request path --------------------------------------------------------

    def submit(self, patterns, docs) -> Ticket:
        return self.scheduler.submit(patterns, docs)

    def flush(self) -> int:
        return self.scheduler.flush()

    # -- observability -------------------------------------------------------

    def serve_telemetry(self, port: int = 0,
                        host: str = "127.0.0.1") -> TelemetryServer:
        """Start the HTTP telemetry front (``/metrics``, ``/healthz``,
        ``/traces``) bound to this service. ``port=0`` picks an ephemeral
        port — read it off the returned server's ``.port``/``.url``. The
        server stops with :meth:`close` (or its own ``.close()``); starting
        a second one while the first runs raises."""
        if self.telemetry is not None and self.telemetry.running:
            raise RuntimeError(
                f"telemetry already serving on {self.telemetry.url}; "
                "close it before starting another"
            )
        self.telemetry = TelemetryServer(self, host=host, port=port).start()
        return self.telemetry

    def metrics(self, trace_id: str | None = None) -> dict:
        """One correlated observability snapshot of the whole service.

        Everything in the returned dict is read at the same moment:

        * ``"cache"`` — the two-tier SFA cache counters plus the derived
          hit rate;
        * ``"scheduler"`` — an atomic :class:`SchedulerStats` copy (see the
          thread-driver consistency contract there);
        * ``"registry"`` — the full process-wide metric snapshot
          (``construction.*``, ``speculative.*``, ``store.artifact.*`` …);
        * ``"trace"`` — the span summary for ``trace_id`` (default: the
          last flush's trace), with two pre-digested views: per-bucket
          construction rounds/walls (from the ``construct_bank.bucket``
          spans) and the speculative span walls — the "where did this
          request's time go" answer, keyed by the same trace id the
          request's :class:`Ticket` carries.
        """
        if trace_id is None:
            trace_id = self.scheduler.last_trace_id
        info = self.cache.info.snapshot()
        looked = info["hits"] + info["misses"]
        cache = {**info,
                 "hit_rate": info["hits"] / looked if looked else 0.0}
        trace = (obs.trace_summary(trace_id) if trace_id is not None
                 else {"trace_id": None, "spans": [], "wall_s": 0.0})
        buckets = [
            {**sp["attrs"], "wall_s": sp["wall_s"]}
            for sp in trace["spans"] if sp["name"] == "construct_bank.bucket"
        ]
        speculative = [
            {**sp["attrs"], "wall_s": sp["wall_s"]}
            for sp in trace["spans"]
            if sp["name"].startswith("speculative.")
        ]
        return {
            "trace": {**trace, "construction_buckets": buckets,
                      "speculative_spans": speculative},
            "cache": cache,
            "scheduler": asdict(self.scheduler.stats),
            "registry": obs.snapshot(),
        }

    # -- corpus jobs ---------------------------------------------------------

    def corpus_job(self, patterns, manifest: CorpusManifest, workdir,
                   **kwargs) -> CorpusJob:
        """A resumable job running under the service's plan (and cache)."""
        return CorpusJob(patterns, manifest, workdir, plan=self.plan, **kwargs)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        self.scheduler.close()

    def __enter__(self) -> "ScanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
