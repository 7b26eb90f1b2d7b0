"""The scan service: a serving layer on top of the ``Scanner`` engine.

The paper's speedups come from never recomputing what can be cached —
fingerprints stand in for state sets so construction work is done once and
reused. :mod:`repro_torch.engine` realizes that within a process (the
content-addressed :class:`~repro_torch.construction.SFACache`); this package
extends it across processes, requests, and corpora:

* :mod:`.store` — :class:`ArtifactStore`, the persistent disk tier under
  the SFA cache: atomic versioned npz+sidecar artifacts keyed by the
  canonical DFA hash + base polynomial, blowup markers, LRU by bytes, and
  warm-start preloading. A fresh process compiling previously-seen patterns
  performs zero construction rounds.
* :mod:`.scheduler` — :class:`BatchScheduler`, the coalescing micro-batch
  scheduler: concurrent ``submit(patterns, docs)`` requests become one
  union-bank compile (one :func:`~repro_torch.construction.construct_bank` call
  for all cache misses) plus one fused, size-bucketed bank scan, demuxed
  per request bit-identically to per-request ``Scanner.scan``.
* :mod:`.corpus` / :mod:`.jobs` — :class:`CorpusManifest` +
  :class:`CorpusJob`, resumable corpus scans: sharded manifests (document
  corpora or sliding-window sequences), per-shard execution through the
  streaming and prefix-scan-census paths, atomically checkpointed shard
  results, and byte-identical aggregates across kill/resume.
* :mod:`.service` — :class:`ScanService`, the facade tying the three
  together (also reachable as ``Scanner.service(...)``).
* :mod:`.telemetry` — :class:`TelemetryServer`, the stdlib HTTP front
  serving ``/metrics`` (Prometheus text of the live registry),
  ``/healthz`` (scheduler + cache + store state), and ``/traces``
  (recent per-trace span summaries); owned via
  ``ScanService.serve_telemetry(port=...)``.
"""

from .corpus import CorpusManifest, default_stream_threshold, scan_shard
from .jobs import JOB_VERSION, CorpusJob, JobReport
from .scheduler import (
    DRIVERS,
    BatchScheduler,
    RequestResult,
    SchedulerStats,
    Ticket,
)
from .service import ScanService
from .store import STORE_VERSION, ArtifactStore
from .telemetry import TelemetryServer

__all__ = [
    "ArtifactStore",
    "BatchScheduler",
    "CorpusJob",
    "CorpusManifest",
    "DRIVERS",
    "JOB_VERSION",
    "JobReport",
    "RequestResult",
    "STORE_VERSION",
    "ScanService",
    "SchedulerStats",
    "TelemetryServer",
    "Ticket",
    "default_stream_threshold",
    "scan_shard",
]
