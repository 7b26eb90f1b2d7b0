"""Resumable corpus jobs: checkpointed shard-by-shard scans.

A :class:`CorpusJob` executes one :class:`~repro_torch.scanservice.CorpusManifest`
against one compiled pattern set, writing each shard's hit matrix to its own
atomically-renamed ``.npz`` the moment it finishes. Killing the process
between shards (or mid-write — the rename is the commit point) loses at most
the shard in flight: a new ``CorpusJob`` pointed at the same work directory
verifies it is resuming the *same* work (content digest over corpus +
patterns recorded in ``job.json``), skips every finished shard, and scans
only the remainder. Because every shard scans independently through the same
exact automaton semantics, the aggregated hit matrix and census are
byte-identical whether the job ran straight through or was killed and
resumed — and even if the resuming process picked a different backend, or
the other package: every backend is bit-identical, and the digest below is
the reference package's, so a job begun by one package resumes in the
other.

The job digest deliberately excludes the execution plan: plans change *how*
(backend, device, chunking), never *what*, so a resume may e.g. move from
the CPU to the card without invalidating finished shards.

Every shard checkpoint also carries its *telemetry*: a
:class:`~repro_torch.obs.FlightRecorder` in the work directory appends one
registry delta record per scanned shard (plus the shard's spans), so a
worker killed mid-job leaves a merge-ready trail behind. Because the
deterministic per-shard metrics (``jobs.shards_scanned``,
``jobs.items_scanned``, the ``jobs.shard_items`` histogram) move by
exactly the shard's item count, merging the per-shard deltas
(:meth:`CorpusJob.flight_totals`, via :func:`repro_torch.obs.merge_records`)
reproduces the uninterrupted job's ``jobs.*`` totals bit-exactly however
the job was killed and resumed — the multi-host aggregation story,
executed locally first.

Layout::

    <workdir>/job.json               # version, digest, ids, n_shards
    <workdir>/shards/shard_00007.npz # hits: (P, shard_items) bool
    <workdir>/flight/flight.jsonl    # per-shard metric deltas + spans
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import obs
from ..construction import dfa_cache_key
from ..engine import ScanPlan, Scanner, ScanResult
from ..obs.aggregate import merge_records
from ..obs.flight import FlightRecorder, read_flight
from .corpus import CorpusManifest, scan_shard

JOB_VERSION = 1

#: ``jobs.shard_items`` bucket edges: shard sizes are item counts, not
#: seconds, so the default (time) edges don't apply. Powers of two up to
#: the largest shards a manifest realistically cuts.
SHARD_ITEM_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                    1024, 4096, 16384, 65536)


@dataclass(frozen=True)
class JobReport:
    """Outcome of one :meth:`CorpusJob.run` call."""

    n_shards: int
    done_before: int       # shards already checkpointed when run() started
    scanned: int           # shards scanned (and checkpointed) by this call
    complete: bool

    @property
    def done(self) -> int:
        return self.done_before + self.scanned


class CorpusJob:
    """One resumable scan of a sharded corpus. See module docstring."""

    def __init__(self, patterns, manifest: CorpusManifest, workdir,
                 plan: ScanPlan | None = None,
                 stream_threshold: int | None = None,
                 flight: bool = True,
                 flight_interval_s: float | None = None):
        self.manifest = manifest
        self.workdir = Path(workdir)
        self.stream_threshold = stream_threshold
        self._shard_dir = self.workdir / "shards"
        self._shard_dir.mkdir(parents=True, exist_ok=True)
        # The job owns one trace id for its whole lifetime: the compile here
        # and every shard span in run() carry it, so a resumed job's spans
        # correlate with the original compile in the event log.
        with obs.span("jobs.compile") as sp:
            self.trace_id = sp.trace_id if sp is not None else None
            # Compilation runs through the plan's cache tiers, so a resuming
            # process with a persistent store pays zero construction rounds.
            self.scanner = Scanner.compile(patterns, plan)
        self._check_or_write_meta()
        # Flight recorder: created *after* the compile so its delta base
        # excludes construction — shard records then carry exactly shard
        # work, the additivity the kill/resume merge acceptance relies on.
        # ``flight_interval_s`` additionally ticks a background record
        # during long shards (run() starts/stops the thread).
        self.flight = FlightRecorder(
            self.flight_path, interval_s=flight_interval_s, label="corpus_job"
        ) if flight else None

    # -- metadata ------------------------------------------------------------

    def digest(self) -> str:
        """Content hash of *what* this job computes: corpus + patterns.
        Plan knobs are excluded on purpose (see module docstring)."""
        h = hashlib.sha256()
        h.update(f"job-v{JOB_VERSION}|".encode())
        h.update(self.manifest.digest().encode())
        for d in self.scanner._dfas:
            h.update(b"|")
            h.update(dfa_cache_key(d).encode())
        return h.hexdigest()

    def _check_or_write_meta(self) -> None:
        meta_path = self.workdir / "job.json"
        digest = self.digest()
        if meta_path.exists():
            try:
                meta = json.loads(meta_path.read_text())
            except ValueError:
                meta = {}
            if meta.get("version") != JOB_VERSION or \
                    meta.get("digest") != digest:
                raise ValueError(
                    f"work directory {self.workdir} belongs to a different "
                    "job (corpus or pattern set changed); point the job at "
                    "a fresh directory or delete the old one"
                )
            return
        tmp = meta_path.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps({
            "version": JOB_VERSION,
            "digest": digest,
            "ids": list(self.scanner.ids),
            "kind": self.manifest.kind,
            "n_shards": self.manifest.n_shards,
            "n_items": self.manifest.n_items,
        }, indent=1))
        os.replace(tmp, meta_path)

    @property
    def flight_path(self) -> Path:
        return self.workdir / "flight" / "flight.jsonl"

    # -- shard bookkeeping ---------------------------------------------------

    def _shard_path(self, shard: int) -> Path:
        return self._shard_dir / f"shard_{shard:05d}.npz"

    def _load_shard(self, shard: int) -> np.ndarray | None:
        """A finished shard's hits, or None (missing / unreadable / wrong
        shape — unreadable checkpoints are re-scanned, never fatal)."""
        path = self._shard_path(shard)
        start, stop = self.manifest.shard_range(shard)
        try:
            with np.load(path) as z:
                hits = np.asarray(z["hits"], dtype=bool)
        except Exception:
            return None
        if hits.shape != (self.scanner.n_patterns, stop - start):
            return None
        return hits

    def _shard_ready(self, shard: int) -> bool:
        """Cheap completeness probe: the checkpoint's zip directory must be
        intact and name the hits array — no payload read (aggregate() does
        the full load + shape check once, at the end)."""
        try:
            with np.load(self._shard_path(shard)) as z:
                return "hits" in z.files
        except Exception:
            return False

    def pending(self) -> list:
        """Shard indices not yet validly checkpointed, in scan order."""
        return [s for s in range(self.manifest.n_shards)
                if not self._shard_ready(s)]

    @property
    def complete(self) -> bool:
        return not self.pending()

    # -- execution -----------------------------------------------------------

    def run(self, max_shards: int | None = None) -> JobReport:
        """Scan up to ``max_shards`` pending shards (all, by default),
        checkpointing each one atomically as it finishes. With the flight
        recorder on (default), every checkpoint also appends the shard's
        registry delta to the work directory's flight trail."""
        todo = self.pending()
        done_before = self.manifest.n_shards - len(todo)
        scanned = 0
        if self.flight is not None:
            # Flush anything that moved since the last record (other work
            # between construction and run) into a non-shard record, so
            # each shard record below is the shard's work alone.
            self.flight.record(label="jobs.pre_run", force=False)
            if self.flight.interval_s is not None:
                self.flight.start()
        try:
            for shard in todo:
                if max_shards is not None and scanned >= max_shards:
                    break
                start, stop = self.manifest.shard_range(shard)
                with obs.span("jobs.shard", trace_id=self.trace_id,
                              shard=shard):
                    hits = scan_shard(self.scanner, self.manifest, shard,
                                      stream_threshold=self.stream_threshold)
                    path = self._shard_path(shard)
                    tmp = path.with_suffix(f".tmp.{os.getpid()}")
                    with open(tmp, "wb") as f:
                        np.savez(f, hits=hits)
                    os.replace(tmp, path)   # commit point
                obs.counter("jobs.shards_scanned",
                            help="corpus shards scanned to completion").inc()
                # Deterministic per-shard quantities: these move by exactly
                # the shard's item count, so per-shard flight deltas merge
                # to the same totals however a job is killed and resumed.
                obs.counter("jobs.items_scanned",
                            help="corpus items (documents or windows) "
                                 "scanned").inc(stop - start)
                obs.histogram("jobs.shard_items", edges=SHARD_ITEM_EDGES,
                              help="items per scanned shard"
                              ).observe(stop - start)
                if self.flight is not None:
                    self.flight.record(shard=shard, items=stop - start)
                scanned += 1
        finally:
            if self.flight is not None:
                self.flight.stop()
        return JobReport(
            n_shards=self.manifest.n_shards,
            done_before=done_before,
            scanned=scanned,
            complete=done_before + scanned == self.manifest.n_shards,
        )

    # -- aggregation ---------------------------------------------------------

    def flight_records(self) -> list:
        """Every record on this job's flight trail (rotations included,
        oldest first) — shard deltas, span records, periodic ticks."""
        return read_flight(self.flight_path)

    def flight_totals(self, prefix: str | None = "jobs",
                      shards_only: bool = True) -> dict:
        """Merge the flight trail's shard deltas into one fleet record.

        The default view keeps only shard-stamped records and the
        deterministic ``jobs.*`` metrics, which is the exact-reproduction
        contract: however the job was killed and resumed (even across
        processes appending to the same trail), the merged counters and
        histograms equal the uninterrupted run's bit-for-bit. Pass
        ``prefix=None``/``shards_only=False`` for the kitchen-sink merge
        (wall-time histograms included — informative, not deterministic).
        """
        recs = [r for r in self.flight_records()
                if r.get("kind") == "flight"
                and (not shards_only or "shard" in r)]
        return merge_records(recs, prefix=prefix)

    def aggregate(self) -> ScanResult:
        """Concatenate every shard's hits -> ``(P, n_items)``
        :class:`~repro_torch.engine.ScanResult` (``.counts`` is the census).
        Raises if any shard is still pending."""
        parts = []
        missing = []
        for shard in range(self.manifest.n_shards):
            hits = self._load_shard(shard)
            if hits is None:
                missing.append(shard)
            else:
                parts.append(hits)
        if missing:
            raise RuntimeError(
                f"job incomplete: shards {missing} pending — call run() first"
            )
        return ScanResult(hits=np.concatenate(parts, axis=1),
                          ids=self.scanner.ids)

    def census(self) -> np.ndarray:
        """Aggregated per-pattern hit counts over the whole corpus."""
        return self.aggregate().counts
