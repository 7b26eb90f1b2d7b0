"""Flight recorder: a crash-surviving telemetry trail on disk.

A process that dies takes its metrics registry with it — the fleet view
loses exactly the worker whose last minutes mattered most. The
:class:`FlightRecorder` fixes that the way aircraft do: a background thread
(or explicit :meth:`FlightRecorder.record` calls at checkpoints) appends
the registry's :func:`snapshot_delta` since the previous record, plus every
span finished since then, to a JSONL file on disk. The trail is

* **size-bounded**: when the active file exceeds ``max_bytes`` it rotates
  (``flight.jsonl`` -> ``flight.jsonl.1`` -> ... up to ``max_files`` files,
  oldest dropped) — a long-lived service records forever in constant disk;
* **delta-structured**: each record is what moved since the last one, so
  the records are *additive* — :func:`repro_torch.obs.aggregate.merge_records`
  over any contiguous stretch reproduces the registry delta across that
  stretch exactly (counters and histograms bit-exact), which is what lets
  per-shard corpus-job records merge into the whole-job view, and a killed
  worker's partial trail merge with its successor's;
* **attributed**: every record carries ``host``/``pid`` (via
  :func:`snapshot_record`), so merged fleet views keep per-process origin.

:func:`read_flight` reads the whole ring back oldest-first, skipping the
torn final line a killed writer may leave.

``repro_torch.scanservice.CorpusJob`` wires one recorder into its work directory
and records at every shard checkpoint; services with long quiet periods use
``interval_s`` + :meth:`start` for the periodic background mode (idle ticks
with nothing new are skipped, not written).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

from .export import snapshot_record, span_records, write_jsonl


def _live_obs():
    # Lazy: repro_torch.obs imports this module while initializing, so the
    # package-level registry/tracer are fetched at call time, not import.
    from repro_torch import obs
    return obs


class FlightRecorder:
    """Appends periodic/explicit telemetry deltas to a rotated JSONL ring.

    ``interval_s=None`` (default) is manual mode: records happen only via
    :meth:`record` — the corpus-job per-shard wiring. With ``interval_s``
    set, :meth:`start` launches a daemon thread recording every interval
    (skipping empty ticks); :meth:`stop` / :meth:`close` ends it.
    """

    def __init__(self, path, *, interval_s: float | None = None,
                 max_bytes: int = 1 << 20, max_files: int = 4,
                 label: str | None = None):
        if interval_s is not None and interval_s <= 0:
            raise ValueError("interval_s must be positive (or None)")
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        if max_files < 1:
            raise ValueError("max_files must be >= 1")
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.interval_s = interval_s
        self.max_bytes = max_bytes
        self.max_files = max_files
        self.label = label
        self._lock = threading.Lock()
        obs = _live_obs()
        # Delta base: everything before the recorder existed is not its
        # story. Same for spans — by max id, not ring position: the ring
        # appends in *finish* order, so a parent finishing last sits at the
        # tail with a lower id than its already-finished children.
        self._last_snap = obs.snapshot()
        self._last_span_id = max(
            (s.span_id for s in obs.recent_spans(1 << 30)), default=0)
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None

    # -- recording -----------------------------------------------------------

    def record(self, *, label: str | None = None, force: bool = True,
               **extra) -> dict | None:
        """Append one delta record (+ the spans finished since the last
        record). ``extra`` keys land on the record top-level (the corpus job
        stamps ``shard=``). ``force=False`` skips the write when nothing
        moved (the periodic tick's idle case). -> the metrics record, or
        None if skipped."""
        obs = _live_obs()
        with self._lock:
            cur = obs.snapshot()
            delta = obs.snapshot_delta(self._last_snap, cur)
            self._last_snap = cur
            spans = [s for s in obs.recent_spans(1 << 30)
                     if s.span_id > self._last_span_id]
            if spans:
                self._last_span_id = max(s.span_id for s in spans)
            if not force and not delta and not spans:
                return None
            rec = snapshot_record(delta, label=label if label is not None
                                  else self.label, kind="flight")
            rec.update(extra)
            self._rotate_if_needed()
            write_jsonl(self.path, [rec] + span_records(spans))
            return rec

    def _rotate_if_needed(self) -> None:
        try:
            size = self.path.stat().st_size
        except OSError:
            return
        if size < self.max_bytes:
            return
        # logrotate-style shift: .{n-1} dropped, .k -> .k+1, active -> .1
        oldest = self._rotated(self.max_files - 1)
        oldest.unlink(missing_ok=True)
        for i in range(self.max_files - 2, 0, -1):
            src = self._rotated(i)
            if src.exists():
                src.replace(self._rotated(i + 1))
        if self.max_files > 1:
            self.path.replace(self._rotated(1))
        else:
            self.path.unlink(missing_ok=True)

    def _rotated(self, i: int) -> Path:
        return self.path.with_name(f"{self.path.name}.{i}")

    # -- the periodic background mode ----------------------------------------

    def start(self) -> "FlightRecorder":
        """Launch the periodic daemon thread (requires ``interval_s``)."""
        if self.interval_s is None:
            raise ValueError("start() needs interval_s; use record() for "
                             "explicit checkpoints")
        if self._thread is None or not self._thread.is_alive():
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._loop, name="flight-recorder", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            self.record(force=False)

    def stop(self) -> None:
        if self._thread is not None:
            self._stop_event.set()
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        """Stop the thread (if any) and flush a final tail delta."""
        self.stop()
        self.record(force=False)

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_flight(path) -> list:
    """The whole ring's records, oldest first (rotations before the active
    file). Unparseable lines — a killed writer's torn tail — are skipped."""
    path = Path(path)
    suffix_of: dict = {}
    for p in path.parent.glob(f"{path.name}.*"):
        tail = p.name[len(path.name) + 1:]
        if tail.isdigit():
            suffix_of[int(tail)] = p
    files = [suffix_of[i] for i in sorted(suffix_of, reverse=True)]
    if path.exists():
        files.append(path)
    out = []
    for p in files:
        try:
            text = p.read_text()
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out
