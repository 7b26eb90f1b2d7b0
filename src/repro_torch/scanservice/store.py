"""Persistent SFA artifact store: the disk tier under :class:`SFACache`.

The on-disk format (``STORE_VERSION``, the file layout and the sidecars) is
the reference package's, so an artifact written by either package loads in
the other.

Construction results are pure functions of (DFA, base polynomial) — exactly
what :func:`repro_torch.construction.dfa_cache_key` hashes — so they can outlive
the process that built them. The store keeps one artifact per key:

* a **positive** artifact is an ``.npz`` payload (the SFA's mapping stack,
  delta table, fingerprints, and the source DFA's table/accepting — enough
  to rebuild the full :class:`~repro_torch.construction.SFA`) committed by a JSON
  sidecar;
* a **blowup marker** is a sidecar alone recording the state budget that
  failed (the same never-downgrade semantics as the in-memory tier).

Writes are atomic (write to a same-directory temp file, then
``os.replace``), and the sidecar is written *last* — its presence is the
commit point, so a crashed writer can never publish a partial payload.
Readers treat anything unreadable (truncated npz, garbage JSON, unknown
format version) as a miss, never an error: a corrupted artifact costs one
reconstruction, not an outage.

Eviction is LRU over a byte budget: every hit touches the sidecar's mtime
(through a strictly-increasing per-store clock, so ordering survives coarse
filesystem timestamps), and :meth:`ArtifactStore.put_sfa` evicts
oldest-touched artifacts until the store fits ``max_bytes`` again.

The store implements the backing protocol :class:`SFACache` speaks
(``get`` / ``put_sfa`` / ``put_blowup`` / ``entries``): attach one via
``SFACache(backing=ArtifactStore(dir))`` — or just
``ConstructionPolicy(store=dir)`` — and a fresh process compiling
previously-seen patterns performs zero construction rounds.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

from .. import obs
from ..construction.types import SFA, SFAStats
from ..core.dfa import DFA

# /metrics HELP descriptions, registered once; hot paths increment by name.
obs.counter("store.artifact.hits",
            help="artifact-store gets that found a valid artifact")
obs.counter("store.artifact.misses",
            help="artifact-store gets that missed (or hit a broken file)")
obs.counter("store.artifact.puts", help="artifacts written to the store")
obs.counter("store.artifact.evictions",
            help="artifacts evicted by the byte-budget LRU")

#: On-disk format version. Bump on any layout change; readers ignore
#: artifacts from other versions (a stale store degrades to a cold one).
STORE_VERSION = 1


class ArtifactStore:
    """Content-addressed on-disk SFA artifacts under one root directory."""

    def __init__(self, root, *, max_bytes: int = 1 << 30):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        # Monotonic LRU clock: strictly increasing mtimes even on
        # filesystems with 1s timestamp resolution.
        self._clock = time.time()

    # -- paths --------------------------------------------------------------

    def _dir(self, key: str) -> Path:
        return self.root / key[:2]

    def _payload_path(self, key: str) -> Path:
        return self._dir(key) / f"{key}.npz"

    def _sidecar_path(self, key: str) -> Path:
        return self._dir(key) / f"{key}.json"

    def _touch(self, path: Path) -> None:
        self._clock = max(self._clock + 1e-3, time.time())
        try:
            os.utime(path, (self._clock, self._clock))
        except OSError:
            pass

    # -- the backing protocol ------------------------------------------------

    def get(self, key: str):
        """-> ``("sfa", SFA)`` | ``("blowup", budget)`` | ``None``.

        Any unreadable artifact — missing payload, truncated npz, invalid
        JSON, foreign format version — is a miss, never an exception.
        """
        with obs.span("store.artifact.get", key=key[:12]):
            side = self._sidecar_path(key)
            try:
                meta = json.loads(side.read_text())
            except (OSError, ValueError):
                obs.counter("store.artifact.misses").inc()
                return None
            if not isinstance(meta, dict) \
                    or meta.get("version") != STORE_VERSION:
                obs.counter("store.artifact.misses").inc()
                return None
            kind = meta.get("kind")
            if kind == "blowup":
                budget = meta.get("budget")
                if not isinstance(budget, int):
                    obs.counter("store.artifact.misses").inc()
                    return None
                self._touch(side)
                obs.counter("store.artifact.hits").inc()
                return "blowup", budget
            if kind != "sfa":
                obs.counter("store.artifact.misses").inc()
                return None
            try:
                with np.load(self._payload_path(key)) as z:
                    sfa = SFA(
                        mappings=np.asarray(z["mappings"], dtype=np.int32),
                        delta=np.asarray(z["delta"], dtype=np.int32),
                        fingerprints=np.asarray(
                            z["fingerprints"], dtype=np.uint32
                        ),
                        dfa=DFA(
                            table=np.asarray(z["dfa_table"], dtype=np.int32),
                            start=int(meta["start"]),
                            accepting=np.asarray(
                                z["dfa_accepting"], dtype=bool
                            ),
                            alphabet=str(meta["alphabet"]),
                        ),
                        stats=SFAStats(engine=str(meta.get("engine", "store"))),
                    )
            except Exception:
                # partial/corrupt payload: reconstruct instead
                obs.counter("store.artifact.misses").inc()
                return None
            self._touch(side)
            obs.counter("store.artifact.hits").inc()
            return "sfa", sfa

    def put_sfa(self, key: str, sfa: SFA) -> None:
        """Persist a positive artifact (idempotent; last write wins)."""
        with obs.span("store.artifact.put", key=key[:12],
                      nbytes=sfa.nbytes()):
            d = self._dir(key)
            d.mkdir(parents=True, exist_ok=True)
            payload = self._payload_path(key)
            self._atomic_write(
                payload,
                lambda f: np.savez(
                    f,
                    mappings=sfa.mappings.astype(np.int32, copy=False),
                    delta=sfa.delta.astype(np.int32, copy=False),
                    fingerprints=sfa.fingerprints.astype(
                        np.uint32, copy=False
                    ),
                    dfa_table=sfa.dfa.table.astype(np.int32, copy=False),
                    dfa_accepting=sfa.dfa.accepting.astype(bool, copy=False),
                ),
            )
            meta = {
                "version": STORE_VERSION,
                "kind": "sfa",
                "n_states": sfa.n_states,
                "start": int(sfa.dfa.start),
                "alphabet": sfa.dfa.alphabet,
                "engine": sfa.stats.engine,
                "nbytes": sfa.nbytes(),
            }
            self._write_sidecar(key, meta)  # commit point
            evicted = self._evict()
        obs.counter("store.artifact.puts").inc()
        if evicted:
            obs.counter("store.artifact.evictions").inc(evicted)

    def put_blowup(self, key: str, budget: int) -> None:
        """Persist/upgrade a blowup marker (never downgrades; a positive
        artifact always wins over a marker)."""
        existing = None
        try:
            existing = json.loads(self._sidecar_path(key).read_text())
        except (OSError, ValueError):
            pass
        if isinstance(existing, dict) and existing.get("version") == STORE_VERSION:
            if existing.get("kind") == "sfa":
                return
            old = existing.get("budget")
            if isinstance(old, int) and old >= budget:
                return
        self._dir(key).mkdir(parents=True, exist_ok=True)
        self._write_sidecar(
            key, {"version": STORE_VERSION, "kind": "blowup", "budget": int(budget)}
        )

    # -- hot-state profiles ---------------------------------------------------
    #
    # Speculative scanning's per-pattern boundary-state profiles persist
    # next to the SFA artifacts under the same ``dfa_cache_key`` — a corpus
    # profiled once seeds speculation for every later process. Profiles are
    # tiny JSON documents in their own ``profiles/`` subtree (one directory
    # level deeper than artifacts, so the artifact walks — ``entries``,
    # ``keys``, ``total_bytes``, eviction — never see them), written with
    # the same atomic replace and the same read-anything-broken-as-a-miss
    # contract. They are advisory data: a lost or stale profile costs
    # repair rounds on the next scan, never correctness.

    def _profile_path(self, key: str) -> Path:
        return self.root / "profiles" / key[:2] / f"{key}.json"

    def get_profile(self, key: str):
        """-> the persisted profile dict for ``key``, or None. Unreadable
        or foreign-version profiles are a miss, never an error."""
        try:
            meta = json.loads(self._profile_path(key).read_text())
        except (OSError, ValueError):
            return None
        if not isinstance(meta, dict) or meta.get("version") != STORE_VERSION \
                or meta.get("kind") != "profile":
            return None
        return meta

    def put_profile(self, key: str, profile: dict) -> None:
        """Persist one hot-state profile (idempotent; last write wins)."""
        path = self._profile_path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {"version": STORE_VERSION, "kind": "profile", **profile}
        self._atomic_write(path, lambda f: f.write(json.dumps(meta).encode()))

    def profile_keys(self) -> list:
        return sorted(p.stem for p in self.root.glob("profiles/*/*.json"))

    def entries(self):
        """Yield ``(key, kind, payload)`` for every readable artifact in
        LRU order (least-recently-touched first) — the warm-start preload
        walk, ordered so promotion preserves recency in the memory tier.
        Unreadable artifacts are skipped."""
        def mtime(p: Path) -> float:
            try:
                return p.stat().st_mtime
            except OSError:
                return 0.0

        for side in sorted(self.root.glob("*/*.json"), key=mtime):
            key = side.stem
            got = self.get(key)
            if got is not None:
                yield (key, *got)

    # -- maintenance ---------------------------------------------------------

    def keys(self) -> list:
        return sorted(p.stem for p in self.root.glob("*/*.json"))

    def __len__(self) -> int:
        return len(self.keys())

    def __contains__(self, key: str) -> bool:
        return self._sidecar_path(key).exists()

    def __eq__(self, other) -> bool:
        return isinstance(other, ArtifactStore) and \
            self.root.resolve() == other.root.resolve()

    def total_bytes(self) -> int:
        """Payload + sidecar bytes currently on disk."""
        return sum(
            p.stat().st_size
            for pat in ("*/*.json", "*/*.npz")
            for p in self.root.glob(pat)
            if p.exists()
        )

    def remove(self, key: str) -> None:
        for p in (self._sidecar_path(key), self._payload_path(key)):
            try:
                p.unlink()
            except OSError:
                pass

    def _evict(self) -> int:
        """Drop oldest-touched artifacts until the store fits ``max_bytes``.
        Blowup markers are near-free and never evicted. -> artifacts removed."""
        total = self.total_bytes()
        if total <= self.max_bytes:
            return 0
        victims = sorted(
            (p for p in self.root.glob("*/*.npz")),
            key=lambda p: self._sidecar_path(p.stem).stat().st_mtime
            if self._sidecar_path(p.stem).exists() else 0.0,
        )
        removed = 0
        for payload in victims:
            if total <= self.max_bytes:
                break
            key = payload.stem
            total -= payload.stat().st_size
            side = self._sidecar_path(key)
            if side.exists():
                total -= side.stat().st_size
            self.remove(key)
            removed += 1
        return removed

    # -- write helpers -------------------------------------------------------

    def _atomic_write(self, path: Path, write_fn) -> None:
        tmp = path.with_suffix(path.suffix + f".tmp.{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                write_fn(f)
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()

    def _write_sidecar(self, key: str, meta: dict) -> None:
        side = self._sidecar_path(key)
        self._atomic_write(side, lambda f: f.write(json.dumps(meta).encode()))
        self._touch(side)
