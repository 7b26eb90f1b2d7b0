"""Content-addressed SFA cache.

Construction is the expensive half of the paper's pipeline (minutes for large
PROSITE signatures, vs milliseconds to scan); it is also *pure*: every engine
produces the bit-identical exact SFA for a given DFA and base polynomial. So
SFAs are cached content-addressed — the key is a canonical byte serialization
of the DFA (transition table, start, accepting set, alphabet) plus the base
polynomial of the fingerprint retry sequence — and a hit is valid no matter
which engine or scanner produced it. :func:`dfa_cache_key` is the reference
package's key byte for byte, so artifacts written by either package are
found by the other.

Entries are positive (the exact SFA) or negative (a *blowup marker*: the
construction exceeded some state budget). Negative entries record the budget
that failed, so a later request with a larger budget is a miss (the closure
might fit) while an equal-or-smaller budget is a hit (known blowup, skip the
work). A positive entry whose SFA is larger than the requested budget also
answers "blowup" without constructing anything — the cache knows the exact
state count.

Eviction is LRU over a byte budget (``max_bytes``) with an entry-count lid
(``max_entries``); blowup markers are near-free and only count against the
entry lid. ``repro_torch.engine.Scanner`` consults the shared process-wide
instance (:func:`shared_cache`) by default, so recompiling the same patterns
performs zero construction rounds.

The cache optionally sits on a **backing store** — any object speaking the
protocol of :class:`repro_torch.scanservice.ArtifactStore` (``get(key)`` ->
``("sfa", SFA) | ("blowup", budget) | None``, ``put_sfa``, ``put_blowup``,
``entries()``). Memory misses fall through to the backing tier (a hit
promotes into memory and counts in ``info.disk_hits``), and stores write
through, so the cache persists across processes: a *fresh* ``SFACache``
pointed at the same store directory answers previously-seen patterns with
zero construction rounds. :meth:`SFACache.preload` bulk-loads the backing
tier for warm starts.

The reference module also caches AOT-compiled construction rounds
(``RoundCompileCache``, the ``cache.rounds.*`` metrics). That has no twin
here: a PyTorch round is eager calls of built kernels, with no compiled
executable to keep.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from .. import obs
from ..core.dfa import DFA
from ..core.fingerprint import DEFAULT_POLY_LOW
from .types import SFA

# /metrics HELP descriptions, registered once; hot paths increment by name.
obs.counter("cache.sfa.hits", help="SFA cache lookups answered in memory")
obs.counter("cache.sfa.misses", help="SFA cache lookups that missed")
obs.counter("cache.sfa.disk_hits",
            help="misses answered by the backing store (promoted to memory)")
obs.counter("cache.sfa.stores", help="SFA entries written to the cache")
obs.counter("cache.sfa.evictions", help="SFA entries evicted (LRU)")
obs.gauge("cache.sfa.bytes",
          help="resident SFA bytes in memory (fleet merges by sum)")


def dfa_cache_key(dfa: DFA, poly_low: int = DEFAULT_POLY_LOW) -> str:
    """Canonical content hash of a DFA + fingerprint base polynomial.

    Deliberately hashes the exact table layout (not an isomorphism-canonical
    form): SFA mappings are vectors *of these state ids*, so only an
    identically-numbered DFA may share the entry.
    """
    h = hashlib.sha256()
    h.update(b"sfa-v1|")
    h.update(str(dfa.n_states).encode())
    h.update(b"|")
    h.update(dfa.alphabet.encode())
    h.update(b"|")
    h.update(int(dfa.start).to_bytes(4, "little"))
    h.update(dfa.table.astype("<i4", copy=False).tobytes())
    h.update(dfa.accepting.astype("u1", copy=False).tobytes())
    h.update(poly_low.to_bytes(8, "little"))
    return h.hexdigest()


@dataclass
class CacheInfo:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    stores: int = 0
    current_bytes: int = 0
    disk_hits: int = 0

    def snapshot(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "stores": self.stores,
            "current_bytes": self.current_bytes,
            "disk_hits": self.disk_hits,
        }


@dataclass
class _Blowup:
    """Negative entry: construction exceeded ``budget`` states."""

    budget: int
    nbytes: int = 0


class SFACache:
    """LRU content-addressed cache of constructed SFAs (+ blowup markers).

    ``backing``: optional persistent tier (see module docstring). Lookups
    fall through to it on a memory miss; stores write through to it.
    """

    def __init__(self, max_entries: int = 256,
                 max_bytes: int = 256 * 1024 * 1024,
                 backing=None):
        if max_entries < 1 or max_bytes < 1:
            raise ValueError("max_entries and max_bytes must be >= 1")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.backing = backing
        self.info = CacheInfo()
        self._entries: OrderedDict = OrderedDict()
        # One coarse lock over lookup/store/preload: the scan service's
        # thread driver compiles through the same cache its callers use.
        self._lock = threading.RLock()

    def attach_backing(self, backing) -> None:
        """Attach/replace the persistent tier (plan plumbing entry point).

        A no-op when ``backing`` already is the attached store (object
        identity or store equality), so repeated compiles under one plan
        don't churn; otherwise the new store wins. NOTE: attaching to the
        process-wide :func:`shared_cache` is a process-wide decision —
        every later compile in the process reads/writes that store until
        another one is attached.
        """
        if backing is None or self.backing is backing or self.backing == backing:
            return
        with self._lock:
            self.backing = backing

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, dfa: DFA) -> bool:
        return dfa_cache_key(dfa) in self._entries

    # -- lookup / store -----------------------------------------------------

    def lookup(self, dfa: DFA, *, max_states: int,
               poly_low: int = DEFAULT_POLY_LOW) -> tuple:
        """-> ("sfa", SFA) | ("blowup", None) | (None, None).

        "blowup" means construction under ``max_states`` is *known* to fail:
        either a marker recorded at an equal-or-larger budget, or a cached
        SFA whose exact state count exceeds the budget.
        """
        key = dfa_cache_key(dfa, poly_low)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None and self.backing is not None:
                ent = self._promote(key)
            if ent is None:
                self.info.misses += 1
                obs.counter("cache.sfa.misses").inc()
                return None, None
            if isinstance(ent, _Blowup):
                if ent.budget >= max_states:
                    self.info.hits += 1
                    obs.counter("cache.sfa.hits").inc()
                    self._entries.move_to_end(key)
                    return "blowup", None
                self.info.misses += 1  # bigger budget might close — rebuild
                obs.counter("cache.sfa.misses").inc()
                return None, None
            self.info.hits += 1
            obs.counter("cache.sfa.hits").inc()
            self._entries.move_to_end(key)
            if ent.n_states > max_states:
                return "blowup", None
            return "sfa", ent

    def store(self, dfa: DFA, sfa: SFA,
              poly_low: int = DEFAULT_POLY_LOW) -> None:
        """Insert/refresh the positive entry for ``dfa`` (write-through)."""
        key = dfa_cache_key(dfa, poly_low)
        with self._lock:
            self._put(key, sfa, sfa.nbytes())
            if self.backing is not None:
                self.backing.put_sfa(key, sfa)

    def store_blowup(self, dfa: DFA, budget: int,
                     poly_low: int = DEFAULT_POLY_LOW) -> None:
        """Record that construction under ``budget`` states blew up.

        Never downgrades: a positive entry (the exact SFA) stays, and a
        marker only grows its recorded budget.
        """
        key = dfa_cache_key(dfa, poly_low)
        with self._lock:
            ent = self._entries.get(key)
            if isinstance(ent, SFA):
                return
            if isinstance(ent, _Blowup):
                ent.budget = max(ent.budget, budget)
                self._entries.move_to_end(key)
            else:
                self._put(key, _Blowup(budget=budget), 0)
            if self.backing is not None:
                self.backing.put_blowup(key, budget)

    def preload(self, max_entries: int | None = None) -> int:
        """Warm start: bulk-promote the backing tier into memory.

        ``entries()`` yields in the store's LRU order (least-recently-used
        first), so insertion preserves recency in the memory LRU and any
        in-memory eviction drops the coldest artifacts. With ``max_entries``
        only the *most*-recently-used that many are promoted.
        -> number of entries promoted; 0 without a backing store.
        """
        if self.backing is None:
            return 0
        entries = self.backing.entries()
        if max_entries is not None:
            from collections import deque

            entries = deque(entries, maxlen=max_entries)  # keep the hottest
        n = 0
        with self._lock:
            for key, kind, payload in entries:
                if kind == "sfa":
                    self._put(key, payload, payload.nbytes())
                else:
                    self._put(key, _Blowup(budget=int(payload)), 0)
                self.info.disk_hits += 1
                n += 1
        obs.counter("cache.sfa.disk_hits").inc(n)
        return n

    def _promote(self, key: str):
        """Memory miss -> consult the backing tier; insert any hit into the
        memory LRU (without writing back) and return the new entry."""
        got = self.backing.get(key)
        if got is None:
            return None
        kind, payload = got
        if kind == "sfa":
            ent = payload
            self._put(key, ent, ent.nbytes())
        else:
            ent = _Blowup(budget=int(payload))
            self._put(key, ent, 0)
        self.info.disk_hits += 1
        obs.counter("cache.sfa.disk_hits").inc()
        return ent

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.info.current_bytes = 0

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _size(ent) -> int:
        return ent.nbytes() if isinstance(ent, SFA) else ent.nbytes

    def _put(self, key: str, value, nbytes: int) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self.info.current_bytes -= self._size(old)
        self._entries[key] = value
        self.info.stores += 1
        obs.counter("cache.sfa.stores").inc()
        self.info.current_bytes += nbytes
        while (len(self._entries) > self.max_entries
               or self.info.current_bytes > self.max_bytes):
            _, victim = self._entries.popitem(last=False)
            self.info.evictions += 1
            obs.counter("cache.sfa.evictions").inc()
            self.info.current_bytes -= self._size(victim)
        obs.gauge("cache.sfa.bytes").set(self.info.current_bytes)


_SHARED: SFACache | None = None


def shared_cache() -> SFACache:
    """The process-wide cache ``Scanner.compile`` consults by default."""
    global _SHARED
    if _SHARED is None:
        _SHARED = SFACache()
    return _SHARED
