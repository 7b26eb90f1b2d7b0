"""Hot-state profiler: where does each automaton actually live?

Speculation only pays when the ``m`` states a chunk is run from cover the
states the automaton really occupies at chunk boundaries. On real inputs
DFAs are heavily skewed — a search automaton for ``Σ* pattern Σ*`` spends
almost all its time in the start state and the first few prefix states
(1210.5093's empirical basis) — so a small sample of the input pins the
distribution down well.

:func:`profile_hot_states` advances every pattern's DFA over one shared
symbol sample (vectorized across the pattern axis; one NumPy gather per
sample symbol) while histogramming visited states, then takes each
pattern's top-``m`` by visit count. Chunk boundaries are just positions,
so the position-state distribution *is* the boundary-state distribution,
independent of how the scan plan chunks the input.

Profiles are plain data (:class:`HotStateProfile`, JSON round-trip via
``to_json``/``from_json``) so the scan service can persist them next to
SFA artifacts in the :class:`~repro_torch.scanservice.ArtifactStore` under
the same ``dfa_cache_key`` — a corpus profiled once seeds speculation for
every later process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HotStateProfile:
    """Top-``m`` boundary-state distribution of one pattern.

    ``states`` is most-frequent-first; ``weights`` are the matching visit
    frequencies (normalized over the whole sample, so they need not sum
    to 1 when ``m < n_states``). The profile is advisory only — a stale or
    even adversarial profile costs repair rounds, never correctness.
    """

    states: np.ndarray        # (m,) int32, most frequent first
    weights: np.ndarray       # (m,) float64 visit frequencies
    sample_len: int           # symbols profiled

    def to_json(self) -> dict:
        return {
            "m": int(len(self.states)),
            "states": [int(s) for s in self.states],
            "weights": [float(w) for w in self.weights],
            "sample_len": int(self.sample_len),
        }

    @classmethod
    def from_json(cls, meta: dict) -> "HotStateProfile | None":
        """Parse a persisted profile; anything malformed is a miss (None)."""
        try:
            states = np.asarray(meta["states"], dtype=np.int32)
            weights = np.asarray(meta["weights"], dtype=np.float64)
            sample_len = int(meta["sample_len"])
        except (KeyError, TypeError, ValueError, OverflowError):
            return None
        if states.ndim != 1 or states.shape != weights.shape or not len(states):
            return None
        return cls(states=states, weights=weights, sample_len=sample_len)


def profile_hot_states(tables, starts, sample, m: int) -> list:
    """Profile every pattern of a bank over one shared symbol sample.

    ``tables`` (P, n, k) int — padded enumeration tables (padding rows are
    self-loops, which the histogram never reaches from a true start);
    ``starts`` (P,); ``sample`` (S,) encoded symbols. -> list of P
    :class:`HotStateProfile` with exactly ``m`` states each: the top-``m``
    visited states (count desc, state id asc — deterministic), padded out
    with the remaining state ids (or repeats when ``m > n``). Extra states
    only widen speculation coverage; duplicates are harmless.
    """
    tables = np.asarray(tables)
    P, n, _ = tables.shape
    rows = np.arange(P)
    states = np.asarray(starts, dtype=np.int64).copy()
    counts = np.zeros((P, n), dtype=np.int64)
    counts[rows, states] += 1        # the entry state is itself a boundary state
    for sym in np.asarray(sample, dtype=np.int64):
        states = tables[rows, states, sym].astype(np.int64)
        counts[rows, states] += 1
    total = max(1, int(np.asarray(sample).size) + 1)
    profiles = []
    order_tail = np.arange(n)
    for p in range(P):
        order = np.lexsort((order_tail, -counts[p]))
        if m <= n:
            top = order[:m]
        else:
            top = np.concatenate([order, np.full(m - n, order[-1])])
        profiles.append(HotStateProfile(
            states=top.astype(np.int32),
            weights=(counts[p][top] / total).astype(np.float64),
            sample_len=int(np.asarray(sample).size),
        ))
    return profiles


def stack_profile_states(profiles, m: int, n_max: int) -> np.ndarray:
    """Normalize per-pattern profiles to one (P, m) int32 speculation stack.

    Profiles persisted with a different ``m`` are truncated (they are
    ordered most-frequent-first) or padded by repeating their last state;
    states are clipped into the padded table range so speculative gathers
    can never go out of bounds (a clipped state is just a lane that never
    validates — exactness is unaffected).
    """
    out = np.empty((len(profiles), m), dtype=np.int32)
    for p, prof in enumerate(profiles):
        s = np.asarray(prof.states, dtype=np.int32)
        if len(s) >= m:
            s = s[:m]
        else:
            s = np.concatenate([s, np.full(m - len(s), s[-1], dtype=np.int32)])
        out[p] = s
    return np.clip(out, 0, max(0, n_max - 1))
