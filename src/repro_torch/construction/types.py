"""Shared data types of the construction subsystem.

:class:`SFA` and the two failure modes (``FingerprintCollision`` for a
detected 64-bit fingerprint clash — exactness by detection + retry — and
``StateBlowup`` for the O(n^n) wall), plus the bank-level results:
:class:`BankStats` (the bulk-round accounting) and
:class:`BankConstructionResult` (per-pattern SFAs + blowup flags). SFAs are
host-side NumPy arrays, as in the reference package, so results of the two
packages compare directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.dfa import DFA


class FingerprintCollision(RuntimeError):
    """Two distinct state vectors produced the same 64-bit fingerprint."""


class StateBlowup(RuntimeError):
    """SFA state count exceeded the configured cap (the O(n^n) problem)."""


@dataclass
class SFAStats:
    engine: str
    rounds: int = 0
    candidates: int = 0
    fp_compares: int = 0
    exact_compares: int = 0
    collisions_detected: int = 0
    wall_time_s: float = 0.0


@dataclass
class SFA:
    """The simultaneous automaton.

    ``mappings[i]`` is the state vector of SFA state ``i``; ``delta[i, a]`` is
    the SFA transition table; state 0 is the start (identity mapping).
    """

    mappings: np.ndarray      # (S, n) int32
    delta: np.ndarray         # (S, |Σ|) int32
    fingerprints: np.ndarray  # (S, 2) uint32 [hi, lo]
    dfa: DFA
    stats: SFAStats

    @property
    def n_states(self) -> int:
        return int(self.mappings.shape[0])

    @property
    def start(self) -> int:
        return 0

    def accepting_states(self) -> np.ndarray:
        """F_s = { f | f(q0) ∈ F } (paper line 11, with I = {q0})."""
        return self.dfa.accepting[self.mappings[:, self.dfa.start]]

    def run(self, symbols: np.ndarray, state: int | None = None) -> int:
        """Run the SFA like a plain DFA (one table lookup per character)."""
        s = 0 if state is None else state
        tbl = self.delta
        for x in np.asarray(symbols, dtype=np.int64):
            s = int(tbl[s, x])
        return s

    def mapping_of(self, symbols: np.ndarray) -> np.ndarray:
        """Transition function of the whole input string, as a vector."""
        return self.mappings[self.run(symbols)]

    def nbytes(self) -> int:
        """Array payload size (the cache's eviction currency)."""
        return int(
            self.mappings.nbytes + self.delta.nbytes + self.fingerprints.nbytes
        )


@dataclass(frozen=True)
class BucketStats:
    """Accounting of one size bucket of a bucketed bank construction.

    ``edge`` is the bucket's size-ladder edge (patterns with
    ``n_states <= edge``), ``n_max`` the bucket's true widest pattern —
    the row width every pattern in the bucket actually paid, versus the
    whole bank's ``n_max`` it would have paid unbucketed.
    """

    edge: int
    n_patterns: int
    n_max: int
    rounds: int
    blown: int
    wall_time_s: float

    def to_json(self) -> dict:
        return {
            "edge": self.edge, "n_patterns": self.n_patterns,
            "n_max": self.n_max, "rounds": self.rounds,
            "blown": self.blown, "wall_time_s": self.wall_time_s,
        }


@dataclass
class BankStats:
    """Accounting of one :func:`~.batched.construct_bank` call.

    ``rounds`` counts *bulk-synchronous device rounds* (one round advances
    every active pattern's frontier by one tile). ``pattern_rounds[p]`` counts the rounds in which pattern ``p``
    actually had frontier states processed (a retried pattern's counter grows;
    a finished passenger's does not — the per-pattern retry test pins this).

    ``pattern_candidates[p]`` is pattern ``p``'s candidate-expansion count
    (the single source for both ``candidates == pattern_candidates.sum()``
    and each pattern's ``SFAStats.candidates``). ``wall_time_s`` is the
    whole-bank wall time; per-pattern ``SFAStats.wall_time_s`` is the
    rounds-weighted *share* of it — a bank's wall belongs to the bank, and a
    pattern that closed in 2 of 13 rounds must not report 13 rounds' worth.
    """

    method: str
    rounds: int = 0
    pattern_rounds: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    retries: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    pattern_candidates: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    candidates: int = 0
    wall_time_s: float = 0.0
    #: Per-size-bucket accounting (``BucketStats``) when the batched method
    #: ran bucketed; empty for unbucketed or loop constructions.
    buckets: list = field(default_factory=list)


@dataclass
class BankConstructionResult:
    """Per-pattern outcome of a bank construction.

    ``sfas[p]`` is the exact SFA of pattern ``p`` or ``None`` where
    ``blown[p]`` (state count exceeded ``max_states``).
    """

    sfas: list
    blown: np.ndarray            # (P,) bool
    stats: BankStats

    @property
    def n_patterns(self) -> int:
        return len(self.sfas)

    def require_all(self) -> "BankConstructionResult":
        """Raise :class:`StateBlowup` unless every pattern closed."""
        if bool(np.any(self.blown)):
            bad = [int(i) for i in np.flatnonzero(self.blown)]
            raise StateBlowup(f"patterns {bad} exceeded the state cap")
        return self
