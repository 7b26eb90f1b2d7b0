"""Multi-pattern banks: P automata as one padded table stack (paper §IV).

Patterns compile to DFAs of very different sizes, so tables are padded to
the bank's ``n_max`` with **self-loop rows** (state ``j >= n_i`` maps every
symbol back to ``j``). Self-loops keep every table entry a valid state id
and make the padded states inert: they are unreachable from real states,
and under function composition a padded entry ``f[q] = q`` stays the
identity (the *identity padding* the SFA mapping stacks use too). Per-
pattern true sizes ride along in ``PatternBank.n_states``.

The bank keeps its arrays on the host as NumPy; :meth:`PatternBank.to`
hands out device tensors for the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from .dfa import DFA


@dataclass
class PatternBank:
    """``P`` complete DFAs over one alphabet, padded to a common state count.

    ``tables[p]`` is pattern ``p``'s transition table, rows ``>= n_states[p]``
    are self-loops; ``accepting[p]``/``starts[p]`` follow the same layout.
    """

    tables: np.ndarray     # (P, n_max, k) int32
    accepting: np.ndarray  # (P, n_max) bool
    starts: np.ndarray     # (P,) int32
    n_states: np.ndarray   # (P,) int32 — true (unpadded) state counts
    ids: tuple
    alphabet: str

    @property
    def n_patterns(self) -> int:
        return int(self.tables.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.tables.shape[1])

    @property
    def n_symbols(self) -> int:
        return int(self.tables.shape[2])

    def encode(self, text: str) -> np.ndarray:
        sym = {c: i for i, c in enumerate(self.alphabet)}
        return np.asarray([sym[c] for c in text], dtype=np.int32)

    def dfa(self, p: int) -> DFA:
        """Crop pattern ``p`` back out of the bank as a standalone DFA."""
        n = int(self.n_states[p])
        return DFA(
            table=np.ascontiguousarray(self.tables[p, :n, :]),
            start=int(self.starts[p]),
            accepting=np.ascontiguousarray(self.accepting[p, :n]),
            alphabet=self.alphabet,
        )

    @classmethod
    def from_dfas(cls, dfas: Sequence[DFA], ids: Iterable[str] | None = None
                  ) -> "PatternBank":
        if not dfas:
            raise ValueError("empty pattern bank")
        alphabet = dfas[0].alphabet
        k = dfas[0].n_symbols
        for d in dfas:
            if d.alphabet != alphabet or d.n_symbols != k:
                raise ValueError("bank patterns must share one alphabet")
        n_max = max(d.n_states for d in dfas)
        p_count = len(dfas)
        tables = np.empty((p_count, n_max, k), dtype=np.int32)
        accepting = np.zeros((p_count, n_max), dtype=bool)
        # Self-loop padding: row j -> j for every symbol (see module docstring).
        pad_rows = np.repeat(np.arange(n_max, dtype=np.int32)[:, None], k, axis=1)
        for p, d in enumerate(dfas):
            tables[p] = pad_rows
            tables[p, : d.n_states] = d.table
            accepting[p, : d.n_states] = d.accepting
        return cls(
            tables=tables,
            accepting=accepting,
            starts=np.asarray([d.start for d in dfas], dtype=np.int32),
            n_states=np.asarray([d.n_states for d in dfas], dtype=np.int32),
            ids=tuple(ids) if ids is not None else tuple(
                f"pattern_{p}" for p in range(p_count)
            ),
            alphabet=alphabet,
        )

    @classmethod
    def from_patterns(cls, patterns: Mapping[str, str] | Sequence[str]
                      ) -> "PatternBank":
        """Compile PROSITE signatures (id -> pattern mapping, or a list)."""
        from .prosite import compile_prosite

        if isinstance(patterns, Mapping):
            ids = tuple(patterns.keys())
            dfas = [compile_prosite(patterns[i]) for i in ids]
        else:
            ids = tuple(f"pattern_{p}" for p in range(len(patterns)))
            dfas = [compile_prosite(p) for p in patterns]
        return cls.from_dfas(dfas, ids)

    def to(self, device) -> tuple:
        """(tables int32, accepting bool, starts int64) as tensors on
        ``device``, ready for the matchers."""
        return (
            torch.as_tensor(self.tables, device=device),
            torch.as_tensor(self.accepting, device=device),
            torch.as_tensor(self.starts, dtype=torch.int64, device=device),
        )


def census_sequential(bank: PatternBank, corpus: np.ndarray) -> np.ndarray:
    """Reference census: plain per-pattern, per-sequence DFA loop (paper
    Fig. 1c applied P × D times). The differential-test oracle."""
    counts = np.zeros(bank.n_patterns, dtype=np.int32)
    for p in range(bank.n_patterns):
        d = bank.dfa(p)
        for row in np.asarray(corpus):
            counts[p] += bool(d.accepting[d.run(row)])
    return counts
