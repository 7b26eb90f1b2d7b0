"""Frozen copy of the port's ``core/dfa.py``, kept with the benchmark so
that its inputs do not change when the program does.

Deterministic finite automata: subset construction, Hopcroft minimization,
and the dense transition-table representation used throughout the framework.

The DFA here is always *complete* (every (state, symbol) has a target), so the
transition table is a dense ``(n_states, n_symbols)`` int32 array — the layout
the paper's SFA construction, the transposed-table locality optimization, and
our CUDA kernels all assume.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .regex import AMINO_ACIDS, NFA, compile_nfa


@dataclass
class DFA:
    table: np.ndarray  # (n_states, n_symbols) int32
    start: int
    accepting: np.ndarray  # (n_states,) bool
    alphabet: str

    @property
    def n_states(self) -> int:
        return int(self.table.shape[0])

    @property
    def n_symbols(self) -> int:
        return int(self.table.shape[1])

    # -- execution ---------------------------------------------------------
    def encode(self, text: str) -> np.ndarray:
        sym = {c: i for i, c in enumerate(self.alphabet)}
        return np.asarray([sym[c] for c in text], dtype=np.int32)

    def run(self, symbols: np.ndarray, state: int | None = None) -> int:
        """Sequential matching routine (paper Fig. 1c)."""
        s = self.start if state is None else state
        tbl = self.table
        for x in np.asarray(symbols, dtype=np.int64):
            s = int(tbl[s, x])
        return s

    def accepts(self, text: str) -> bool:
        return bool(self.accepting[self.run(self.encode(text))])

    def transposed(self) -> np.ndarray:
        """Symbol-major transition table (paper §III-B3)."""
        return np.ascontiguousarray(self.table.T)


# --------------------------------------------------------------------------
# Subset construction (NFA -> DFA)
# --------------------------------------------------------------------------


def subset_construct(nfa: NFA) -> DFA:
    start_set = nfa.eps_closure([nfa.start])
    index: dict = {start_set: 0}
    worklist = [start_set]
    rows: list = []
    accepting: list = []
    while worklist:
        cur = worklist.pop()
        # Rows may be discovered out of order; fill placeholders first.
        while len(rows) <= index[cur]:
            rows.append(None)
            accepting.append(False)
        row = np.zeros(nfa.n_symbols, dtype=np.int32)
        for sym in range(nfa.n_symbols):
            nxt = nfa.step(cur, sym)
            if nxt not in index:
                index[nxt] = len(index)
                worklist.append(nxt)
            row[sym] = index[nxt]
        rows[index[cur]] = row
        accepting[index[cur]] = nfa.accept in cur
    table = np.stack(rows).astype(np.int32)
    return DFA(
        table=table,
        start=0,
        accepting=np.asarray(accepting, dtype=bool),
        alphabet=nfa.alphabet,
    )


# --------------------------------------------------------------------------
# Hopcroft minimization
# --------------------------------------------------------------------------


def minimize(dfa: DFA) -> DFA:
    n, k = dfa.n_states, dfa.n_symbols
    # Pre-compute inverse transitions: inv[sym][target] = list of sources.
    inv: list = [[[] for _ in range(n)] for _ in range(k)]
    for s in range(n):
        for a in range(k):
            inv[a][int(dfa.table[s, a])].append(s)

    accepting = set(np.flatnonzero(dfa.accepting).tolist())
    rejecting = set(range(n)) - accepting
    partitions: list = [p for p in (accepting, rejecting) if p]
    work = [p.copy() for p in partitions]

    while work:
        splitter = work.pop()
        for a in range(k):
            pre = set()
            for t in splitter:
                pre.update(inv[a][t])
            new_parts = []
            for p in partitions:
                inter = p & pre
                diff = p - pre
                if inter and diff:
                    new_parts.append(inter)
                    new_parts.append(diff)
                    if p in work:
                        work.remove(p)
                        work.append(inter)
                        work.append(diff)
                    else:
                        work.append(inter if len(inter) <= len(diff) else diff)
                else:
                    new_parts.append(p)
            partitions = new_parts

    # Renumber blocks; keep the start state's block as state 0.
    block_of = np.zeros(n, dtype=np.int64)
    for bi, p in enumerate(partitions):
        for s in p:
            block_of[s] = bi
    order = [int(block_of[dfa.start])]
    order += [b for b in range(len(partitions)) if b != order[0]]
    renum = {b: i for i, b in enumerate(order)}

    m = len(partitions)
    table = np.zeros((m, k), dtype=np.int32)
    accepting_out = np.zeros(m, dtype=bool)
    for bi, p in enumerate(partitions):
        rep = next(iter(p))
        for a in range(k):
            table[renum[bi], a] = renum[int(block_of[int(dfa.table[rep, a])])]
        accepting_out[renum[bi]] = bool(dfa.accepting[rep])
    return DFA(table=table, start=0, accepting=accepting_out, alphabet=dfa.alphabet)


# --------------------------------------------------------------------------
# High-level compilers
# --------------------------------------------------------------------------


def compile_dfa(
    pattern: str,
    alphabet: str = AMINO_ACIDS,
    *,
    search: bool = True,
    minimize_dfa: bool = True,
) -> DFA:
    """Compile a regex to a minimal complete DFA.

    With ``search=True`` the DFA accepts any string *containing* a match
    (``Σ* pattern Σ*`` semantics — the paper's Fig. 1 "contains RG" example):
    we prepend ``.*`` and make accepting states absorbing.
    """
    pat = f"(.*)({pattern})" if search else pattern
    dfa = subset_construct(compile_nfa(pat, alphabet))
    if search:
        dfa = _make_accepting_absorbing(dfa)
    if minimize_dfa:
        dfa = minimize(dfa)
    return dfa


def _make_accepting_absorbing(dfa: DFA) -> DFA:
    table = dfa.table.copy()
    for s in np.flatnonzero(dfa.accepting):
        table[s, :] = s
    return replace(dfa, table=table)


def example_fa() -> DFA:
    """The paper's running example (Fig. 1): accepts strings containing "RG"."""
    return compile_dfa("RG", AMINO_ACIDS, search=True)


def random_dfa(
    n_states: int,
    n_symbols: int,
    *,
    seed: int = 0,
    n_accepting: int = 1,
) -> DFA:
    """Random complete DFA — used by property tests and synthetic benchmarks."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n_states, size=(n_states, n_symbols), dtype=np.int32)
    accepting = np.zeros(n_states, dtype=bool)
    accepting[rng.choice(n_states, size=min(n_accepting, n_states), replace=False)] = True
    alphabet = AMINO_ACIDS[:n_symbols] if n_symbols <= len(AMINO_ACIDS) else "".join(
        chr(ord("a") + i) for i in range(n_symbols)
    )
    return DFA(table=table, start=0, accepting=accepting, alphabet=alphabet)
