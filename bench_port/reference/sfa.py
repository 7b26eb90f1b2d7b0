"""Plain reference of SFA construction (the paper's Algorithm 1).

The SFA of a DFA is the closure of the identity mapping under
``f -> (q -> delta(f[q], a))`` for every symbol ``a``. States are numbered
in the order a FIFO breadth-first search discovers them, symbols in order,
state 0 the identity; membership is an exact dictionary of the mapping
vectors' bytes (no fingerprints). A DFA whose closure has more than
``budget`` states is blown. Plain NumPy; it imports nothing of the program.

``dtype`` is the type state ids are held in: ``int32`` for the reference,
``uint8`` for the control, whose ids wrap at 256.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RefSFA:
    blown: bool
    delta: np.ndarray | None      # (S, k) int32
    mappings: np.ndarray | None   # (S, n) int32


def construct(table: np.ndarray, budget: int, dtype=np.int32) -> RefSFA:
    """The SFA of the DFA with transition table ``table`` (n, k), or a
    blown verdict once its closure passes ``budget`` states."""
    n, k = table.shape
    tab = np.asarray(table).astype(dtype)
    first = np.arange(n).astype(dtype)
    index = {first.tobytes(): 0}
    states = [first]
    rows = []
    head = 0
    while head < len(states):
        # every symbol's successor of the frontier state at once: (k, n)
        succ = np.ascontiguousarray(tab[states[head]].T)
        head += 1
        row = np.empty(k, dtype=np.int64)
        for a in range(k):
            key = succ[a].tobytes()
            sid = index.get(key)
            if sid is None:
                sid = len(states)
                if sid >= budget:
                    return RefSFA(blown=True, delta=None, mappings=None)
                index[key] = sid
                states.append(succ[a])
            row[a] = sid
        rows.append(row.astype(dtype))
    return RefSFA(blown=False,
                  delta=np.stack(rows).astype(np.int32),
                  mappings=np.stack(states).astype(np.int32))


def construct_bank(tables, budget: int, dtype=np.int32) -> list:
    """:func:`construct` of every table of a bank."""
    return [construct(t, budget, dtype) for t in tables]


def same(a: RefSFA, b: RefSFA) -> bool:
    """Whether two outcomes agree: the verdict, and for SFAs that closed
    their transition tables and mapping stacks bit for bit."""
    if a.blown or b.blown:
        return a.blown == b.blown
    return (a.delta.shape == b.delta.shape
            and np.array_equal(a.delta, b.delta)
            and np.array_equal(a.mappings, b.mappings))


def walk_tables(table, accepting, start: int, budget: int, dtype=np.int32):
    """What a scan of one pattern walks, as the paper scans: its SFA, from
    the identity (state 0), accepting in the states whose mapping takes the
    DFA's start to an accepting state -> (table (S, k), accepting (S,),
    start 0); where the SFA blows past ``budget``, the DFA itself. ``dtype``
    is the type the SFA's state ids are held in, as in :func:`construct`."""
    s = construct(table, budget, dtype)
    if s.blown:
        return np.asarray(table), np.asarray(accepting), int(start)
    return s.delta, np.asarray(accepting)[s.mappings[:, int(start)]], 0
