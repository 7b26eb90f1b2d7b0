"""The one worklist closure every single-pattern engine shares (paper Alg. 1).

Given a DFA, the SFA is the closure of the identity mapping under
``f ↦ λq. δ(f[q], σ)`` for every symbol σ. Discovery order is FIFO BFS with
symbols in order — the same order as the batched rounds of
:mod:`.batched`, so every engine produces bit-identical SFAs. What varies is
only the membership policy (:mod:`.stores`) and the execution shape:

* :func:`close_scalar` — one candidate at a time through a scalar store, on
  the host (the faithful sequential engine, with the paper's §III-A ablation
  toggles expressed as store choice);
* :func:`close_bulk` — whole frontier × alphabet tiles through the
  :class:`~.stores.SortedFingerprintStore` on the store's device: the
  expansion is the ``expand_bank`` kernel with one table, the fingerprints
  the ``fingerprint`` kernel, membership a ``searchsorted``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.dfa import DFA
from ..kernels import ops as kernel_ops
from .stores import SortedFingerprintStore
from .types import SFA, SFAStats, StateBlowup


def close_scalar(dfa: DFA, store, stats: SFAStats, *,
                 max_states: int) -> SFA:
    """Algorithm 1 with membership delegated to a scalar store."""
    t0 = time.perf_counter()
    n, k = dfa.n_states, dfa.n_symbols
    table = dfa.table

    identity = np.arange(n, dtype=np.int32)
    store.lookup_or_add(identity)
    delta_rows: list = []
    head = 0

    while head < len(store):
        cur_vec = store.mappings[head]
        head += 1
        stats.rounds += 1
        row = np.empty(k, dtype=np.int32)
        for a in range(k):
            nxt = table[cur_vec, a]  # f_next(q) = δ(f(q), σ) (paper line 6)
            stats.candidates += 1
            idx, is_new = store.lookup_or_add(nxt)
            if is_new and idx >= max_states:
                raise StateBlowup(f"SFA exceeded {max_states} states")
            row[a] = idx
        delta_rows.append(row)

    stats.wall_time_s = time.perf_counter() - t0
    return SFA(
        mappings=np.stack(store.mappings).astype(np.int32),
        delta=np.stack(delta_rows).astype(np.int32),
        fingerprints=store.fingerprint_pairs(),
        dfa=dfa,
        stats=stats,
    )


def close_bulk(dfa: DFA, store: SortedFingerprintStore, stats: SFAStats, *,
               max_states: int, tile: int) -> SFA:
    """Bulk-synchronous frontier closure on the store's device.

    Per round, the whole frontier × alphabet expands tile by tile in one
    gather each (``out[t·k + a] = δ(f_t, a)``, row-major (frontier, symbol)
    order — identical to :func:`close_scalar`'s FIFO BFS), the store
    fingerprints every candidate of the tile at once and assigns ids. The
    result is copied to the host once, at the end.
    """
    t0 = time.perf_counter()
    n, k = dfa.n_states, dfa.n_symbols
    if n >= 1 << 16:
        raise ValueError("bulk engine packs 16-bit state ids (paper layout)")
    table = torch.as_tensor(dfa.table, dtype=torch.int32,
                            device=store.device)[None]      # (1, n, k)

    delta_rows: list = []
    n_rows = 0
    frontier_lo = 0            # store.mappings[frontier_lo:] unprocessed

    while frontier_lo < len(store):
        stats.rounds += 1
        frontier = store.mappings[frontier_lo:]
        for t in range(0, frontier.shape[0], tile):
            ft = frontier[t: t + tile]                     # (m, n)
            m = ft.shape[0]
            cand = kernel_ops.expand_bank(table, ft[None])[0]   # (m·k, n)
            stats.candidates += m * k
            ids = store.assign(cand)
            if len(store) > max_states:
                raise StateBlowup(f"SFA exceeded {max_states} states")
            delta_rows.append(ids.view(m, k))
            n_rows += m
        frontier_lo = n_rows

    stats.wall_time_s = time.perf_counter() - t0
    return SFA(
        mappings=store.mappings.cpu().numpy(),
        delta=torch.cat(delta_rows).cpu().numpy(),
        fingerprints=store.fingerprint_pairs(),
        dfa=dfa,
        stats=stats,
    )
