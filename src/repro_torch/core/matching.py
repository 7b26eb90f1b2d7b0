"""Chunk-level matching primitives (paper §I, §IV-C), plain PyTorch.

The dependency chain ``state ← δ(state, Str[i])`` makes plain DFA matching
sequential. The SFA breaks it: split the input into chunks, compute each
chunk's *transition function* independently, and combine the functions
associatively (``core.monoid.function_monoid``). Two ways to get a chunk's
function:

* **SFA mode** (the paper): run the SFA like a DFA — one ``δ_s`` lookup per
  character — and read the mapping off the final SFA state;
* **enumeration mode** (Mytkowicz et al.): run all ``n`` DFA instances per
  chunk as one vectorized gather.

These single-chunk versions are the readable statement of what
``kernels/csrc/match_chunks.cu`` and ``match_bank_chunks.cu`` compute for
every (pattern, chunk) cell at once; the engine goes through the kernel
wrappers instead. ``chunk_accept_trace`` is the second pass of match
localization, and ``match_sequential`` / ``match_ends_sequential`` are the
sequential oracles (NumPy, as in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from .dfa import DFA


def match_sequential(dfa: DFA, symbols: np.ndarray) -> int:
    """Final state of a plain sequential DFA run (paper Fig. 1c)."""
    return dfa.run(symbols)


def match_ends_sequential(dfa: DFA, symbols: np.ndarray) -> np.ndarray:
    """Accepting-state flag after every position (for match localization)."""
    out = np.zeros(len(symbols), dtype=bool)
    s = dfa.start
    for i, x in enumerate(np.asarray(symbols, dtype=np.int64)):
        s = int(dfa.table[s, x])
        out[i] = bool(dfa.accepting[s])
    return out


def chunk_mapping_enumeration(table: torch.Tensor,
                              chunk: torch.Tensor) -> torch.Tensor:
    """Transition function of one chunk by running all n states at once.

    ``table``: (n, k) int32; ``chunk``: (L,) int -> mapping (n,) int32.
    """
    v = torch.arange(table.shape[0], dtype=torch.int64, device=table.device)
    for sym in chunk.tolist():
        v = table[v, sym].to(torch.int64)
    return v.to(torch.int32)


def chunk_state_sfa(delta_s: torch.Tensor, chunk: torch.Tensor,
                    start: int = 0) -> torch.Tensor:
    """Final SFA state of one chunk (single lookup per character)."""
    s = int(start)
    for sym in chunk.tolist():
        s = int(delta_s[s, sym])
    return torch.tensor(s, dtype=torch.int32, device=delta_s.device)


def chunk_accept_trace(table: torch.Tensor, accepting: torch.Tensor,
                       chunks: torch.Tensor,
                       entry_states: torch.Tensor) -> torch.Tensor:
    """Accept flags after every position of each chunk, from its entry
    state: (n, k) table, (n,) accepting, (B, L) chunks, (B,) entry states
    -> (B, L) bool. One gather per position, all chunks at once."""
    chunks = chunks.to(torch.int64)
    s = entry_states.to(torch.int64)
    flags = torch.empty(chunks.shape, dtype=torch.bool, device=chunks.device)
    for t in range(chunks.shape[1]):
        s = table[s, chunks[:, t]].to(torch.int64)
        flags[:, t] = accepting[s]
    return flags
