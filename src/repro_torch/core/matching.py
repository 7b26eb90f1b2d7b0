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
``kernels/csrc/match_bank_chunks.cu`` computes for every (pattern, chunk)
cell at once; the engine goes through the kernel wrapper instead.
"""

from __future__ import annotations

import torch


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
