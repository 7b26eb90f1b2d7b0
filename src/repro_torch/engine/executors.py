"""Execution primitives behind the port's :class:`~.scanner.Scanner`.

Layout conventions (shared with ``core.multipattern.PatternBank``):

* enumeration tables are ``(P, n, k)`` int32, padded rows are self-loops;
* stacked SFA tables are ``deltas (P, S, k)`` + ``sfa_maps (P, S, n)`` —
  per-pattern SFA transition tables and state -> mapping stacks padded the
  same way (delta padding rows self-loop, mapping padding is identity), so
  the SFA path's chunk functions equal enumeration's entry for entry;
* chunk functions combine with ``monoid.function_monoid``.

The chunk walks go through ``kernels.ops.match_bank_chunks`` (the CUDA
kernel for CUDA tensors); ``match_fn`` swaps in another function of the same
signature, such as the plain version ``kernels.ref.match_bank_chunks``.
Everything else here is plain PyTorch gathers, as the reference left it to
XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import monoid as M
from ..kernels import ops

FN = M.function_monoid()


# --------------------------------------------------------------------------
# Sequential composition (ragged tails, the reference backend)
# --------------------------------------------------------------------------


def compose_sequential(tables: np.ndarray, mapping: np.ndarray,
                       syms: np.ndarray) -> np.ndarray:
    """Extend per-pattern transition functions by ``syms``, one symbol at a
    time: ``m'[p, q] = tables[p, m[p, q], sym]``. (Pg, n, k), (Pg, n), (L,)
    -> (Pg, n), in NumPy — the sequential oracle behind the ``reference``
    backend."""
    rows = np.arange(tables.shape[0])[:, None]
    m = mapping
    for sym in np.asarray(syms):
        m = tables[rows, m, int(sym)]
    return m


def advance_states_sequential(tables: torch.Tensor, states: torch.Tensor,
                              tail: torch.Tensor) -> torch.Tensor:
    """Advance per-(pattern, lane) *states* through per-lane tail symbols:
    ``s'[p, d] = tables[p, s[p, d], tail[d, t]]`` folded over ``t``.
    (Pg, n, k), (Pg, D), (D, T) -> (Pg, D) int32, on the tensors' device —
    one gather per tail symbol. The scanner composes ragged tails with it,
    one lane per (doc, state)."""
    rows = torch.arange(tables.shape[0], device=tables.device)[:, None]
    s = states.to(torch.int64)
    tail = tail.to(torch.int64)
    for t in range(tail.shape[1]):
        s = tables[rows, s, tail[None, :, t]]
    return s.to(torch.int32)


# --------------------------------------------------------------------------
# Banked matchers: enumeration and stacked-SFA modes
# --------------------------------------------------------------------------


def _chunks_of(corpus: torch.Tensor, n_chunks: int) -> torch.Tensor:
    D, L = corpus.shape
    if L % n_chunks:
        raise ValueError(f"corpus length {L} is not a multiple of "
                         f"n_chunks={n_chunks}")
    return corpus.contiguous().view(D * n_chunks, L // n_chunks)


def bank_doc_mappings(tables: torch.Tensor, corpus: torch.Tensor,
                      n_chunks: int = 8, *, match_fn=None) -> torch.Tensor:
    """Enumeration final mapping of every (pattern, doc): (P, n, k) int32,
    (D, L) int32 -> (P, D, n) int32. Every (pattern, chunk) transition
    function comes from one kernel call over the flattened ``D·n_chunks``
    chunk axis; the chunks then fold with the function monoid."""
    match_fn = match_fn or ops.match_bank_chunks
    D = corpus.shape[0]
    P, n, _ = tables.shape
    fns = match_fn(tables, _chunks_of(corpus, n_chunks), n)  # (P, D*nc, n)
    return M.reduce(FN, fns.view(P, D, n_chunks, n), axis=2)


def bank_doc_mappings_sfa(deltas: torch.Tensor, sfa_maps: torch.Tensor,
                          corpus: torch.Tensor, n_chunks: int = 8, *,
                          match_fn=None) -> torch.Tensor:
    """SFA-mode final mapping of every (pattern, doc): (P, S, k) deltas,
    (P, S, n) mapping stacks, (D, L) -> (P, D, n). The SFA delta *is* a DFA
    table, so the same kernel walks each chunk from SFA state 0 (one lane,
    ``n_starts=1``); the mapping stack turns each final SFA state into the
    chunk's DFA-state function, and the chunks fold with the function
    monoid — one (P, D, n) mapping at a time, never the whole
    (P, D·n_chunks, n) stack."""
    match_fn = match_fn or ops.match_bank_chunks
    D = corpus.shape[0]
    P = deltas.shape[0]
    finals = match_fn(deltas, _chunks_of(corpus, n_chunks), 1)
    finals = finals.view(P, D, n_chunks).to(torch.int64)
    rows = torch.arange(P, device=deltas.device)[:, None]
    out = sfa_maps[rows, finals[:, :, 0]]
    for c in range(1, n_chunks):
        out = FN.combine(out, sfa_maps[rows, finals[:, :, c]])
    return out


def hits_of_mappings(maps: torch.Tensor, accepting: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """(P, D, n) final mappings, (P, n) accepting, (P,) starts -> (P, D)
    accept flags, computed where the mappings live."""
    P, D, _ = maps.shape
    idx = starts.to(torch.int64)[:, None, None].expand(P, D, 1)
    finals = maps.gather(2, idx)[:, :, 0]
    return accepting.gather(1, finals.to(torch.int64))
