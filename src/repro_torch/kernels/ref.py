"""Plain PyTorch versions of the three CUDA kernels.

Each function computes exactly what its kernel computes, on any device. The
wrappers in :mod:`.ops` call these for CPU tensors; ``chip_smoke.py`` holds
each kernel against its plain version on the card. u32 data travels as
``int32`` tensors carrying the same 32 bits, as the kernels read it.
"""

from __future__ import annotations

import torch

from ..core.fingerprint import (
    barrett_reduce_u32,
    clmul32,
    i32_to_u32,
    u32_to_i32,
    xor_reduce,
)


def fingerprint_bank(words: torch.Tensor, weights: torch.Tensor,
                     limbs: torch.Tensor) -> torch.Tensor:
    """Per-pattern Rabin fingerprints.

    words: (P, B, W) packed u32 words; weights: (P, W, 2) fold constants
    ``x^(32 i) mod P`` as [hi, lo]; limbs: (P, 4) Barrett constants
    [p_hi, p_lo, mu_hi, mu_lo] — all int32 bit patterns -> (P, B, 2) int32
    [hi, lo].
    """
    w = i32_to_u32(words)
    wt = i32_to_u32(weights)[:, None]                    # (P, 1, W, 2)
    lm = i32_to_u32(limbs)[:, None]                      # (P, 1, 4)
    p_lo_h, p_lo_l = clmul32(w, wt[..., 1])
    p_hi_h, p_hi_l = clmul32(w, wt[..., 0])
    l0 = xor_reduce(p_lo_l)
    l1 = xor_reduce(p_lo_h ^ p_hi_l)
    l2 = xor_reduce(p_hi_h)
    hi, lo = barrett_reduce_u32(
        (torch.zeros_like(l2), l2, l1, l0),
        (lm[..., 0], lm[..., 1], lm[..., 2], lm[..., 3]),
    )
    return u32_to_i32(torch.stack([hi, lo], dim=-1))


def expand_bank(tables: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """Frontier × alphabet expansion over a bank.

    tables: (B, n, k) int32; ft: (B, T, n) int32 state ids < n ->
    (B, T·k, n) int32 with ``out[b, t·k + a, q] = tables[b, ft[b, t, q], a]``
    (row-major (frontier, symbol) candidate order).
    """
    B, T, n = ft.shape
    k = tables.shape[-1]
    rows = torch.arange(B, device=ft.device)[:, None, None]
    cand = tables[rows, ft.to(torch.int64)]               # (B, T, n, k)
    return cand.permute(0, 1, 3, 2).reshape(B, T * k, n)


def match_bank_chunks(tables: torch.Tensor, chunks: torch.Tensor,
                      n_starts: int) -> torch.Tensor:
    """Each chunk run from start states ``0 .. n_starts-1`` of every table.

    tables: (P, n, k) int32; chunks: (B, L) int32 symbols < k ->
    (P, B, n_starts) int32, ``out[p, b, q]`` = the state pattern ``p``
    reaches from ``q`` after chunk ``b``. ``n_starts = n`` gives the chunk's
    whole transition function (enumeration); ``n_starts = 1`` the walk from
    state 0 alone (the SFA path's final state).
    """
    P = tables.shape[0]
    B, L = chunks.shape
    dev = tables.device
    rows = torch.arange(P, device=dev)[:, None, None]
    v = torch.arange(n_starts, device=dev).expand(P, B, n_starts)
    syms = chunks.to(torch.int64)
    for t in range(L):
        v = tables[rows, v, syms[None, :, t, None]].to(torch.int64)
    return v.to(torch.int32)
