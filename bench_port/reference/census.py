"""Plain reference of a windowed census: every window of a sequence
materialised and every DFA walked over it.

Hit ``(p, i)`` is whether pattern ``p``'s DFA, started at its start state
and fed ``seq[i * stride : i * stride + window]`` symbol by symbol, ends in
an accepting state: no blocks, no mapping compositions, no prefix scans.
The windows are cut in blocks of at most ``block`` windows and walked with
:class:`.scan.BankTables`, so a shard of millions of residues fits beside
nothing else on the card. Plain PyTorch on any device; it imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np

#: Windows materialised at a time: 8,192 x 384 int32 symbols are 12.6 MB.
BLOCK = 8192


def n_windows(length: int, window: int, stride: int) -> int:
    """The full windows of a sequence of ``length`` symbols."""
    return (length - window) // stride + 1 if length >= window else 0


def window_hits(tables, seq: np.ndarray, window: int, stride: int,
                block: int = BLOCK) -> np.ndarray:
    """(L,) symbol codes -> (P, W) bool: pattern ``p`` accepts window ``i``.
    ``tables`` is a :class:`.scan.BankTables`."""
    seq = np.asarray(seq)
    W = n_windows(len(seq), window, stride)
    P = tables.base.numel()
    out = np.zeros((P, W), dtype=bool)
    cols = np.arange(window)
    for lo in range(0, W, block):
        hi = min(W, lo + block)
        codes = seq[np.arange(lo, hi)[:, None] * stride + cols[None, :]]
        out[:, lo:hi] = tables.hits(codes, np.full(hi - lo, window),
                                    block=P * block)
    return out
