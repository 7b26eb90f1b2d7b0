"""Plain reference of a bank scan: every DFA walked over every document.

Hit ``(p, d)`` is whether pattern ``p``'s DFA, started at its start state
and fed document ``d`` symbol by symbol, ends in an accepting state: no
chunks, no SFAs, no speculation. Plain PyTorch on any device; it imports
nothing of the program and builds its tables from the benchmark's own DFAs.
"""

from __future__ import annotations

import numpy as np
import torch


class BankTables:
    """A bank's DFAs as one flat table: pattern ``p``'s row for state ``s``
    starts at ``base[p] + s * k``. ``dtype`` is the dtype the state ids are
    held in (the control holds them in fewer bits)."""

    def __init__(self, tables, accepting, starts, device,
                 dtype=torch.int32):
        k = int(tables[0].shape[1])
        sizes = np.asarray([len(t) for t in tables], dtype=np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        flat = np.concatenate([np.asarray(t).reshape(-1) for t in tables])
        self.k = k
        self.base = torch.as_tensor(offs[:-1] * k, device=device)
        self.acc_base = torch.as_tensor(offs[:-1], device=device)
        self.table = torch.as_tensor(flat, device=device).to(dtype)
        self.accepting = torch.as_tensor(np.concatenate(accepting),
                                         device=device)
        self.starts = torch.as_tensor(np.asarray(starts), device=device
                                      ).to(dtype)
        self.device = device

    def hits(self, codes: np.ndarray, lengths: np.ndarray,
             block: int = 1 << 22) -> np.ndarray:
        """(D, L) symbol codes, (D,) lengths -> (P, D) bool hit matrix,
        in blocks of documents of about ``block`` (pattern, doc) lanes."""
        P = self.base.numel()
        D = codes.shape[0]
        out = np.zeros((P, D), dtype=bool)
        step = max(1, block // P)
        for lo in range(0, D, step):
            hi = min(D, lo + step)
            out[:, lo:hi] = self._block(codes[lo:hi], lengths[lo:hi])
        return out

    def _block(self, codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        dev = self.device
        L = int(lengths.max()) if lengths.size else 0
        sym = torch.as_tensor(codes[:, :L], device=dev).to(torch.int64)
        lens = torch.as_tensor(lengths, device=dev)
        dtype = self.table.dtype
        s = self.starts[:, None].expand(-1, codes.shape[0]).clone()
        base = self.base[:, None]
        for t in range(L):
            nxt = self.table[base + s.to(torch.int64) * self.k + sym[None, :, t]]
            s = torch.where((t < lens)[None, :], nxt, s).to(dtype)
        acc = self.accepting[self.acc_base[:, None] + s.to(torch.int64)]
        return acc.cpu().numpy()
