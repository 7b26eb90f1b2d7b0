"""Carry state across from the reference package.

The "weights" of this system are its automata: DFA tables and SFA stacks.
These helpers take the reference package's arrays as NumPy (for example a
reference ``PatternGroup``'s ``tables``, ``deltas`` and ``sfa_maps`` passed
through ``numpy.asarray``) and return the port's objects and tensors, so
both packages can be fed the same automata independently of construction.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.multipattern import PatternBank
from .core.regex import AMINO_ACIDS
from .device import resolve_device


def _int32(name: str, a, ndim: int) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim != ndim or not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"{name} must be a {ndim}-D integer array, got "
                         f"{a.dtype} of shape {a.shape}")
    return np.array(a, dtype=np.int32)


def bank_from_arrays(tables, accepting, starts, n_states=None, ids=None,
                     alphabet: str = AMINO_ACIDS) -> PatternBank:
    """A padded (P, n_max, k) table stack, (P, n_max) accepting flags and
    (P,) start states -> the port's :class:`PatternBank`. ``n_states``
    defaults to ``n_max`` for every pattern."""
    tables = _int32("tables", tables, 3)
    P, n, k = tables.shape
    if len(alphabet) != k:
        raise ValueError(f"alphabet has {len(alphabet)} symbols, tables {k}")
    if tables.size and (tables.min() < 0 or tables.max() >= n):
        raise ValueError("table entries must be state ids in [0, n_max)")
    accepting = np.asarray(accepting, dtype=bool)
    if accepting.shape != (P, n):
        raise ValueError(f"accepting must be {(P, n)}, got {accepting.shape}")
    starts = _int32("starts", starts, 1)
    n_states = (np.full(P, n, dtype=np.int32) if n_states is None
                else _int32("n_states", n_states, 1))
    if starts.shape != (P,) or n_states.shape != (P,):
        raise ValueError("starts and n_states must have one entry per pattern")
    return PatternBank(
        tables=tables, accepting=accepting.copy(), starts=starts,
        n_states=n_states,
        ids=tuple(ids) if ids is not None else tuple(
            f"pattern_{p}" for p in range(P)),
        alphabet=alphabet,
    )


def sfa_stack_from_arrays(deltas, maps, sizes, device="cpu") -> tuple:
    """Stacked SFAs — (P, S, k) deltas, (P, S, n) state -> mapping stacks,
    (P,) true state counts — -> (deltas, maps) int32 tensors on ``device``
    plus the sizes as NumPy, the layout the port's SFA executor reads."""
    deltas = _int32("deltas", deltas, 3)
    maps = _int32("maps", maps, 3)
    sizes = _int32("sizes", sizes, 1)
    P, S, _ = deltas.shape
    if maps.shape[:2] != (P, S) or sizes.shape != (P,):
        raise ValueError(f"maps {maps.shape} / sizes {sizes.shape} do not "
                         f"fit deltas {deltas.shape}")
    if deltas.size and (deltas.min() < 0 or deltas.max() >= S):
        raise ValueError("delta entries must be SFA state ids in [0, S)")
    if maps.size and (maps.min() < 0 or maps.max() >= maps.shape[2]):
        raise ValueError("mapping entries must be DFA state ids in [0, n)")
    dev = resolve_device(device)
    return (torch.as_tensor(deltas, device=dev),
            torch.as_tensor(maps, device=dev), sizes)
