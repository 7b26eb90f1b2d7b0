"""Dispatching wrappers around the CUDA kernels.

A CPU tensor goes to the kernel's plain PyTorch version (:mod:`.ref`); a
CUDA tensor goes to the kernel, or the call raises. There is no fallback.
Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, checks the launch error, and adds one to
``launches[<kernel>]`` for every kernel launch (plain-version calls are not
counted).

Index values are the caller's contract, as for the Pallas kernels: a
frontier or table entry is a state id below ``n`` and a chunk symbol is
below ``k``. The plain versions raise on a bad index; the kernels do not
check (a check would cost a device synchronisation per launch). The port
checks ids where they enter it: ``interop`` checks external arrays,
``PatternBank`` is built from validated DFAs, and ``Scanner`` checks
document symbols.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches = {name: 0 for name in build.KERNELS}

#: Tables of at most this many bytes are staged in shared memory by
#: ``match_bank_chunks`` and ``match_chunks`` (two blocks per SM); larger
#: ones are read from global memory. The wrappers pass their choice to the
#: launch, so this is the one place the threshold lives. ``match_chunks``
#: counts its padded rows (``k | 1`` words).
MATCH_SMEM_TABLE_MAX = 96 * 1024

_VP = ctypes.c_void_p
_ARGTYPES = {
    "fingerprint_bank": [_VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_int, _VP],
    "expand_bank": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, _VP],
    "match_bank_chunks": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _VP],
    "compose": [_VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, _VP],
    "match_chunks": [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP],
    "fingerprint": [_VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int,
                    _VP],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _function(name: str):
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, fn


def _check(name: str, tensors: dict) -> torch.device:
    """Every tensor int32, contiguous, on one device (cpu or cuda)."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    for arg, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


def _launch(name: str, *args) -> None:
    lib, fn = _function(name)
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
    launches[name] += 1


def fingerprint_bank(words: torch.Tensor, weights: torch.Tensor,
                     limbs: torch.Tensor) -> torch.Tensor:
    """Per-pattern Rabin fingerprints: (P, B, W) packed words, (P, W, 2) fold
    weights [hi, lo], (P, 4) Barrett limbs [p_hi, p_lo, mu_hi, mu_lo] — int32
    bit patterns of u32 values -> (P, B, 2) int32 [hi, lo]."""
    dev = _check("fingerprint_bank",
                 dict(words=words, weights=weights, limbs=limbs))
    if words.dim() != 3:
        raise ValueError(f"fingerprint_bank: words must be (P, B, W), got "
                         f"{tuple(words.shape)}")
    P, B, W = words.shape
    if tuple(weights.shape) != (P, W, 2) or tuple(limbs.shape) != (P, 4):
        raise ValueError(
            f"fingerprint_bank: weights {tuple(weights.shape)} / limbs "
            f"{tuple(limbs.shape)} do not fit words {tuple(words.shape)}")
    if dev.type == "cpu":
        return ref.fingerprint_bank(words, weights, limbs)
    out = torch.empty((P, B, 2), dtype=torch.int32, device=dev)
    if P and B:
        with torch.cuda.device(dev):
            _launch("fingerprint_bank", words.data_ptr(), weights.data_ptr(),
                    limbs.data_ptr(), out.data_ptr(), P, B, W)
    return out


def expand_bank(tables: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """Frontier × alphabet expansion: (B, n, k) tables, (B, T, n) frontier
    tiles of state ids < n -> (B, T·k, n),
    ``out[b, t·k + a, q] = tables[b, ft[b, t, q], a]``."""
    dev = _check("expand_bank", dict(tables=tables, ft=ft))
    if tables.dim() != 3 or ft.dim() != 3:
        raise ValueError("expand_bank: tables must be (B, n, k), ft (B, T, n)")
    B, n, k = tables.shape
    if ft.shape[0] != B or ft.shape[2] != n:
        raise ValueError(f"expand_bank: ft {tuple(ft.shape)} does not fit "
                         f"tables {tuple(tables.shape)}")
    if dev.type == "cpu":
        return ref.expand_bank(tables, ft)
    smem_max = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin
    if n * k * 4 > smem_max:
        raise ValueError(
            f"expand_bank: the kernel stages each ({n}, {k}) table in shared "
            f"memory, {n * k * 4} bytes, more than the {smem_max} a block "
            f"of {torch.cuda.get_device_name(dev)} may hold")
    T = ft.shape[1]
    out = torch.empty((B, T * k, n), dtype=torch.int32, device=dev)
    if B and T and n and k:
        with torch.cuda.device(dev):
            _launch("expand_bank", tables.data_ptr(), ft.data_ptr(),
                    out.data_ptr(), B, T, n, k)
    return out


def match_bank_chunks(tables: torch.Tensor, chunks: torch.Tensor,
                      n_starts: int | None = None) -> torch.Tensor:
    """Chunk walks of every table: (P, n, k) tables, (B, L) chunk symbols
    < k -> (P, B, n_starts), column ``q`` the state reached from ``q``.
    ``n_starts`` defaults to ``n`` (whole transition functions). A table
    of at most :data:`MATCH_SMEM_TABLE_MAX` bytes is read from shared
    memory, a larger one from global memory."""
    dev = _check("match_bank_chunks", dict(tables=tables, chunks=chunks))
    if tables.dim() != 3 or chunks.dim() != 2:
        raise ValueError("match_bank_chunks: tables must be (P, n, k), "
                         "chunks (B, L)")
    P, n, k = tables.shape
    B, L = chunks.shape
    n_starts = n if n_starts is None else int(n_starts)
    if not 1 <= n_starts <= n:
        raise ValueError(f"match_bank_chunks: n_starts must be in [1, {n}], "
                         f"got {n_starts}")
    if dev.type == "cpu":
        return ref.match_bank_chunks(tables, chunks, n_starts)
    out = torch.empty((P, B, n_starts), dtype=torch.int32, device=dev)
    if P and B:
        with torch.cuda.device(dev):
            _launch("match_bank_chunks", tables.data_ptr(), chunks.data_ptr(),
                    out.data_ptr(), P, n, k, B, L, n_starts,
                    int(n * k * 4 <= MATCH_SMEM_TABLE_MAX))
    return out


def compose(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Function-monoid combine ("apply f, then g"): (B, n) mapping vectors
    of state ids < n -> (B, n), ``out[b, q] = g[b, f[b, q]]``."""
    dev = _check("compose", dict(f=f, g=g))
    if f.dim() != 2 or f.shape != g.shape:
        raise ValueError(f"compose: f and g must both be (B, n), got "
                         f"{tuple(f.shape)} and {tuple(g.shape)}")
    if dev.type == "cpu":
        return ref.compose(f, g)
    B, n = f.shape
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    if B and n:
        with torch.cuda.device(dev):
            _launch("compose", f.data_ptr(), g.data_ptr(), out.data_ptr(),
                    B, n)
    return out


def match_chunks(table: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """Chunk walks of one table from every state: (n, k) table, (B, L)
    chunk symbols < k -> (B, n), column ``q`` the state reached from ``q``.
    A table whose rows padded to ``k | 1`` words take at most
    :data:`MATCH_SMEM_TABLE_MAX` bytes is read from shared memory, a larger
    one from global memory."""
    dev = _check("match_chunks", dict(table=table, chunks=chunks))
    if table.dim() != 2 or chunks.dim() != 2:
        raise ValueError("match_chunks: table must be (n, k), chunks (B, L)")
    if dev.type == "cpu":
        return ref.match_chunks(table, chunks)
    n, k = table.shape
    B, L = chunks.shape
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    if B and n:
        with torch.cuda.device(dev):
            _launch("match_chunks", table.data_ptr(), chunks.data_ptr(),
                    out.data_ptr(), n, k, B, L,
                    int(n * (k | 1) * 4 <= MATCH_SMEM_TABLE_MAX))
    return out


def fingerprint(words: torch.Tensor, weights: torch.Tensor,
                limbs: torch.Tensor) -> torch.Tensor:
    """Rabin fingerprints under one polynomial: (B, W) packed words,
    (W, 2) fold weights [hi, lo], (4,) Barrett limbs [p_hi, p_lo, mu_hi,
    mu_lo] — int32 bit patterns of u32 values -> (B, 2) int32 [hi, lo]."""
    dev = _check("fingerprint", dict(words=words, weights=weights,
                                     limbs=limbs))
    if words.dim() != 2:
        raise ValueError(f"fingerprint: words must be (B, W), got "
                         f"{tuple(words.shape)}")
    B, W = words.shape
    if tuple(weights.shape) != (W, 2) or tuple(limbs.shape) != (4,):
        raise ValueError(
            f"fingerprint: weights {tuple(weights.shape)} / limbs "
            f"{tuple(limbs.shape)} do not fit words {tuple(words.shape)}")
    if dev.type == "cpu":
        return ref.fingerprint(words, weights, limbs)
    out = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("fingerprint", words.data_ptr(), weights.data_ptr(),
                    limbs.data_ptr(), out.data_ptr(), B, W)
    return out
