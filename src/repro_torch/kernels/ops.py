"""Dispatching wrappers around the CUDA kernels.

A CPU tensor goes to the kernel's plain PyTorch version (:mod:`.ref`); a
CUDA tensor goes to the kernel, or the call raises. There is no fallback.
Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, checks the launch error, and adds one to
``launches[<kernel>]`` for every kernel launch (plain-version calls are not
counted; ``compose``, ``compose_fold`` and ``compose_fold_rows`` are one
kernel and share its count).

The launch path is paid on every call, and the stream and the chunk folds
make thousands of small ones, so it keeps to a few microseconds of host
time: each C entry point is bound once and cached, the shared-memory limit
is read once per device, the checks build no containers, the device guard
is entered only when the tensors are not on the current device, and the
stream is PyTorch's raw current-stream handle.

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
import functools

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

_VP, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (kernel library, argument types before the stream).
_ENTRY_POINTS = {
    "fingerprint_bank_launch": ("fingerprint_bank",
                                [_VP, _VP, _VP, _VP, _INT, _LONG, _INT]),
    "expand_bank_launch": ("expand_bank",
                           [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT]),
    "match_bank_chunks_launch": ("match_bank_chunks",
                                 [_VP, _VP, _VP, _INT, _INT, _INT, _LONG,
                                  _INT, _INT, _INT]),
    "compose_launch": ("compose", [_VP, _VP, _VP, _LONG, _INT, _INT]),
    "compose_rows_launch": ("compose",
                            [_VP, _VP, _VP, _INT, _INT, _INT, _LONG, _INT]),
    "match_chunks_launch": ("match_chunks",
                            [_VP, _VP, _VP, _INT, _INT, _LONG, _INT, _INT]),
    "fingerprint_launch": ("fingerprint", [_VP, _VP, _VP, _VP, _LONG, _INT]),
}

#: Largest grid y extent: the kernels that put the pattern axis there.
_GRID_Y_MAX = 65535


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _bind(entry: str) -> tuple:
    """(ctypes function, error-string function, kernel) of a C entry point,
    bound at its first launch; later launches look nothing else up."""
    kernel, argtypes = _ENTRY_POINTS[entry]
    lib = build.load(kernel)
    fn = getattr(lib, entry)
    fn.argtypes = [*argtypes, _VP]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{kernel}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err, kernel


def _check(name: str, args: tuple, *tensors) -> int:
    """Every tensor int32, contiguous and on one device, the CPU or a CUDA
    device -> that device's CUDA index, or -1 on the CPU. ``args`` names the
    tensors in order."""
    dev = tensors[0].get_device()
    for arg, t in zip(args, tensors):
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on several devices "
                             f"{[x.device for x in tensors]}")
        if not (t.is_cuda if dev >= 0 else t.is_cpu):
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


def _launch(entry: str, dev: int, *args) -> None:
    """Call ``entry`` on CUDA device ``dev``'s current stream, raise if the
    launch failed, count it."""
    fn, err, kernel = _bind(entry)
    if dev == torch._C._cuda_getDevice():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if code != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{err(code).decode()} ({code})")
    launches[kernel] += 1


@functools.cache
def _smem_limit(dev: int) -> int:
    """Shared memory a block of CUDA device ``dev`` may opt in to, bytes."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def fingerprint_bank(words: torch.Tensor, weights: torch.Tensor,
                     limbs: torch.Tensor) -> torch.Tensor:
    """Per-pattern Rabin fingerprints: (P, B, W) packed words, (P, W, 2) fold
    weights [hi, lo], (P, 4) Barrett limbs [p_hi, p_lo, mu_hi, mu_lo] — int32
    bit patterns of u32 values -> (P, B, 2) int32 [hi, lo]."""
    dev = _check("fingerprint_bank", ("words", "weights", "limbs"),
                 words, weights, limbs)
    if words.dim() != 3:
        raise ValueError(f"fingerprint_bank: words must be (P, B, W), got "
                         f"{tuple(words.shape)}")
    P, B, W = words.shape
    if tuple(weights.shape) != (P, W, 2) or tuple(limbs.shape) != (P, 4):
        raise ValueError(
            f"fingerprint_bank: weights {tuple(weights.shape)} / limbs "
            f"{tuple(limbs.shape)} do not fit words {tuple(words.shape)}")
    if dev < 0:
        return ref.fingerprint_bank(words, weights, limbs)
    out = words.new_empty((P, B, 2))
    if P and B:
        _launch("fingerprint_bank_launch", dev, words.data_ptr(),
                weights.data_ptr(), limbs.data_ptr(), out.data_ptr(), P, B, W)
    return out


def expand_bank(tables: torch.Tensor, ft: torch.Tensor,
                word_masks: torch.Tensor | None = None):
    """Frontier × alphabet expansion: (B, n, k) tables, (B, T, n) frontier
    tiles of state ids < n -> (B, T·k, n) candidates,
    ``cand[b, t·k + a, q] = tables[b, ft[b, t, q], a]``.

    With ``word_masks`` (B, W), W = ⌈n/2⌉, the same launch also packs the
    candidates (two 16-bit ids a u32 word, an odd tail's high half 0) and
    masks them: -> ``(cand, words)``, words (B, T·k, W) int32 bit patterns
    of ``pack_states_u32(cand) & word_masks`` — what ``fingerprint_bank``
    reads."""
    if word_masks is None:
        dev = _check("expand_bank", ("tables", "ft"), tables, ft)
    else:
        dev = _check("expand_bank", ("tables", "ft", "word_masks"),
                     tables, ft, word_masks)
    if tables.dim() != 3 or ft.dim() != 3:
        raise ValueError("expand_bank: tables must be (B, n, k), ft (B, T, n)")
    B, n, k = tables.shape
    T = ft.shape[1]
    if ft.shape[0] != B or ft.shape[2] != n:
        raise ValueError(f"expand_bank: ft {tuple(ft.shape)} does not fit "
                         f"tables {tuple(tables.shape)}")
    W = (n + 1) // 2
    if word_masks is not None and tuple(word_masks.shape) != (B, W):
        raise ValueError(f"expand_bank: word_masks must be {(B, W)}, got "
                         f"{tuple(word_masks.shape)}")
    if dev < 0:
        return ref.expand_bank(tables, ft, word_masks)
    smem, limit = n * (k | 1) * 4, _smem_limit(dev)
    if smem > limit:
        raise ValueError(
            f"expand_bank: the kernel stages each ({n}, {k}) table in shared "
            f"memory with rows of {k | 1} words, {smem} bytes, more than the "
            f"{limit} a block of {torch.cuda.get_device_name(dev)} may hold")
    if B > _GRID_Y_MAX or T * k * W >= 1 << 31:
        raise ValueError(f"expand_bank: {B} tables of {T * k * W} word "
                         f"pairs each are more than one launch indexes")
    cand = ft.new_empty((B, T * k, n))
    words = None if word_masks is None else ft.new_empty((B, T * k, W))
    if B and T and n and k:
        _launch("expand_bank_launch", dev, tables.data_ptr(), ft.data_ptr(),
                None if words is None else word_masks.data_ptr(),
                cand.data_ptr(), None if words is None else words.data_ptr(),
                B, T, n, k)
    return cand if words is None else (cand, words)


def match_bank_chunks(tables: torch.Tensor, chunks: torch.Tensor,
                      n_starts: int | None = None) -> torch.Tensor:
    """Chunk walks of every table: (P, n, k) tables, (B, L) chunk symbols
    < k -> (P, B, n_starts), column ``q`` the state reached from ``q``.
    ``n_starts`` defaults to ``n`` (whole transition functions). A table
    of at most :data:`MATCH_SMEM_TABLE_MAX` bytes is read from shared
    memory, a larger one from global memory."""
    dev = _check("match_bank_chunks", ("tables", "chunks"), tables, chunks)
    if tables.dim() != 3 or chunks.dim() != 2:
        raise ValueError("match_bank_chunks: tables must be (P, n, k), "
                         "chunks (B, L)")
    P, n, k = tables.shape
    B, L = chunks.shape
    n_starts = n if n_starts is None else int(n_starts)
    if not 1 <= n_starts <= n:
        raise ValueError(f"match_bank_chunks: n_starts must be in [1, {n}], "
                         f"got {n_starts}")
    if dev < 0:
        return ref.match_bank_chunks(tables, chunks, n_starts)
    out = tables.new_empty((P, B, n_starts))
    if P and B:
        _launch("match_bank_chunks_launch", dev, tables.data_ptr(),
                chunks.data_ptr(), out.data_ptr(), P, n, k, B, L, n_starts,
                int(n * k * 4 <= MATCH_SMEM_TABLE_MAX))
    return out


def compose(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Function-monoid combine ("apply f, then g"): (B, n) mapping vectors
    of state ids < n -> (B, n), ``out[b, q] = g[b, f[b, q]]`` — the
    ``m = 1`` case of :func:`compose_fold`."""
    dev = _check("compose", ("f", "g"), f, g)
    if f.dim() != 2 or f.shape != g.shape:
        raise ValueError(f"compose: f and g must both be (B, n), got "
                         f"{tuple(f.shape)} and {tuple(g.shape)}")
    if dev < 0:
        return ref.compose(f, g)
    B, n = f.shape
    out = torch.empty_like(f)
    if B and n:
        _launch("compose_launch", dev, f.data_ptr(), g.data_ptr(),
                out.data_ptr(), B, n, 1)
    return out


def compose_fold(f: torch.Tensor | None, gs: torch.Tensor) -> torch.Tensor:
    """A fold of ``m >= 1`` combines in one launch: f (B, n) or ``None``
    (the identity), gs (B, m, n) mapping vectors of state ids < n ->
    (B, n), ``out[b, q] = gs[b, m-1, … gs[b, 0, f[b, q]] …]`` (apply f,
    then each g in order)."""
    if f is None:
        dev = _check("compose_fold", ("gs",), gs)
    else:
        dev = _check("compose_fold", ("f", "gs"), f, gs)
    if gs.dim() != 3 or gs.shape[1] < 1:
        raise ValueError(f"compose_fold: gs must be (B, m, n) with m >= 1, "
                         f"got {tuple(gs.shape)}")
    B, m, n = gs.shape
    if f is not None and (f.dim() != 2 or f.shape[0] != B
                          or f.shape[1] != n):
        raise ValueError(f"compose_fold: f must be {(B, n)}, got "
                         f"{tuple(f.shape)}")
    if dev < 0:
        return ref.compose_fold(f, gs)
    out = gs.new_empty((B, n))
    if B and n:
        _launch("compose_launch", dev, None if f is None else f.data_ptr(),
                gs.data_ptr(), out.data_ptr(), B, n, m)
    return out


def compose_fold_rows(stacks: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """A fold of rows of a mapping stack in one launch: stacks (P, S, n)
    mapping vectors of state ids < n, idx (P, D, m) row ids < S, m >= 1 ->
    (P, D, n), the identity then ``stacks[p, idx[p, d, 0]]``, …,
    ``stacks[p, idx[p, d, m-1]]`` in order (the SFA scan's chunk fold: row
    ``idx[p, d, j]`` is chunk ``j``'s final SFA state)."""
    dev = _check("compose_fold_rows", ("stacks", "idx"), stacks, idx)
    if (stacks.dim() != 3 or idx.dim() != 3
            or idx.shape[0] != stacks.shape[0] or idx.shape[2] < 1):
        raise ValueError(f"compose_fold_rows: stacks must be (P, S, n), idx "
                         f"(P, D, m) with m >= 1, got {tuple(stacks.shape)} "
                         f"and {tuple(idx.shape)}")
    P, S, n = stacks.shape
    D, m = idx.shape[1], idx.shape[2]
    if dev < 0:
        return ref.compose_fold_rows(stacks, idx)
    if P > _GRID_Y_MAX:
        raise ValueError(f"compose_fold_rows: {P} stacks are more than one "
                         f"launch indexes ({_GRID_Y_MAX})")
    out = stacks.new_empty((P, D, n))
    if P and D and n:
        _launch("compose_rows_launch", dev, stacks.data_ptr(), idx.data_ptr(),
                out.data_ptr(), P, S, n, D, m)
    return out


def match_chunks(table: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """Chunk walks of one table from every state: (n, k) table, (B, L)
    chunk symbols < k -> (B, n), column ``q`` the state reached from ``q``.
    A table whose rows padded to ``k | 1`` words take at most
    :data:`MATCH_SMEM_TABLE_MAX` bytes is read from shared memory, a larger
    one from global memory."""
    dev = _check("match_chunks", ("table", "chunks"), table, chunks)
    if table.dim() != 2 or chunks.dim() != 2:
        raise ValueError("match_chunks: table must be (n, k), chunks (B, L)")
    if dev < 0:
        return ref.match_chunks(table, chunks)
    n, k = table.shape
    B, L = chunks.shape
    out = table.new_empty((B, n))
    if B and n:
        _launch("match_chunks_launch", dev, table.data_ptr(),
                chunks.data_ptr(), out.data_ptr(), n, k, B, L,
                int(n * (k | 1) * 4 <= MATCH_SMEM_TABLE_MAX))
    return out


def fingerprint(words: torch.Tensor, weights: torch.Tensor,
                limbs: torch.Tensor) -> torch.Tensor:
    """Rabin fingerprints under one polynomial: (B, W) packed words,
    (W, 2) fold weights [hi, lo], (4,) Barrett limbs [p_hi, p_lo, mu_hi,
    mu_lo] — int32 bit patterns of u32 values -> (B, 2) int32 [hi, lo]."""
    dev = _check("fingerprint", ("words", "weights", "limbs"),
                 words, weights, limbs)
    if words.dim() != 2:
        raise ValueError(f"fingerprint: words must be (B, W), got "
                         f"{tuple(words.shape)}")
    B, W = words.shape
    if tuple(weights.shape) != (W, 2) or tuple(limbs.shape) != (4,):
        raise ValueError(
            f"fingerprint: weights {tuple(weights.shape)} / limbs "
            f"{tuple(limbs.shape)} do not fit words {tuple(words.shape)}")
    if dev < 0:
        return ref.fingerprint(words, weights, limbs)
    out = words.new_empty((B, 2))
    if B:
        _launch("fingerprint_launch", dev, words.data_ptr(),
                weights.data_ptr(), limbs.data_ptr(), out.data_ptr(), B, W)
    return out
