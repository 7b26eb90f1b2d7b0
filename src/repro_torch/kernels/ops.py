"""Dispatching wrappers around the CUDA kernels.

A CPU tensor goes to the kernel's plain PyTorch version (:mod:`.ref`); a
CUDA tensor goes to the kernel, or the call raises. There is no fallback.
Each wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, checks the launch error, and adds one to
``launches[<kernel>]`` for every kernel launch (plain-version calls are not
counted; ``compose``, ``compose_fold`` and ``compose_fold_rows`` are one
kernel and share its count, as do ``spec_resolve`` and
``spec_resolve_chain``). A walk of ``match_bank_chunks`` from explicit
starts also adds one to ``form_launches["match_bank_chunks.starts"]``, so a
caller can tell the speculative pass from the other walks, and a chained
``spec_resolve`` to ``form_launches["spec_resolve.chain"]``. ``launches`` is
the per-launch count that ``chip_smoke.py`` reads; it does not depend on :mod:`..obs`, which can be
disabled. Besides, every wrapper call, kernel or plain version, adds one to
the ``kernels.<wrapper>.calls`` counter of :mod:`..obs` (the reference
package's counters of the same names count jit trace events, not calls, so
the two packages' ``kernels.*`` values are not compared).

The launch path is paid on every call, and the stream and the chunk folds
make thousands of small ones, so it keeps to a few microseconds of host
time: each C entry point is bound once and cached, the shared-memory limit
and the SM count are read once per device, a chunk walk's launch plan is
made once per shape, the checks build no containers, the device guard
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
from typing import NamedTuple

import torch

from .. import obs
from . import build, ref

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches = {name: 0 for name in build.KERNELS}
#: Launches of one form of a kernel, counted in ``launches`` as well.
form_launches = {"match_bank_chunks.starts": 0, "spec_resolve.chain": 0}

#: ``kernels.<wrapper>.calls`` of :mod:`..obs`, bound once.
_CALLS = {
    name: obs.counter(f"kernels.{name}.calls",
                      help=f"calls of the {name} kernel wrapper")
    for name in ("fingerprint_bank", "expand_bank", "match_bank_chunks",
                 "compose", "compose_fold", "compose_fold_rows",
                 "match_chunks", "fingerprint", "spec_resolve",
                 "spec_resolve_chain")
}

#: Shared memory a block of ``match_bank_chunks`` / ``match_chunks`` fills
#: with table rows (padded to ``k | 1`` words) and its warps' symbol slabs:
#: 113 KB, so two blocks fit an SM of an H100 (228 KB an SM, 1 KB of it
#: reserved a block). A table whose rows do not fit beside the slabs stages
#: its first rows and reads the rest from global memory (L2). A card whose
#: blocks may opt in to less caps it. :func:`match_plan` applies it; this
#: is the one place it lives.
MATCH_SMEM_BLOCK = 113 * 1024
#: Threads a block, and symbol words a warp's slab buffer holds at most
#: (8 KB), of the chunk walks.
MATCH_THREADS, MATCH_WARP_WORDS = 512, 2048
#: Chunk-major walks take fewer chains a thread (more warps) until their
#: warps fill the card to this many an SM.
MATCH_WARPS_PER_SM = 8
#: Rows each table keeps at least where chunk-major walks over tables too
#: large to stage share a block among tables: re-reading the int32 chunks
#: once a table costs more than sending the walks that leave the first rows
#: to L2 (the bundled bank's SFA walks from state 0 stay on rows < 128 for
#: 90 % of their lookups).
MATCH_MIN_ROWS = 32

#: ``spec_resolve``: threads a block of the independent-docs form and the
#: shared bytes it may take for the profile and the table's staged rows
#: (two blocks an SM, as the chunk walks) without exits slabs; the bytes
#: its warps' exits slabs may take together (one block an SM, the table in
#: what is left). The chained form's blocks take up to the card's opt-in
#: limit (one block a pattern, few of them).
SPEC_THREADS, SPEC_SMEM_BLOCK = 512, MATCH_SMEM_BLOCK
SPEC_SLAB_BYTES = 136 * 1024
#: Exit words a warp of the chained form stages at a time: 32 chunks at
#: m = 8, and at least one chunk.
SPEC_GROUP_WORDS = 256

_VP, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry point -> (kernel library, argument types before the stream).
_ENTRY_POINTS = {
    "fingerprint_bank_launch": ("fingerprint_bank",
                                [_VP, _VP, _VP, _VP, _INT, _LONG, _INT]),
    "expand_bank_launch": ("expand_bank",
                           [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT]),
    "match_bank_chunks_launch": ("match_bank_chunks",
                                 [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _LONG,
                                  _INT, _INT, _VP]),
    "compose_launch": ("compose", [_VP, _VP, _VP, _LONG, _INT, _INT]),
    "compose_rows_launch": ("compose",
                            [_VP, _VP, _VP, _INT, _INT, _INT, _LONG, _INT]),
    "match_chunks_launch": ("match_chunks",
                            [_VP, _VP, _VP, _INT, _INT, _LONG, _INT, _VP]),
    "fingerprint_launch": ("fingerprint", [_VP, _VP, _VP, _VP, _LONG, _INT]),
    "spec_resolve_launch": ("spec_resolve",
                            [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT,
                             _INT, _INT, _INT, _LONG, _INT, _INT, _INT, _INT,
                             _INT, _INT]),
    "spec_resolve_chain_launch": ("spec_resolve",
                                  [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT,
                                   _INT, _INT, _INT, _LONG, _INT, _INT, _INT,
                                   _INT, _INT, _INT]),
}

#: Largest grid y extent: the kernels that put the pattern axis there.
_GRID_Y_MAX = 65535


def reset_launches() -> None:
    for counts in (launches, form_launches):
        for name in counts:
            counts[name] = 0


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


@functools.cache
def _sm_count(dev: int) -> int:
    """Streaming multiprocessors of CUDA device ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


class MatchPlan(NamedTuple):
    """How a chunk walk (``match_bank_chunks``, ``match_chunks``) lays out
    its launch; the fields up to ``smem`` in the order of
    ``csrc/match.cuh``'s ``Field``."""

    threads: int          # a block
    chains: int           # independent walks a thread, 1 .. 3
    one_chunk: bool       # start-major (a warp takes one chunk's starts)
    sym_per_word: int     # 4: byte symbols (k <= 256); 1: int32
    chunks_per_warp: int  # chunks of a warp task
    lanes_per_chunk: int  # start states a warp task takes of a chunk
    groups: int           # warp tasks a chunk
    slab_words: int       # symbol words of each chunk staged at a time
    stride: int           # words between slab rows, chunks_per_warp | 1
    rows: int             # table rows staged in shared memory (R)
    patterns: int         # tables a block stages and walks
    smem: int             # shared bytes a block
    global_rows: int      # rows >= R, read from global memory (L2)

    @property
    def branch(self) -> str:
        return "smem" if self.global_rows == 0 else "smem + L2"


@functools.lru_cache(maxsize=1024)
def match_plan(P: int, n: int, k: int, B: int, L: int, n_starts: int,
               sms: int, smem_limit: int,
               from_starts: bool = False) -> MatchPlan:
    """The launch layout of a chunk walk of P (n, k) tables over (B, L)
    chunks from ``n_starts`` start states (``from_starts``: explicit ones)
    on a card of ``sms`` SMs whose blocks may opt in to ``smem_limit`` bytes
    of shared memory (``csrc/match.cuh`` says what each choice is for).

    ``n_starts >= 32`` is start-major: a warp takes one chunk, ⌈n_starts/32⌉
    chains a thread up to 3, several warp tasks a chunk above 96 starts.
    Below it is chunk-major: a warp takes ⌊32·chains / n_starts⌋ chunks,
    with 2 chains a thread, or 1 where 2 would leave the card short of
    :data:`MATCH_WARPS_PER_SM` warps an SM. Walks from explicit starts are
    chunk-major at any ``n_starts`` (their kernels are built only so): above
    32 starts a warp task takes 32 of a chunk's starts on each of its
    ``chains`` chunks, ⌈n_starts/32⌉ warp tasks a chunk.

    A block has :data:`MATCH_THREADS` threads and
    :data:`MATCH_SMEM_BLOCK` bytes (two blocks an SM), the warps' slabs
    taking at most :data:`MATCH_WARP_WORDS` symbol words each and half the
    bytes together (all of a chunk where that fits). The rest holds the tables of
    a group of patterns, groups of even size: as many whole tables as fit;
    or, for tables that do not fit, the first rows of one (start-major:
    walks from every state visit every row) or of as many as keep
    :data:`MATCH_MIN_ROWS` rows each (chunk-major). Two cases take
    one block an SM (twice the bytes) instead, for more rows:
    - a small launch (every pattern's warp tasks fit one 16-warp block on
      its own SM, a stream piece): a block has one pattern, just the warps
      it needs, and its slabs an eighth of the bytes. Its time is its
      slowest walk, so rows matter, not occupancy;
    - start-major on a table that does not fit beside the slabs: walks from
      every state visit every row, where walks from SFA state 0 stay near
      it; with 2 chains a thread.
    No block takes more than ``smem_limit`` bytes for its slabs and rows."""
    spw = 4 if k <= 256 else 1
    rowb = (k | 1) * 4
    one = n_starts >= 32 and not from_starts
    wide = one and n * rowb > MATCH_SMEM_BLOCK // 2
    if one:
        J = min(2 if wide else 3, -(-n_starts // 32))
        cw, qw = 1, 32 * J
        groups = -(-n_starts // qw)
    else:
        qw = min(n_starts, 32)
        groups = -(-n_starts // qw)
        J = (2 if P * -(-B // (64 // qw)) * groups
             >= MATCH_WARPS_PER_SM * sms else 1)
        cw = 32 * J // qw
    tasks = -(-B // cw) * groups
    small = P * tasks <= sms * 16
    threads = min(MATCH_THREADS, 32 * tasks) if small else MATCH_THREADS
    smem = min(MATCH_SMEM_BLOCK * (2 if small or wide else 1), smem_limit)
    stride = cw | 1
    warps = threads // 32
    slab_words = max(1, min(-(-L // spw), MATCH_WARP_WORDS // stride,
                            smem // (8 if small else 2)
                            // (warps * stride * 4)))
    sym = warps * slab_words * stride * 4
    avail = max(0, smem - sym)
    if small or not n:   # a small launch spreads its patterns over SMs
        pg = 1
    else:
        # Whole tables, as many as fit. A table that does not fit: walks
        # from every state visit every row, so one table and as many rows
        # as fit; walks from a few states stay near them, so as many tables
        # as keep MATCH_MIN_ROWS rows each, and the slab is read once for
        # them all.
        per = n if one or n * rowb <= avail else min(n, MATCH_MIN_ROWS)
        most = max(1, min(P, avail // (per * rowb)))
        pg = -(-P // -(-P // most))   # in groups of even size
    rows = min(n, avail // (pg * rowb))
    return MatchPlan(threads, J, one, spw, cw, qw, groups, slab_words, stride,
                     rows, pg, pg * rows * rowb + sym, n - rows)


def match_plan_of(tables: torch.Tensor, chunks: torch.Tensor,
                  n_starts: int | None = None,
                  from_starts: bool = False) -> MatchPlan:
    """The plan a launch on these CUDA tensors takes: ``tables`` (P, n, k)
    as :func:`match_bank_chunks` gets them (``from_starts``: with explicit
    starts), or one (n, k) table as :func:`match_chunks`
    (``n_starts = n``); chunks (B, L)."""
    t = tables if tables.dim() == 3 else tables[None]
    P, n, k = t.shape
    B, L = chunks.shape
    dev = t.get_device()
    return match_plan(P, n, k, B, L, n if n_starts is None else n_starts,
                      _sm_count(dev), _smem_limit(dev), from_starts)


class ResolvePlan(NamedTuple):
    """How a ``spec_resolve`` launch lays out its shared memory: ``rows``
    (R) of the table's ``n`` staged, padded to ``k | 1`` words, the rest read
    from global memory (L2); ``group`` the chunks whose exits a warp of the
    chained form stages at a time (0 for independent docs); ``slab`` the
    words of the exits slab each warp of the independent-docs form stages
    its 32 docs' exits into (0: none, a hit reads global memory); ``smem``
    the shared bytes a block."""

    rows: int
    group: int
    slab: int
    smem: int
    global_rows: int

    @property
    def branch(self) -> str:
        return "smem" if self.global_rows == 0 else "smem + L2"


@functools.lru_cache(maxsize=1024)
def resolve_plan(n: int, k: int, m: int, n_chunks: int, smem_limit: int,
                 chained: bool = False) -> ResolvePlan:
    """The shared-memory layout of a ``spec_resolve`` launch over (n, k)
    tables with an m-state profile and docs of ``n_chunks`` chunks on a
    card whose blocks may opt in to ``smem_limit`` bytes. First the
    profile (m words), then the chained form's staged exits (``group`` =
    ⌊SPEC_GROUP_WORDS / m⌋ chunks of m words, between 1 and 32) or the
    independent form's warp slabs (32 docs of ``n_chunks·m + 1`` words a
    warp, where the :data:`SPEC_THREADS` / 32 of them fit in
    :data:`SPEC_SLAB_BYTES` and leave half of :data:`SPEC_SMEM_BLOCK` of
    the limit), each padded to 16 bytes; then as many table
    rows as fit in the block's budget: ``smem_limit`` for the chained form
    and beside slabs (one block an SM), else :data:`SPEC_SMEM_BLOCK`."""
    rowb = (k | 1) * 4

    def pad(words):
        return -(-words // 4) * 4

    group = max(1, min(32, SPEC_GROUP_WORDS // m)) if chained else 0
    slab = 0 if chained else 32 * (n_chunks * m + 1)
    if 4 * SPEC_THREADS // 32 * slab > min(
            SPEC_SLAB_BYTES, smem_limit - SPEC_SMEM_BLOCK // 2):
        slab = 0
    fixed = 4 * (pad(m) + pad(group * m) + pad(SPEC_THREADS // 32 * slab))
    budget = (smem_limit if chained or slab
              else min(SPEC_SMEM_BLOCK, smem_limit))
    rows = max(0, min(n, (budget - fixed) // rowb))
    return ResolvePlan(rows, group, slab, fixed + rows * rowb, n - rows)


def resolve_plan_of(tables: torch.Tensor, spec: torch.Tensor, n_chunks: int,
                    chained: bool = False) -> ResolvePlan:
    """The plan a ``spec_resolve`` launch on these CUDA tensors takes."""
    _, n, k = tables.shape
    return resolve_plan(n, k, spec.shape[1], n_chunks,
                        _smem_limit(tables.get_device()), chained)


@functools.lru_cache(maxsize=1024)
def _match_args(dev: int, P: int, n: int, k: int, B: int, L: int,
                n_starts: int, name: str, from_starts: bool = False):
    """The plan of a launch on CUDA device ``dev`` as the C int array the
    kernel reads; raises where a block cannot hold it."""
    if n * (k | 1) * 4 >= 1 << 31:
        raise ValueError(f"{name}: a ({n}, {k}) table is more than the kernel "
                         f"indexes")
    limit = _smem_limit(dev)
    plan = match_plan(P, n, k, B, L, n_starts, _sm_count(dev), limit,
                      from_starts)
    if plan.smem > limit:
        raise ValueError(
            f"{name}: the walk stages {plan.smem} bytes of shared memory a "
            f"block, more than the {limit} a block of "
            f"{torch.cuda.get_device_name(dev)} may hold")
    return (ctypes.c_int * (len(plan) - 1))(*plan[:-1])


def fingerprint_bank(words: torch.Tensor, weights: torch.Tensor,
                     limbs: torch.Tensor) -> torch.Tensor:
    """Per-pattern Rabin fingerprints: (P, B, W) packed words, (P, W, 2) fold
    weights [hi, lo], (P, 4) Barrett limbs [p_hi, p_lo, mu_hi, mu_lo] — int32
    bit patterns of u32 values -> (P, B, 2) int32 [hi, lo]."""
    _CALLS["fingerprint_bank"].inc()
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
    _CALLS["expand_bank"].inc()
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
                      n_starts: int | None = None,
                      starts: torch.Tensor | None = None) -> torch.Tensor:
    """Chunk walks of every table: (P, n, k) tables, (B, L) chunk symbols
    < k -> (P, B, n_starts), column ``q`` the state reached from ``q``.
    ``n_starts`` defaults to ``n`` (whole transition functions). Given
    ``starts`` (P, m) state ids < n, column ``q`` walks from
    ``starts[p, q]`` instead and ``n_starts`` is ``m`` (the speculative
    scan's m-lane pass; a (D, L) corpus viewed as (D·C, L/C) chunks gives
    the reference's (P, D, C, m) exits in this layout). The layout, and how
    many rows are staged in shared memory, is :func:`match_plan`'s."""
    _CALLS["match_bank_chunks"].inc()
    if starts is None:
        dev = _check("match_bank_chunks", ("tables", "chunks"), tables,
                     chunks)
    else:
        dev = _check("match_bank_chunks", ("tables", "chunks", "starts"),
                     tables, chunks, starts)
    if tables.dim() != 3 or chunks.dim() != 2:
        raise ValueError("match_bank_chunks: tables must be (P, n, k), "
                         "chunks (B, L)")
    P, n, k = tables.shape
    B, L = chunks.shape
    if starts is None:
        n_starts = n if n_starts is None else int(n_starts)
        if not 1 <= n_starts <= n:
            raise ValueError(f"match_bank_chunks: n_starts must be in "
                             f"[1, {n}], got {n_starts}")
    else:
        if starts.dim() != 2 or starts.shape[0] != P or starts.shape[1] < 1:
            raise ValueError(f"match_bank_chunks: starts must be (P, m) with "
                             f"P = {P}, m >= 1, got {tuple(starts.shape)}")
        if n_starts is not None and int(n_starts) != starts.shape[1]:
            raise ValueError(f"match_bank_chunks: n_starts {n_starts} is not "
                             f"the {starts.shape[1]} columns of starts")
        n_starts = starts.shape[1]
    if dev < 0:
        return ref.match_bank_chunks(tables, chunks, n_starts, starts)
    out = tables.new_empty((P, B, n_starts))
    if P and B:
        _launch("match_bank_chunks_launch", dev, tables.data_ptr(),
                chunks.data_ptr(),
                None if starts is None else starts.data_ptr(),
                out.data_ptr(), P, n, k, B, L, n_starts,
                _match_args(dev, P, n, k, B, L, n_starts,
                            "match_bank_chunks", starts is not None))
        if starts is not None:
            form_launches["match_bank_chunks.starts"] += 1
    return out


def compose(f: torch.Tensor, g: torch.Tensor, *,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Function-monoid combine ("apply f, then g"): (B, n) mapping vectors
    of state ids < n -> (B, n), ``out[b, q] = g[b, f[b, q]]`` — the
    ``m = 1`` case of :func:`compose_fold`.

    ``out``, where given, is a contiguous (B, n) int32 tensor on f's device
    that shares no byte with f or g (a slab of a larger buffer, say); the
    result is written there and ``out`` returned."""
    _CALLS["compose"].inc()
    if out is None:
        dev = _check("compose", ("f", "g"), f, g)
    else:
        dev = _check("compose", ("f", "g", "out"), f, g, out)
    if f.dim() != 2 or f.shape != g.shape:
        raise ValueError(f"compose: f and g must both be (B, n), got "
                         f"{tuple(f.shape)} and {tuple(g.shape)}")
    if out is not None:
        if out.shape != f.shape:
            raise ValueError(f"compose: out must be {tuple(f.shape)}, got "
                             f"{tuple(out.shape)}")
        if _overlaps(out, f) or _overlaps(out, g):
            raise ValueError("compose: out overlaps f or g")
    if dev < 0:
        res = ref.compose(f, g)
        return res if out is None else out.copy_(res)
    B, n = f.shape
    if out is None:
        out = torch.empty_like(f)
    if B and n:
        _launch("compose_launch", dev, f.data_ptr(), g.data_ptr(),
                out.data_ptr(), B, n, 1)
    return out


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two contiguous tensors share a byte."""
    if not (a.numel() and b.numel()):
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def compose_fold(f: torch.Tensor | None, gs: torch.Tensor) -> torch.Tensor:
    """A fold of ``m >= 1`` combines in one launch: f (B, n) or ``None``
    (the identity), gs (B, m, n) mapping vectors of state ids < n ->
    (B, n), ``out[b, q] = gs[b, m-1, … gs[b, 0, f[b, q]] …]`` (apply f,
    then each g in order)."""
    _CALLS["compose_fold"].inc()
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
    _CALLS["compose_fold_rows"].inc()
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
    chunk symbols < k -> (B, n), column ``q`` the state reached from ``q``:
    the ``P = 1``, ``n_starts = n`` walk of :func:`match_bank_chunks`, on
    its own launch (:func:`match_plan` lays it out)."""
    _CALLS["match_chunks"].inc()
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
                _match_args(dev, 1, n, k, B, L, n, "match_chunks"))
    return out


def fingerprint(words: torch.Tensor, weights: torch.Tensor,
                limbs: torch.Tensor) -> torch.Tensor:
    """Rabin fingerprints under one polynomial: (B, W) packed words,
    (W, 2) fold weights [hi, lo], (4,) Barrett limbs [p_hi, p_lo, mu_hi,
    mu_lo] — int32 bit patterns of u32 values -> (B, 2) int32 [hi, lo]."""
    _CALLS["fingerprint"].inc()
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


def _check_resolve(name: str, tables, spec, starts, exits, chunks,
                   n_chunks: int, max_rounds: int) -> tuple:
    """The checks both forms of ``spec_resolve`` make -> (device, C, D)."""
    dev = _check(name, ("tables", "spec", "starts", "exits", "chunks"),
                 tables, spec, starts, exits, chunks)
    if tables.dim() != 3 or spec.dim() != 2 or starts.dim() != 1 \
            or exits.dim() != 3 or chunks.dim() != 2:
        raise ValueError(f"{name}: tables must be (P, n, k), spec (P, m), "
                         f"starts (P,), exits (P, B, m), chunks (B, Lc)")
    P, n, k = tables.shape
    m = spec.shape[1]
    B = chunks.shape[0]
    C = int(n_chunks)
    if (spec.shape[0] != P or starts.shape[0] != P or m < 1
            or tuple(exits.shape) != (P, B, m)):
        raise ValueError(
            f"{name}: spec {tuple(spec.shape)}, starts "
            f"{tuple(starts.shape)} and exits {tuple(exits.shape)} do not fit "
            f"tables {tuple(tables.shape)} and chunks {tuple(chunks.shape)}")
    if C < 1 or B % C:
        raise ValueError(f"{name}: {B} chunks are not whole docs of "
                         f"n_chunks = {n_chunks}")
    if max_rounds < 0:
        raise ValueError(f"{name}: max_rounds must be >= 0, got "
                         f"{max_rounds}")
    if dev >= 0 and n * (k | 1) * 4 >= 1 << 31:
        raise ValueError(f"{name}: a ({n}, {k}) table is more than the kernel "
                         f"indexes")
    return dev, C, B // C


def _resolve_plan_checked(name: str, dev: int, n: int, k: int, m: int,
                          C: int, chained: bool) -> ResolvePlan:
    limit = _smem_limit(dev)
    plan = resolve_plan(n, k, m, C, limit, chained)
    if plan.smem > limit:
        raise ValueError(
            f"{name}: a profile of {m} states takes {plan.smem} bytes of "
            f"shared memory a block, more than the {limit} a block of "
            f"{torch.cuda.get_device_name(dev)} may hold")
    return plan


def spec_resolve(tables: torch.Tensor, spec: torch.Tensor,
                 starts: torch.Tensor, exits: torch.Tensor,
                 chunks: torch.Tensor, n_chunks: int, max_rounds: int
                 ) -> tuple:
    """Validate and repair of speculative scanning in one launch: tables
    (P, n, k), spec (P, m) speculated entry states, starts (P,), exits
    (P, D·C, m) from :func:`match_bank_chunks` with ``starts=spec``, chunks
    (D·C, Lc), C = ``n_chunks`` -> ``(finals (P, D) int32, resolved (P, D)
    bool, hit_chunks, repaired, rounds)``, the last three 0-d int64
    tensors, as :func:`.ref.spec_resolve` computes them in rounds (the CUDA
    kernel walks each lane once; ``csrc/spec_resolve.cu`` says why that is
    the same function). The table rows the kernel stages are
    :func:`resolve_plan`'s."""
    _CALLS["spec_resolve"].inc()
    dev, C, D = _check_resolve("spec_resolve", tables, spec, starts, exits,
                               chunks, n_chunks, max_rounds)
    if dev < 0:
        return ref.spec_resolve(tables, spec, starts, exits, chunks, C,
                                max_rounds)
    P, n, k = tables.shape
    m = spec.shape[1]
    finals = tables.new_empty((P, D))
    resolved = torch.empty((P, D), dtype=torch.bool, device=tables.device)
    if not (P and D):
        totals = torch.zeros(3, dtype=torch.int64, device=tables.device)
        return finals, resolved, totals[0], totals[1], totals[2]
    plan = _resolve_plan_checked("spec_resolve", dev, n, k, m, C, False)
    totals = torch.empty(3, dtype=torch.int64, device=tables.device)
    _launch("spec_resolve_launch", dev, tables.data_ptr(), spec.data_ptr(),
            starts.data_ptr(), exits.data_ptr(), chunks.data_ptr(),
            finals.data_ptr(), resolved.data_ptr(), totals.data_ptr(),
            P, n, k, m, D, C, chunks.shape[1], int(max_rounds), plan.rows,
            plan.slab, plan.smem)
    return finals, resolved, totals[0], totals[1], totals[2]


def spec_resolve_chain(tables: torch.Tensor, spec: torch.Tensor,
                       starts: torch.Tensor, exits: torch.Tensor,
                       chunks: torch.Tensor, n_chunks: int, max_rounds: int
                       ) -> tuple:
    """Validate and repair of a stream's successive blocks in one launch:
    the arguments of :func:`spec_resolve`, the D docs the blocks of one
    input in order, doc d + 1 starting from doc d's exact final state; a
    doc's lane that the bound leaves unresolved is walked on exactly (the
    stream's enumeration fallback) -> ``(finals (P,) int32, totals (4,)
    int64)``: the state after the last doc and ``[hit_chunks, repaired,
    rounds, fallback_lanes]``, the per-doc stats of :func:`spec_resolve`
    summed over the docs (``rounds`` their maximum), as
    :func:`.ref.spec_resolve_chain` computes them doc by doc."""
    _CALLS["spec_resolve_chain"].inc()
    dev, C, D = _check_resolve("spec_resolve_chain", tables, spec, starts,
                               exits, chunks, n_chunks, max_rounds)
    if dev < 0:
        return ref.spec_resolve_chain(tables, spec, starts, exits, chunks, C,
                                      max_rounds)
    P, n, k = tables.shape
    m = spec.shape[1]
    if not (P and D):
        return (starts.clone(),
                torch.zeros(4, dtype=torch.int64, device=tables.device))
    plan = _resolve_plan_checked("spec_resolve_chain", dev, n, k, m, C, True)
    finals = tables.new_empty((P,))
    totals = torch.empty(4, dtype=torch.int64, device=tables.device)
    _launch("spec_resolve_chain_launch", dev, tables.data_ptr(),
            spec.data_ptr(), starts.data_ptr(), exits.data_ptr(),
            chunks.data_ptr(), finals.data_ptr(), totals.data_ptr(),
            P, n, k, m, D, C, chunks.shape[1], int(max_rounds), plan.rows,
            plan.group, plan.smem)
    form_launches["spec_resolve.chain"] += 1
    return finals, totals
