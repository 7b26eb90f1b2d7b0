"""Execution primitives behind the port's :class:`~.scanner.Scanner`.

Layout conventions (shared with ``core.multipattern.PatternBank``):

* enumeration tables are ``(P, n, k)`` int32, padded rows are self-loops;
* stacked SFA tables are ``deltas (P, S, k)`` + ``sfa_maps (P, S, n)`` —
  per-pattern SFA transition tables and state -> mapping stacks padded the
  same way (delta padding rows self-loop, mapping padding is identity), so
  the SFA path's chunk functions equal enumeration's entry for entry;
* chunk functions combine with ``monoid.function_monoid``.

The chunk walks go through ``kernels.ops.match_chunks`` (one table) and
``kernels.ops.match_bank_chunks`` (a bank) — the CUDA kernels for CUDA
tensors — and every fold of chunk functions through the ``compose`` kernel:
behind ``monoid.function_monoid``, or ``kernels.ops.compose_fold_rows`` for
the SFA path's mapping rows. ``match_fn`` / ``monoid`` / ``fold_rows`` swap
in other functions of the same signature, such as the plain versions of
``kernels.ref``. The rest is plain PyTorch gathers, as the reference left it
to XLA.

The distributed builders (``distributed_*_fn``, ``distributed_bank_matcher``
and ``throughput_matcher``) are the reference's ``shard_map`` builders over
a :mod:`torch.distributed` mesh (:mod:`..mesh`): every rank calls the
returned function with the whole arguments, runs the local path above on
its slice, and gets the whole result back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..construction import SFA
from ..core import monoid as M
from ..core.dfa import DFA
from ..core.matching import chunk_accept_trace
from ..device import resolve_device
from ..kernels import ops
from ..mesh import all_gather, all_reduce, local_shard

FN = M.function_monoid()


# --------------------------------------------------------------------------
# Single-pattern parallel matching (one input, one automaton)
# --------------------------------------------------------------------------


def _split(symbols: torch.Tensor, n_chunks: int) -> torch.Tensor:
    L = symbols.shape[0]
    if L % n_chunks:
        raise ValueError(f"input length {L} is not a multiple of "
                         f"n_chunks={n_chunks} (pad or crop first)")
    return symbols.contiguous().view(n_chunks, L // n_chunks)


def match_parallel_enumeration(table: torch.Tensor, symbols: torch.Tensor,
                               n_chunks: int = 8) -> torch.Tensor:
    """Parallel match via enumeration: (n, k) table, (L,) symbols -> the
    (n,) mapping of the whole input. ``L`` must be a multiple of
    ``n_chunks``."""
    return M.reduce(FN, ops.match_chunks(table, _split(symbols, n_chunks)),
                    axis=0)


def match_parallel_sfa(delta_s: torch.Tensor, sfa_mappings: torch.Tensor,
                       symbols: torch.Tensor,
                       n_chunks: int = 8) -> torch.Tensor:
    """Parallel match via the SFA (the paper's method): each chunk walks
    δ_s from SFA state 0 (one lane of ``match_bank_chunks``), its mapping
    is read off the final state, and the chunks fold -> (n,): the
    one-pattern, one-document :func:`bank_doc_mappings_sfa`."""
    return bank_doc_mappings_sfa(delta_s[None], sfa_mappings[None],
                                 symbols[None], n_chunks)[0, 0]


def find_matches_parallel(table: torch.Tensor, accepting: torch.Tensor,
                          symbols: torch.Tensor, start: int,
                          n_chunks: int = 8, *, match_fn=None,
                          monoid: M.Monoid = FN) -> torch.Tensor:
    """Per-position accept flags (L,) bool, in two parallel passes: (1)
    chunk functions (``match_chunks``) and their exclusive scan give each
    chunk's entry state; (2) every chunk's accept trace from its entry
    state, all chunks at once."""
    match_fn = match_fn or ops.match_chunks
    chunks = _split(symbols, n_chunks)
    prefix = M.exclusive_scan(monoid, match_fn(table, chunks), axis=0)
    entry = prefix[:, start]                              # (n_chunks,)
    return chunk_accept_trace(table, accepting, chunks, entry).reshape(-1)


def accepts_parallel(dfa: DFA, text: str, n_chunks: int = 8,
                     sfa: SFA | None = None, device="cuda") -> bool:
    """Does ``text`` match? The head (a multiple of ``n_chunks`` symbols)
    runs chunk-parallel on ``device`` — through the SFA when one is given,
    else by enumeration — and the ragged tail sequentially on the host."""
    dev = resolve_device(device)
    symbols = dfa.encode(text)
    head_len = len(symbols) - len(symbols) % n_chunks
    state = dfa.start
    if head_len:
        head = torch.as_tensor(symbols[:head_len], device=dev)
        if sfa is not None:
            mapping = match_parallel_sfa(
                torch.as_tensor(sfa.delta, device=dev),
                torch.as_tensor(sfa.mappings, device=dev), head, n_chunks)
        else:
            mapping = match_parallel_enumeration(
                torch.as_tensor(dfa.table, device=dev), head, n_chunks)
        state = int(mapping[dfa.start])
    state = dfa.run(symbols[head_len:], state=state)
    return bool(dfa.accepting[state])


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
                      n_chunks: int = 8, *, match_fn=None,
                      monoid: M.Monoid = FN) -> torch.Tensor:
    """Enumeration final mapping of every (pattern, doc): (P, n, k) int32,
    (D, L) int32 -> (P, D, n) int32. Every (pattern, chunk) transition
    function comes from one kernel call over the flattened ``D·n_chunks``
    chunk axis; the chunks then fold with the function monoid."""
    match_fn = match_fn or ops.match_bank_chunks
    D = corpus.shape[0]
    P, n, _ = tables.shape
    fns = match_fn(tables, _chunks_of(corpus, n_chunks), n)  # (P, D*nc, n)
    return M.reduce(monoid, fns.view(P, D, n_chunks, n), axis=2)


def bank_doc_mappings_sfa(deltas: torch.Tensor, sfa_maps: torch.Tensor,
                          corpus: torch.Tensor, n_chunks: int = 8, *,
                          match_fn=None, fold_rows=None) -> torch.Tensor:
    """SFA-mode final mapping of every (pattern, doc): (P, S, k) deltas,
    (P, S, n) mapping stacks, (D, L) -> (P, D, n). The SFA delta *is* a DFA
    table, so the same kernel walks each chunk from SFA state 0 (one lane,
    ``n_starts=1``); the chunks' final SFA states index their mapping rows,
    and one ``compose`` launch folds those rows in chunk order
    (``fold_rows``, ``kernels.ops.compose_fold_rows`` by default) — no
    (P, D, n) mapping is gathered per chunk."""
    match_fn = match_fn or ops.match_bank_chunks
    fold_rows = fold_rows or ops.compose_fold_rows
    D = corpus.shape[0]
    P = deltas.shape[0]
    finals = match_fn(deltas, _chunks_of(corpus, n_chunks), 1)
    return fold_rows(sfa_maps, finals.view(P, D, n_chunks))


def match_bank_parallel(tables: torch.Tensor, symbols: torch.Tensor,
                        n_chunks: int = 8) -> torch.Tensor:
    """Final mappings of one input under every pattern: (P, n, k), (L,) ->
    (P, n) int32 (enumeration)."""
    return bank_doc_mappings(tables, symbols[None], n_chunks)[:, 0]


def match_bank_parallel_sfa(deltas: torch.Tensor, sfa_maps: torch.Tensor,
                            symbols: torch.Tensor,
                            n_chunks: int = 8) -> torch.Tensor:
    """SFA-mode twin of :func:`match_bank_parallel`: (P, S, k) deltas,
    (P, S, n) mapping stacks, (L,) -> (P, n), bit-identical to it on the
    same padded layout."""
    return bank_doc_mappings_sfa(deltas, sfa_maps, symbols[None],
                                 n_chunks)[:, 0]


def sliding_window_mappings(block_maps: torch.Tensor, m: int
                            ) -> torch.Tensor:
    """All length-``m`` sliding-window compositions of consecutive block
    transition functions: (Pg, B, n) -> (Pg, B - m + 1, n), output ``w``
    being ``block w`` then ... then ``block w+m-1``.

    The Gil–Werman trick on the function monoid: tile the block axis into
    groups of ``m``, run one *suffix* scan and one *prefix* scan per tile
    (each block's function enters two log-depth scans), and stitch window
    ``w = t·m + j`` as ``suffix[t, j]`` then ``prefix[t+1, j-1]`` (identity
    when ``j = 0``). Composition is exactly associative, so the result is
    bit-identical to composing every window on its own.
    """
    Pg, B, n = block_maps.shape
    W = B - m + 1
    if W < 1:
        raise ValueError(f"need at least m={m} blocks, got {B}")
    if m == 1:
        return block_maps
    T = -(-B // m)  # tiles of m blocks, the last padded with identities
    ident = torch.arange(n, dtype=block_maps.dtype, device=block_maps.device)
    x = torch.cat([block_maps, ident.expand(Pg, T * m - B, n)], dim=1)
    x = x.view(Pg, T, m, n)
    # A reverse scan folds the right end in first, so the suffix combine
    # "block j then j+1 then ..." needs the argument-flipped monoid.
    flipped = M.Monoid(lambda a, b: FN.combine(b, a), FN.identity, FN.name)
    suffix = M.scan(flipped, x, axis=2, reverse=True)  # [t,j] = tm+j..tm+m-1
    prefix = M.scan(FN, x, axis=2)                     # [t,j] = tm..tm+j
    # The prefix shifted one block right within each tile (j = 0 ->
    # identity) and one whole tile down: flat index w + m lands on tile t+1,
    # offset j.
    shifted = torch.cat([ident.expand(Pg, T, 1, n), prefix[:, :, :-1]], dim=2)
    shifted = torch.cat([shifted, ident.expand(Pg, 1, m, n)], dim=1)
    s_flat = suffix.reshape(Pg, T * m, n)[:, :W]
    q_flat = shifted.reshape(Pg, (T + 1) * m, n)[:, m:m + W]
    return FN.combine(s_flat, q_flat)


def hits_of_mappings(maps: torch.Tensor, accepting: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """(P, D, n) final mappings, (P, n) accepting, (P,) starts -> (P, D)
    accept flags, computed where the mappings live."""
    P, D, _ = maps.shape
    idx = starts.to(torch.int64)[:, None, None].expand(P, D, 1)
    finals = maps.gather(2, idx)[:, :, 0]
    return accepting.gather(1, finals.to(torch.int64))


def bank_hits(tables: torch.Tensor, accepting: torch.Tensor,
              starts: torch.Tensor, corpus: torch.Tensor,
              n_chunks: int = 8) -> torch.Tensor:
    """Hit matrix of a corpus against the bank (enumeration): (P, n, k),
    (P, n) bool, (P,), (D, L) -> (P, D) bool."""
    return hits_of_mappings(bank_doc_mappings(tables, corpus, n_chunks),
                            accepting, starts)


def census_bank(tables: torch.Tensor, accepting: torch.Tensor,
                starts: torch.Tensor, corpus: torch.Tensor,
                n_chunks: int = 8) -> torch.Tensor:
    """Per-pattern hit counts over a corpus, (P,) int32 — the ScanProsite
    census."""
    return bank_hits(tables, accepting, starts, corpus,
                     n_chunks).sum(1, dtype=torch.int32)


# --------------------------------------------------------------------------
# Distributed builders (the reference's shard_map, over a mesh's ranks)
# --------------------------------------------------------------------------


def distributed_match_fn(mesh, table_shape: tuple, axis_name: str = "data"):
    """-> ``matcher(table, symbols, sub_chunks=8)``: the (n,) mapping of
    the whole input. ``symbols`` (L,) shard over ``axis_name``; each rank
    walks its shard in ``sub_chunks`` chunks, folds them, and the ranks'
    functions combine in one :func:`~..core.monoid.shard_reduce`."""

    def matcher(table, symbols, sub_chunks: int = 8):
        shard = local_shard(symbols, mesh, axis_name, what="input length")
        local = match_parallel_enumeration(table, shard, sub_chunks)
        return M.shard_reduce(FN, local[None], mesh, axis_name)[0]

    return matcher


def throughput_matcher(mesh, start: int = 0, axis_name: str = "data"):
    """-> ``matcher(table, accepting, batch)``: (B,) accept flags of a
    (B, L) batch of independent strings, rows sharded over ``axis_name``
    (the many-strings workload of the related work). Each row is one chunk
    walked from every state; its mapping is read at ``start``."""

    def matcher(table, accepting, batch):
        rows = local_shard(batch, mesh, axis_name, what="batch size")
        maps = ops.match_chunks(table, rows.contiguous())      # (B_r, n)
        return all_gather(accepting[maps[:, start].to(torch.int64)],
                          mesh, axis_name)

    return matcher


def distributed_bank_matcher(mesh, pattern_axis: str = "model",
                             data_axis: str = "data"):
    """-> ``matcher(tables, symbols, sub_chunks=8)``: (P, n) whole-input
    mappings, patterns sharded over ``pattern_axis`` and symbols over
    ``data_axis`` of a 2-D mesh. Each rank folds its patterns' chunk
    functions on its symbols, one ``shard_reduce`` over ``data_axis``
    combines them (one all_gather of (P_local, n) ints), and the pattern
    shards gather back."""

    def matcher(tables, symbols, sub_chunks: int = 8):
        local_tables = local_shard(tables, mesh, pattern_axis,
                                   what="pattern count")
        shard = local_shard(symbols, mesh, data_axis, what="input length")
        local = match_bank_parallel(local_tables, shard, sub_chunks)
        maps = M.shard_reduce(FN, local, mesh, data_axis)
        return all_gather(maps, mesh, pattern_axis)

    return matcher


def distributed_census_fn(mesh, pattern_axis: str = "model",
                          data_axis: str = "data", n_chunks: int = 8):
    """-> ``census(tables, accepting, starts, corpus)``: (P,) int32 hit
    counts, corpus rows sharded over ``data_axis`` and patterns over
    ``pattern_axis``; the ranks' partial counts combine with one sum over
    ``data_axis`` (the reference's ``psum``)."""

    def census(tables, accepting, starts, corpus):
        args = [local_shard(a, mesh, pattern_axis, what="pattern count")
                for a in (tables, accepting, starts)]
        docs = local_shard(corpus, mesh, data_axis, what="doc count")
        counts = all_reduce(census_bank(*args, docs, n_chunks), mesh,
                            data_axis, "sum")
        return all_gather(counts, mesh, pattern_axis)

    return census


def distributed_doc_mappings_fn(mesh, data_axis: str = "data",
                                n_chunks: int = 8, sfa_mode: bool = False):
    """The Scanner's ``shard_map`` path: docs shard over ``data_axis``
    (the bank is replicated — its stacks are small next to a corpus), each
    rank computes its docs' final mappings with the local executor, and the
    doc axis gathers back. -> ``fn(deltas, sfa_maps, corpus)`` (SFA mode)
    or ``fn(tables, corpus)``, each (P, D, n) on every rank."""

    def gather(maps):
        return all_gather(maps, mesh, data_axis, dim=1)

    def shard(corpus):
        return local_shard(corpus, mesh, data_axis, what="doc count")

    if sfa_mode:
        def fn(deltas, sfa_maps, corpus):
            return gather(bank_doc_mappings_sfa(deltas, sfa_maps,
                                                shard(corpus), n_chunks))
    else:
        def fn(tables, corpus):
            return gather(bank_doc_mappings(tables, shard(corpus),
                                            n_chunks))
    return fn
