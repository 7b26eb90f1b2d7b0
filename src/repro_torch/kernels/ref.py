"""Plain PyTorch versions of the seven CUDA kernels and their forms.

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
    pack_states_u32,
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


def expand_bank(tables: torch.Tensor, ft: torch.Tensor,
                word_masks: torch.Tensor | None = None):
    """Frontier × alphabet expansion over a bank.

    tables: (B, n, k) int32; ft: (B, T, n) int32 state ids < n ->
    (B, T·k, n) int32 with ``out[b, t·k + a, q] = tables[b, ft[b, t, q], a]``
    (row-major (frontier, symbol) candidate order). With ``word_masks``
    (B, ⌈n/2⌉) int32 -> ``(cand, words)``, words the int32 bit patterns of
    ``pack_states_u32(cand) & word_masks``.
    """
    B, T, n = ft.shape
    k = tables.shape[-1]
    rows = torch.arange(B, device=ft.device)[:, None, None]
    cand = tables[rows, ft.to(torch.int64)]               # (B, T, n, k)
    cand = cand.permute(0, 1, 3, 2).reshape(B, T * k, n)
    if word_masks is None:
        return cand
    words = u32_to_i32(pack_states_u32(cand)) & word_masks[:, None, :]
    return cand, words


def match_bank_chunks(tables: torch.Tensor, chunks: torch.Tensor,
                      n_starts: int,
                      starts: torch.Tensor | None = None) -> torch.Tensor:
    """Each chunk run from start states ``0 .. n_starts-1`` of every table,
    or, given ``starts`` (P, n_starts), from states ``starts[p]``.

    tables: (P, n, k) int32; chunks: (B, L) int32 symbols < k ->
    (P, B, n_starts) int32, ``out[p, b, q]`` = the state pattern ``p``
    reaches from ``q`` (from ``starts[p, q]``) after chunk ``b``.
    ``n_starts = n`` gives the chunk's whole transition function
    (enumeration); ``n_starts = 1`` the walk from state 0 alone (the SFA
    path's final state); ``starts`` the speculative pass's m-lane walk from
    a hot-state profile.
    """
    P = tables.shape[0]
    B, L = chunks.shape
    dev = tables.device
    rows = torch.arange(P, device=dev)[:, None, None]
    if starts is None:
        v = torch.arange(n_starts, device=dev).expand(P, B, n_starts)
    else:
        v = starts.to(torch.int64)[:, None, :].expand(P, B, n_starts)
    syms = chunks.to(torch.int64)
    for t in range(L):
        v = tables[rows, v, syms[None, :, t, None]].to(torch.int64)
    return v.to(torch.int32)


def compose(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Function-monoid combine: f, g (B, n) int32 -> (B, n) int32,
    ``out[b, q] = g[b, f[b, q]]`` (apply f, then g)."""
    return torch.gather(g, 1, f.to(torch.int64))


def compose_fold(f: torch.Tensor | None, gs: torch.Tensor) -> torch.Tensor:
    """A fold of combines: f (B, n) int32 or ``None`` (the identity), gs
    (B, m, n) int32 -> (B, n), f then ``gs[:, 0]``, …, ``gs[:, m-1]`` —
    one gather per element of the fold."""
    B, m, n = gs.shape
    out = (torch.arange(n, dtype=gs.dtype, device=gs.device).expand(B, n)
           if f is None else f)
    for j in range(m):
        out = compose(out, gs[:, j])
    return out


def compose_fold_rows(stacks: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """A fold of mapping-stack rows: stacks (P, S, n) int32, idx (P, D, m)
    int32 row ids < S -> (P, D, n), ``stacks[p, idx[p, d, 0]]`` then … then
    ``stacks[p, idx[p, d, m-1]]``: each row gathered by advanced indexing,
    then combined."""
    P = stacks.shape[0]
    rows = torch.arange(P, device=stacks.device)[:, None]
    i = idx.to(torch.int64)
    out = stacks[rows, i[:, :, 0]]
    for j in range(1, i.shape[2]):
        out = torch.gather(stacks[rows, i[:, :, j]], 2, out.to(torch.int64))
    return out


def match_chunks(table: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """Each chunk run through one table from every state: table (n, k)
    int32, chunks (B, L) int32 symbols < k -> (B, n) int32 chunk mappings.
    The one-table, all-states case of :func:`match_bank_chunks`."""
    return match_bank_chunks(table[None], chunks, table.shape[0])[0]


def fingerprint(words: torch.Tensor, weights: torch.Tensor,
                limbs: torch.Tensor) -> torch.Tensor:
    """Rabin fingerprints under one polynomial: words (B, W), weights
    (W, 2), limbs (4,) — int32 bit patterns -> (B, 2) int32 [hi, lo]. The
    one-pattern case of :func:`fingerprint_bank`."""
    return fingerprint_bank(words[None], weights[None], limbs[None])[0]


def spec_resolve(tables: torch.Tensor, spec: torch.Tensor,
                 starts: torch.Tensor, exits: torch.Tensor,
                 chunks: torch.Tensor, n_chunks: int, max_rounds: int
                 ) -> tuple:
    """Validate and repair of speculative scanning, in rounds.

    tables (P, n, k); spec (P, m) speculated chunk entry states; starts
    (P,); exits (P, D·C, m), ``exits[p, d·C + c, q]`` the state chunk ``c``
    of doc ``d`` leaves from ``spec[p, q]`` (:func:`match_bank_chunks` with
    ``starts=spec``); chunks (D·C, Lc); C = ``n_chunks`` -> ``(finals (P, D)
    int32, resolved (P, D) bool, hit_chunks, repaired, rounds)``, the last
    three 0-d int64 tensors.

    The rounds of the reference executor's loop, one for one: walk the
    chunks of every (pattern, doc) lane from its start, adopting the
    speculated exit where the entry was speculated and a repaired exit
    where one exists, up to the lane's first miss; then, while a lane is
    broken and fewer than ``max_rounds`` rounds ran, re-walk the first
    missed chunk of every broken lane from its exact entry and validate
    again. ``finals`` is exact where ``resolved``; an unresolved lane keeps
    the entry state of its first unrepaired miss. ``hit_chunks`` counts the
    chunks the last validation settled by speculation.
    """
    P = tables.shape[0]
    B, Lc = chunks.shape
    C = n_chunks
    D = B // C
    dev = tables.device
    ex = exits.view(P, D, C, -1).to(torch.int64)
    ch = chunks.view(D, C, Lc).to(torch.int64)
    sp = spec.to(torch.int64)[:, None, :]                    # (P, 1, m)
    st = starts.to(torch.int64)[:, None].expand(P, D)
    rows = torch.arange(P, device=dev)[:, None]
    docs = torch.arange(D, device=dev)[None, :]
    c_idx = torch.arange(C, device=dev)

    def validate(rep_exit, rep_mask):
        cur = st.clone()
        alive = torch.ones((P, D), dtype=torch.bool, device=dev)
        miss_c = torch.full((P, D), C, dtype=torch.int64, device=dev)
        miss_entry = torch.zeros((P, D), dtype=torch.int64, device=dev)
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        for c in range(C):
            match = sp == cur[:, :, None]                     # (P, D, m)
            hit = match.any(-1)
            lane = match.to(torch.int32).argmax(-1, keepdim=True)
            spec_exit = ex[:, :, c].gather(-1, lane)[..., 0]
            rep_m = rep_mask[:, :, c]
            ok = rep_m | hit
            nxt = torch.where(rep_m, rep_exit[:, :, c], spec_exit)
            newly = alive & ~ok
            hits = hits + (alive & ~rep_m & hit).sum()
            miss_c = torch.where(newly, c, miss_c)
            miss_entry = torch.where(newly, cur, miss_entry)
            cur = torch.where(alive & ok, nxt, cur)
            alive = alive & ok
        return cur, alive, miss_c, miss_entry, hits

    def repair(rep_exit, rep_mask, alive, miss_c, miss_entry):
        c = miss_c.clamp(max=C - 1)
        lane_chunks = ch[docs, c]                             # (P, D, Lc)
        s = miss_entry
        for t in range(Lc):
            s = tables[rows, s, lane_chunks[:, :, t]].to(torch.int64)
        sel = (c_idx == c[:, :, None]) & (~alive)[:, :, None]
        return (torch.where(sel, s[:, :, None], rep_exit),
                rep_mask | sel)

    rep_exit = torch.zeros((P, D, C), dtype=torch.int64, device=dev)
    rep_mask = torch.zeros((P, D, C), dtype=torch.bool, device=dev)
    cur, alive, miss_c, miss_entry, hits = validate(rep_exit, rep_mask)
    rounds = 0
    while rounds < max_rounds and not bool(alive.all()):
        rep_exit, rep_mask = repair(rep_exit, rep_mask, alive, miss_c,
                                    miss_entry)
        cur, alive, miss_c, miss_entry, hits = validate(rep_exit, rep_mask)
        rounds += 1
    return (cur.to(torch.int32), alive, hits, rep_mask.sum(),
            torch.tensor(rounds, dtype=torch.int64, device=dev))


def spec_resolve_chain(tables: torch.Tensor, spec: torch.Tensor,
                       starts: torch.Tensor, exits: torch.Tensor,
                       chunks: torch.Tensor, n_chunks: int, max_rounds: int
                       ) -> tuple:
    """Validate and repair of a stream's successive blocks, block by block.

    The arguments of :func:`spec_resolve`, the D docs the blocks of one
    input in order -> ``(finals (P,) int32, totals (4,) int64)``: the state
    after the last doc and ``[hit_chunks, repaired, rounds,
    fallback_lanes]``.

    The loop a speculative stream ran a block at a time: :func:`spec_resolve`
    on one doc from the current states, then an exact walk of the doc from
    its entry state for each lane the bound left unresolved (the stream's
    enumeration fallback, read off at that state), and the doc's stats
    merged as ``SpeculationStats.merged`` merges them (sums, and the
    maximum of the rounds).
    """
    P = tables.shape[0]
    C = n_chunks
    D = chunks.shape[0] // C
    rows = torch.arange(P, device=tables.device)
    state = starts
    totals = torch.zeros(4, dtype=torch.int64, device=tables.device)
    for d in range(D):
        blk = slice(d * C, (d + 1) * C)
        finals, resolved, hits, repaired, rounds = spec_resolve(
            tables, spec, state, exits[:, blk], chunks[blk], C, max_rounds)
        finals, resolved = finals[:, 0], resolved[:, 0]
        if not bool(resolved.all()):
            exact = state.to(torch.int64)
            for sym in chunks[blk].reshape(-1).to(torch.int64):
                exact = tables[rows, exact, sym].to(torch.int64)
            finals = torch.where(resolved, finals, exact.to(torch.int32))
        totals += torch.stack([hits, repaired, torch.zeros_like(rounds),
                               (~resolved).sum()])
        totals[2] = torch.maximum(totals[2], rounds)
        state = finals
    return state, totals
