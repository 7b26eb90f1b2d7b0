"""Batched SFA construction: every pattern's frontier advances at once.

The paper's headline result is *construction* speed through task-level
parallelism: hundreds of PROSITE signatures, each an independent worklist
closure. ``construct_bank`` expresses that task parallelism as a batch
dimension: ``P`` DFAs pad to a common state count (the ``PatternBank``
self-loop/identity padding) and **all P frontiers advance together** in one
bulk-synchronous round over stacked ``(P, capacity, n_max)`` state buffers:

  1. each pattern slices a ``tile`` of unprocessed frontier states;
  2. frontier × alphabet expands in one call over the bank
     (``kernels/csrc/expand_bank.cu`` on the card);
  3. candidates are packed to u32 words and fingerprinted with *per-pattern*
     fold constants (``kernels/csrc/fingerprint_bank.cu`` on the card) — a
     per-pattern word mask zeroes the padding tail, so the fingerprints (and
     with them the whole discovery order) equal the unpadded engines';
  4. membership is a sort-merge of (known ∪ candidates) fingerprints per
     pattern, with an exact vector check of every fingerprint match;
  5. per-pattern ``done`` / ``blowup`` / ``collision`` flags come back each
     round. A collided pattern restarts alone with the next irreducible
     polynomial; finished or blown patterns drop out of later rounds (the
     paper's nonblocking construction).

Every round shape comes from :func:`round_schedule` — capacity tiers growing
toward the ``n^n``/budget cap and active-set buckets shrinking from ``P`` —
the same schedule as the reference, so the kernels only ever see shapes from
a set known before the first round. Results are bit-identical to the
reference package's ``construct_bank``: same δ_s, state order, mappings,
fingerprints, blowup and retry verdicts.

Only ``method="batched"`` with ``distribution="local"`` exists in the port so
far (``"auto"`` resolves to ``"batched"``; the reference's loop method gives
bit-identical results).
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.bucketing import (
    geometric_edges,
    merge_small_buckets,
    partition_by_size,
)
from ..core.dfa import DFA
from ..core.fingerprint import (
    BarrettConstants,
    fingerprint_states_np,
    fold_weights_u32,
    i32_to_u32,
    limbs_of,
    nth_poly_low,
    pack_states_u32,
    u32_to_i32,
)
from ..core.multipattern import PatternBank
from ..device import resolve_device
from ..kernels import ops as kernel_ops
from ..kernels import ref as kernel_ref
from .types import (
    BankConstructionResult,
    BankStats,
    BucketStats,
    SFA,
    SFAStats,
    FingerprintCollision,
)

_U32MAX = 0xFFFFFFFF

#: Stage backends of the batched round: ``"kernel"`` goes through the
#: :mod:`..kernels.ops` wrappers (the CUDA kernel on a CUDA device, its plain
#: version on the CPU), ``"plain"`` calls the plain PyTorch version on any
#: device, ``"auto"`` is ``"kernel"`` on a CUDA device and ``"plain"`` on the
#: CPU — it follows the device asked for, not what is installed.
FINGERPRINT_BACKENDS = ("auto", "kernel", "plain")
EXPAND_BACKENDS = ("auto", "kernel", "plain")

#: Size-bucketing modes (see :func:`construct_bank`).
BUCKETINGS = ("auto", "size", "off")

#: Construction methods the port runs. ``"auto"`` resolves to ``"batched"``.
METHODS = ("auto", "batched")

#: Buckets smaller than this merge into a neighbor.
_BUCKET_MIN_PATTERNS = 4

#: ``bucketing="auto"`` leaves banks smaller than this unbucketed.
_BUCKET_AUTO_MIN_P = 8

#: Capacity tiers grow by this factor between schedule entries. Results are
#: capacity-invariant (pinned by the capacity-growth test).
CAPACITY_GROWTH = 4


# --------------------------------------------------------------------------
# The round, in stages (each stage batched over the bucket axis)
# --------------------------------------------------------------------------


def _frontier_tile(states, n_states, frontier, active, *, tile: int):
    """Stage 1: slice each pattern's frontier tile and its row-validity mask.
    (B, C, n) states, (B,) counts/frontiers/active -> (ft (B, T, n),
    row_valid (B, T)). The host loop guarantees ``frontier + tile <= C``
    for every pattern in the round, so no slice start needs clamping."""
    B = states.shape[0]
    rows = frontier[:, None] + torch.arange(tile, device=states.device)
    ft = states[torch.arange(B, device=states.device)[:, None], rows]
    row_valid = (rows < n_states[:, None]) & active[:, None]
    return ft, row_valid


def _gather_expand(tables, ft, backend: str):
    """Stage 2: frontier × alphabet expansion, ``next[f, a, q] = δ(f[q], a)``
    in row-major (frontier, symbol) candidate order -> (B, T·k, n)."""
    if backend == "kernel":
        return kernel_ops.expand_bank(tables, ft)
    return kernel_ref.expand_bank(tables, ft)


def _fold_words(words, weights, limbs, backend: str):
    """Stage 3: fold + Barrett-reduce packed (B, T·k, W) words with each
    pattern's constants -> (c_hi, c_lo), each (B, T·k) int64 u32 values.
    All three inputs are int32 bit patterns, as the kernel reads them."""
    if backend == "kernel":
        fp = kernel_ops.fingerprint_bank(words, weights, limbs)
    else:
        fp = kernel_ref.fingerprint_bank(words, weights, limbs)
    return i32_to_u32(fp[..., 0]), i32_to_u32(fp[..., 1])


def _merge(states, fp_hi, fp_lo, delta, n_states, frontier, active,
           cand, cand_valid, c_hi, c_lo, *, tile: int, k: int,
           capacity: int):
    """Stages 4/5: sort-merge membership, exactness check, state append and
    δ_s rows, batched over the bucket axis. Updates ``states``, ``fp_hi``,
    ``fp_lo`` and ``delta`` in place (they are the round's own copies) and
    returns them with the new counts, frontiers and collision flags.

    Shapes: states (B, C, n) int32; fp_hi/fp_lo (B, C) int64 u32 values;
    delta (B, C, k) int32; n_states/frontier (B,) int64; active (B,) bool;
    cand (B, T·k, n) int32; cand_valid (B, T·k) bool; c_hi/c_lo (B, T·k).
    """
    C = capacity
    B = states.shape[0]
    Tk = tile * k
    total = C + Tk
    dev = states.device
    bidx = torch.arange(B, device=dev)[:, None]

    known_valid = torch.arange(C, device=dev)[None, :] < n_states[:, None]
    inval = torch.cat([~known_valid, ~cand_valid], dim=1).to(torch.int64)
    hi = torch.cat([fp_hi, c_hi], dim=1)
    lo = torch.cat([fp_lo, c_lo], dim=1)
    # The reference sorts by five keys (invalid, fp_hi, fp_lo, known-before-
    # candidate, original index). The concatenation is already in (is_cand,
    # index) order, so stable sorts by fp_lo and then by (invalid, fp_hi) —
    # least significant key first — give the same order. Non-negative int64
    # keys order as u32, the 0xFFFFFFFF fill of empty slots included.
    perm = torch.sort(lo, dim=1, stable=True).indices
    key = ((inval << 32) | hi).gather(1, perm)
    perm = perm.gather(1, torch.sort(key, dim=1, stable=True).indices)
    s_inval = inval.gather(1, perm)
    s_hi = hi.gather(1, perm)
    s_lo = lo.gather(1, perm)
    s_isc = perm >= C
    s_pay = torch.where(s_isc, perm - C, perm)

    run_start = torch.ones_like(s_isc)
    run_start[:, 1:] = ((s_hi[:, 1:] != s_hi[:, :-1])
                        | (s_lo[:, 1:] != s_lo[:, :-1])
                        | (s_inval[:, 1:] != s_inval[:, :-1]))
    pos = torch.arange(total, device=dev).expand(B, total)
    head_pos = torch.cummax(torch.where(run_start, pos, -1), dim=1).values
    is_new_head = run_start & s_isc & (s_inval == 0)

    # Everything below is per candidate, in original (frontier, symbol)
    # order: its sorted position, and the run head it landed under.
    inv = torch.empty_like(perm).scatter_(1, perm, pos)
    cpos = inv[:, C:]                                    # (B, T·k)
    c_head = head_pos.gather(1, cpos)
    c_head_pay = s_pay.gather(1, c_head)
    c_head_known = ~s_isc.gather(1, c_head)
    c_new = is_new_head.gather(1, cpos)
    # New states take ids in candidate order: BFS discovery order.
    new_id = n_states[:, None] + torch.cumsum(c_new.to(torch.int64), 1) - 1
    head_new_id = new_id.gather(1, c_head_pay.clamp(0, Tk - 1))
    ids = torch.where(c_head_known, c_head_pay, head_new_id)

    # Exactness check: every valid candidate equals the vector heading its
    # fingerprint run, else two distinct states share a fingerprint.
    ref_known = states[bidx, c_head_pay.clamp(0, C - 1)]
    ref_cand = cand[bidx, c_head_pay.clamp(0, Tk - 1)]
    ref_vec = torch.where(c_head_known[..., None], ref_known, ref_cand)
    collision = ((ref_vec != cand).any(-1) & cand_valid).any(1)

    # Append new states. Targets at or past the capacity are dropped, as the
    # reference's mode="drop" scatter drops them (a blowup round appends past
    # the last tier; the pattern is then flagged blown).
    tgt = torch.where(c_new, new_id, C)
    keep = tgt < C
    b_keep = bidx.expand(B, Tk)[keep]
    t_keep = tgt[keep]
    states[b_keep, t_keep] = cand[keep]
    fp_hi[b_keep, t_keep] = c_hi[keep]
    fp_lo[b_keep, t_keep] = c_lo[keep]

    # δ_s rows of the tile: candidate (f, a) order is row-major, so the ids
    # reshape straight into delta rows frontier .. frontier + tile.
    rows = frontier[:, None] + torch.arange(tile, device=dev)
    delta[bidx, rows] = ids.view(B, tile, k).to(torch.int32)

    num_new = c_new.sum(1)
    processed = torch.where(
        active, torch.clamp(n_states - frontier, max=tile), 0)
    return (states, fp_hi, fp_lo, delta, n_states + num_new,
            frontier + processed, collision)


def _bucket_round(tables, states, fp_hi, fp_lo, delta, n_states, frontier,
                  active, weights, limbs, word_masks, *, tile: int, k: int,
                  capacity: int, fp_backend: str, expand_backend: str):
    """One bulk-synchronous round over a bucket of patterns: expand, pack,
    fingerprint, sort-merge — stages 1–5 above."""
    ft, row_valid = _frontier_tile(states, n_states, frontier, active,
                                   tile=tile)
    cand = _gather_expand(tables, ft, expand_backend)            # (B, T·k, n)
    cand_valid = row_valid.repeat_interleave(k, dim=1)           # (B, T·k)
    words = u32_to_i32(pack_states_u32(cand) & word_masks[:, None, :])
    c_hi, c_lo = _fold_words(words, weights, limbs, fp_backend)
    return _merge(states, fp_hi, fp_lo, delta, n_states, frontier, active,
                  cand, cand_valid, c_hi, c_lo, tile=tile, k=k,
                  capacity=capacity)


# --------------------------------------------------------------------------
# The fixed shape schedule
# --------------------------------------------------------------------------


def _state_cap(n: int, max_states: int) -> int:
    """min(max_states, n^n): the SFA can never exceed n^n mappings, so small
    automata get small buffers even under a huge budget."""
    if n <= 1:
        return 1
    if n * math.log2(n) <= 40:
        return min(max_states, n ** n)
    return max_states


def _bucket_sizes(P: int, quantum: int, growth: int = 4) -> list:
    """Active-set padding buckets: shrinking by ``growth`` from P, rounded up
    to multiples of ``quantum`` (a future mesh's pattern-axis size; 1 on one
    device) — O(log P) round shapes."""

    def up(x):
        return max(quantum, ((x + quantum - 1) // quantum) * quantum)

    sizes, b = [], up(P)
    while True:
        sizes.append(b)
        if b == up(1):
            break
        b = up((b + growth - 1) // growth)
    return sorted(set(sizes))


@dataclass(frozen=True)
class RoundSchedule:
    """Every (capacity, bucket) round shape one bank construction may visit,
    precomputed from static quantities — no runtime value can produce a
    shape outside this set, so every kernel launch of a construction has a
    shape known before the first round.

    ``capacities`` are the buffer-row tiers (ascending, last = full cap);
    ``buckets`` the active-set padding sizes (ascending, ``quantum``-rounded
    for the mesh's pattern axis).
    """

    tile: int
    n: int
    k: int
    P: int
    quantum: int
    capacities: tuple
    buckets: tuple

    def capacity_for(self, worst: int) -> int:
        """Smallest tier holding ``worst`` rows (or the full cap)."""
        for c in self.capacities:
            if c >= worst:
                return c
        return self.capacities[-1]

    def bucket_for(self, n_active: int) -> int:
        """Smallest bucket holding ``n_active`` patterns."""
        for b in self.buckets:
            if b >= n_active:
                return b
        return self.buckets[-1]

    @property
    def shapes(self) -> tuple:
        """The full (capacity, bucket) cross product — every round shape
        this bank can launch."""
        return tuple((c, b) for c in self.capacities for b in self.buckets)


def round_schedule(*, tile: int, n: int, k: int, max_states: int, P: int,
                   quantum: int = 1,
                   bucket_growth: int = 4) -> RoundSchedule:
    """Precompute the capacity/bucket schedule of a bank construction.

    Capacity starts small (a 200k-state budget must not mean 200k-row sorts
    for a bank that closes in a few hundred states) and grows by
    ``CAPACITY_GROWTH`` toward ``n^n``/budget; buckets shrink by
    ``bucket_growth`` from ``P``. The host loop's growth guard keeps
    ``capacity >= n_states + tile·k`` for every runnable pattern, so a round
    can never drop an append of a pattern that still fits the cap.
    """
    if bucket_growth < 2:
        raise ValueError(f"bucket_growth must be >= 2, got {bucket_growth}")
    full_cap = _state_cap(n, max_states) + tile
    caps = [min(full_cap, max(1024, 2 * (tile * k + tile)))]
    while caps[-1] < full_cap:
        caps.append(min(full_cap, caps[-1] * CAPACITY_GROWTH))
    return RoundSchedule(
        tile=tile, n=n, k=k, P=P, quantum=quantum,
        capacities=tuple(caps),
        buckets=tuple(_bucket_sizes(P, quantum, bucket_growth)),
    )


def _resolve_backend(backend: str, choices: tuple, what: str,
                     device: torch.device) -> str:
    if backend not in choices:
        raise ValueError(f"{what} must be one of {choices}, got {backend!r}")
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    return backend


# --------------------------------------------------------------------------
# Host-side bank driver
# --------------------------------------------------------------------------


def _word_mask(n_true: int, n_pad: int) -> np.ndarray:
    """Packed-word mask selecting the unpadded prefix of a padded vector."""
    W = (n_pad + 1) // 2
    m = np.zeros(W, dtype=np.uint32)
    m[: n_true // 2] = np.uint32(0xFFFFFFFF)
    if n_true % 2:
        m[n_true // 2] = np.uint32(0x0000FFFF)
    return m


def _default_weight_fn(pattern: int, attempt: int, n_words: int,
                       consts: BarrettConstants) -> np.ndarray:
    return fold_weights_u32(n_words, consts).numpy()


@functools.lru_cache(maxsize=8192)
def _seed_fingerprint(n_true: int, poly_low: int) -> tuple:
    """(hi, lo) fingerprint of the identity mapping over ``n_true`` states —
    the bank's seed row. A pure function of (size, polynomial), so cached."""
    c = BarrettConstants.cached(poly_low)
    fp = fingerprint_states_np(np.arange(n_true, dtype=np.int32)[None], c)[0]
    return int(fp[0]), int(fp[1])


def _as_i32(u32_values) -> np.ndarray:
    """Array of u32 values (any integer dtype) -> int32 with the same bits."""
    return np.asarray(u32_values).astype(np.uint32).view(np.int32)


def _limbs_of(consts: BarrettConstants) -> np.ndarray:
    return _as_i32(np.asarray(limbs_of(consts), dtype=np.uint64))


def construct_bank(
    dfas: Sequence[DFA] | PatternBank,
    *,
    max_states: int = 200_000,
    tile: int = 128,
    max_retries: int = 4,
    poly_index: int = 0,
    method: str = "batched",
    distribution: str = "local",
    on_blowup: str = "skip",
    fingerprint_backend: str = "auto",
    expand_backend: str = "auto",
    bucketing: str = "auto",
    bucket_growth: int = 4,
    device="cuda",
    _weight_fn=None,
) -> BankConstructionResult:
    """Construct the exact SFA of every pattern in one batched closure.

    ``device`` is where the rounds run (``"cuda"`` by default; asking for
    CUDA without a card raises). ``on_blowup``: ``"skip"`` marks patterns
    whose closure exceeds ``max_states`` in ``result.blown`` (their slot in
    ``sfas`` is ``None``); ``"raise"`` raises :class:`~.types.StateBlowup`
    instead.

    ``fingerprint_backend`` / ``expand_backend`` pick the round's stages:
    ``"kernel"`` (the CUDA kernel through :mod:`..kernels.ops`), ``"plain"``
    (the plain PyTorch version), or ``"auto"`` (kernel on a CUDA device,
    plain on the CPU). All give bit-identical results.

    ``bucketing`` controls size-bucketed construction: ``"size"`` partitions
    the bank by DFA state count into O(log n_max) sub-banks, each with its
    own ``n_max`` and capacity tiers; ``"off"`` keeps one bank; ``"auto"``
    buckets only when the bank is big and skewed enough to pay (>= 2 merged
    buckets over >= 8 patterns). Bit-identical either way. ``bucket_growth``
    sets the active-set bucket shrink factor of :func:`round_schedule`.

    ``_weight_fn(pattern, attempt, n_words, consts)`` is a test seam: it
    supplies the fingerprint fold constants (u32 values, (n_words, 2)) and
    lets tests force a fingerprint collision for one pattern's attempt.
    """
    if isinstance(dfas, PatternBank):
        dfas = [dfas.dfa(p) for p in range(dfas.n_patterns)]
    dfas = list(dfas)
    if not dfas:
        raise ValueError("empty pattern bank")
    if method == "loop":
        raise NotImplementedError(
            "method='loop' is not ported yet; 'batched' gives bit-identical "
            "SFAs")
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if distribution == "shard_map":
        raise NotImplementedError(
            "distribution='shard_map' is not ported yet (multi-device "
            "construction is a later slice of the port)")
    if distribution != "local":
        raise ValueError(
            f"distribution must be 'local', got {distribution!r}")
    if on_blowup not in ("skip", "raise"):
        raise ValueError(
            f"on_blowup must be 'skip' or 'raise', got {on_blowup!r}")
    dev = resolve_device(device)
    fp_backend = _resolve_backend(fingerprint_backend, FINGERPRINT_BACKENDS,
                                  "fingerprint_backend", dev)
    exp_backend = _resolve_backend(expand_backend, EXPAND_BACKENDS,
                                   "expand_backend", dev)
    if bucketing not in BUCKETINGS:
        raise ValueError(
            f"bucketing must be one of {BUCKETINGS}, got {bucketing!r}"
        )
    if bucket_growth < 2:
        raise ValueError(f"bucket_growth must be >= 2, got {bucket_growth}")

    result = _construct_bucketed(
        dfas, max_states=max_states, tile=tile, max_retries=max_retries,
        poly_index=poly_index, fp_backend=fp_backend,
        expand_backend=exp_backend, bucketing=bucketing,
        bucket_growth=bucket_growth,
        weight_fn=_weight_fn or _default_weight_fn, device=dev,
    )
    if on_blowup == "raise":
        result.require_all()
    return result


def _construction_partition(sizes, bucketing: str):
    """The size-bucket partition of one bank, or ``None`` to run unbucketed.
    -> ``[(edge, [pattern indices…]), …]`` via the shared
    :mod:`..core.bucketing` helpers (geometric edge ladder, undersized
    buckets merged into neighbors)."""
    if bucketing == "off" or len(sizes) < 2:
        return None
    parts = merge_small_buckets(
        partition_by_size(sizes, geometric_edges(max(sizes))),
        _BUCKET_MIN_PATTERNS,
    )
    if len(parts) < 2:
        return None
    if bucketing == "auto" and len(sizes) < _BUCKET_AUTO_MIN_P:
        return None
    return parts


def _construct_bucketed(dfas, *, max_states, tile, max_retries, poly_index,
                        fp_backend, expand_backend, bucketing, bucket_growth,
                        weight_fn, device):
    """The size-bucketed batched driver: partition the bank by DFA state
    count, close each sub-bank with bucket-local ``n_max``/capacity/round
    shapes, and scatter results back to the original pattern order.

    Wall-time attribution stays a *bank-global* rounds-weighted share: the
    merged stats recompute every pattern's ``SFAStats.wall_time_s`` against
    the whole call's wall and the total active-round count across buckets,
    so the attribution contract is bucketing-invariant.
    """
    t0 = time.perf_counter()
    parts = _construction_partition(
        [d.n_states for d in dfas], bucketing
    )
    if parts is None:
        return _construct_batched(
            dfas, max_states=max_states, tile=tile, max_retries=max_retries,
            poly_index=poly_index, fp_backend=fp_backend,
            expand_backend=expand_backend, bucket_growth=bucket_growth,
            weight_fn=weight_fn, device=device,
        )

    P = len(dfas)
    stats = BankStats(
        method="batched",
        pattern_rounds=np.zeros(P, np.int64),
        retries=np.zeros(P, np.int64),
        pattern_candidates=np.zeros(P, np.int64),
    )
    sfas: list = [None] * P
    blown = np.zeros(P, dtype=bool)
    for edge, idx in parts:
        sub_dfas = [dfas[i] for i in idx]

        def sub_weight_fn(p, attempt, n_words, consts, _idx=idx):
            # The seam keys on *bank-global* pattern position, so forced
            # collisions hit the same pattern bucketed or not. n_words is
            # bucket-local; weight fns must derive weights from it alone.
            return weight_fn(_idx[p], attempt, n_words, consts)

        sub = _construct_batched(
            sub_dfas, max_states=max_states, tile=tile,
            max_retries=max_retries, poly_index=poly_index,
            fp_backend=fp_backend, expand_backend=expand_backend,
            bucket_growth=bucket_growth, weight_fn=sub_weight_fn,
            device=device,
        )
        ii = np.asarray(idx, dtype=np.int64)
        stats.pattern_rounds[ii] = sub.stats.pattern_rounds
        stats.retries[ii] = sub.stats.retries
        stats.pattern_candidates[ii] = sub.stats.pattern_candidates
        stats.rounds += sub.stats.rounds
        blown[ii] = sub.blown
        for j, i in enumerate(idx):
            sfas[i] = sub.sfas[j]
        stats.buckets.append(BucketStats(
            edge=int(edge),
            n_patterns=len(idx),
            n_max=max(d.n_states for d in sub_dfas),
            rounds=sub.stats.rounds,
            blown=int(sub.blown.sum()),
            wall_time_s=sub.stats.wall_time_s,
        ))
    stats.candidates = int(stats.pattern_candidates.sum())
    stats.wall_time_s = time.perf_counter() - t0
    total_rounds = int(stats.pattern_rounds.sum())
    for p in range(P):
        if sfas[p] is not None:
            sfas[p].stats.wall_time_s = (
                stats.wall_time_s * int(stats.pattern_rounds[p]) / total_rounds
                if total_rounds else 0.0
            )
    return BankConstructionResult(sfas=sfas, blown=blown, stats=stats)


def _construct_batched(dfas, *, max_states, tile, max_retries, poly_index,
                       fp_backend, expand_backend, bucket_growth, weight_fn,
                       device):
    t0 = time.perf_counter()
    bank = PatternBank.from_dfas(dfas)  # validates the shared alphabet
    P, n, k = bank.n_patterns, bank.n_max, bank.n_symbols
    if n >= 1 << 16:
        raise ValueError("batched engine packs 16-bit state ids")
    W = (n + 1) // 2
    sched = round_schedule(
        tile=tile, n=n, k=k, max_states=max_states, P=P,
        bucket_growth=bucket_growth,
    )
    capacity = sched.capacities[0]

    stats = BankStats(
        method="batched",
        pattern_rounds=np.zeros(P, np.int64),
        retries=np.zeros(P, np.int64),
        pattern_candidates=np.zeros(P, np.int64),
    )

    # -- per-pattern fingerprint constants + initial buffers ------------------
    n_true = bank.n_states.astype(np.int64)
    attempts = np.zeros(P, dtype=np.int64)

    def consts_of(p):
        return BarrettConstants.cached(
            nth_poly_low(poly_index + int(attempts[p]))
        )

    weights_np = np.empty((P, W, 2), dtype=np.int32)
    limbs_np = np.empty((P, 4), dtype=np.int32)
    masks_np = np.empty((P, W), dtype=np.int64)
    fp0_np = np.empty((P, 2), dtype=np.int64)
    for p in range(P):
        c = consts_of(p)
        weights_np[p] = _as_i32(weight_fn(p, 0, W, c))
        limbs_np[p] = _limbs_of(c)
        masks_np[p] = _word_mask(int(n_true[p]), n)
        fp0_np[p] = _seed_fingerprint(int(n_true[p]), c.poly_low)

    def tensor(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    states = torch.zeros((P, capacity, n), dtype=torch.int32, device=device)
    states[:, 0] = torch.arange(n, dtype=torch.int32, device=device)
    fp_hi = torch.full((P, capacity), _U32MAX, dtype=torch.int64,
                       device=device)
    fp_lo = fp_hi.clone()
    fp_hi[:, 0] = tensor(fp0_np[:, 0])
    fp_lo[:, 0] = tensor(fp0_np[:, 1])
    delta = torch.zeros((P, capacity, k), dtype=torch.int32, device=device)
    n_states = torch.ones(P, dtype=torch.int64, device=device)
    frontier = torch.zeros(P, dtype=torch.int64, device=device)
    weights = tensor(weights_np)
    limbs = tensor(limbs_np)
    masks = tensor(masks_np)
    tables = tensor(bank.tables)

    n_states_h = np.ones(P, dtype=np.int64)
    frontier_h = np.zeros(P, dtype=np.int64)
    blown = np.zeros(P, dtype=bool)

    # -- the nonblocking host loop -------------------------------------------
    while True:
        runnable = (~blown) & (frontier_h < n_states_h)
        act = np.flatnonzero(runnable)
        if act.size == 0:
            break
        worst = int(n_states_h[act].max()) + tile * k
        if worst > capacity and capacity < sched.capacities[-1]:
            grown = sched.capacity_for(worst)
            pad = grown - capacity
            states = torch.nn.functional.pad(states, (0, 0, 0, pad))
            fp_hi = torch.nn.functional.pad(fp_hi, (0, pad), value=_U32MAX)
            fp_lo = torch.nn.functional.pad(fp_lo, (0, pad), value=_U32MAX)
            delta = torch.nn.functional.pad(delta, (0, 0, 0, pad))
            capacity = grown
        # The reference slices the tile with a clamping dynamic_slice; the
        # schedule's growth guard makes the clamp unreachable, so check that
        # here rather than reproduce it.
        if int(frontier_h[act].max()) + tile > capacity:
            raise RuntimeError(
                "frontier tile runs past the state buffer: "
                f"frontier {int(frontier_h[act].max())} + tile {tile} > "
                f"capacity {capacity}")
        bucket = sched.bucket_for(act.size)
        idx_np = np.full(bucket, act[0], dtype=np.int64)
        idx_np[: act.size] = act
        act_np = np.zeros(bucket, dtype=bool)
        act_np[: act.size] = True
        idx = tensor(idx_np)
        live = idx[: act.size]

        stats.rounds += 1
        stats.pattern_rounds[act] += 1
        stats.pattern_candidates[act] += (
            np.minimum(n_states_h[act] - frontier_h[act], tile) * k
        )

        # The round runs on the bucket's own copies (padding rows repeat the
        # first active pattern and are never written back).
        o_states, o_fp_hi, o_fp_lo, o_delta, o_n, o_frontier, o_coll = (
            _bucket_round(
                tables[idx], states[idx], fp_hi[idx], fp_lo[idx], delta[idx],
                n_states[idx], frontier[idx], tensor(act_np), weights[idx],
                limbs[idx], masks[idx],
                tile=tile, k=k, capacity=capacity,
                fp_backend=fp_backend, expand_backend=expand_backend,
            )
        )
        m = act.size
        states[live] = o_states[:m]
        fp_hi[live] = o_fp_hi[:m]
        fp_lo[live] = o_fp_lo[:m]
        delta[live] = o_delta[:m]
        n_states[live] = o_n[:m]
        frontier[live] = o_frontier[:m]
        flags = torch.stack(
            [o_n[:m], o_frontier[:m], o_coll[:m].to(torch.int64)]).cpu()
        n_states_h[act] = flags[0].numpy()
        frontier_h[act] = flags[1].numpy()
        coll_np = flags[2].numpy().astype(bool)

        collided = act[coll_np]
        # Per-pattern polynomial retry: only collided patterns restart; the
        # others keep their progress.
        if collided.size:
            for p in collided:
                attempts[p] += 1
                stats.retries[p] += 1
                if attempts[p] >= max_retries:
                    raise FingerprintCollision(
                        f"pattern {p}: {max_retries} polynomials all collided"
                    )
                c = consts_of(p)
                weights_np[p] = _as_i32(weight_fn(int(p), int(attempts[p]),
                                                  W, c))
                limbs_np[p] = _limbs_of(c)
                fp0_np[p] = _seed_fingerprint(int(n_true[p]), c.poly_low)
            cidx = tensor(collided)
            weights[cidx] = tensor(weights_np[collided])
            limbs[cidx] = tensor(limbs_np[collided])
            fp_hi[cidx, 0] = tensor(fp0_np[collided, 0])
            fp_lo[cidx, 0] = tensor(fp0_np[collided, 1])
            n_states[cidx] = 1
            frontier[cidx] = 0
            n_states_h[collided] = 1
            frontier_h[collided] = 0

        blown |= n_states_h > max_states

    # -- crop per-pattern results ---------------------------------------------
    states_np = states.cpu().numpy()
    delta_np = delta.cpu().numpy()
    fp_np = torch.stack([fp_hi, fp_lo], dim=-1).cpu().numpy().astype(
        np.uint32)
    stats.wall_time_s = time.perf_counter() - t0
    stats.candidates = int(stats.pattern_candidates.sum())
    total_rounds = int(stats.pattern_rounds.sum())
    sfas: list = [None] * P
    for p in range(P):
        if blown[p]:
            continue
        S = int(n_states_h[p])
        # Rounds-weighted share: the bank's wall belongs to BankStats; a
        # pattern reports only the fraction of rounds it was active in.
        share = (
            stats.wall_time_s * int(stats.pattern_rounds[p]) / total_rounds
            if total_rounds else 0.0
        )
        pstats = SFAStats(
            engine="batched",
            rounds=int(stats.pattern_rounds[p]),
            candidates=int(stats.pattern_candidates[p]),
            wall_time_s=share,
        )
        sfas[p] = SFA(
            mappings=np.ascontiguousarray(states_np[p, :S, : int(n_true[p])]),
            delta=np.ascontiguousarray(delta_np[p, :S]),
            fingerprints=np.ascontiguousarray(fp_np[p, :S]),
            dfa=dfas[p],
            stats=pstats,
        )
    return BankConstructionResult(sfas=sfas, blown=blown, stats=stats)
