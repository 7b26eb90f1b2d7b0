#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--out results.json]

Phases, in order (any failure raises and exits non-zero):

1. build the seven CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc (one process per source, in parallel) and print the build time;
2. hold each kernel equal to its plain PyTorch version on the card, on
   random inputs from a numpy seed: at the largest shapes its path gives
   it and at a ragged edge; the two chunk walks also on tables past their
   shared-memory budget, each walk's launch plan held to the branch its
   case names and its share of lookups on staged rows printed; the
   speculative scan's two launches (the chunk walk from explicit start
   states, ``spec_resolve`` under a profile that hits every chunk and one
   that misses every chunk with 2 repairs a lane) at its shape; time each
   kernel, its plain version, and (where one exists) one PyTorch call that
   computes the same function — for the kernel and that call both the
   device time per call and the host's time per call of the wrapper;
3. drive the main path at full size with every launch count at 0: the
   bundled 23-signature PROSITE bank through ``Scanner.compile`` under the
   default plan (SFA budget 512: SFA and enumeration patterns) and under
   ``mode="sfa"`` with budget 20000 (all 23 SFAs, the largest 7,184
   states), each followed by ``scan`` and ``census`` of a 65,536 x 384
   random protein corpus; then read the launch counts; then hold
   ``match_bank_chunks`` equal to its plain version, and time it as in
   phase 2, on the bundled bank's own tables as these compiles built them
   (budget-512 enumeration tables and SFA deltas, budget-20000 deltas, and
   a stream piece's shape);
4. run the same construction and scan through the plain versions on the
   card, and through the NumPy ``reference`` backend on a 256-document
   sub-corpus, and require equal SFAs, hits and census;
5. drive the single-pattern path with every launch count at 0 again:
   ``Scanner.compile`` of PS00010 alone (87-state DFA, SFA budget 20000:
   ``method="auto"`` loops, the vectorized engine builds its 7,184 states on
   the card) and its one-pattern bank construction, ``locate`` on a
   2^22-residue sequence in 4,096 chunks, and ``census_windows`` (window
   384, stride 48) and a 64-piece ``stream`` of the same sequence through
   the budget-20000 bank scanner; then read the launch counts and require
   equal results from the host construction, the plain versions, the
   match oracle, the materialised windows and the whole-sequence mapping;
6. speculative scanning, launch counts at 0 before each of its own runs
   and summed after it (the comparison runs and plain-version checks are
   left out): the bundled bank under
   ``mode="speculative"`` against ``mode="enumeration"``; the bank and a
   702-state random DFA (the paper's largest FA) under the default
   ``mode="auto"`` (18 SFA, 5 enumeration, 1 speculative pattern) against
   enumeration, its ``SpeculationStats`` against the same executor through
   the plain versions; the 702-state pattern alone; an explicit profile of
   states no chunk is entered in, 2 repairs a lane; a 64-piece stream of
   the long sequence against its scan and the whole-sequence walk; the
   walls and stats are printed, and the walk from explicit starts
   (counted apart, ``ops.form_launches``) and ``spec_resolve`` must have
   launched;
7. the scan service, launch counts as in 6: ``Scanner.service`` with an
   artifact store coalescing four overlapping requests of 4,096 docs, each
   answer equal to a direct scan; a compile under the shared SFA cache
   twice (23 hits and 0 rounds the second time); a fresh cache preloaded
   from the store; a ``CorpusJob`` of 8 shards killed after 3 and resumed,
   byte-identical to the straight scan, its ``jobs.*`` flight totals equal
   to an uninterrupted job's; the main path's four kernels must have
   launched;
8. ``distribution="shard_map"`` at world size 1 (a one-rank NCCL world on
   ``cuda:0``, the mesh the entry points build over the whole world),
   launch counts as in 6: the bundled bank compiled at budget 512 with
   the construction sharded over the pattern axis (cache off; its SFAs
   equal the main phase's) and scanned with the corpus sharded over the
   data axis (hits and census equal to the main phase's); the bank under
   forced speculation (hits and ``SpeculationStats`` equal to phase 6's);
   ``census_windows`` of the long sequence through the budget-20000 bank
   (equal to phase 5's); each wall is printed beside its local twin's,
   and the construction, scan and speculation kernels must have launched;
   then two spawned gloo ranks on the one card (the mesh paths with a real
   split: patterns, documents and speculation lanes halved) compile and
   scan the first 4,096 documents, their SFAs, hits and
   ``SpeculationStats`` equal to the local path's, and their launches
   counted in the ranks; the process group is destroyed at the end;
9. the LM half's serving path, launch counts at 0 before it and read
   after (it launches none of the seven kernels): first every LM
   architecture but qwen1.5-0.5B at its published width, depth cut to one
   pattern cycle (whisper: one encoder and one decoder layer; phi3-vision
   with 256 prefix embeddings; MoE capacity raised so no assignment
   drops): a B = 2 prefill (64 tokens, mamba2 256) and 4 decode steps
   against the forward, each layer in bf16 within the reference's bound
   and the whole model in f32 within 1e-3 (mamba2, whose f32 forward
   keeps bf16 operands in its quadratic form: 1e-2); then qwen1.5-0.5B at its
   published size (24 layers, d_model 1,024, vocab 151,936; 464 M f32
   parameters from a seeded ``torch.Generator``, bf16 activations) serves
   16 requests (prompts of 16-128 tokens, numpy seed 0) x 32 tokens
   through the continuous-batching ``ServeEngine`` (4 slots, cache 256):
   every request completes with tokens in range, prefill ms a request,
   decode ms a step, generated tokens/s and peak memory printed; a decode
   step against the forward at that position, layer by layer (each
   layer fed the forward's input; within 3e-2), the logits' error end to
   end printed; the same weights in f32: the engine's greedy tokens for 3
   ragged prompts x 8 equal the argmax of full forwards; then the reduced
   f32 models of the CPU tests on the card and on the CPU with the same
   weights, within 1e-4;
10. with ``--profile`` only: trace one compile and one scan per budget, one
   ``stream`` of the single-pattern phase, the speculative phase's repeat
   scans beside enumeration's and its stream, and prefill and decode
   steps of the LM phase's qwen1.5-0.5B parameters, with ``torch.profiler`` (the
   port's ``obs`` spans included) and print where the device time and the
   host time go.

Every compile that measures or compares a construction passes
``cache="off"``: under the default shared SFA cache, a repeat compile is a
lookup.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. It exits non-zero
without a result when no CUDA device is present or when the package is not
beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
DOCS, DOC_LEN = 65_536, 384          # 25.2 M residues
N_CHUNKS = 8
TILE, K = 128, 20                    # construction tile, amino-acid alphabet
REF_DOCS = 256                       # sub-corpus of the NumPy reference

# The single-pattern phase: one 87-state signature, one long sequence.
SINGLE_ID, SINGLE_BUDGET = "PS00010", 20_000
SEQ_LEN = 1 << 22                    # residues, uniform, numpy seed 0
LOCATE_CHUNKS = 4096                 # chunks of 1,024 residues
WINDOW, STRIDE = 384, 48             # census_windows: 87,376 windows
STREAM_PIECES = 64
ORACLE_LEN = 1 << 18                 # prefix held against the match oracle
CLOSE_TILE = 4096                    # construct_sfa_vectorized's tile

# The speculative phase: the paper's largest FA (702 states) beside the
# bundled bank, speculated from m = 8 boundary states a chunk.
SPEC_STATES, SPEC_SEED, SPEC_M = 702, 7, 8
SPEC_ID = "R702"
# The service phase: four requests of overlapping bundled subsets and
# 4,096 docs each; a corpus job of 8 shards of 8,192 docs, 3 before a kill.
SERVICE_DOCS, JOB_SHARD_DOCS, JOB_FIRST = 4096, 8192, 3

#: Kernels each path must launch.
MAIN_KERNELS = ("fingerprint_bank", "expand_bank", "match_bank_chunks",
                "compose")
SINGLE_KERNELS = ("fingerprint_bank", "expand_bank", "match_bank_chunks",
                  "compose", "match_chunks", "fingerprint")
#: The speculative path counts its walks from explicit starts apart
#: (``ops.form_launches``), so it can tell them from enumeration walks.
SPEC_KERNELS = ("match_bank_chunks.starts", "spec_resolve")
SERVICE_KERNELS = MAIN_KERNELS
DIST_KERNELS = MAIN_KERNELS + ("spec_resolve",)

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the int32 ALU
#: rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz, a quarter of the
#: 67 TFLOP/s float32 rate (128 FP32 lanes, an FMA counting two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12

#: Integer operations per bit-sliced 32x32 carry-less multiply: 32 steps of
#: (mask from b's bit, shift a left, and-xor into lo, shift a right, and-xor
#: into hi).
CLMUL32_OPS = 32 * 5


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


def cuda_ms(torch, fn, reps: int = 10) -> float:
    """Mean time of ``fn`` over ``reps`` calls, after a warm-up, from CUDA
    events around the whole run: device time where the host keeps up with
    the card, the host's rate of calling where it does not."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Calls per host-time measurement (best of HOST_REPEATS: the host is
#: shared, and a run interrupted by a neighbour measures the neighbour), and
#: per device-time measurement.
HOST_CALLS, HOST_REPEATS, DEVICE_REPS = 200, 3, 100
#: Spin cycles per µs of host time: the H100's SM clock tops out at
#: 1.98 GHz, so 4,000 cycles cover at least two µs at any clock.
SPIN_CYCLES_PER_US = 4000


def host_us(torch, fn, calls: int = HOST_CALLS) -> tuple:
    """(best, worst) µs per call that the host spends in ``fn``: ``calls``
    calls with no synchronize between them (the card works behind), after a
    warm-up, in each of :data:`HOST_REPEATS` runs."""
    fn()
    runs = []
    for _ in range(HOST_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return min(runs) / calls * 1e6, max(runs) / calls * 1e6


#: Runs of :func:`device_ms`, the spin twice as long each time, before it
#: gives up.
SPIN_TRIES = 5


def device_ms(torch, fn, us_per_call: float, reps: int = DEVICE_REPS
              ) -> float:
    """Mean device time of ``fn``: ``reps`` calls queued behind a
    ``torch.cuda._sleep`` spin, so the card runs them back to back and the
    events around them see device time, not the host's rate of launching.
    The spin is sized at twice ``us_per_call`` (the slowest host time
    measured), and the start event, recorded after the spin, is queried
    once the last call is queued: if the card has passed it, the spin ended
    before the queue was full, and the run is repeated with a spin twice as
    long."""
    fn()
    torch.cuda.synchronize()
    cycles = int(2 * reps * us_per_call * SPIN_CYCLES_PER_US)
    for _ in range(SPIN_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued = not start.query()
        end.record()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"check failed: {reps} calls were not queued within "
                       f"a spin of {cycles // 2} cycles")


def timings(torch, fn, reps: int = DEVICE_REPS) -> tuple:
    """(device ms, host µs per call) of ``fn``: the best host run, and a
    spin sized from the slowest."""
    best, worst = host_us(torch, fn)
    return device_ms(torch, fn, worst, reps), best


def bound(nbytes: float, ops: float) -> tuple:
    """(least time in ms, what bounds it) on the H100's peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# --------------------------------------------------------------------------


def kernel_cases(torch, ops, ref, dev):
    rng = np.random.default_rng(SEED)

    def i32(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(dev)

    def ids(hi, shape):
        return torch.from_numpy(
            rng.integers(0, hi, shape).astype(np.int32)).to(dev)

    def u32(shape):
        return i32(rng.integers(0, 1 << 32, shape, dtype=np.uint64))

    cases = []

    # fingerprint_bank: the widest construction bucket's round (6 patterns
    # with n_max = 87: W = 44 words, T·k = 2560 candidates), then a ragged
    # edge (B not a multiple of the block, odd W).
    for label, (P, B, W) in (("main", (6, TILE * K, 44)),
                             ("ragged", (3, 1000, 7))):
        args = (u32((P, B, W)), u32((P, W, 2)), u32((P, 4)))
        rows = P * B
        cases.append(dict(
            kernel="fingerprint_bank", label=label,
            shape=f"words {P}x{B}x{W}",
            run=lambda a=args: ops.fingerprint_bank(*a),
            plain=lambda a=args: ref.fingerprint_bank(*a),
            library=None,
            nbytes=4 * (P * B * W + P * W * 2 + P * 4 + P * B * 2),
            # Per word two 32x32 products and 4 XORs into the limbs; the
            # Barrett step three products (its operands are one limb wide)
            # and 4 XORs.
            ops=rows * (W * (2 * CLMUL32_OPS + 4) + 3 * CLMUL32_OPS + 4),
        ))

    # expand_bank: the same bucket's frontier tile, then a ragged edge.
    for label, (B, T, n) in (("main", (6, TILE, 87)),
                             ("ragged", (3, 37, 13))):
        tables, ft = ids(n, (B, n, K)), ids(n, (B, T, n))
        tab_t = tables.transpose(1, 2).contiguous()          # (B, k, n)
        src = tab_t[:, None].expand(B, T, K, n)
        index = ft.to(torch.int64)[:, :, None].expand(B, T, K, n)
        cases.append(dict(
            kernel="expand_bank", label=label,
            shape=f"tables {B}x{n}x{K}, ft {B}x{T}x{n}",
            run=lambda a=(tables, ft): ops.expand_bank(*a),
            plain=lambda a=(tables, ft): ref.expand_bank(*a),
            # One PyTorch call computing the same function (a yardstick,
            # never used by the port): gather along the state axis.
            library=lambda s=src, i=index, sh=(B, T * K, n):
                torch.gather(s, 3, i).view(sh),
            nbytes=4 * (B * T * n + B * n * K + B * T * K * n),
            ops=0,
        ))

    # fingerprint: the single-pattern construction's largest tile (4,096
    # frontier states x 20 symbols of PS00010's 87-state vectors: W = 44),
    # then a ragged edge.
    for label, (B, W) in (("main", (CLOSE_TILE * K, 44)),
                          ("ragged", (1000, 7))):
        args = (u32((B, W)), u32((W, 2)), u32((4,)))
        cases.append(dict(
            kernel="fingerprint", label=label, shape=f"words {B}x{W}",
            run=lambda a=args: ops.fingerprint(*a),
            plain=lambda a=args: ref.fingerprint(*a),
            library=None,
            nbytes=4 * (B * W + W * 2 + 4 + B * 2),
            ops=B * (W * (2 * CLMUL32_OPS + 4) + 3 * CLMUL32_OPS + 4),
        ))

    # compose: census_windows' block fold on the budget-20000 bank (23
    # patterns x 87,383 stride blocks, n = 87), then a ragged edge and the
    # one-row-per-block branch (n >= 8192).
    blocks = (SEQ_LEN - WINDOW) // STRIDE + WINDOW // STRIDE
    for label, (B, n) in (("main", (23 * blocks, 87)),
                          ("ragged", (1001, 13)),
                          ("wide rows", (5, 9000))):
        f, g = ids(n, (B, n)), ids(n, (B, n))
        f64 = f.to(torch.int64)
        cases.append(dict(
            kernel="compose", label=label, shape=f"f, g {B}x{n}",
            run=lambda a=(f, g): ops.compose(*a),
            plain=lambda a=(f, g): ref.compose(*a),
            # One PyTorch call computing the same function (a yardstick,
            # never used by the port); its index must be int64.
            library=lambda g=g, i=f64: torch.gather(g, 1, i),
            nbytes=4 * 3 * B * n,
            ops=0,
        ))

    return cases + match_cases(torch, ops, ref, dev, ids)


def staged_share(torch, tables, chunks, n_starts: int, rows: int,
                 starts=None) -> float:
    """Share of a walk's lookups (from states 0 .. n_starts-1, or from
    ``starts`` (P, n_starts)) that fall on table rows < ``rows`` (the rows
    the kernel stages in shared memory), walked on the card."""
    P = tables.shape[0]
    B, L = chunks.shape
    if not rows:
        return 0.0
    pr = torch.arange(P, device=tables.device)[:, None, None]
    v = (torch.arange(n_starts, device=tables.device) if starts is None
         else starts.to(torch.int64)[:, None, :]).expand(P, B, n_starts)
    syms = chunks.to(torch.int64)
    staged = torch.zeros((), dtype=torch.int64, device=tables.device)
    for t in range(L):
        staged += (v < rows).sum()
        v = tables[pr, v, syms[None, :, t, None]].to(torch.int64)
    return int(staged) / (P * B * n_starts * L)


def walk_case(torch, ops, kernel, label, branch, tables, ch, ns, run,
              plain, starts=None) -> dict:
    """A chunk-walk case (from ``starts`` (P, ns) where given). It names
    the branch its plan must take (``smem``: the whole table staged;
    ``smem + L2``: rows >= R read from global memory); the wrapper's plan is
    held to it, and the plan and the share of lookups on staged rows are
    printed."""
    P, n, _ = tables.shape
    B, L = ch.shape
    plan = ops.match_plan_of(tables, ch, ns, from_starts=starts is not None)
    check(plan.branch == branch,
          f"{kernel} {label}: plan branch {plan.branch!r}, expected "
          f"{branch!r}")
    share = (1.0 if not plan.global_rows else
             staged_share(torch, tables, ch, ns, plan.rows, starts))
    print(f"[plan] {kernel:18s} {label:40s} {plan.branch:9s} "
          f"R = {plan.rows}/{n} rows, {plan.threads} threads x "
          f"{plan.chains} chains, {plan.patterns} tables a block, "
          f"{'start' if plan.one_chunk else 'chunk'}-major, "
          f"{plan.smem} B shared; lookups on staged rows {share:.6f}",
          flush=True)
    return dict(
        kernel=kernel, label=label,
        shape=f"tables {P}x{n}x{K}, chunks {B}x{L}, n_starts {ns}",
        run=run, plain=plain, library=None,
        nbytes=4 * (P * n * K + B * L + P * B * ns),
        ops=2 * P * B * ns * L,
    )


def match_cases(torch, ops, ref, dev, ids):
    """The two chunk walks at the main path's shapes, on random tables."""
    cases = []

    # match_chunks: locate's first pass (PS00010's 87-state table, 4,096
    # chunks of 1,024 residues, all 87 lanes), then a table past the
    # shared-memory budget and a ragged edge.
    for label, (n, B, L), branch in (
            ("locate", (87, LOCATE_CHUNKS, SEQ_LEN // LOCATE_CHUNKS), "smem"),
            ("7,184 states", (7184, 300, 48), "smem + L2"),
            ("ragged", (13, 1001, 7), "smem")):
        table, ch = ids(n, (n, K)), ids(K, (B, L))
        cases.append(walk_case(
            torch, ops, "match_chunks", label, branch, table[None], ch, n,
            lambda a=(table, ch): ops.match_chunks(*a),
            lambda a=(table, ch): ref.match_chunks(*a)))

    # match_bank_chunks at the scan's shapes (65,536 docs x 8 chunks of 48
    # symbols), on random tables: the SFA group (18 deltas of <= 272 rows,
    # one lane) and the enumeration group (5 tables of 87 states, all lanes)
    # at budget 512, and all 23 SFA deltas at budget 20000 (7,184 rows, one
    # lane; uniform random tables visit every row alike, the design's worst
    # case); then n_starts = n past the budget on fewer chunks, and ragged
    # edges.
    chunks = ids(K, (DOCS * N_CHUNKS, DOC_LEN // N_CHUNKS))
    few = chunks[:4096].contiguous()
    for label, (P, n, ch, ns), branch in (
            ("enumeration, budget 512", (5, 87, chunks, 87), "smem"),
            ("sfa, budget 512", (18, 272, chunks, 1), "smem"),
            ("sfa, budget 20000, random rows", (23, 7184, chunks, 1),
             "smem + L2"),
            ("n_starts = n, 7,184 states", (2, 7184, few, 7184), "smem + L2"),
            ("ragged, n_starts = n", (3, 13, ids(K, (1001, 7)), 13), "smem"),
            ("ragged, n_starts = 1", (3, 13, ids(K, (1001, 7)), 1), "smem")):
        tables = ids(n, (P, n, K))
        cases.append(walk_case(
            torch, ops, "match_bank_chunks", label, branch, tables, ch, ns,
            lambda a=(tables, ch, ns): ops.match_bank_chunks(*a),
            lambda a=(tables, ch, ns): ref.match_bank_chunks(*a)))
    return cases


def bundled_cases(torch, ops, ref, dev, main) -> list:
    """``match_bank_chunks`` on the bundled bank's own tables, as the main
    path's scanners compiled them (run after it, so its compiles stay
    cold): the budget-512 enumeration tables and SFA deltas and the
    budget-20000 deltas on random chunks of the scan's shape (the walks stay
    near state 0), and one stream piece of the single phase: 2^22 / 64
    residues in blocks of the stream's n_chunks x block_len through the
    budget-20000 deltas — a small launch."""
    rng = np.random.default_rng(SEED + 1)

    def ids(hi, shape):
        return torch.from_numpy(
            rng.integers(0, hi, shape).astype(np.int32)).to(dev)

    runs = main["runs"]
    g512 = {g.mode: g for g in runs["budget 512 (auto)"]["scanner"].groups}
    s20k = runs["budget 20000 (sfa)"]["scanner"]
    enum, sfa512 = g512["enumeration"].tables, g512["sfa"].deltas
    sfa20k = s20k.groups[0].deltas
    sess = s20k.open_stream()
    n_chunks, block_len = sess.n_chunks, sess.block_len
    chunks = ids(K, (DOCS * N_CHUNKS, DOC_LEN // N_CHUNKS))
    piece = ids(K, (SEQ_LEN // STREAM_PIECES // (n_chunks * block_len)
                    * n_chunks, block_len))
    cases = []
    for label, (tables, ch, ns), branch in (
            ("enumeration, budget 512, bundled",
             (enum, chunks, enum.shape[1]), "smem"),
            ("sfa, budget 512, bundled", (sfa512, chunks, 1), "smem"),
            ("sfa, budget 20000, bundled", (sfa20k, chunks, 1), "smem + L2"),
            ("stream piece, budget 20000, bundled", (sfa20k, piece, 1),
             "smem + L2")):
        cases.append(walk_case(
            torch, ops, "match_bank_chunks", label, branch, tables, ch, ns,
            lambda a=(tables, ch, ns): ops.match_bank_chunks(*a),
            lambda a=(tables, ch, ns): ref.match_bank_chunks(*a)))
    return cases


def form_cases(torch, ops, ref, dev):
    """The forms this slice added, at the main path's shapes: expand_bank
    writing the round's packed words, and compose folding m combines in one
    launch, stacked or by rows of a mapping stack."""
    rng = np.random.default_rng(SEED + 1)

    def ids(hi, shape):
        return torch.from_numpy(
            rng.integers(0, hi, shape).astype(np.int32)).to(dev)

    cases = []
    # expand_bank with words: the construction's bucket round, then a
    # ragged edge (both n odd: the last word's high half is 0).
    for label, (B, T, n) in (("words, main", (6, TILE, 87)),
                             ("words, ragged", (3, 37, 13))):
        W = (n + 1) // 2
        tables, ft = ids(n, (B, n, K)), ids(n, (B, T, n))
        masks = torch.from_numpy(rng.integers(
            0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(dev)
        cases.append(dict(
            kernel="expand_bank", label=label,
            shape=f"tables {B}x{n}x{K}, ft {B}x{T}x{n}, words W={W}",
            run=lambda a=(tables, ft, masks): ops.expand_bank(*a),
            plain=lambda a=(tables, ft, masks): ref.expand_bank(*a),
            library=None,      # no one PyTorch call packs
            nbytes=4 * (B * T * n + B * n * K + B * W + B * T * K * (n + W)),
            ops=0,
        ))

    # compose, stacked: one stream piece (the running prefix then 32 block
    # mappings of the budget-20000 bank), and the budget-512 scan's
    # enumeration chunk reduce (5 patterns x 65,536 docs, 8 chunks, from the
    # identity).
    for label, (B, m, n, first) in (
            ("fold, stream piece", (23, 32, 87, True)),
            ("fold, enumeration reduce", (5 * DOCS, N_CHUNKS, 87, False))):
        f = ids(n, (B, n)) if first else None
        gs = ids(n, (B, m, n))
        cases.append(dict(
            kernel="compose", label=label,
            shape=f"{'f, ' if first else ''}gs {B}x{m}x{n}",
            run=lambda a=(f, gs): ops.compose_fold(*a),
            plain=lambda a=(f, gs): ref.compose_fold(*a),
            library=None,      # one gather per combine
            nbytes=4 * B * n * (m + 1 + first),
            ops=0,
        ))

    # compose, rows: the budget-20000 SFA scan's chunk fold (23 mapping
    # stacks of 7,184 x 87, 65,536 docs x 8 chunks; uniform random final
    # states, so nearly every row is read and the 57 MB stack does not stay
    # in L2), then a ragged edge.
    for label, (P, S, n, D, m) in (
            ("rows, sfa scan 20000", (23, 7184, 87, DOCS, N_CHUNKS)),
            ("rows, ragged", (3, 13, 13, 1001, 3))):
        stacks, idx = ids(n, (P, S, n)), ids(S, (P, D, m))
        rows = int(torch.unique(
            idx + torch.arange(P, device=dev)[:, None, None] * S).numel())
        cases.append(dict(
            kernel="compose", label=label,
            shape=f"stacks {P}x{S}x{n}, idx {P}x{D}x{m}",
            run=lambda a=(stacks, idx): ops.compose_fold_rows(*a),
            plain=lambda a=(stacks, idx): ref.compose_fold_rows(*a),
            library=lambda a=(stacks, idx): gather_fold_rows(torch, *a),
            # 2 m + 4 launches a call: fewer calls, so the queue behind
            # the spin holds them all (it takes about 1,000 launches)
            library_reps=30,
            nbytes=4 * (P * D * m + P * D * n + rows * n),
            ops=0,
        ))
    return cases


def gather_fold_rows(torch, stacks, idx):
    """The rows fold as ``torch.gather`` calls, one a chunk, on the
    flattened stacks (no one PyTorch call folds m rows): chunk ``j``
    gathers ``stacks[p, idx[p, d, j], state]`` at index ``row · n +
    state``. A yardstick, never used by the port."""
    P, S, n = stacks.shape
    D, m = idx.shape[1:]
    flat = stacks.reshape(P, S * n)
    rows = idx.to(torch.int64) * n
    out = torch.arange(n, device=stacks.device).expand(P, D, n)
    for j in range(m):
        out = torch.gather(flat, 1, (rows[:, :, j, None] + out)
                           .reshape(P, D * n)).view(P, D, n)
    return out


def spec_cases(torch, ops, ref, dev):
    """The speculative scan's two launches at its shape (24 patterns of 702
    states, m = 8, 65,536 docs x 8 chunks of 48): the m-lane walk from
    explicit start states, then ``spec_resolve`` on its exits under a
    profile that hits every chunk and one that misses every chunk with 2
    repairs a lane (so lanes stay unresolved); and a ragged edge of each."""
    rng = np.random.default_rng(SEED + 2)

    def ids(lo, hi, shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape).astype(np.int32)).to(dev)

    cases = []
    C, Lc, m = N_CHUNKS, DOC_LEN // N_CHUNKS, SPEC_M
    chunks = ids(0, K, (DOCS * C, Lc))
    for label, (P, n, ch) in (
            ("explicit starts, 24x702, m = 8", (24, SPEC_STATES, chunks)),
            ("explicit starts, ragged", (3, 13, ids(0, K, (1001, 7))))):
        tables, starts = ids(0, n, (P, n, K)), ids(0, n, (P, m))
        B, L = ch.shape
        case = walk_case(
            torch, ops, "match_bank_chunks", label, "smem", tables, ch, m,
            lambda a=(tables, ch, m, starts): ops.match_bank_chunks(*a),
            lambda a=(tables, ch, m, starts): ref.match_bank_chunks(*a),
            starts=starts)
        case["nbytes"] += 4 * P * m          # the start states
        cases.append(case)

    # spec_resolve: "hit all" walks tables on states 0 .. m-1 only, all of
    # them speculated; "miss all" never enters the m speculated states and
    # repairs at most 2 chunks a lane. The bound counts what the data
    # needs (``resolve_work``).
    for label, (P, n, D, ch, rounds, hit) in (
            ("hit all, 24x702", (24, SPEC_STATES, DOCS, chunks, 8, True)),
            ("miss all, 2 rounds, 24x702",
             (24, SPEC_STATES, DOCS, chunks, 2, False)),
            ("ragged, miss all, 1 round", (3, 13, 143, ids(0, K, (1001, 7)),
                                           1, False))):
        C_ = ch.shape[0] // D
        if hit:
            tables, spec = ids(0, m, (P, n, K)), torch.arange(
                m, dtype=torch.int32, device=dev).repeat(P, 1)
            starts = ids(0, m, (P,))
        else:
            tables = ids(0, n - m, (P, n, K))
            spec = torch.arange(n - m, n, dtype=torch.int32,
                                device=dev).repeat(P, 1)
            starts = ids(0, n - m, (P,))
        exits = ops.match_bank_chunks(tables, ch, m, spec)
        args = (tables, spec, starts, exits, ch, C_, rounds)
        nbytes, n_ops = resolve_work(torch, ref, args)
        cases.append(dict(
            kernel="spec_resolve", label=label,
            shape=f"tables {P}x{n}x{K}, {D} docs x {C_} chunks of "
                  f"{ch.shape[1]}, m {m}, max_rounds {rounds}",
            run=lambda a=args: ops.spec_resolve(*a),
            plain=lambda a=args: ref.spec_resolve(*a),
            library=None, nbytes=nbytes, ops=n_ops))
    return cases


def resolve_work(torch, ref, args) -> tuple:
    """(bytes, int32 ops) ``spec_resolve`` needs on these inputs, counted
    from its plain version's outputs: each lane reads its start, one
    4-byte exit a hit and a chunk's symbols a repair, and writes its final
    state and flag; a walked chunk costs m compares, a repaired one an
    address and a load a step."""
    tables, spec, starts, exits, ch, C, rounds = args
    P, m = spec.shape
    D, Lc = ch.shape[0] // C, ch.shape[1]
    _, resolved, hits, repaired, _ = ref.spec_resolve(*args)
    hits, repaired = int(hits), int(repaired)
    stopped = int((~resolved).sum())
    nbytes = 4 * (P * m + P + hits + repaired * Lc) + 5 * P * D + 24
    return nbytes, (hits + repaired + stopped) * m + 2 * repaired * Lc


def check_expand_limit(torch, ops, dev) -> None:
    """``expand_bank`` stages each table in shared memory, rows padded to
    ``k | 1`` words: a table larger than a block may hold must raise
    ValueError, without a launch."""
    n = 2800           # 2800 x 21 x 4 B = 235,200 B; unpadded 224,000 B
    before = ops.launches["expand_bank"]
    try:
        ops.expand_bank(torch.zeros((1, n, K), dtype=torch.int32, device=dev),
                        torch.zeros((1, 1, n), dtype=torch.int32, device=dev))
    except ValueError as e:
        print(f"[kernel] expand_bank, {n}-state table: ValueError ({e})",
              flush=True)
    else:
        raise RuntimeError("check failed: expand_bank accepted a table "
                           "larger than a block's shared memory")
    check(ops.launches["expand_bank"] == before,
          "expand_bank launched on a table it cannot stage")


def run_kernel_checks(torch, cases) -> list:
    results = []
    for c in cases:
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        check(len(got) == len(want)
              and all(a.shape == b.shape and a.dtype == b.dtype
                      for a, b in zip(got, want)),
              f"{c['kernel']} {c['label']}: shape/dtype")
        err = max(int((a.to(torch.int64) - b.to(torch.int64))
                      .abs().max().item()) if a.numel() else 0
                  for a, b in zip(got, want))
        check(err == 0, f"{c['kernel']} {c['label']}: differs from its "
                        f"plain version (max abs err {err})")
        ms, us = timings(torch, c["run"])
        plain_ms = cuda_ms(torch, c["plain"], reps=2)
        lib_ms = lib_us = None
        if c["library"] is not None:
            check(torch.equal(c["library"](), want[0]),
                  f"{c['kernel']} {c['label']}: library yardstick differs")
            lib_ms, lib_us = timings(torch, c["library"],
                                     c.get("library_reps", DEVICE_REPS))
        b_ms, b_by = bound(c["nbytes"], c["ops"])
        r = dict(kernel=c["kernel"], label=c["label"], shape=c["shape"],
                 max_abs_err=err, ms=ms, host_us=us, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                 library_host_us=lib_us)
        print(f"[kernel] {c['kernel']:18s} {c['label']:32s} {c['shape']:40s}"
              f" equal  device {ms:9.4f} ms  host {us:8.1f} us  plain "
              f"{plain_ms:9.3f} ms  bound {b_ms:8.4f} ms ({b_by})"
              + (f"  library {lib_ms:8.4f} ms, host {lib_us:6.1f} us"
                 if lib_ms is not None else ""),
              flush=True)
        results.append(r)
        del got, want
    return results


# --------------------------------------------------------------------------
# Phases 3 and 4: the main path, then plain and reference twins
# --------------------------------------------------------------------------


def sfa_sizes(scanner) -> dict:
    out = {}
    for g in scanner.groups:
        if g.mode == "sfa":
            for i, s in zip(g.indices, g.sfa_states):
                out[scanner.ids[i]] = int(s)
    return out


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class PathLaunches:
    """The kernel launches of a path's own runs, by kernel (and by form,
    ``ops.form_launches``): :meth:`run` sets the counts to 0 just before a
    run of the path and adds them here just after, so the launches of the
    runs that check the path (plain versions, comparison scans) are left
    out."""

    def __init__(self, ops):
        self.ops = ops
        self.counts = dict.fromkeys([*ops.launches, *ops.form_launches], 0)

    def run(self, fn):
        self.ops.reset_launches()
        out = fn()
        for counts in (self.ops.launches, self.ops.form_launches):
            for name, v in counts.items():
                self.counts[name] += v
        return out


def cold():
    """Construction settings of every compile that measures or compares a
    construction: the SFA cache off, so each one constructs."""
    from repro_torch.engine import ConstructionPolicy

    return ConstructionPolicy(cache="off")


def main_path(torch, ops, corpus) -> dict:
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import Scanner

    bank = load_bank()
    runs = {}
    ops.reset_launches()
    for name, overrides in (("budget 512 (auto)", {}),
                            ("budget 20000 (sfa)",
                             dict(mode="sfa", sfa_state_budget=20_000))):
        sc, t_compile = timed(torch, lambda: Scanner.compile(
            bank, construction=cold(), **overrides))
        res, t_scan = timed(torch, lambda: sc.scan(corpus))
        census, t_census = timed(torch, lambda: sc.census(corpus))
        check(np.array_equal(census, res.counts), f"{name}: census vs scan")
        rep = sc.construction_report
        sizes = sfa_sizes(sc)
        modes = list(sc.pattern_modes.values())
        runs[name] = dict(scanner=sc, hits=res.hits, census=census,
                          compile_s=t_compile, scan_s=t_scan,
                          census_s=t_census, rounds=rep.rounds,
                          blown=rep.blown, sfa_states=sizes,
                          n_sfa=modes.count("sfa"),
                          n_enum=modes.count("enumeration"))
        print(f"[main] {name}: compile {t_compile:.3f} s "
              f"({rep.rounds} construction rounds, {rep.blown} blown, "
              f"{modes.count('sfa')} sfa / {modes.count('enumeration')} "
              f"enumeration patterns); scan {t_scan:.3f} s "
              f"= {corpus.size / t_scan / 1e6:.1f} M residues/s; census "
              f"{t_census:.3f} s", flush=True)
        print(f"[main] {name}: SFA states {sizes}", flush=True)
        print(f"[main] {name}: census {census.tolist()}", flush=True)
    launches = dict(ops.launches)
    print(f"[main] kernel launches in the main path: {launches}", flush=True)
    for name in MAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the main path")

    r512, r20k = runs["budget 512 (auto)"], runs["budget 20000 (sfa)"]
    check(r512["blown"] == 5 and r512["n_sfa"] == 18 and r512["n_enum"] == 5,
          "budget 512 splits the bank 18 SFA / 5 enumeration")
    check(r20k["blown"] == 0 and r20k["n_sfa"] == 23,
          "all 23 SFAs close at budget 20000")
    check(max(r20k["sfa_states"].values()) == 7184,
          "largest SFA at budget 20000 has 7,184 states")
    for name, r in runs.items():
        check(r["hits"].shape == (23, DOCS), f"{name}: hit matrix shape")
    # The kernel cases above use these group shapes.
    g512 = {g.mode: g for g in r512["scanner"].groups}
    check(tuple(g512["enumeration"].tables.shape) == (5, 87, K)
          and tuple(g512["sfa"].deltas.shape) == (18, 272, K)
          and tuple(r20k["scanner"].groups[0].deltas.shape) == (23, 7184, K),
          "main-path table shapes match the kernel cases")
    return dict(runs=runs, launches=launches)


def plain_hits(torch, X, kref, scanner, corpus) -> np.ndarray:
    """Hits of ``scanner``'s groups with the chunk walks and the chunk
    folds through the plain versions of the kernels, on the card."""
    from repro_torch.core.monoid import function_monoid

    plain_fn = function_monoid(kref)
    hits = np.zeros((scanner.n_patterns, corpus.shape[0]), dtype=bool)
    head = torch.as_tensor(corpus, device=scanner.device)
    for g in scanner.groups:
        if g.mode == "sfa":
            maps = X.bank_doc_mappings_sfa(g.deltas, g.sfa_maps, head,
                                           N_CHUNKS,
                                           match_fn=kref.match_bank_chunks,
                                           fold_rows=kref.compose_fold_rows)
        else:
            maps = X.bank_doc_mappings(g.tables, head, N_CHUNKS,
                                       match_fn=kref.match_bank_chunks,
                                       monoid=plain_fn)
        hits[g.indices] = X.hits_of_mappings(
            maps, g.accepting, g.starts).cpu().numpy()
    return hits


def twins(torch, corpus, main) -> dict:
    from repro_torch.construction import construct_bank
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ConstructionPolicy, Scanner
    from repro_torch.engine import executors as X
    from repro_torch.kernels import ref as kref

    bank = load_bank()
    out = {}
    for name, budget, overrides in (
            ("budget 512 (auto)", 512, {}),
            ("budget 20000 (sfa)", 20_000,
             dict(mode="sfa", sfa_state_budget=20_000))):
        kern, t_kern = timed(torch, lambda: construct_bank(
            bank, max_states=budget))
        plain, t_plain = timed(torch, lambda: construct_bank(
            bank, max_states=budget, fingerprint_backend="plain",
            expand_backend="plain"))
        check(np.array_equal(kern.blown, plain.blown)
              and np.array_equal(kern.stats.retries, plain.stats.retries),
              f"{name}: plain construction verdicts")
        for a, b in zip(kern.sfas, plain.sfas):
            check((a is None) == (b is None), f"{name}: blown sets")
            if a is not None:
                check(np.array_equal(a.delta, b.delta)
                      and np.array_equal(a.mappings, b.mappings)
                      and np.array_equal(a.fingerprints, b.fingerprints),
                      f"{name}: plain construction gives the same SFAs")
        policy = ConstructionPolicy(fingerprint_backend="plain",
                                    expand_backend="plain", cache="off")
        sc_plain = Scanner.compile(bank, construction=policy, **overrides)
        hits_plain, t_pscan = timed(
            torch, lambda: plain_hits(torch, X, kref, sc_plain, corpus))
        kernel_hits = main["runs"][name]["hits"]
        check(np.array_equal(hits_plain, kernel_hits),
              f"{name}: plain scan hits equal the kernel scan's")
        sc_ref = Scanner.compile(bank, backend="reference",
                                 construction=cold(), **overrides)
        sub = corpus[:REF_DOCS]
        ref_res, t_ref = timed(torch, lambda: sc_ref.scan(sub))
        check(np.array_equal(ref_res.hits, kernel_hits[:, :REF_DOCS])
              and np.array_equal(ref_res.counts,
                                 kernel_hits[:, :REF_DOCS].sum(1)),
              f"{name}: reference backend hits and census")
        out[name] = dict(construct_kernel_s=t_kern, construct_plain_s=t_plain,
                         rounds=kern.stats.rounds, scan_plain_s=t_pscan,
                         reference_s=t_ref)
        print(f"[twins] {name}: construct_bank kernel {t_kern:.3f} s / plain "
              f"{t_plain:.3f} s ({kern.stats.rounds} rounds, SFAs equal); "
              f"plain scan {t_pscan:.3f} s, hits equal; reference backend "
              f"{REF_DOCS} docs {t_ref:.3f} s, hits equal", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 5: the single-pattern path
# --------------------------------------------------------------------------


def sfa_fields_equal(a, b) -> bool:
    return (np.array_equal(a.mappings, b.mappings)
            and np.array_equal(a.delta, b.delta)
            and np.array_equal(a.fingerprints, b.fingerprints))


def single_path(torch, ops, kref, seq, profile: bool = False) -> dict:
    from repro_torch.construction import construct_sfa, construct_sfa_sequential
    from repro_torch.core.matching import match_ends_sequential
    from repro_torch.core.monoid import function_monoid
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ChunkPolicy, Scanner
    from repro_torch.engine import executors as X

    one = load_bank([SINGLE_ID])
    dfa = one.dfa(0)
    pieces = np.array_split(seq, STREAM_PIECES)
    walls = {}

    def run(name, fn):
        out, walls[name] = timed(torch, fn)
        return out

    ops.reset_launches()
    sc = run("compile", lambda: Scanner.compile(
        one, mode="sfa", sfa_state_budget=SINGLE_BUDGET, construction=cold(),
        chunking=ChunkPolicy(n_chunks=LOCATE_CHUNKS)))
    bank_sfa = run("construct_sfa engine=jax", lambda: construct_sfa(
        dfa, engine="jax", max_states=SINGLE_BUDGET))
    flags = run("locate", lambda: sc.locate(seq, SINGLE_ID))
    bank = run("compile bank", lambda: Scanner.compile(
        load_bank(), mode="sfa", sfa_state_budget=SINGLE_BUDGET,
        construction=cold()))
    windows = run("census_windows", lambda: bank.census_windows(
        seq, WINDOW, STRIDE))
    before = ops.launches["compose"]
    streamed = run("stream", lambda: bank.stream(pieces))
    stream_composes = ops.launches["compose"] - before
    launches = dict(ops.launches)
    rep = sc.construction_report
    sfa_states = int(sc.groups[0].sfa_states[0])
    n_win = (SEQ_LEN - WINDOW) // STRIDE + 1
    print(f"[single] {SINGLE_ID} ({dfa.n_states} states): compile "
          f"{walls['compile']:.3f} s via {rep.method}, {rep.rounds} rounds, "
          f"{sfa_states} SFA states; one-pattern bank construction "
          f"{walls['construct_sfa engine=jax']:.3f} s; locate of "
          f"{SEQ_LEN} residues in {LOCATE_CHUNKS} chunks "
          f"{walls['locate']:.3f} s ({int(flags.sum())} match ends)",
          flush=True)
    print(f"[single] budget-20000 bank: compile {walls['compile bank']:.3f} "
          f"s; census_windows({WINDOW}, {STRIDE}) of {n_win} windows "
          f"{walls['census_windows']:.3f} s (census "
          f"{windows.counts.tolist()}); stream in {STREAM_PIECES} pieces "
          f"{walls['stream']:.3f} s", flush=True)
    print(f"[single] kernel launches in the single-pattern path: {launches}",
          flush=True)
    for name in SINGLE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the single-pattern path")
    # A piece is one fold of the chunks' mapping rows and one of the prefix
    # and the piece's blocks, per group.
    print(f"[single] compose launches of the stream: {stream_composes} for "
          f"{STREAM_PIECES} pieces x {len(bank.groups)} group(s)", flush=True)
    check(stream_composes <= 2 * STREAM_PIECES * len(bank.groups),
          "the stream launches compose at most twice per piece and group")

    # Construction: the auto rule, the reference's round count, and equal
    # SFAs from the one-pattern bank construction and the host engine.
    check(rep.method == "loop" and rep.rounds == 21 and rep.blown == 0
          and sfa_states == 7184,
          f"{SINGLE_ID} compiles by the loop in 21 rounds to 7,184 states")
    sfa = sc.groups[0]
    check(np.array_equal(sfa.deltas[0].cpu().numpy(), bank_sfa.delta)
          and np.array_equal(sfa.sfa_maps[0].cpu().numpy(),
                             bank_sfa.mappings),
          "the scanner's SFA equals the one-pattern bank construction's")
    vec = construct_sfa(dfa, max_states=SINGLE_BUDGET)
    host, t_host = timed(torch, lambda: construct_sfa_sequential(
        dfa, max_states=SINGLE_BUDGET))
    check(sfa_fields_equal(vec, bank_sfa) and sfa_fields_equal(vec, host),
          "vectorized, one-pattern bank and host hash-chain SFAs are equal")
    check(vec.stats.rounds == 21 and vec.stats.candidates == 7184 * K,
          "vectorized engine: 21 rounds, 143,680 candidates")

    # locate: the same path through the plain versions on the card, and the
    # sequential match oracle on a prefix.
    dev = sc.device
    plain, t_plain_locate = timed(torch, lambda: X.find_matches_parallel(
        torch.as_tensor(dfa.table, device=dev),
        torch.as_tensor(dfa.accepting, device=dev),
        torch.as_tensor(seq, device=dev), dfa.start, LOCATE_CHUNKS,
        match_fn=kref.match_chunks,
        monoid=function_monoid(kref)).cpu().numpy())
    check(flags.shape == (SEQ_LEN,) and np.array_equal(flags, plain),
          "locate equals the plain-version path")
    check(np.array_equal(flags[:ORACLE_LEN],
                         match_ends_sequential(dfa, seq[:ORACLE_LEN])),
          "locate equals match_ends_sequential on the prefix")

    # census_windows: scan of the materialised windows.
    starts = np.arange(n_win) * STRIDE
    mat = seq[starts[:, None] + np.arange(WINDOW)]
    naive, t_naive = timed(torch, lambda: bank.scan(mat))
    check(windows.hits.shape == (23, n_win)
          and np.array_equal(windows.hits, naive.hits),
          "census_windows equals scan of the materialised windows")

    # stream: the whole sequence's mapping and accept flags.
    whole, t_whole = timed(torch, lambda: bank.mapping(seq))
    check(streamed.n_symbols == SEQ_LEN
          and np.array_equal(streamed.mapping, whole)
          and np.array_equal(streamed.accepted, bank.accepts(seq)),
          "stream equals mapping/accepts of the whole sequence")
    print(f"[single] equal: SFAs (vectorized, one-pattern bank, host "
          f"hash-chain {t_host:.1f} s); locate vs plain versions "
          f"({t_plain_locate:.3f} s) and the oracle on {ORACLE_LEN} residues;"
          f" census_windows vs scan of {n_win} windows ({t_naive:.3f} s); "
          f"stream vs whole-sequence mapping ({t_whole:.3f} s)", flush=True)
    return dict(walls=walls, launches=launches, rounds=rep.rounds,
                method=rep.method, sfa_states=sfa_states,
                host_construct_s=t_host, plain_locate_s=t_plain_locate,
                materialised_scan_s=t_naive, whole_mapping_s=t_whole,
                census=windows.counts.tolist(), windows_hits=windows.hits,
                match_ends=int(flags.sum()), stream_composes=stream_composes,
                profile_stream=(trace(torch, "single stream",
                                      lambda: bank.stream(pieces))
                                if profile else None))


# --------------------------------------------------------------------------
# Phase 6: speculative scanning
# --------------------------------------------------------------------------


def spec_stats_dict(st) -> dict:
    return dict(total_chunks=st.total_chunks, hit_chunks=st.hit_chunks,
                repaired_chunks=st.repaired_chunks,
                repair_rounds=st.repair_rounds,
                fallback_lanes=st.fallback_lanes)


def plain_spec_stats(torch, kref, scanner, corpus) -> dict:
    """The speculative groups of ``scanner`` run again through the plain
    versions of both launches on the card, from the profiles its scan
    memoised: the kernels' outputs must equal them, and -> the stats."""
    from repro_torch.speculative import (
        SpeculationStats,
        speculative_bank_finals,
    )

    total = None
    head = torch.as_tensor(corpus, device=scanner.device)
    for g in scanner.groups:
        if g.mode != "speculative":
            continue
        spec = torch.as_tensor(g._spec_profile, device=scanner.device)
        args = (g.tables, spec, g.starts.to(torch.int32), head, N_CHUNKS,
                scanner.plan.speculation.max_repair_rounds)
        kern = speculative_bank_finals(*args)
        plain = speculative_bank_finals(*args,
                                        match_fn=kref.match_bank_chunks,
                                        resolve_fn=kref.spec_resolve)
        for a, b in zip(kern, plain):
            check(torch.equal(a, b), "speculative executor: kernels differ "
                                     "from their plain versions")
        st = SpeculationStats.of(plain, len(g.indices) * corpus.shape[0]
                                 * N_CHUNKS)
        total = st if total is None else total.merged(st)
    return spec_stats_dict(total)


def never_entered(torch, scanner, corpus, m: int) -> dict:
    """{pattern id: m states} no chunk of ``corpus`` is entered in (by the
    exact walk from each start; the padded rows beyond a pattern's own
    states are never entered), or, for a pattern with fewer such states,
    the least-entered ones: a profile that misses."""
    (g,) = [g for g in scanner.groups if g.mode == "speculative"]
    head = torch.as_tensor(corpus, device=scanner.device).to(torch.int64)
    Pg, n, _ = g.tables.shape
    Lc = corpus.shape[1] // N_CHUNKS
    rows = torch.arange(Pg, device=scanner.device)[:, None]
    cur = g.starts[:, None].expand(Pg, corpus.shape[0])
    counts = torch.zeros((Pg, n), dtype=torch.int64, device=scanner.device)
    for c in range(N_CHUNKS):
        counts.scatter_add_(1, cur, torch.ones_like(cur))
        for t in range(c * Lc, (c + 1) * Lc):
            cur = g.tables[rows, cur, head[None, :, t]].to(torch.int64)
    counts = counts.cpu().numpy()
    out = {}
    for j, i in enumerate(g.indices):
        order = np.lexsort((np.arange(n), counts[j]))
        out[scanner.ids[i]] = order[:m].astype(np.int32)
    return out


def speculative_path(torch, ops, kref, corpus, seq) -> dict:
    from repro_torch.core.dfa import random_dfa
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import (
        ChunkPolicy,
        ConstructionPolicy,
        ScanPlan,
        Scanner,
        SpeculationPolicy,
    )

    bank = load_bank()
    pats = {bank.ids[i]: bank.dfa(i) for i in range(bank.n_patterns)}
    pats[SPEC_ID] = random_dfa(SPEC_STATES, K, seed=SPEC_SEED)
    walls, stats = {}, {}
    path = PathLaunches(ops)

    def run(name, fn):          # a run of the path: timed and counted
        out, walls[name] = timed(torch, lambda: path.run(fn))
        return out

    def twin(name, fn):         # a run that checks it: timed only
        out, walls[name] = timed(torch, fn)
        return out

    # 1. Forced speculation on the bundled bank, against enumeration.
    forced = run("forced: compile", lambda: Scanner.compile(bank, ScanPlan(
        mode="speculative", construction=ConstructionPolicy(cache="off"))))
    got1 = run("forced: scan", lambda: forced.scan(corpus))
    run("forced: repeat scan", lambda: forced.scan(corpus))
    enum1 = twin("enumeration: compile", lambda: Scanner.compile(
        bank, mode="enumeration"))
    want1 = twin("enumeration: scan", lambda: enum1.scan(corpus))
    check(np.array_equal(got1.hits, want1.hits),
          "forced speculation: hits equal enumeration's")
    stats["forced"] = spec_stats_dict(got1.speculation)
    check(plain_spec_stats(torch, kref, forced, corpus) == stats["forced"],
          "forced speculation: stats equal the plain versions'")

    # 2. The auto tier at the paper's scale: the bundled bank and the
    # 702-state DFA, budget 512, cache off (the construction is timed).
    auto = run("auto: compile", lambda: Scanner.compile(
        pats, construction=ConstructionPolicy(cache="off")))
    modes = list(auto.pattern_modes.values())
    check((modes.count("sfa"), modes.count("enumeration"),
           modes.count("speculative")) == (18, 5, 1)
          and auto.pattern_modes[SPEC_ID] == "speculative",
          "auto tier: 18 SFA, 5 enumeration and the 702-state pattern "
          "speculative")
    got2 = run("auto: scan", lambda: auto.scan(corpus))
    run("auto: repeat scan", lambda: auto.scan(corpus))
    # Bucketed, so the 702-state table is a group of its own and the 23
    # others are not padded to it.
    enum2 = twin("auto, enumeration: compile", lambda: Scanner.compile(
        pats, mode="enumeration", chunking=ChunkPolicy(bucket=True)))
    want2 = twin("auto, enumeration: scan", lambda: enum2.scan(corpus))
    check(np.array_equal(got2.hits, want2.hits),
          "auto tier: hits equal enumeration's")
    stats["auto"] = spec_stats_dict(got2.speculation)
    check(plain_spec_stats(torch, kref, auto, corpus) == stats["auto"],
          "auto tier: stats equal the plain versions'")
    # The 702-state pattern alone, speculative against enumeration.
    one = {SPEC_ID: pats[SPEC_ID]}
    alone = run("702 alone: speculative compile",
                lambda: Scanner.compile(one, mode="speculative"))
    run("702 alone: speculative scan", lambda: alone.scan(corpus))
    got3 = run("702 alone: repeat speculative scan",
               lambda: alone.scan(corpus))
    enum3 = Scanner.compile(one, mode="enumeration")
    want3 = twin("702 alone: enumeration scan", lambda: enum3.scan(corpus))
    check(np.array_equal(got3.hits, want3.hits),
          "702 alone: hits equal enumeration's")
    stats["702 alone"] = spec_stats_dict(got3.speculation)

    # 3. An adversarial profile: states no chunk is entered in, 2 repairs.
    profile = never_entered(torch, forced, corpus, SPEC_M)
    adv = run("adversarial: compile", lambda: Scanner.compile(bank, ScanPlan(
        mode="speculative", speculation=SpeculationPolicy(
            profile_source=profile, max_repair_rounds=2))))
    got4 = run("adversarial: scan", lambda: adv.scan(corpus))
    stats["adversarial"] = spec_stats_dict(got4.speculation)
    check(np.array_equal(got4.hits, want1.hits)
          and got4.speculation.repaired_chunks > 0
          and got4.speculation.fallback_lanes > 0,
          "adversarial profile: hits unchanged, chunks repaired and lanes "
          "falling back")

    # 4. A 64-piece stream of the long sequence through the auto scanner.
    pieces = np.array_split(seq, STREAM_PIECES)
    streamed = run("auto: stream", lambda: auto.stream(pieces))
    whole = twin("auto: scan of the whole sequence",
                 lambda: auto.scan([seq]))
    walk = twin("auto: mapping of the whole sequence",
                lambda: auto.mapping(seq))
    starts = np.asarray([d.start for d in auto._dfas])
    check(streamed.n_symbols == SEQ_LEN and streamed.mapping is None
          and np.array_equal(streamed.accepted, whole.hits[:, 0])
          and np.array_equal(streamed.final_states,
                             walk[np.arange(len(starts)), starts]),
          "stream equals the scan and the whole-sequence walk")
    stats["stream"] = spec_stats_dict(streamed.speculation)
    launches = path.counts

    for name, wall in walls.items():
        print(f"[speculative] {name}: {wall:.4f} s", flush=True)
    for name, st in stats.items():
        print(f"[speculative] stats {name}: {st}", flush=True)
    print(f"[speculative] kernel launches in the speculative path's own "
          f"runs: {launches}", flush=True)
    for name in SPEC_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the speculative path")
    return dict(walls=walls, stats=stats, launches=launches,
                modes={"sfa": 18, "enumeration": 5, "speculative": 1},
                forced_hits=got1.hits)


# --------------------------------------------------------------------------
# Phase 7: the scan service, the SFA cache and a resumable corpus job
# --------------------------------------------------------------------------


def service_path(torch, ops, corpus, workdir) -> dict:
    import os.path as osp

    from repro_torch import obs
    from repro_torch.construction import SFACache, shared_cache
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ConstructionPolicy, Scanner
    from repro_torch.scanservice import (
        ArtifactStore,
        CorpusJob,
        CorpusManifest,
    )

    bank = load_bank()
    ids = list(bank.ids)
    walls = {}
    path = PathLaunches(ops)

    def run(name, fn):          # a run of the path: timed and counted
        out, walls[name] = timed(torch, lambda: path.run(fn))
        return out

    def twin(name, fn):         # a run that checks it: timed only
        out, walls[name] = timed(torch, fn)
        return out

    store_dir = osp.join(workdir, "store")
    # 1. Four overlapping requests, one flush, each answer a direct scan.
    requests = [(ids[6 * r: 6 * r + 11],
                 corpus[r * SERVICE_DOCS // 2:
                        r * SERVICE_DOCS // 2 + SERVICE_DOCS])
                for r in range(4)]
    with Scanner.service(store_dir=store_dir) as svc:
        tickets = [svc.submit(p, list(d)) for p, d in requests]
        run("service: flush of 4 requests", svc.flush)
        sched = svc.scheduler.stats
        for t, (p, d) in zip(tickets, requests):
            want = Scanner.compile(p, construction=cold()).scan(d)
            check(np.array_equal(t.result().hits, want.hits),
                  "service: a coalesced answer equals a direct scan")
    check(sched.flushes == 1 and sched.union_patterns == len(
        set(sum((p for p, _ in requests), []))),
        "service: one flush of the union bank")

    # 2. The shared cache: a cold compile, then one answered from it.
    shared_cache().clear()
    cold_sc = run("compile, cache shared, cold", lambda: Scanner.compile(
        bank, construction=ConstructionPolicy(cache="shared")))
    warm_sc = run("compile, cache shared, warm", lambda: Scanner.compile(
        bank, construction=ConstructionPolicy(cache="shared")))
    r = warm_sc.construction_report
    check(cold_sc.construction_report.rounds > 0 and r.cache_hits == 23
          and r.rounds == 0 and r.constructed == 0,
          "a second compile under the shared cache: 23 hits, 0 rounds")

    # 3. A fresh cache preloaded from the service's store.
    fresh = SFACache(backing=ArtifactStore(store_dir))
    promoted = fresh.preload()
    check(promoted > 0 and fresh.info.disk_hits == promoted,
          "a fresh cache preloads the store (disk hits)")

    # 4. A corpus job, killed after 3 of 8 shards and resumed, against a
    # straight scan and an uninterrupted job.
    docs = list(corpus)
    man = CorpusManifest.from_docs(docs, shard_docs=JOB_SHARD_DOCS)
    plan_kw = dict(construction=ConstructionPolicy(cache=fresh))

    def job(name):
        from repro_torch.engine import ScanPlan

        return CorpusJob(bank, man, osp.join(workdir, name),
                         plan=ScanPlan(**plan_kw))

    first = job("resumed")
    rep1 = run("job: first 3 shards", lambda: first.run(
        max_shards=JOB_FIRST))
    check(rep1.scanned == JOB_FIRST and not rep1.complete,
          "job: 3 shards before the kill")
    del first                                       # the kill
    resumed = job("resumed")
    rep2 = run("job: resume", resumed.run)
    check(rep2.done_before == JOB_FIRST and rep2.complete,
          "job: the resume scans the rest")
    straight = twin("job: straight scan", lambda: Scanner.compile(
        bank, **plan_kw).scan(corpus))
    agg = resumed.aggregate()
    check(agg.hits.tobytes() == straight.hits.tobytes()
          and resumed.census().tobytes() == straight.counts.tobytes(),
          "job: aggregate hits and census byte-identical to the straight "
          "scan")
    whole = job("uninterrupted")
    twin("job: uninterrupted", whole.run)
    totals = resumed.flight_totals()["metrics"]
    check(totals == whole.flight_totals()["metrics"]
          and totals["jobs.items_scanned"] == DOCS,
          "job: jobs.* flight totals equal the uninterrupted job's")
    launches = path.counts
    for name, wall in walls.items():
        print(f"[service] {name}: {wall:.4f} s", flush=True)
    print(f"[service] shared cache: cold compile "
          f"{cold_sc.construction_report.rounds} rounds, warm compile "
          f"{r.cache_hits} hits / {r.rounds} rounds; preload {promoted} "
          f"artifacts; job shards {man.n_shards}, flight totals "
          f"{ {k: v for k, v in totals.items() if not isinstance(v, dict)} }",
          flush=True)
    print(f"[service] kernel launches in the service path's own runs: "
          f"{launches}; registry scheduler.flushes "
          f"{obs.snapshot('scheduler').get('scheduler.flushes')}",
          flush=True)
    for name in SERVICE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the service path")
    return dict(walls=walls, launches=launches, preloaded=promoted,
                cold_rounds=cold_sc.construction_report.rounds)


# --------------------------------------------------------------------------
# Phase 8: distribution="shard_map" at world size 1
# --------------------------------------------------------------------------


def distributed_path(torch, ops, corpus, seq, main, single, spec,
                     service) -> dict:
    """The mesh paths of the Scanner and of construction, each held equal
    to the local result an earlier phase computed (not recomputed here),
    its wall beside that run's."""
    import torch.distributed as dist

    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ConstructionPolicy, ScanPlan, Scanner

    bank = load_bank()
    walls = {}
    path = PathLaunches(ops)

    def run(name, fn):          # a run of the path: timed and counted
        out, walls[name] = timed(torch, lambda: path.run(fn))
        return out

    sharded = ConstructionPolicy(cache="off", distribution="shard_map")
    # 1. Construction over the pattern axis and the scan over the data axis.
    sc = run("compile", lambda: Scanner.compile(bank, ScanPlan(
        distribution="shard_map", construction=sharded)))
    check(dist.is_initialized() and dist.get_world_size() == 1
          and dist.get_backend() == "nccl" and sc.mesh.device_type == "cuda"
          and torch.cuda.current_device() == 0,
          "the mesh is a one-rank NCCL world on cuda:0")
    # The first compile also sets up NCCL's communicator; a second one
    # shows the mesh path's own cost.
    again = run("compile again", lambda: Scanner.compile(bank, ScanPlan(
        distribution="shard_map", construction=sharded)))
    res = run("scan", lambda: sc.scan(corpus))
    census = run("census", lambda: sc.census(corpus))
    local = main["runs"]["budget 512 (auto)"]
    check(again.construction_report == sc.construction_report,
          "sharded construction: the same report twice")
    check(len(sc.groups) == len(local["scanner"].groups),
          "sharded construction: the main phase's groups")
    for g, lg in zip(sc.groups, local["scanner"].groups):
        check(g.mode == lg.mode and np.array_equal(g.indices, lg.indices)
              and torch.equal(g.tables, lg.tables),
              "sharded construction: the main phase's groups")
        if g.mode == "sfa":
            check(torch.equal(g.deltas, lg.deltas)
                  and torch.equal(g.sfa_maps, lg.sfa_maps)
                  and np.array_equal(g.sfa_states, lg.sfa_states),
                  "sharded construction: the main phase's SFAs")
    rep = sc.construction_report
    check(rep.rounds == local["rounds"] and rep.blown == local["blown"],
          "sharded construction: the main phase's rounds and blowups")
    check(np.array_equal(res.hits, local["hits"])
          and np.array_equal(census, local["census"]),
          "mesh scan: the main phase's hits and census")

    # 2. Forced speculation under the mesh.
    forced = run("forced speculation: compile", lambda: Scanner.compile(
        bank, ScanPlan(mode="speculative", distribution="shard_map")))
    got = run("forced speculation: scan", lambda: forced.scan(corpus))
    stats = spec_stats_dict(got.speculation)
    check(np.array_equal(got.hits, spec["forced_hits"])
          and stats == spec["stats"]["forced"],
          "mesh speculation: phase 6's hits and SpeculationStats")

    # 3. census_windows of the long sequence through the budget-20000 bank.
    wbank = run("compile bank", lambda: Scanner.compile(
        bank, ScanPlan(mode="sfa", sfa_state_budget=SINGLE_BUDGET,
                       distribution="shard_map", construction=sharded)))
    windows = run("census_windows", lambda: wbank.census_windows(
        seq, WINDOW, STRIDE))
    check(np.array_equal(windows.hits, single["windows_hits"]),
          "mesh census_windows: phase 5's windows")
    launches = path.counts

    # A repeat compile's twin is the service phase's, which also comes
    # after the process's first compile of the bank.
    twins = {"compile": local["compile_s"],
             "compile again": service["walls"]["compile, cache shared, cold"],
             "scan": local["scan_s"],
             "census": local["census_s"],
             "forced speculation: compile": spec["walls"]["forced: compile"],
             "forced speculation: scan": spec["walls"]["forced: scan"],
             "compile bank": single["walls"]["compile bank"],
             "census_windows": single["walls"]["census_windows"]}
    for name, wall in walls.items():
        print(f"[distributed] {name}: {wall:.4f} s (local {twins[name]:.4f} "
              f"s)", flush=True)
    print(f"[distributed] construction {rep.rounds} rounds, {rep.blown} "
          f"blown; speculation {stats}", flush=True)
    print(f"[distributed] kernel launches in the distributed path's own "
          f"runs: {launches}", flush=True)
    for name in DIST_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the distributed path")
    return dict(walls=walls, local_walls=twins, launches=launches,
                rounds=rep.rounds, stats=stats)


#: The two-rank run: two gloo ranks on the one card (``cuda:0`` both; gloo
#: carries CUDA tensors through host memory), each spawned with the first
#: TWO_RANK_DOCS documents of the corpus, for at most TWO_RANK_TIMEOUT_S.
TWO_RANK_DOCS, TWO_RANK_TIMEOUT_S = 4096, 300


def two_rank_worker(rank: int, workdir: str) -> None:
    """One of two ranks on the one card: the bank compiled with the
    construction sharded over the pattern axis and scanned with the docs
    sharded over the data axis, then scanned under forced speculation;
    each rank writes its launch counts, and rank 0 the results."""
    import datetime

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ConstructionPolicy, ScanPlan, Scanner
    from repro_torch.kernels import ops
    from repro_torch.mesh import make_mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=TWO_RANK_TIMEOUT_S))
    data = make_mesh((2,), ("data",), device="cuda")
    patterns = make_mesh((2,), ("pattern",), device="cuda")
    corpus = np.load(os.path.join(workdir, "corpus.npy"))
    bank = load_bank()
    ops.reset_launches()
    t0 = time.perf_counter()
    sc = Scanner.compile(bank, ScanPlan(
        distribution="shard_map", mesh=data, construction=ConstructionPolicy(
            cache="off", distribution="shard_map", mesh=patterns)))
    t1 = time.perf_counter()
    hits = sc.scan(corpus).hits
    t2 = time.perf_counter()
    forced = Scanner.compile(bank, ScanPlan(
        mode="speculative", distribution="shard_map", mesh=data)).scan(corpus)
    t3 = time.perf_counter()
    with open(os.path.join(workdir, f"launches{rank}.json"), "w") as f:
        json.dump({**ops.launches, **ops.form_launches}, f)
    if rank == 0:
        groups = {}
        for i, g in enumerate(sc.groups):
            groups[f"{i}_indices"] = g.indices
            if g.mode == "sfa":
                groups[f"{i}_deltas"] = g.deltas.cpu().numpy()
                groups[f"{i}_sfa_maps"] = g.sfa_maps.cpu().numpy()
        np.savez(os.path.join(workdir, "results.npz"), hits=hits,
                 forced_hits=forced.hits, **groups)
        st = forced.speculation
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(dict(rounds=sc.construction_report.rounds,
                           stats=[st.total_chunks, st.hit_chunks,
                                  st.repaired_chunks, st.repair_rounds,
                                  st.fallback_lanes],
                           walls=dict(compile=t1 - t0, scan=t2 - t1,
                                      forced=t3 - t2)), f)
    dist.destroy_process_group()


def two_rank_path(torch, corpus, main) -> dict:
    """Both ranks' results against the local path on the same documents:
    the main phase's SFAs and hits, and a local forced speculation."""
    import multiprocessing

    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ScanPlan, Scanner

    docs = corpus[:TWO_RANK_DOCS]
    with tempfile.TemporaryDirectory() as workdir:
        np.save(os.path.join(workdir, "corpus.npy"), docs)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=two_rank_worker, args=(r, workdir))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
            p.join(timeout=10)
        check(not hung and [p.exitcode for p in procs] == [0, 0],
              f"two ranks on one card: exit codes "
              f"{[p.exitcode for p in procs]}")
        res = dict(np.load(os.path.join(workdir, "results.npz")))
        with open(os.path.join(workdir, "results.json")) as f:
            info = json.load(f)
        launches = {}
        for r in range(2):
            with open(os.path.join(workdir, f"launches{r}.json")) as f:
                for name, v in json.load(f).items():
                    launches[name] = launches.get(name, 0) + v

    local = main["runs"]["budget 512 (auto)"]
    for i, g in enumerate(local["scanner"].groups):
        check(np.array_equal(res[f"{i}_indices"], g.indices),
              "two ranks: the main phase's groups")
        if g.mode == "sfa":
            check(np.array_equal(res[f"{i}_deltas"], g.deltas.cpu().numpy())
                  and np.array_equal(res[f"{i}_sfa_maps"],
                                     g.sfa_maps.cpu().numpy()),
                  "two ranks: the main phase's SFAs")
    check(info["rounds"] == local["rounds"]
          and np.array_equal(res["hits"], local["hits"][:, :TWO_RANK_DOCS]),
          "two ranks: the main phase's rounds and hits")
    want = Scanner.compile(load_bank(), ScanPlan(mode="speculative")).scan(
        docs)
    st = want.speculation
    check(np.array_equal(res["forced_hits"], want.hits)
          and info["stats"] == [st.total_chunks, st.hit_chunks,
                                st.repaired_chunks, st.repair_rounds,
                                st.fallback_lanes],
          "two ranks: forced speculation's hits and stats")
    print(f"[distributed, 2 ranks] {TWO_RANK_DOCS} docs on cuda:0 through "
          f"gloo: spawn to exit {wall:.2f} s; rank 0: compile "
          f"{info['walls']['compile']:.3f} s, scan "
          f"{info['walls']['scan']:.4f} s, forced speculation "
          f"{info['walls']['forced']:.4f} s; stats {info['stats']}",
          flush=True)
    print(f"[distributed, 2 ranks] kernel launches, both ranks: {launches}",
          flush=True)
    for name in DIST_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the two ranks")
    return dict(wall_s=wall, walls=info["walls"], stats=info["stats"],
                launches=launches)


# --------------------------------------------------------------------------
# Phase 9: the LM half's serving path
# --------------------------------------------------------------------------

#: qwen1.5-0.5B served through the engine: slots, cache length, requests,
#: prompt lengths (numpy seed 0) and tokens a request.
LM_ARCH, LM_SLOTS, LM_MAX_LEN = "qwen1p5_0p5b", 4, 256
LM_REQUESTS, LM_PROMPT, LM_NEW = 16, (16, 128), 32
#: The f32 greedy check: ragged prompts (numpy seed 1) through 2 slots.
LM_GREEDY_PROMPTS, LM_GREEDY_NEW = (8, 13, 5), 8
#: The other architectures: batch, prompt length (mamba2: one SSD chunk),
#: decode steps held against the forward.
LM_B, LM_S, LM_S_MAMBA2, LM_STEPS = 2, 64, 256, 4
#: The reference tests' bounds: decode against forward (relative to the
#: forward's largest value), bf16; the hybrid's exp-gated recurrence gets
#: more. A one-cycle model's decode against its forward in f32 (measured
#: up to 5e-5, recurrentgemma); mamba2's f32 forward still rounds the
#: operands of its two intra-chunk contractions to bf16, as the reference
#: does in every dtype (measured 8.1e-4). Card against CPU: f32 on both.
LM_TOL, LM_TOL_HYBRID = 3e-2, 1e-1
LM_F32_TOL, LM_F32_TOL_SSM, LM_CARD_CPU_TOL = 1e-3, 1e-2, 1e-4


def lm_rel(want, got) -> float:
    """max |got - want| / max |want|, in f32."""
    want, got = want.float(), got.float().to(want.device)
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


def lm_inputs(torch, cfg, B, S, seed, dev):
    """Tokens (B, S) in [1, vocab) and the stub modality inputs (whisper's
    frames, phi3-vision's prefix embeddings) from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.num_prefix_embeds:
        extra["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model))
    return toks, {k: torch.from_numpy(v.astype(np.float32)).to(dev)
                  for k, v in extra.items()}


def decode_against_forward(torch, model, toks, extra, S, steps, dev) -> list:
    """A prefill of ``toks[:, :S]`` and ``steps`` decode steps at per-slot
    positions, each step's logits against the train-mode forward of
    ``toks[:, :S + steps]`` at that position -> the relative errors."""
    from repro_torch.sharding.rules import Dist

    B = toks.shape[0]
    with torch.inference_mode():
        full, _, _ = model(None, toks[:, :S + steps], Dist(), mode="train",
                           **extra)
        cache = model.init_cache(B, S + steps + 4, device=dev)
        model(None, toks[:, :S], Dist(), mode="prefill", cache=cache, **extra)
        errs = []
        for i in range(steps):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            dec, _, _ = model(None, toks[:, S + i:S + i + 1], Dist(),
                              mode="decode", cache=cache, cache_pos=pos)
            check(bool(torch.isfinite(dec).all()), "decode logits finite")
            errs.append(lm_rel(full[:, S + i], dec[:, 0]))
    return errs


def decode_against_forward_by_layer(torch, model, toks, S, dev) -> list:
    """A decoder-only model's decode step at position ``S`` against its
    forward, one layer at a time, each layer fed the forward's input to
    it: a prefill of its first ``S`` positions and a decode of position
    ``S`` against the train-mode layer's output there -> the relative
    errors, a layer each. A random-init model's deep stack amplifies
    rounding (end to end, decode and forward part by more than the bound
    at 24 layers, in this port and in the reference alike:
    tests/test_torch_depth.py), so each layer is held on the same input."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed
    from repro_torch.sharding.rules import Dist

    cfg, params = model.cfg, model.params
    B, L = toks.shape
    cache = model.init_cache(B, L + 4, device=dev)
    positions = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
    pos_s = torch.full((B,), S, dtype=torch.int32, device=dev)
    errs = []
    with torch.inference_mode():
        x = embed(params["embed"], toks, cfg, Dist().rules)
        for kind, bp, bc in T.blocks_in_run_order(params, cfg, cache):
            y, _, _ = T.block_forward(bp, x, cfg, Dist(), kind, mode="train",
                                      positions=positions, cache=None,
                                      cache_pos=None)
            _, c, _ = T.block_forward(bp, x[:, :S], cfg, Dist(), kind,
                                      mode="prefill",
                                      positions=positions[:, :S], cache=bc,
                                      cache_pos=None)
            T.write_back(bc, c)
            dec, _, _ = T.block_forward(bp, x[:, S:S + 1], cfg, Dist(), kind,
                                        mode="decode",
                                        positions=positions[:, S:S + 1],
                                        cache=bc, cache_pos=pos_s)
            errs.append(lm_rel(y[:, S], dec[:, 0]))
            x = y
    return errs


def timed_calls(torch, fn, sink: list):
    """``fn`` with each call's wall (synchronized on both sides) appended
    to ``sink``."""
    def wrapped(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out
    return wrapped


def serve_qwen(torch, dev, card: str) -> tuple:
    """qwen1.5-0.5B at its published size (bf16 activations, f32
    parameters from a seeded generator) serving LM_REQUESTS requests
    through the continuous-batching engine."""
    from repro_torch.config import HOST_MESH, RunConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding.rules import Dist

    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params, t_init = timed(torch, lambda: model.init(gen, device=dev))
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", LM_MAX_LEN,
                                                 LM_SLOTS, "decode"),
                    mesh=HOST_MESH)
    eng = ServeEngine(model, run, Dist(), params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, temperature=0.0)
    # warm-up: one short request (cuBLAS handles, allocator pools)
    eng.submit(Request(prompt=np.arange(1, 17, dtype=np.int32),
                       max_new_tokens=2, rid=-1))
    eng.run_until_done()
    eng.completed.clear()
    prefill_s, decode_s = [], []
    eng.prefill_one = timed_calls(torch, eng.prefill_one, prefill_s)
    eng.decode = timed_calls(torch, eng.decode, decode_s)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    for i, L in enumerate(lens):
        eng.submit(Request(prompt=rng.integers(1, cfg.vocab_size, int(L))
                           .astype(np.int32), max_new_tokens=LM_NEW, rid=i))
    done, wall = timed(torch, eng.run_until_done)
    check(len(done) == LM_REQUESTS and all(
        r.done and len(r.out_tokens) == LM_NEW
        and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
        for r in done), "qwen: every request completes, tokens in range")
    generated = sum(len(r.out_tokens) for r in done)
    peak = torch.cuda.max_memory_allocated()
    # one decode step against the full forward at that position: layer by
    # layer (checked), and end to end (printed)
    toks, _ = lm_inputs(torch, cfg, 1, 65, SEED, dev)
    layer_errs = decode_against_forward_by_layer(torch, model, toks, 64, dev)
    check(max(layer_errs) < LM_TOL,
          f"qwen: a layer's decode against its forward {max(layer_errs):.3e}")
    errs = decode_against_forward(torch, model, toks, {}, 64, 1, dev)
    res = dict(params=model.n_params(), init_s=t_init, wall_s=wall,
               prompt_lens=lens.tolist(), generated=generated,
               prefill_ms=[1e3 * t for t in prefill_s],
               decode_ms=[1e3 * t for t in decode_s],
               tokens_per_s=generated / wall,
               decode_tokens_per_s=(generated - LM_REQUESTS)
               / sum(decode_s), peak_bytes=peak, decode_vs_forward=errs[0],
               decode_vs_forward_by_layer=layer_errs)
    print(f"[lm_serve] {LM_ARCH} full size ({res['params']:,} f32 "
          f"parameters, bf16 activations, {LM_SLOTS} slots, max_len "
          f"{LM_MAX_LEN}): {LM_REQUESTS} requests (prompts "
          f"{LM_PROMPT[0]}-{LM_PROMPT[1]}) x {LM_NEW} tokens in "
          f"{wall:.3f} s = {res['tokens_per_s']:.1f} generated tokens/s; "
          f"prefill {np.mean(res['prefill_ms']):.2f} ms a request (median "
          f"{np.median(res['prefill_ms']):.2f}); decode "
          f"{np.mean(res['decode_ms']):.2f} ms a step (median "
          f"{np.median(res['decode_ms']):.2f}, {len(decode_s)} steps) = "
          f"{res['decode_tokens_per_s']:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; decode against forward: worst layer "
          f"{max(layer_errs):.3e} (bound {LM_TOL}), logits end to end "
          f"{errs[0]:.3e} (not checked) ({card})", flush=True)
    return res, model, params


def greedy_f32(torch, model, params, dev) -> dict:
    """The same weights in f32: the engine's greedy tokens for ragged
    prompts equal the argmax of full forwards (the reference's
    invariant), with TF32 off."""
    import dataclasses

    from repro_torch.config import HOST_MESH, RunConfig, ShapeConfig
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding.rules import Dist

    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 products must not run in TF32")
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    m32 = build_model(cfg)
    m32.load(params)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(1, cfg.vocab_size, L).astype(np.int32)
               for L in LM_GREEDY_PROMPTS]
    want = []
    with torch.inference_mode():
        for p in prompts:
            seq = list(p)
            for _ in range(LM_GREEDY_NEW):
                logits, _, _ = m32(None, torch.tensor([seq], device=dev),
                                   Dist(), mode="train")
                seq.append(int(torch.argmax(logits[0, -1])))
            want.append(seq[len(p):])
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", 64, 2, "decode"),
                    mesh=HOST_MESH)
    eng = ServeEngine(m32, run, Dist(), m32.params, n_slots=2, max_len=64,
                      temperature=0.0)
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=p, max_new_tokens=LM_GREEDY_NEW, rid=i))
    got = {r.rid: r.out_tokens for r in eng.run_until_done()}
    check(all(got[i] == want[i] for i in range(len(prompts))),
          f"f32 greedy tokens differ from the forward argmax: {got} {want}")
    print(f"[lm_serve] {LM_ARCH} f32: the engine's greedy tokens for "
          f"{len(prompts)} prompts ({LM_GREEDY_PROMPTS}) x {LM_GREEDY_NEW} "
          f"equal the forward argmax", flush=True)
    return dict(prompts=list(LM_GREEDY_PROMPTS), tokens=want)


def full_width_archs(torch, dev, card: str) -> dict:
    """Every other LM architecture at its published width, its depth cut
    to one pattern cycle (whisper: one encoder and one decoder layer): a
    prefill and LM_STEPS decode steps against the forward, each layer in
    bf16 within the reference's bound (whisper's one decoder layer end to
    end) and the whole model in f32 within LM_F32_TOL (LM_F32_TOL_SSM for
    mamba2); the bf16 error end
    to end is printed (a random-init stack amplifies bf16 rounding:
    recurrentgemma's three layers part by up to 0.3). MoE layers get the
    capacity that drops no assignment: a decode step (T = 2 tokens) and a
    forward (T = 2 x 68) drop different assignments by design, so with
    the published capacity the two differ wherever a drop falls (the CPU
    tests hold the dropped assignments against the reference)."""
    import dataclasses
    import gc

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.model import build_model

    out = {}
    for arch in ARCH_IDS:
        if arch in ("paper_sfa", LM_ARCH):
            continue
        cfg = get_config(arch)
        cut = dict(n_layers=len(cfg.layer_pattern))
        if cfg.is_encoder_decoder:
            cut = dict(n_layers=1, n_encoder_layers=1)
        if cfg.n_experts:
            cut["moe_capacity_factor"] = cfg.n_experts / cfg.experts_per_token
        cfg = dataclasses.replace(cfg, **cut)
        S = LM_S_MAMBA2 if cfg.family == "ssm" else LM_S
        # phi3-vision's 256 prefix embeddings lead the prompt
        S += cfg.num_prefix_embeds
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.perf_counter()
        params = model.init(gen, device=dev)
        toks, extra = lm_inputs(torch, cfg, LM_B, S + LM_STEPS, SEED, dev)
        extra16 = {k: v.to(torch.bfloat16) for k, v in extra.items()}
        errs = decode_against_forward(torch, model, toks, extra16, S,
                                      LM_STEPS, dev)
        by_layer = (errs if cfg.is_encoder_decoder else
                    decode_against_forward_by_layer(torch, model, toks, S,
                                                    dev))
        m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        m32.load(params)
        errs32 = decode_against_forward(torch, m32, toks, extra, S, LM_STEPS,
                                        dev)
        del m32
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tol = LM_TOL_HYBRID if cfg.family == "hybrid" else LM_TOL
        tol32 = LM_F32_TOL_SSM if cfg.family == "ssm" else LM_F32_TOL
        check(max(by_layer) < tol, f"{arch}: a layer's decode against its "
                                   f"forward {max(by_layer):.3e} (bound {tol})")
        check(max(errs32) < tol32, f"{arch}: f32 decode against forward "
                                   f"{max(errs32):.3e} (bound {tol32})")
        r = dict(cut=cut, S=S, params=model.n_params(), wall_s=wall,
                 by_layer=by_layer, errs=errs, errs_f32=errs32,
                 peak_bytes=torch.cuda.max_memory_allocated())
        out[arch] = r
        print(f"[lm_serve] {arch} full width, cut {cut}: B={LM_B} prefill "
              f"S={S} + {LM_STEPS} decode steps against the forward: bf16 "
              f"worst layer {max(by_layer):.3e} (bound {tol}), f32 end to end "
              f"{max(errs32):.3e} (bound {tol32}), bf16 end to end "
              f"{max(errs):.3e}; {r['params']:,} parameters, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, {wall:.2f} s ({card})",
              flush=True)
        del model, params, toks, extra, extra16
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_reduced_cfg(arch: str):
    """The reference tests' reduced configs, in f32."""
    import dataclasses

    from repro_torch.config import reduced
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "mamba2_370m":
        cfg = reduced(cfg, ssm_heads=4, ssm_head_dim=32, d_model=64,
                      ssm_state=16)
    elif arch == "recurrentgemma_9b":
        cfg = reduced(cfg, n_layers=5, rglru_width=64, head_dim=16)
    else:
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, dtype="float32")


def card_against_cpu(torch, dev) -> dict:
    """The reduced f32 models with the same weights on the card and on the
    CPU: train logits, the prefill cache and a decode step agree."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.base import leaves_with_paths, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import Dist

    out = {}
    cpu = torch.device("cpu")
    for arch in ARCH_IDS:
        if arch == "paper_sfa":
            continue
        cfg = lm_reduced_cfg(arch)
        B, S = 2, (16 if cfg.family == "ssm" else 12)
        host = build_model(cfg)
        params = host.init(torch.Generator().manual_seed(SEED), device=cpu)
        card = build_model(cfg)
        card.load(tree_map(lambda t: t.to(dev), params))
        res = []
        for m, d in ((card, dev), (host, cpu)):
            toks, extra = lm_inputs(torch, cfg, B, S + 1, SEED, d)
            with torch.inference_mode():
                full, _, _ = m(None, toks, Dist(), mode="train", **extra)
                cache = m.init_cache(B, S + 4, device=d)
                m(None, toks[:, :S], Dist(), mode="prefill", cache=cache,
                  **extra)
                leaves = [t.clone() for _, t in leaves_with_paths(cache)]
                dec, _, _ = m(None, toks[:, S:], Dist(), mode="decode",
                              cache=cache, cache_pos=torch.tensor(S, device=d))
            res.append((full, leaves, dec))
        errs = dict(forward=lm_rel(res[1][0], res[0][0]),
                    cache=max(lm_rel(b, a) for a, b in zip(res[0][1],
                                                           res[1][1])),
                    decode=lm_rel(res[1][2], res[0][2]))
        check(max(errs.values()) < LM_CARD_CPU_TOL,
              f"{arch}: card against CPU {errs}")
        out[arch] = errs
    worst = {k: max(e[k] for e in out.values()) for k in
             ("forward", "cache", "decode")}
    print(f"[lm_serve] card against CPU, {len(out)} reduced f32 models: "
          f"worst relative error forward {worst['forward']:.2e}, prefill "
          f"cache {worst['cache']:.2e}, decode {worst['decode']:.2e} "
          f"(bound {LM_CARD_CPU_TOL})", flush=True)
    return out


def lm_serve_path(torch, ops, dev, card: str) -> tuple:
    """Phase 9: the LM serving path. Launch counts at 0 before its runs,
    read after: the LM half launches none of the SFA kernels. Returns the
    results and qwen's model and parameters (for ``--profile``)."""
    t0 = time.perf_counter()
    ops.reset_launches()
    archs = full_width_archs(torch, dev, card)
    serve, model, params = serve_qwen(torch, dev, card)
    greedy = greedy_f32(torch, model, params, dev)
    launches = {**ops.launches, **ops.form_launches}
    check(not any(launches.values()),
          f"the LM phase launched SFA kernels: {launches}")
    host = card_against_cpu(torch, dev)
    wall = time.perf_counter() - t0
    print(f"[lm_serve] phase wall {wall:.1f} s; kernel launches {launches}",
          flush=True)
    return dict(serve=serve, greedy_f32=greedy, archs=archs,
                card_vs_cpu=host, wall_s=wall, launches=launches), model, params


def trace(torch, label: str, fn, n_top: int = 12) -> dict:
    """One traced run of ``fn`` under ``torch.profiler``: its wall, the
    device's busy time, device time by kernel and host time by operation
    (self time on the CPU: the launches' own runtime calls, allocations and
    PyTorch ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    host = sorted((e for e in ka if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    # A span bridged into the trace (obs's record_function) also appears as
    # a device range under its own name: not a kernel, so not device time.
    spans = {e.key for e in host}
    kernels = sorted((e for e in ka if e.device_type == DeviceType.CUDA
                      and e.key not in spans),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [dict(name=e.key[:90], calls=e.count,
                device_ms=e.self_device_time_total / 1e3)
           for e in kernels[:n_top]]
    host_top = [dict(name=e.key[:90], calls=e.count,
                     host_ms=e.self_cpu_time_total / 1e3)
                for e in host[:n_top]]
    print(f"[profile] {label}: traced wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({busy_ms / (wall * 1e3):.1%}), "
          f"{sum(e.count for e in kernels)} kernels", flush=True)
    for t in top:
        print(f"[profile]   {t['device_ms']:9.3f} ms {t['calls']:6d}x"
              f"  {t['name']}", flush=True)
    for t in host_top:
        print(f"[profile]   host {t['host_ms']:9.3f} ms {t['calls']:6d}x"
              f"  {t['name']}", flush=True)
    return dict(wall_s=wall, device_busy_ms=busy_ms, top=top,
                host_top=host_top)


def profile_main_path(torch, corpus) -> dict:
    """Device-time breakdown of one compile and one scan per budget (a
    separate traced run; the walls above are untraced)."""
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import Scanner

    bank = load_bank()
    out = {}
    for name, overrides in (("budget 512 (auto)", {}),
                            ("budget 20000 (sfa)",
                             dict(mode="sfa", sfa_state_budget=20_000))):
        sc = Scanner.compile(bank, construction=cold(), **overrides)
        for phase, fn in (("compile", lambda: Scanner.compile(
                              bank, construction=cold(), **overrides)),
                          ("scan", lambda: sc.scan(corpus))):
            out[f"{name} {phase}"] = trace(torch, f"{name} {phase}", fn)
    return out


def profile_lm_decode(torch, model, params) -> dict:
    """Device and host breakdown of qwen1.5-0.5B's serving steps (the
    lm_serve phase's model and parameters, a fresh engine): one 128-token
    prefill and 5 decode steps over 4 live slots."""
    from repro_torch.config import HOST_MESH, RunConfig, ShapeConfig
    from repro_torch.models.base import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sharding.rules import Dist

    cfg = model.cfg
    dev = tree_leaves(params)[0].device
    run = RunConfig(model=cfg, shape=ShapeConfig("serve", LM_MAX_LEN,
                                                 LM_SLOTS, "decode"),
                    mesh=HOST_MESH)
    eng = ServeEngine(model, run, Dist(), params, n_slots=LM_SLOTS,
                      max_len=LM_MAX_LEN, temperature=0.0)
    rng = np.random.default_rng(SEED)
    for i in range(LM_SLOTS):
        eng.submit(Request(prompt=rng.integers(1, cfg.vocab_size, 64)
                           .astype(np.int32), max_new_tokens=LM_NEW, rid=i))
    eng._admit()
    for _ in range(3):              # warm
        eng.step()
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 128))
                            .astype(np.int32)).to(dev)

    def prefill():
        for leaf in tree_leaves(eng._single_cache):
            leaf.zero_()
        with torch.inference_mode():
            eng.prefill_one(params, eng._single_cache, {"tokens": toks})

    prefill()
    return {
        "lm prefill": trace(torch, "lm_serve: one 128-token prefill", prefill),
        "lm decode": trace(torch, f"lm_serve: 5 decode steps, {LM_SLOTS} "
                                  f"slots", lambda: [eng.step()
                                                     for _ in range(5)]),
    }


def profile_speculative(torch, corpus, seq) -> dict:
    """Device-time breakdown of the speculative phase's scans (their
    repeats, the profile memoised) beside enumeration's, and of its
    stream."""
    from repro_torch.core.dfa import random_dfa
    from repro_torch.core.prosite import load_bank
    from repro_torch.engine import ChunkPolicy, Scanner

    bank = load_bank()
    pats = {bank.ids[i]: bank.dfa(i) for i in range(bank.n_patterns)}
    pats[SPEC_ID] = random_dfa(SPEC_STATES, K, seed=SPEC_SEED)
    one = {SPEC_ID: pats[SPEC_ID]}
    scanners = {
        "forced": Scanner.compile(bank, mode="speculative"),
        "enumeration": Scanner.compile(bank, mode="enumeration"),
        "auto": Scanner.compile(pats, construction=cold()),
        "auto, enumeration": Scanner.compile(
            pats, mode="enumeration", chunking=ChunkPolicy(bucket=True)),
        "702 alone": Scanner.compile(one, mode="speculative"),
        "702 alone, enumeration": Scanner.compile(one, mode="enumeration"),
    }
    out = {}
    for name, sc in scanners.items():
        sc.scan(corpus)                          # the profile, memoised
        out[f"{name} scan"] = trace(torch, f"speculative phase: {name} scan",
                                    lambda: sc.scan(corpus))
    pieces = np.array_split(seq, STREAM_PIECES)
    out["auto stream"] = trace(torch, "speculative phase: auto stream",
                               lambda: scanners["auto"].stream(pieces))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the numbers to this JSON")
    parser.add_argument("--profile", action="store_true",
                        help="add traced runs: device time by kernel, host "
                             "time by operation")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch.kernels import build, ops
        from repro_torch.kernels import ref as kref
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    t_build = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel libraries built in {t_build:.2f} s "
          f"(nvcc for sm_90a, in parallel)", flush=True)
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = re.findall(r"[1-9]\d* bytes spill stores", log)
        print(f"[build] {name}: {len(regs)} kernels, {min(regs, default=0)}"
              f"-{max(regs, default=0)} registers a thread, "
              f"{len(spills)} spilling", flush=True)

    check_expand_limit(torch, ops, dev)
    kernel_results = run_kernel_checks(
        torch, kernel_cases(torch, ops, kref, dev)
        + form_cases(torch, ops, kref, dev)
        + spec_cases(torch, ops, kref, dev))

    corpus = np.random.default_rng(SEED).integers(
        0, K, (DOCS, DOC_LEN), dtype=np.int32)
    main_res = main_path(torch, ops, corpus)
    kernel_results += run_kernel_checks(
        torch, bundled_cases(torch, ops, kref, dev, main_res))
    twin_res = twins(torch, corpus, main_res)
    seq = np.random.default_rng(SEED).integers(0, K, SEQ_LEN, dtype=np.int32)
    single_res = single_path(torch, ops, kref, seq, args.profile)
    spec_res = speculative_path(torch, ops, kref, corpus, seq)
    with tempfile.TemporaryDirectory() as workdir:
        service_res = service_path(torch, ops, corpus, workdir)
    dist_res = distributed_path(torch, ops, corpus, seq, main_res,
                                single_res, spec_res, service_res)
    two_res = two_rank_path(torch, corpus, main_res)
    lm_res, lm_model, lm_params = lm_serve_path(torch, ops, dev, card)
    prof_res = None
    if args.profile:
        from repro_torch import obs

        obs.configure(profiler_annotations=True)   # spans in the traces
        prof_res = profile_main_path(torch, corpus)
        prof_res.update(profile_speculative(torch, corpus, seq))
        prof_res.update(profile_lm_decode(torch, lm_model, lm_params))

    csrc, tpu = "src/repro_torch/kernels/csrc", "src/repro/kernels"
    sources = {
        "fingerprint_bank": (f"{csrc}/fingerprint_bank.cu",
                             f"{tpu}/clmul.py:169"),
        "expand_bank": (f"{csrc}/expand_bank.cu", f"{tpu}/expand.py:64"),
        "match_bank_chunks": (f"{csrc}/match_bank_chunks.cu",
                              f"{tpu}/match_scan.py:116"),
        "compose": (f"{csrc}/compose.cu", f"{tpu}/compose.py:43"),
        "match_chunks": (f"{csrc}/match_chunks.cu",
                         f"{tpu}/match_scan.py:72"),
        "fingerprint": (f"{csrc}/fingerprint.cu", f"{tpu}/clmul.py:105"),
        # No TPU kernel: the reference's validate-and-repair loop is XLA.
        "spec_resolve": (f"{csrc}/spec_resolve.cu",
                         "src/repro/speculative/executor.py:94"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        rows = [r for r in kernel_results if r["kernel"] == name]
        head = rows[0]      # the path's first (largest) shape
        by_phase = {"main": main_res["launches"][name],
                    "single": single_res["launches"][name],
                    "speculative": spec_res["launches"][name],
                    "service": service_res["launches"][name],
                    "distributed": dist_res["launches"][name],
                    "distributed, 2 ranks": two_res["launches"][name],
                    "lm_serve": lm_res["launches"][name]}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=head["ms"], host_us=head["host_us"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            cases=[{k: v for k, v in r.items() if k != "kernel"}
                   for r in rows],
        ))
        if name == "match_bank_chunks":     # of them, walks from starts
            kernels[-1]["from_starts_by_phase"] = {
                phase: res["launches"]["match_bank_chunks.starts"]
                for phase, res in (("speculative", spec_res),
                                   ("service", service_res),
                                   ("distributed", dist_res),
                                   ("distributed, 2 ranks", two_res))}

    if args.out:
        summary = dict(
            card=card, build_s=t_build, kernels=kernels,
            main={name: {k: v for k, v in r.items()
                         if k not in ("scanner", "hits")}
                  for name, r in main_res["runs"].items()},
            twins=twin_res,
            single={k: v for k, v in single_res.items()
                    if k != "windows_hits"},
            speculative={k: v for k, v in spec_res.items()
                         if k != "forced_hits"},
            service=service_res,
            distributed=dist_res,
            distributed_2_ranks=two_res,
            lm_serve=lm_res,
            profile=prof_res,
        )
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1, default=lambda o: (
                o.tolist() if hasattr(o, "tolist") else str(o)))

    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
