"""The port's ``Scanner``: one entry point for the paper's scan pipeline.

``Scanner.compile(patterns, plan)`` accepts one pattern or a bank — a string
(PROSITE id, PROSITE signature, or framework regex), a compiled
:class:`~..core.dfa.DFA`, a :class:`~..core.multipattern.PatternBank`, or a
sequence/mapping of those — and a :class:`~.plan.ScanPlan`. Compilation
resolves each pattern's matching mode (``auto`` builds every SFA under the
plan's state budget in one batched :func:`~..construction.construct_bank`
closure and falls back to enumeration for patterns that blow up), stacks the
per-pattern tables into padded device tensors, and returns a scanner with
``scan`` / ``census`` / ``mapping`` / ``accepts``, the one-sequence entry
points ``locate`` (per-position matches) and ``census_windows`` (all sliding
windows by prefix scans), and ``stream`` / ``open_stream`` (one input fed
in pieces).

Scans run on the plan's device: the chunk walks are the CUDA kernel, the
chunk reduce and the hit read-off are device gathers, and only the
``(P, D)`` hit matrix comes back to the host. Results are bit-identical to
the reference package's ``Scanner`` on the same patterns and documents.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..construction import SFA, StateBlowup, construct_bank, resolve_method
from ..core.bucketing import partition_by_size
from ..core.dfa import DFA
from ..core.multipattern import PatternBank
from ..device import resolve_device
from . import executors as X
from .plan import SPECULATION_AUTO_STATES, ScanPlan
from .streaming import StreamResult, StreamSession


# --------------------------------------------------------------------------
# Pattern normalization
# --------------------------------------------------------------------------


def _compile_one(spec: Any) -> DFA:
    """One pattern spec -> DFA. Strings resolve as: bundled PROSITE id,
    then PROSITE signature syntax, then framework regex."""
    from ..core.dfa import compile_dfa
    from ..core.prosite import (
        PROSITE_EXTRA,
        PROSITE_SAMPLES,
        PrositeSyntaxError,
        compile_prosite,
    )

    if isinstance(spec, DFA):
        return spec
    if isinstance(spec, str):
        pool = {**PROSITE_SAMPLES, **PROSITE_EXTRA}
        if spec in pool:
            return compile_prosite(pool[spec])
        try:
            return compile_prosite(spec)
        except PrositeSyntaxError:
            return compile_dfa(spec)
    raise TypeError(
        f"cannot compile pattern spec of type {type(spec).__name__}; "
        "expected str, DFA, PatternBank, or a sequence/mapping of those"
    )


def _normalize(patterns: Any) -> tuple:
    """-> (ids, dfas, single) where ``single`` marks a one-pattern input."""
    if isinstance(patterns, PatternBank):
        return (tuple(patterns.ids),
                [patterns.dfa(p) for p in range(patterns.n_patterns)], False)
    if isinstance(patterns, (str, DFA)):
        dfa = _compile_one(patterns)
        pid = patterns if isinstance(patterns, str) else "pattern_0"
        return (pid,), [dfa], True
    if isinstance(patterns, Mapping):
        ids = tuple(patterns.keys())
        return ids, [_compile_one(patterns[i]) for i in ids], False
    if isinstance(patterns, Sequence):
        dfas = [_compile_one(p) for p in patterns]
        ids = tuple(
            p if isinstance(p, str) else f"pattern_{i}"
            for i, p in enumerate(patterns)
        )
        return ids, dfas, False
    raise TypeError(f"cannot build a Scanner from {type(patterns).__name__}")


# --------------------------------------------------------------------------
# Compiled pattern groups
# --------------------------------------------------------------------------


@dataclass
class PatternGroup:
    """One homogeneous slice of the compiled bank: same mode, one padded
    table stack (and, for SFA mode, one stacked delta + mapping pair), all
    on the scanner's device."""

    indices: np.ndarray            # positions in the scanner's pattern order
    bank: PatternBank              # sub-bank (host arrays)
    mode: str                      # "sfa" | "enumeration"
    tables: torch.Tensor = None    # (Pg, n, k) int32
    accepting: torch.Tensor = None  # (Pg, n) bool
    starts: torch.Tensor = None    # (Pg,) int64
    deltas: torch.Tensor = None    # (Pg, S, k) int32 — stacked SFA tables
    sfa_maps: torch.Tensor = None  # (Pg, S, n) int32 — SFA state -> mapping
    sfa_states: np.ndarray | None = None  # (Pg,) true SFA state counts

    @property
    def n(self) -> int:
        return self.bank.n_max


def _stack_sfas(sfas: Sequence[SFA], n_max: int) -> tuple:
    """Stack per-pattern SFAs into padded (P, S_max, k) + (P, S_max, n_max).

    Delta rows ``s >= S_i`` are self-loops (inert, gathers stay in range)
    and mapping rows/columns pad with the identity, so an SFA-mode chunk
    function equals the enumeration chunk function on the padded layout.
    """
    S_max = max(s.n_states for s in sfas)
    k = sfas[0].delta.shape[1]
    Pg = len(sfas)
    deltas = np.empty((Pg, S_max, k), dtype=np.int32)
    maps = np.empty((Pg, S_max, n_max), dtype=np.int32)
    pad_rows = np.repeat(np.arange(S_max, dtype=np.int32)[:, None], k, axis=1)
    ident = np.arange(n_max, dtype=np.int32)
    for p, s in enumerate(sfas):
        S_i = s.n_states
        n_i = s.mappings.shape[1]
        deltas[p] = pad_rows
        deltas[p, :S_i] = s.delta
        maps[p] = ident
        maps[p, :S_i, :n_i] = s.mappings
        maps[p, :S_i, n_i:] = ident[n_i:]
    return deltas, maps, np.asarray([s.n_states for s in sfas], dtype=np.int32)


@dataclass(frozen=True)
class ConstructionReport:
    """What ``Scanner.compile`` did to obtain its SFAs."""

    rounds: int = 0
    constructed: int = 0
    blown: int = 0
    method: str = "none"
    retries: int = 0


def _resolve_sfas(ids, dfas, plan: ScanPlan, device: torch.device):
    """Per-pattern mode resolution through one bank construction.
    -> (modes, {index: SFA}, report)."""
    P = len(dfas)
    if plan.mode == "enumeration":
        return ["enumeration"] * P, {}, ConstructionReport()
    policy = plan.construction
    budget = plan.sfa_state_budget
    # The reference resolves "auto" here, on the patterns that miss its SFA
    # cache; with no cache in the port, that is every pattern.
    method = resolve_method(policy.method, P)
    result = construct_bank(
        dfas,
        max_states=budget,
        tile=policy.tile,
        max_retries=policy.max_retries,
        method=method,
        engine=policy.engine,
        fingerprint_backend=policy.fingerprint_backend,
        expand_backend=policy.expand_backend,
        bucketing=policy.bucketing,
        bucket_growth=policy.bucket_growth,
        device=device,
    )
    modes: list = []
    sfas: dict = {}
    for i in range(P):
        if not result.blown[i]:
            sfas[i] = result.sfas[i]
            modes.append("sfa")
        elif plan.mode == "sfa":
            raise StateBlowup(
                f"pattern {ids[i]!r}: SFA exceeds the {budget}-state budget "
                "and mode='sfa' forbids the enumeration fallback")
        elif dfas[i].n_states >= SPECULATION_AUTO_STATES:
            raise NotImplementedError(
                f"pattern {ids[i]!r}: its SFA exceeds the {budget}-state "
                f"budget and its DFA has {dfas[i].n_states} >= "
                f"{SPECULATION_AUTO_STATES} states, so mode='auto' would "
                "scan it speculatively; speculative scanning is a later "
                "slice of the port (use mode='enumeration' or a larger "
                "sfa_state_budget)")
        else:
            modes.append("enumeration")
    blown = int(result.blown.sum())
    report = ConstructionReport(
        rounds=result.stats.rounds, constructed=P - blown,
        blown=blown, method=method,
        retries=int(np.sum(result.stats.retries)),
    )
    return modes, sfas, report


# --------------------------------------------------------------------------
# Scan results
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ScanResult:
    """Hit matrix of a scan: ``hits[p, d]`` iff doc ``d`` matches pattern ``p``."""

    hits: np.ndarray      # (P, D) bool
    ids: tuple

    @property
    def counts(self) -> np.ndarray:
        """Per-pattern hit counts (the census row), (P,) int32."""
        return np.sum(self.hits, axis=1, dtype=np.int32)

    def by_id(self) -> dict:
        return {pid: self.hits[p] for p, pid in enumerate(self.ids)}


# --------------------------------------------------------------------------
# The facade
# --------------------------------------------------------------------------


class Scanner:
    """A compiled multi-pattern scan engine. Build with :meth:`compile`."""

    def __init__(self, ids, dfas, groups, plan, single, device,
                 construction_report: ConstructionReport | None = None):
        self.ids = ids
        self.plan = plan
        self.groups = groups
        self.single = single
        self.device = device
        self.construction_report = construction_report or ConstructionReport()
        self.alphabet = dfas[0].alphabet
        self.n_symbols = dfas[0].n_symbols
        self.n_patterns = len(dfas)
        self.n_max = max(d.n_states for d in dfas)
        self._dfas = dfas
        self.pattern_modes = {}
        for g in groups:
            for i in g.indices:
                self.pattern_modes[ids[i]] = g.mode

    # -- compilation --------------------------------------------------------

    @classmethod
    def compile(cls, patterns: Any, plan: ScanPlan | None = None,
                **overrides) -> "Scanner":
        """Compile patterns under a plan (``overrides`` patch plan fields, so
        ``Scanner.compile(bank, mode="sfa", device="cpu")`` works without a
        ScanPlan)."""
        plan = (plan or ScanPlan()).with_(**overrides) if overrides else \
            (plan or ScanPlan()).validate()
        device = resolve_device(plan.device)
        ids, dfas, single = _normalize(patterns)
        if not dfas:
            raise ValueError("empty pattern set")
        alphabet = dfas[0].alphabet
        for d in dfas:
            if d.alphabet != alphabet:
                raise ValueError("all patterns must share one alphabet")

        modes, sfas, report = _resolve_sfas(ids, dfas, plan, device)
        groups = []
        for mode in ("sfa", "enumeration"):
            member = [i for i, m in enumerate(modes) if m == mode]
            if not member:
                continue
            if plan.chunking.bucket:
                sizes = [
                    sfas[i].n_states if mode == "sfa" else dfas[i].n_states
                    for i in member
                ]
                parts = partition_by_size(sizes, plan.chunking.bucket_edges,
                                          overflow="extend")
                parts = [[member[j] for j in idx] for _, idx in parts]
            else:
                parts = [member]
            for part in parts:
                groups.append(cls._build_group(
                    part, [dfas[i] for i in part], [ids[i] for i in part],
                    mode, [sfas.get(i) for i in part], device,
                ))
        return cls(ids, dfas, groups, plan, single, device, report)

    @staticmethod
    def _build_group(indices, dfas, gids, mode, sfas, device) -> PatternGroup:
        bank = PatternBank.from_dfas(dfas, gids)
        tables, accepting, starts = bank.to(device)
        g = PatternGroup(
            indices=np.asarray(indices, dtype=np.int64), bank=bank, mode=mode,
            tables=tables, accepting=accepting, starts=starts,
        )
        if mode == "sfa":
            deltas, maps, sizes = _stack_sfas(sfas, bank.n_max)
            g.deltas = torch.as_tensor(deltas, device=device)
            g.sfa_maps = torch.as_tensor(maps, device=device)
            g.sfa_states = sizes
        return g

    # -- encoding helpers ---------------------------------------------------

    def encode(self, text: str) -> np.ndarray:
        sym = {c: i for i, c in enumerate(self.alphabet)}
        return np.asarray([sym[c] for c in text], dtype=np.int32)

    def _length_batches(self, docs) -> list:
        """Docs -> [(doc indices, (Dg, L) int32 corpus)], one batch per doc
        length (a 2-D array is one batch as it stands)."""
        if isinstance(docs, np.ndarray) and docs.ndim == 2:
            batches = [(np.arange(docs.shape[0]), docs.astype(np.int32,
                                                              copy=False))]
        else:
            if isinstance(docs, str):
                docs = [docs]
            enc = [self.encode(d) if isinstance(d, str)
                   else np.asarray(d, dtype=np.int32) for d in docs]
            by_len: dict = {}
            for d, e in enumerate(enc):
                by_len.setdefault(len(e), []).append(d)
            batches = []
            for L, idxs in sorted(by_len.items()):
                corpus = (np.stack([enc[d] for d in idxs]) if L else
                          np.zeros((len(idxs), 0), dtype=np.int32))
                batches.append((np.asarray(idxs), corpus))
        for _, corpus in batches:
            if corpus.size and (corpus.min() < 0
                                or corpus.max() >= self.n_symbols):
                raise ValueError(
                    f"document symbols must lie in [0, {self.n_symbols})")
        return batches

    # -- the chunk-function core -------------------------------------------

    def _group_doc_mappings(self, g: PatternGroup, corpus: np.ndarray,
                            corpus_t: torch.Tensor) -> torch.Tensor:
        """Final mapping of every (pattern-in-group, doc): -> (Pg, D, n) on
        the scanner's device. ``corpus_t`` is ``corpus`` already on the
        device (copied once per scan batch, shared by the groups). The
        kernel handles the head (the largest prefix divisible by
        ``n_chunks``); a ragged tail is composed symbol by symbol."""
        n_chunks = self.plan.chunking.n_chunks
        D, L = corpus.shape
        head_len = L - (L % n_chunks)
        Pg, n = len(g.indices), g.n
        if head_len:
            maps = self._head_mappings(g, corpus, corpus_t[:, :head_len],
                                       n_chunks)
        else:
            maps = torch.arange(n, dtype=torch.int32, device=self.device
                                ).expand(Pg, D, n)
        if head_len < L:
            # Each (doc, state) lane is a state walking its doc's tail.
            tail = corpus_t[:, head_len:].repeat_interleave(n, dim=0)
            maps = X.advance_states_sequential(
                g.tables, maps.reshape(Pg, D * n), tail).view(Pg, D, n)
        return maps

    def _head_mappings(self, g: PatternGroup, corpus: np.ndarray,
                       head: torch.Tensor, n_chunks: int) -> torch.Tensor:
        if self.plan.backend == "reference":
            maps = _reference_doc_mappings(
                g.bank.tables, corpus[:, : head.shape[1]])
            return torch.as_tensor(maps, device=self.device)
        if g.mode == "sfa":
            return X.bank_doc_mappings_sfa(g.deltas, g.sfa_maps, head,
                                           n_chunks)
        return X.bank_doc_mappings(g.tables, head, n_chunks)

    # -- public scan API ----------------------------------------------------

    def scan(self, docs) -> ScanResult:
        """Match a corpus against the bank -> :class:`ScanResult` (P, D)."""
        batches = self._length_batches(docs)
        D = sum(len(idxs) for idxs, _ in batches)
        hits = np.zeros((self.n_patterns, D), dtype=bool)
        for idxs, corpus in batches:
            corpus_t = torch.as_tensor(corpus, device=self.device)
            for g in self.groups:
                maps = self._group_doc_mappings(g, corpus, corpus_t)
                acc = X.hits_of_mappings(maps, g.accepting, g.starts)
                hits[np.ix_(g.indices, idxs)] = acc.cpu().numpy()
        return ScanResult(hits=hits, ids=self.ids)

    def census(self, docs) -> np.ndarray:
        """Per-pattern hit counts over a corpus, (P,) int32."""
        return self.scan(docs).counts

    def mapping(self, doc) -> np.ndarray:
        """Transition function of one whole input under every pattern,
        (P, n_max) int32 on the scanner's padded layout (identity beyond
        each pattern's true state count)."""
        (_, corpus), = self._length_batches([doc])
        corpus_t = torch.as_tensor(corpus, device=self.device)
        out = np.broadcast_to(
            np.arange(self.n_max, dtype=np.int32),
            (self.n_patterns, self.n_max),
        ).copy()
        for g in self.groups:
            maps = self._group_doc_mappings(g, corpus, corpus_t)[:, 0, :]
            out[g.indices, : g.n] = maps.cpu().numpy()
        return out

    def accepts(self, doc):
        """Accept flags of one input: bool for a single-pattern scanner,
        (P,) bool for a bank."""
        flags = self.scan([doc]).hits[:, 0]
        return bool(flags[0]) if self.single else flags

    def census_windows(self, seq, window: int, stride: int | None = None
                       ) -> ScanResult:
        """Prefix-scan census of all sliding windows of one sequence.

        The sequence is cut into ``stride``-symbol blocks, each block's
        transition function is computed once (the chunk walks of ``scan``),
        and every window's composition comes out of one prefix and one
        suffix scan per tile of ``window // stride`` blocks
        (:func:`.executors.sliding_window_mappings`), all on the device.
        Composition is exactly associative, so ``hits`` is bit-identical to
        ``scan`` of the materialised windows
        ``seq[i*stride : i*stride + window]``.

        ``stride`` must divide ``window`` (default ``stride = window``:
        disjoint blocks). -> :class:`ScanResult` whose "docs" are the
        ``(len(seq) - window) // stride + 1`` full windows.
        """
        stride = window if stride is None else stride
        if window < 1 or stride < 1:
            raise ValueError("window and stride must be >= 1")
        if window % stride:
            raise ValueError(
                f"stride ({stride}) must divide window ({window}): the "
                "prefix-scan census composes whole stride-blocks")
        (_, enc), = self._length_batches([seq])
        enc = enc[0]
        L = len(enc)
        m = window // stride
        W = (L - window) // stride + 1 if L >= window else 0
        hits = np.zeros((self.n_patterns, W), dtype=bool)
        if W == 0:
            return ScanResult(hits=hits, ids=self.ids)
        B = W + m - 1
        blocks = np.ascontiguousarray(enc[: B * stride].reshape(B, stride))
        blocks_t = torch.as_tensor(blocks, device=self.device)
        for g in self.groups:
            maps = self._group_doc_mappings(g, blocks, blocks_t)  # (Pg, B, n)
            wmaps = X.sliding_window_mappings(maps, m)            # (Pg, W, n)
            acc = X.hits_of_mappings(wmaps, g.accepting, g.starts)
            hits[g.indices, :] = acc.cpu().numpy()
        return ScanResult(hits=hits, ids=self.ids)

    def locate(self, doc, pattern=None) -> np.ndarray:
        """Per-position accept flags of one doc under one pattern: the
        two-pass chunk-parallel match localization
        (:func:`.executors.find_matches_parallel`) on the head of
        ``n_chunks`` equal chunks, the ragged tail sequentially on the host.
        ``pattern`` is an id or an index; it defaults to the only pattern of
        a single-pattern scanner."""
        if pattern is None:
            if not self.single:
                raise ValueError("bank scanner: pass pattern=<id or index>")
            p = 0
        else:
            p = (self.ids.index(pattern) if isinstance(pattern, str)
                 else int(pattern))
        d = self._dfas[p]
        (_, enc), = self._length_batches([doc])
        enc = enc[0]
        n_chunks = self.plan.chunking.n_chunks
        head_len = len(enc) - (len(enc) % n_chunks)
        flags = np.zeros(len(enc), dtype=bool)
        if head_len:
            dev = self.device
            flags[:head_len] = X.find_matches_parallel(
                torch.as_tensor(d.table, device=dev),
                torch.as_tensor(d.accepting, device=dev),
                torch.as_tensor(enc[:head_len], device=dev), d.start,
                n_chunks).cpu().numpy()
        if head_len == len(enc):
            return flags
        # sequential tail from the head's final state
        s = d.run(enc[:head_len]) if head_len else d.start
        for i in range(head_len, len(enc)):
            s = int(d.table[s, enc[i]])
            flags[i] = bool(d.accepting[s])
        return flags

    # -- streaming ----------------------------------------------------------

    def open_stream(self) -> StreamSession:
        """Push API: feed pieces of one input, then ``finish()``."""
        return StreamSession(self)

    def stream(self, blocks) -> StreamResult:
        """Scan one logically concatenated input delivered as an iterable of
        pieces (strings or encoded int arrays) without holding it whole:
        equal to ``mapping``/``accepts`` of the concatenation."""
        sess = self.open_stream()
        for b in blocks:
            sess.feed(b)
        return sess.finish()

    # -- introspection ------------------------------------------------------

    def describe(self) -> str:
        r = self.construction_report
        lines = [
            f"Scanner: {self.n_patterns} pattern(s), alphabet |Σ|="
            f"{len(self.alphabet)}, plan=({self.plan.mode}/"
            f"{self.plan.backend}/{self.device}, "
            f"n_chunks={self.plan.chunking.n_chunks})",
            f"  construction: {r.rounds} round(s) via {r.method}, "
            f"{r.constructed} built, {r.blown} blown",
        ]
        for g in self.groups:
            extra = (f", S_max={int(g.deltas.shape[1])}" if g.mode == "sfa"
                     else "")
            lines.append(f"  group[{g.mode}]: {len(g.indices)} pattern(s), "
                         f"n_max={g.n}{extra}")
        return "\n".join(lines)


def _reference_doc_mappings(tables: np.ndarray, corpus: np.ndarray
                            ) -> np.ndarray:
    """Pure-NumPy oracle: compose each doc's transition function symbol by
    symbol over all states at once. (Pg, n, k), (D, L) -> (Pg, D, n)."""
    Pg, n, _ = tables.shape
    D, _ = corpus.shape
    out = np.empty((Pg, D, n), dtype=np.int32)
    ident = np.broadcast_to(np.arange(n, dtype=np.int32), (Pg, n))
    for d in range(D):
        out[:, d] = X.compose_sequential(tables, ident, corpus[d])
    return out
