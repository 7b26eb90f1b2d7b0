"""The port's ``Scanner``: one entry point for the paper's scan pipeline.

``Scanner.compile(patterns, plan)`` accepts one pattern or a bank — a string
(PROSITE id, PROSITE signature, or framework regex), a compiled
:class:`~..core.dfa.DFA`, a :class:`~..core.multipattern.PatternBank`, or a
sequence/mapping of those — and a :class:`~.plan.ScanPlan`. Compilation
resolves each pattern's matching mode (``auto`` answers each pattern from
the content-addressed SFA cache where it can and builds the misses under the
plan's state budget in one :func:`~..construction.construct_bank` closure;
a pattern that blows up goes to speculation when its DFA is large and to
enumeration otherwise), stacks the per-pattern tables into padded device
tensors, and returns a scanner with
``scan`` / ``census`` / ``mapping`` / ``accepts``, the one-sequence entry
points ``locate`` (per-position matches) and ``census_windows`` (all sliding
windows by prefix scans), and ``stream`` / ``open_stream`` (one input fed
in pieces).

Scans run on the plan's device: the chunk walks are the CUDA kernel, the
chunk reduce and the hit read-off are device gathers, and only the
``(P, D)`` hit matrix comes back to the host; a speculative group is an
m-lane chunk walk and the ``spec_resolve`` kernel
(:mod:`..speculative`). Results are bit-identical to the reference
package's ``Scanner`` on the same patterns and documents, its
:class:`~..speculative.SpeculationStats` and its ``obs`` counters included.

Under ``distribution="shard_map"`` every rank of a :mod:`torch.distributed`
mesh calls the same entry point with the whole corpus: ``scan`` /
``census`` / ``mapping`` / ``accepts`` / ``census_windows`` shard the
documents over the plan's ``data_axis`` (:mod:`..mesh`) and every rank gets
the whole result; ``locate`` and ``stream`` run locally, as in the
reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .. import obs
from ..construction import SFA, StateBlowup, construct_bank, resolve_method
from ..core.bucketing import partition_by_size
from ..core.dfa import DFA
from ..core.multipattern import PatternBank
from ..device import resolve_device
from ..mesh import mesh_size, world_mesh
from ..speculative import (
    HotStateProfile,
    SpeculationStats,
    distributed_speculative_finals_fn,
    profile_hot_states,
    speculative_bank_finals,
    stack_profile_states,
)
from . import executors as X
from .plan import ScanPlan
from .streaming import StreamResult, StreamSession

# /metrics HELP descriptions, registered once; hot paths increment by name.
obs.counter("engine.compiles", help="Scanner.compile calls")
obs.counter("engine.scans", help="Scanner scan/census calls")
obs.counter("engine.docs_scanned", help="documents scanned")
obs.counter("engine.scan_symbols", help="document symbols scanned")
obs.counter("engine.scan_pad_symbols",
            help="pad symbols in the length-bucketed batches of scans")
obs.counter("engine.encoded_symbols",
            help="characters encoded to symbols through a scanner's table")
obs.counter("speculative.total_chunks",
            help="chunks executed speculatively")
obs.counter("speculative.hit_chunks",
            help="speculative chunks whose entry state was predicted")
obs.counter("speculative.repaired_chunks",
            help="misspeculated chunks re-scanned in the repair loop")
obs.counter("speculative.repair_rounds", help="repair rounds executed")
obs.counter("speculative.fallback_lanes",
            help="lanes handed to the exact enumeration fallback")
obs.gauge("speculative.hit_rate",
          help="speculation hit rate of the last scan")

#: Growth ratio of the length ladder ``Scanner.scan`` batches a list of
#: documents by (:func:`_ladder_rungs`): about 12 % pad symbols on Swiss-Prot
#: lengths, one batch for every ~10 distinct lengths.
SCAN_LADDER_RATIO = 1.25


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
    mode: str                      # "sfa" | "enumeration" | "speculative"
    walk_tables: torch.Tensor = None  # (Pg, n, k + 1) int32: column k, pad
    accepting: torch.Tensor = None  # (Pg, n) bool
    starts: torch.Tensor = None    # (Pg,) int64
    walk_deltas: torch.Tensor = None  # (Pg, S, k + 1) int32 — stacked SFAs
    sfa_maps: torch.Tensor = None  # (Pg, S, n) int32 — SFA state -> mapping
    sfa_states: np.ndarray | None = None  # (Pg,) true SFA state counts
    _dist_fn: Any = field(default=None, repr=False)
    _spec_dist_fn: Any = field(default=None, repr=False)
    _spec_profile: Any = field(default=None, repr=False)  # memoised (Pg, m)

    @property
    def n(self) -> int:
        return self.bank.n_max

    @property
    def tables(self) -> torch.Tensor:
        """(Pg, n, k) view of :attr:`walk_tables` without the pad column."""
        return self.walk_tables[..., :-1]

    @property
    def deltas(self) -> torch.Tensor | None:
        """(Pg, S, k) view of :attr:`walk_deltas` without the pad column."""
        d = self.walk_deltas
        return None if d is None else d[..., :-1]


def _ladder_rungs(lengths: np.ndarray, n_chunks: int) -> np.ndarray:
    """Each document length's rung on the scan's length ladder: rung 0 holds
    lengths up to ``n_chunks``, and each rung's top is the one below times
    :data:`SCAN_LADDER_RATIO`, rounded up to a multiple of ``n_chunks``."""
    tops = [n_chunks]
    while tops[-1] < lengths.max(initial=0):
        grown = -(-math.ceil(tops[-1] * SCAN_LADDER_RATIO) // n_chunks)
        tops.append(max(grown, tops[-1] // n_chunks + 1) * n_chunks)
    return np.searchsorted(tops, lengths)


def _symbol_table(alphabet: str) -> np.ndarray:
    """``Scanner.encode``'s lookup table: entry ``ord(c)`` holds the symbol
    of character ``c`` (its last index in ``alphabet``, as a ``{c: i}`` dict
    built in order keeps it), every other entry -1. The last entry is one
    past the alphabet's largest code point, so a lookup clipped to the
    table maps every larger code point to -1 too."""
    table = np.full(max(map(ord, alphabet), default=-1) + 2, -1,
                    dtype=np.int32)
    for i, c in enumerate(alphabet):
        table[ord(c)] = i
    return table


def _stack_sfas(sfas: Sequence[SFA], n_max: int) -> tuple:
    """Stack per-pattern SFAs into padded (P, S_max, k + 1) +
    (P, S_max, n_max).

    Delta rows ``s >= S_i`` are self-loops (inert, gathers stay in range),
    as is column ``k`` of every row: the pad symbol. Mapping rows/columns
    pad with the identity, so an SFA-mode chunk function equals the
    enumeration chunk function on the padded layout.
    """
    S_max = max(s.n_states for s in sfas)
    k = sfas[0].delta.shape[1]
    Pg = len(sfas)
    deltas = np.empty((Pg, S_max, k + 1), dtype=np.int32)
    maps = np.empty((Pg, S_max, n_max), dtype=np.int32)
    pad_rows = np.repeat(np.arange(S_max, dtype=np.int32)[:, None], k + 1,
                         axis=1)
    ident = np.arange(n_max, dtype=np.int32)
    for p, s in enumerate(sfas):
        S_i = s.n_states
        n_i = s.mappings.shape[1]
        deltas[p] = pad_rows
        deltas[p, :S_i, :k] = s.delta
        maps[p] = ident
        maps[p, :S_i, :n_i] = s.mappings
        maps[p, :S_i, n_i:] = ident[n_i:]
    return deltas, maps, np.asarray([s.n_states for s in sfas], dtype=np.int32)


@dataclass(frozen=True)
class ConstructionReport:
    """What ``Scanner.compile`` did to obtain its SFAs.

    ``rounds`` is zero when every pattern was answered by the cache — the
    "recompiling the same patterns performs zero construction rounds"
    contract.
    """

    rounds: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    constructed: int = 0
    blown: int = 0
    method: str = "none"
    retries: int = 0


def _resolve_sfas(ids, dfas, plan: ScanPlan, device: torch.device):
    """Per-pattern mode resolution: cache lookups first, then one bank
    construction for the misses. -> (modes, {index: SFA}, report)."""
    P = len(dfas)
    if plan.mode == "enumeration":
        return ["enumeration"] * P, {}, ConstructionReport()
    if plan.mode == "speculative":
        # Forced speculation needs no SFA construction at all: the mode
        # serves the patterns the n^n bound locks out.
        return ["speculative"] * P, {}, ConstructionReport()

    policy = plan.construction
    budget = plan.sfa_state_budget
    cache = policy.resolve_cache()

    def fallback(i):
        if plan.mode == "sfa":
            raise StateBlowup(
                f"pattern {ids[i]!r}: SFA exceeds the {budget}-state budget "
                "and mode='sfa' forbids the enumeration fallback") from None
        # auto's blowup tier: large automata go speculative (their n-wide
        # enumeration walks are what speculation avoids); small blowup
        # patterns keep enumeration.
        if dfas[i].n_states >= plan.speculation.auto_states:
            return "speculative"
        return "enumeration"

    modes: list = [None] * P
    sfas: dict = {}
    hits = misses = 0
    need = []
    for i, d in enumerate(dfas):
        kind, sfa = (None, None) if cache is None else cache.lookup(
            d, max_states=budget)
        if kind == "sfa":
            hits += 1
            sfas[i], modes[i] = sfa, "sfa"
        elif kind == "blowup":
            hits += 1
            modes[i] = fallback(i)
        else:
            misses += 1
            need.append(i)

    rounds = retries = blown_count = 0
    method = "none"
    if need:
        # The reference's rule on the patterns that miss the cache: a bank
        # round from four patterns, the per-pattern loop below.
        method = resolve_method(policy.method, len(need))
        result = construct_bank(
            [dfas[i] for i in need],
            max_states=budget,
            tile=policy.tile,
            max_retries=policy.max_retries,
            method=method,
            engine=policy.engine,
            distribution=policy.distribution,
            mesh=policy.mesh,
            pattern_axis=policy.pattern_axis,
            fingerprint_backend=policy.fingerprint_backend,
            expand_backend=policy.expand_backend,
            bucketing=policy.bucketing,
            bucket_growth=policy.bucket_growth,
            device=device,
        )
        rounds = result.stats.rounds
        retries = int(np.sum(result.stats.retries))
        for j, i in enumerate(need):
            if result.blown[j]:
                blown_count += 1
                if cache is not None:
                    cache.store_blowup(dfas[i], budget)
                modes[i] = fallback(i)
            else:
                sfas[i] = result.sfas[j]
                modes[i] = "sfa"
                if cache is not None:
                    cache.store(dfas[i], result.sfas[j])
    report = ConstructionReport(
        rounds=rounds, cache_hits=hits, cache_misses=misses,
        constructed=len(need) - blown_count, blown=blown_count,
        method=method, retries=retries,
    )
    return modes, sfas, report


# --------------------------------------------------------------------------
# Scan results
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ScanResult:
    """Hit matrix of a scan: ``hits[p, d]`` iff doc ``d`` matches pattern ``p``.

    ``speculation`` carries the scan's aggregated
    :class:`~..speculative.SpeculationStats` when any pattern group ran
    speculatively (None otherwise).
    """

    hits: np.ndarray      # (P, D) bool
    ids: tuple
    speculation: Any = None

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

    def __init__(self, ids, dfas, groups, plan, single, device, mesh=None,
                 construction_report: ConstructionReport | None = None):
        self.ids = ids
        self.plan = plan
        self.groups = groups
        self.single = single
        self.device = device
        self.mesh = mesh
        self.construction_report = construction_report or ConstructionReport()
        self.alphabet = dfas[0].alphabet
        self.n_symbols = dfas[0].n_symbols
        self._symbol_table = _symbol_table(self.alphabet)
        self.n_patterns = len(dfas)
        self.n_max = max(d.n_states for d in dfas)
        self._dfas = dfas
        self.last_speculation: SpeculationStats | None = None
        #: trace id of the last traced compile/scan/census through this
        #: scanner — the key ``obs.trace_summary`` (and ``describe``)
        #: correlates on.
        self.last_trace_id: str | None = None
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

        with obs.span("scanner.compile", patterns=len(dfas),
                      mode=plan.mode, backend=plan.backend):
            trace_id = obs.current_trace_id()
            modes, sfas, report = _resolve_sfas(ids, dfas, plan, device)
            # The reference builds a one-device mesh here; a mesh over the
            # whole world is that mesh at world size 1, and at a larger one
            # it shards instead of repeating the work on every rank.
            mesh = None
            if plan.distribution == "shard_map":
                mesh = plan.mesh if plan.mesh is not None else world_mesh(
                    plan.data_axis, device.type)
            groups = []
            with obs.span("scanner.compile.groups"):
                for mode in ("sfa", "enumeration", "speculative"):
                    member = [i for i, m in enumerate(modes) if m == mode]
                    if not member:
                        continue
                    if plan.chunking.bucket:
                        sizes = [
                            sfas[i].n_states if mode == "sfa"
                            else dfas[i].n_states
                            for i in member
                        ]
                        parts = partition_by_size(
                            sizes, plan.chunking.bucket_edges,
                            overflow="extend")
                        parts = [[member[j] for j in idx]
                                 for _, idx in parts]
                    else:
                        parts = [member]
                    for part in parts:
                        groups.append(cls._build_group(
                            part, [dfas[i] for i in part],
                            [ids[i] for i in part], mode,
                            [sfas.get(i) for i in part], plan, device, mesh,
                        ))
        obs.counter("engine.compiles").inc()
        scanner = cls(ids, dfas, groups, plan, single, device, mesh, report)
        scanner.last_trace_id = trace_id
        return scanner

    @staticmethod
    def _build_group(indices, dfas, gids, mode, sfas, plan, device,
                     mesh) -> PatternGroup:
        bank = PatternBank.from_dfas(dfas, gids)
        Pg, n, k = bank.tables.shape
        # Column k is the pad symbol: every state to itself.
        tables = np.empty((Pg, n, k + 1), dtype=np.int32)
        tables[..., :k] = bank.tables
        tables[..., k] = np.arange(n, dtype=np.int32)
        g = PatternGroup(
            indices=np.asarray(indices, dtype=np.int64), bank=bank, mode=mode,
            walk_tables=torch.as_tensor(tables, device=device),
            accepting=torch.as_tensor(bank.accepting, device=device),
            starts=torch.as_tensor(bank.starts, dtype=torch.int64,
                                   device=device),
        )
        if mode == "sfa":
            deltas, maps, sizes = _stack_sfas(sfas, bank.n_max)
            g.walk_deltas = torch.as_tensor(deltas, device=device)
            g.sfa_maps = torch.as_tensor(maps, device=device)
            g.sfa_states = sizes
        if mesh is not None:
            n_chunks = plan.chunking.n_chunks
            g._dist_fn = X.distributed_doc_mappings_fn(
                mesh, plan.data_axis, n_chunks, sfa_mode=(mode == "sfa"))
            if mode == "speculative":
                g._spec_dist_fn = distributed_speculative_finals_fn(
                    mesh, plan.data_axis, n_chunks,
                    plan.speculation.max_repair_rounds)
        return g

    # -- encoding helpers ---------------------------------------------------

    def encode(self, text: str) -> np.ndarray:
        """A string -> its (len(text),) int32 symbols, by one lookup of the
        scanner's symbol table (:func:`_symbol_table`) over the text's code
        points. A character outside the alphabet raises ``KeyError`` for
        the first such character, as a dict lookup would."""
        codes = np.frombuffer(text.encode("utf-32-le", "surrogatepass"),
                              dtype="<u4")
        symbols = self._symbol_table.take(codes, mode="clip")
        if symbols.size and symbols.min() < 0:
            raise KeyError(text[int(np.argmax(symbols < 0))])
        obs.counter("engine.encoded_symbols").inc(symbols.size)
        return symbols

    def _encoded(self, docs) -> list:
        """A str, or a sequence of str and symbol arrays -> int32 arrays.
        The strings are encoded together, as one joined text, and each
        comes back as a view of that one array."""
        if isinstance(docs, str):
            docs = [docs]
        flat = self.encode("".join(d for d in docs if isinstance(d, str)))
        out, at = [], 0
        for d in docs:
            if isinstance(d, str):
                out.append(flat[at:at + len(d)])
                at += len(d)
            else:
                out.append(np.asarray(d, dtype=np.int32))
        return out

    def _check_symbols(self, corpus: np.ndarray, pads: int = 0) -> None:
        """Every symbol of ``corpus`` in ``[0, n_symbols)``, but for its
        ``pads`` entries of the pad symbol ``n_symbols`` (a ladder batch's
        padding): a doc that holds the pad symbol itself is refused."""
        k = self.n_symbols
        if not corpus.size:
            return
        top = int(corpus.max())
        if corpus.min() < 0 or top > k or (
                top == k and np.count_nonzero(corpus == k) != pads):
            raise ValueError(f"document symbols must lie in [0, {k})")

    def _batches(self, docs) -> list:
        """Docs -> [(doc indices, (Dg, W) int32 corpus, (Dg,) lengths)],
        rows in doc order. A list of docs is grouped by the length ladder
        (:func:`_ladder_rungs`), or by doc length on the two paths that keep
        the reference's batches: the ``reference`` backend, the oracle the
        ladder is held to, and the mesh, whose doc-count check the reference
        makes a length at a time. ``W`` is a batch's longest doc rounded up
        to ``n_chunks``; beyond each doc's end its row holds the pad symbol
        ``n_symbols``, which the group's ``walk_*`` tables map to the
        identity, so no batch has a ragged tail. A 2-D array is one batch as
        it stands, for :meth:`_on_device` to pad on the device."""
        if isinstance(docs, np.ndarray) and docs.ndim == 2:
            corpus = docs.astype(np.int32, copy=False)
            self._check_symbols(corpus)
            D, L = corpus.shape
            return [(np.arange(D), corpus, np.full(D, L, dtype=np.int64))]
        enc = self._encoded(docs)
        lens = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc))
        n_chunks = self.plan.chunking.n_chunks
        by_length = self.mesh is not None or self.plan.backend == "reference"
        keys = lens if by_length else _ladder_rungs(lens, n_chunks)
        batches = []
        for key in np.unique(keys):
            idxs = np.flatnonzero(keys == key)
            L = lens[idxs]
            W = -(-int(L.max()) // n_chunks) * n_chunks
            corpus = np.full((len(idxs), W), self.n_symbols, dtype=np.int32)
            for row, d in zip(corpus, idxs.tolist()):
                row[:len(enc[d])] = enc[d]
            self._check_symbols(corpus, corpus.size - int(L.sum()))
            batches.append((idxs, corpus, L))
        return batches

    @staticmethod
    def _group_parts(g: PatternGroup, idxs, corpus: np.ndarray,
                     lengths: np.ndarray) -> list:
        """What a group walks of a batch: [(doc indices, corpus, the docs'
        longest length)], the batch itself, or a speculative group's batch a
        length at a time, ascending, each part cut to its docs' own length
        (its chunk statistics are the reference's only there)."""
        if g.mode != "speculative":
            return [(idxs, corpus, int(lengths.max(initial=0)))]
        return [(idxs[lengths == L],
                 np.ascontiguousarray(corpus[lengths == L, :L]), int(L))
                for L in np.unique(lengths)]

    def _on_device(self, corpus: np.ndarray) -> torch.Tensor:
        """A batch on the device, its rows padded there with the pad symbol
        to a multiple of ``n_chunks`` columns."""
        corpus_t = torch.as_tensor(corpus, device=self.device)
        pad = -corpus.shape[1] % self.plan.chunking.n_chunks
        if pad:
            corpus_t = torch.nn.functional.pad(corpus_t, (0, pad),
                                               value=self.n_symbols)
        return corpus_t

    # -- the chunk-function core -------------------------------------------

    def _group_doc_mappings(self, g: PatternGroup, corpus: np.ndarray,
                            corpus_t: torch.Tensor, length: int,
                            local: bool = False) -> torch.Tensor:
        """Final mapping of every (pattern-in-group, doc) of a batch: ->
        (Pg, D, n) on the scanner's device. The one place that chooses how
        a group walks.

        ``corpus`` is the batch on the host, ``corpus_t`` on the device
        padded with the pad symbol to a multiple of ``n_chunks`` columns, and
        ``length`` the docs' own length (the longest, in a ladder batch).
        Docs of no symbols map to the identity. The mesh walks the batch
        unless ``local`` (the stream's blocks) or the docs are shorter than
        ``n_chunks``: the reference walks no head there, so it neither
        raises nor gathers. The ``reference`` backend composes the docs at
        their own length on the host. A speculative group walks by
        enumeration: a whole mapping needs every state."""
        n_chunks = self.plan.chunking.n_chunks
        Pg, D, n = len(g.indices), corpus.shape[0], g.n
        if not length:
            return torch.arange(n, dtype=torch.int32, device=self.device
                                ).expand(Pg, D, n)
        if self.mesh is not None and not local and length >= n_chunks:
            self._check_mesh_docs(D)
            if g.mode == "sfa":
                return g._dist_fn(g.walk_deltas, g.sfa_maps, corpus_t)
            return g._dist_fn(g.walk_tables, corpus_t)
        if self.plan.backend == "reference":
            return torch.as_tensor(_reference_doc_mappings(
                g.bank.tables, corpus[:, :length]), device=self.device)
        if g.mode == "sfa":
            return X.bank_doc_mappings_sfa(g.walk_deltas, g.sfa_maps,
                                           corpus_t, n_chunks)
        return X.bank_doc_mappings(g.walk_tables, corpus_t, n_chunks)

    def _check_mesh_docs(self, D: int) -> None:
        """The reference's check, before any collective, on every rank."""
        n_dev = mesh_size(self.mesh)
        if D % n_dev:
            raise ValueError(
                f"shard_map distribution needs doc count ({D}) divisible "
                f"by the mesh's {self.plan.data_axis} size ({n_dev})")

    # -- the speculative core ----------------------------------------------

    def _speculation_sample(self, corpus: np.ndarray) -> np.ndarray:
        """The profiler's symbol sample: a prefix of the flattened corpus
        sized by the policy's ``sample_frac`` / ``max_sample``."""
        pol = self.plan.speculation
        flat = corpus.reshape(-1)
        s = min(pol.max_sample, max(1, int(pol.sample_frac * flat.size)))
        return flat[:s]

    def _explicit_profile_states(self, g: PatternGroup, src) -> np.ndarray:
        """Explicit ``profile_source``: a mapping {pattern id: states} or one
        state sequence for every pattern. Any states are *correct*
        (misspeculation only costs repairs)."""
        pol = self.plan.speculation
        if hasattr(src, "keys"):
            rows = []
            for i in g.indices:
                pid = self.ids[i]
                if pid not in src:
                    raise ValueError(
                        f"explicit speculation profile is missing pattern "
                        f"{pid!r}")
                rows.append(np.asarray(src[pid], dtype=np.int32))
        else:
            rows = [np.asarray(src, dtype=np.int32)] * len(g.indices)
        for r in rows:
            if r.ndim != 1 or not r.size:
                raise ValueError(
                    "explicit speculation profiles must be non-empty 1-D "
                    "state sequences")
        profs = [
            HotStateProfile(states=r, weights=np.zeros(len(r), np.float64),
                            sample_len=0)
            for r in rows
        ]
        return stack_profile_states(profs, pol.m, g.n)

    def _speculation_profile(self, g: PatternGroup, corpus: np.ndarray
                             ) -> np.ndarray:
        """One group's (Pg, m) speculated boundary states.

        ``"sample"`` profiles the first scanned corpus (a bounded
        ``max_sample``-symbol walk on the host) and memoises the result on
        the group, so a scanner pays it once, not once a scan; a profile is
        advisory, and reusing it on other corpora costs repairs, never
        correctness. ``"store"`` looks the profile up in the plan's
        persistent :class:`~..scanservice.ArtifactStore` by
        ``dfa_cache_key`` first, samples on a miss, and persists what it
        learned; explicit sources bypass profiling.
        """
        pol = self.plan.speculation
        src = pol.profile_source
        if not isinstance(src, str):
            return self._explicit_profile_states(g, src)
        if g._spec_profile is not None:
            return g._spec_profile
        store = self.plan.construction.resolve_store() if src == "store" \
            else None
        profiles: list = [None] * len(g.indices)
        keys = None
        if store is not None and hasattr(store, "get_profile"):
            from ..construction import dfa_cache_key

            keys = [dfa_cache_key(self._dfas[i]) for i in g.indices]
            for j, key in enumerate(keys):
                meta = store.get_profile(key)
                if meta is not None:
                    profiles[j] = HotStateProfile.from_json(meta)
        need = [j for j, pr in enumerate(profiles) if pr is None]
        if need:
            with obs.span("speculative.profile", patterns=len(need)):
                sample = self._speculation_sample(corpus)
                fresh = profile_hot_states(
                    g.bank.tables[need], g.bank.starts[need], sample, pol.m)
                for j, pr in zip(need, fresh):
                    profiles[j] = pr
                    if keys is not None and hasattr(store, "put_profile"):
                        store.put_profile(keys[j], pr.to_json())
        states = stack_profile_states(profiles, pol.m, g.n)
        g._spec_profile = states
        return states

    def _group_doc_finals(self, g: PatternGroup, corpus: np.ndarray,
                          corpus_t: torch.Tensor) -> tuple:
        """Speculative path: exact final states of every (pattern-in-group,
        doc) from each pattern's start — (Pg, D) int32 on the device, and
        the group's :class:`~..speculative.SpeculationStats`.

        Bit-identical to reading the enumeration mappings off at the start
        states: the executor only adopts chunk results whose entry state it
        verified exactly, and the docs of any lane the repair bound leaves
        unresolved go through the enumeration executor here. The ragged
        tail advances the finals symbol by symbol. One host sync reads the
        totals.
        """
        pol = self.plan.speculation
        n_chunks = self.plan.chunking.n_chunks
        D, L = corpus.shape
        head_len = L - (L % n_chunks)
        Pg = len(g.indices)
        starts = g.starts.to(torch.int32)
        stats = SpeculationStats()
        with obs.span("speculative.scan", patterns=Pg, docs=D):
            if head_len:
                spec = torch.as_tensor(self._speculation_profile(g, corpus),
                                       device=self.device)
                head = corpus_t[:, :head_len]
                if self.mesh is not None:
                    self._check_mesh_docs(D)
                    out = g._spec_dist_fn(g.walk_tables, spec, starts, head)
                else:
                    out = speculative_bank_finals(
                        g.walk_tables, spec, starts, head, n_chunks,
                        pol.max_repair_rounds)
                finals, resolved = out[0], out[1]
                stats = SpeculationStats.of(out, Pg * D * n_chunks)
                if stats.fallback_lanes:
                    bad = (~resolved).any(dim=0).nonzero()[:, 0]
                    with obs.span("speculative.fallback",
                                  lanes=int(bad.numel())):
                        maps = X.bank_doc_mappings(
                            g.walk_tables, head[bad].contiguous(), n_chunks)
                    exact = maps.gather(2, g.starts[:, None, None].expand(
                        Pg, maps.shape[1], 1))[:, :, 0]
                    finals[:, bad] = torch.where(resolved[:, bad],
                                                 finals[:, bad], exact)
            else:
                finals = starts[:, None].expand(Pg, D)
            if head_len < L:
                # A speculative group walks its docs at their own length, so
                # that its SpeculationStats count the reference's chunks;
                # the tail beyond them goes symbol by symbol.
                finals = X.advance_states_sequential(
                    g.walk_tables, finals, corpus_t[:, head_len:])
        obs.counter("speculative.total_chunks").inc(stats.total_chunks)
        obs.counter("speculative.hit_chunks").inc(stats.hit_chunks)
        obs.counter("speculative.repaired_chunks").inc(stats.repaired_chunks)
        obs.counter("speculative.repair_rounds").inc(stats.repair_rounds)
        obs.counter("speculative.fallback_lanes").inc(stats.fallback_lanes)
        if stats.total_chunks:
            obs.gauge("speculative.hit_rate").set(stats.hit_rate)
        return finals, stats

    # -- public scan API ----------------------------------------------------

    def scan(self, docs) -> ScanResult:
        """Match a corpus against the bank -> :class:`ScanResult` (P, D).

        Docs go to the device in batches (:meth:`_batches`): a list of docs
        by the length ladder (by doc length on the ``reference`` backend and
        the mesh), each batch padded with the neutral pad symbol to a
        multiple of ``n_chunks``; a 2-D array is one batch, padded so on the
        device. A speculative group walks a batch a length at a time
        (:meth:`_group_parts`).

        Spans: ``scanner.scan.prepare`` once (encoding, batching, the
        symbol check), then, as loop spans, for each batch and group (and
        length, in a speculative group) ``scanner.scan.launch`` (the
        batch's upload and device pad in its first group, the walk and fold
        launches), ``scanner.scan.readback`` (the host waits for the
        device, then copies) and ``scanner.scan.scatter`` (the group's hits
        into the (P, D) matrix). Counters: ``engine.scan_symbols`` (the
        docs' symbols) and ``engine.scan_pad_symbols`` (the pad symbols of
        the batches some group takes whole, i.e. of a bank not speculative
        alone)."""
        spec_stats: SpeculationStats | None = None
        with obs.span("scanner.scan", patterns=self.n_patterns) as span:
            self.last_trace_id = obs.current_trace_id() or self.last_trace_id
            with obs.span("scanner.scan.prepare"):
                batches = self._batches(docs)
                D = sum(len(idxs) for idxs, _, _ in batches)
                hits = np.zeros((self.n_patterns, D), dtype=bool)
            if span is not None:
                span.attrs["docs"] = D
            launch = obs.loop_span("scanner.scan.launch")
            readback = obs.loop_span("scanner.scan.readback")
            scatter = obs.loop_span("scanner.scan.scatter")
            symbols = pads = 0
            for idxs, corpus, lengths in batches:
                real = int(lengths.sum())
                symbols += real
                corpus_t = None
                for g in self.groups:
                    for part_idxs, part, length in self._group_parts(
                            g, idxs, corpus, lengths):
                        with launch:
                            if part is not corpus:
                                part_t = torch.as_tensor(part,
                                                         device=self.device)
                            else:
                                if corpus_t is None:
                                    corpus_t = self._on_device(corpus)
                                    pads += corpus_t.numel() - real
                                part_t = corpus_t
                            acc, st = self._group_hits(g, part, part_t,
                                                       length)
                            if st is not None:
                                spec_stats = st if spec_stats is None \
                                    else spec_stats.merged(st)
                        with readback:
                            acc = acc.cpu().numpy()
                        with scatter:
                            hits[np.ix_(g.indices, part_idxs)] = acc
        obs.counter("engine.scans").inc()
        obs.counter("engine.docs_scanned").inc(D)
        obs.counter("engine.scan_symbols").inc(symbols)
        obs.counter("engine.scan_pad_symbols").inc(pads)
        self.last_speculation = spec_stats
        return ScanResult(hits=hits, ids=self.ids, speculation=spec_stats)

    def _group_hits(self, g: PatternGroup, corpus: np.ndarray,
                    corpus_t: torch.Tensor, length: int) -> tuple:
        """One batch under one group -> ((Pg, D) accept flags on the
        device, the group's SpeculationStats or None). A speculative group
        is handed its docs at their own length."""
        if g.mode == "speculative" and length:
            finals, st = self._group_doc_finals(g, corpus, corpus_t)
            return g.accepting.gather(1, finals.to(torch.int64)), st
        maps = self._group_doc_mappings(g, corpus, corpus_t, length)
        return X.hits_of_mappings(maps, g.accepting, g.starts), None

    def census(self, docs) -> np.ndarray:
        """Per-pattern hit counts over a corpus, (P,) int32."""
        return self.scan(docs).counts

    def mapping(self, doc) -> np.ndarray:
        """Transition function of one whole input under every pattern,
        (P, n_max) int32 on the scanner's padded layout (identity beyond
        each pattern's true state count). Speculative groups compute it
        through the enumeration executor: a whole transition function needs
        all n states, so there is nothing for speculation to skip."""
        enc = self._encoded([doc])[0]
        self._check_symbols(enc)
        corpus = enc[None]
        corpus_t = self._on_device(corpus)
        out = np.broadcast_to(
            np.arange(self.n_max, dtype=np.int32),
            (self.n_patterns, self.n_max),
        ).copy()
        for g in self.groups:
            maps = self._group_doc_mappings(g, corpus, corpus_t,
                                            len(enc))[:, 0, :]
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
        suffix scan per tile of ``window // stride`` blocks, all on the
        device (:func:`.executors.sliding_window_hits`: each scan step and
        the stitch one ``compose`` over contiguous slabs of a
        tile-position-major workspace, then each pattern's start lane).
        Composition is exactly associative, so ``hits`` is bit-identical to
        ``scan`` of the materialised windows
        ``seq[i*stride : i*stride + window]``.

        ``stride`` must divide ``window`` (default ``stride = window``:
        disjoint blocks). -> :class:`ScanResult` whose "docs" are the
        ``(len(seq) - window) // stride + 1`` full windows.

        Spans: ``scanner.census`` (the call) and ``scanner.census.prepare``
        (encoding, the symbol check, the block reshape, the upload), then,
        as loop spans, for each pattern group ``scanner.census.fold`` (the
        blocks' walk and rows fold, up to the block mappings),
        ``scanner.census.windows`` (the prefix scans and the hit lookup)
        and ``scanner.census.readback`` (the host waits for the device,
        copies, and fills the group's rows of the hit matrix).
        """
        stride = window if stride is None else stride
        if window < 1 or stride < 1:
            raise ValueError("window and stride must be >= 1")
        if window % stride:
            raise ValueError(
                f"stride ({stride}) must divide window ({window}): the "
                "prefix-scan census composes whole stride-blocks")
        with obs.span("scanner.census", patterns=self.n_patterns,
                      window=window, stride=stride) as span:
            self.last_trace_id = obs.current_trace_id() or self.last_trace_id
            with obs.span("scanner.census.prepare"):
                enc = self._encoded([seq])[0]
                self._check_symbols(enc)
                L = len(enc)
                m = window // stride
                W = (L - window) // stride + 1 if L >= window else 0
                if span is not None:
                    span.attrs["windows"] = W
                hits = np.zeros((self.n_patterns, W), dtype=bool)
                if W == 0:
                    return ScanResult(hits=hits, ids=self.ids)
                B = W + m - 1
                blocks = enc[: B * stride].reshape(B, stride)
                if self.mesh is not None:
                    # Blocks are the "docs" of the mesh path: pad the block
                    # axis to a multiple of the mesh size with zero rows,
                    # cropped below.
                    pad_rows = -B % mesh_size(self.mesh)
                    blocks = np.concatenate(
                        [blocks, np.zeros((pad_rows, stride), dtype=np.int32)])
                blocks_t = self._on_device(blocks)
            fold = obs.loop_span("scanner.census.fold")
            windows = obs.loop_span("scanner.census.windows")
            readback = obs.loop_span("scanner.census.readback")
            for g in self.groups:
                with fold:
                    maps = self._group_doc_mappings(g, blocks, blocks_t,
                                                    stride)[:, :B]
                with windows:
                    acc = X.sliding_window_hits(maps, m, g.accepting,
                                                g.starts)         # (Pg, W)
                with readback:
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
        enc = self._encoded([doc])[0]
        self._check_symbols(enc)
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

    # -- serving ------------------------------------------------------------

    @classmethod
    def service(cls, store_dir=None, plan: ScanPlan | None = None,
                **kwargs):
        """The serving layer's front door: a
        :class:`~..scanservice.ScanService` whose compiles run through a
        persistent artifact store at ``store_dir`` (when given) and whose
        ``submit``/``flush`` coalesce concurrent requests into one bank
        compile and one fused scan. See :mod:`..scanservice`."""
        from ..scanservice import ScanService

        return ScanService(store_dir=store_dir, plan=plan, **kwargs)

    # -- streaming ----------------------------------------------------------

    def open_stream(self) -> StreamSession:
        """Push API: feed pieces of one input, then ``finish()``."""
        return StreamSession(self)

    def stream(self, blocks) -> StreamResult:
        """Scan one logically concatenated input delivered as an iterable of
        pieces (strings or encoded int arrays) without holding it whole:
        equal to ``mapping``/``accepts`` of the concatenation (no mapping
        when a group runs speculatively)."""
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
            f"{self.plan.backend}/{self.plan.distribution}/{self.device}, "
            f"n_chunks={self.plan.chunking.n_chunks})",
            f"  construction: {r.rounds} round(s) via {r.method}, "
            f"cache {r.cache_hits} hit(s) / {r.cache_misses} miss(es), "
            f"{r.constructed} built, {r.blown} blown",
        ]
        for g in self.groups:
            extra = ""
            if g.mode == "sfa":
                extra = f", S_max={int(g.deltas.shape[1])}"
            elif g.mode == "speculative":
                src = self.plan.speculation.profile_source
                extra = (f", m={self.plan.speculation.m}, source="
                         + (repr(src) if isinstance(src, str)
                            else "explicit"))
            lines.append(f"  group[{g.mode}]: {len(g.indices)} pattern(s), "
                         f"n_max={g.n}{extra}")
        s = self.last_speculation
        if s is not None:
            lines.append(
                f"  speculation: hit rate {s.hit_rate:.3f} "
                f"({s.hit_chunks}/{s.total_chunks} chunks), "
                f"{s.repaired_chunks} repaired in {s.repair_rounds} "
                f"round(s), {s.fallback_lanes} fallback lane(s)")
        if self.last_trace_id is not None:
            summ = obs.trace_summary(self.last_trace_id)
            if summ["spans"]:
                lines.append(
                    f"  last trace {summ['trace_id']}: "
                    f"{len(summ['spans'])} span(s), "
                    f"wall {summ['wall_s'] * 1e3:.2f} ms")
                for sp in summ["spans"][:8]:
                    lines.append(
                        f"    {sp['name']}: {sp['wall_s'] * 1e3:.2f} ms "
                        f"{sp['attrs'] or ''}".rstrip())
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
