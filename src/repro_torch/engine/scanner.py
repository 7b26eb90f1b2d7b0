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
    tables: torch.Tensor = None    # (Pg, n, k) int32
    accepting: torch.Tensor = None  # (Pg, n) bool
    starts: torch.Tensor = None    # (Pg,) int64
    deltas: torch.Tensor = None    # (Pg, S, k) int32 — stacked SFA tables
    sfa_maps: torch.Tensor = None  # (Pg, S, n) int32 — SFA state -> mapping
    sfa_states: np.ndarray | None = None  # (Pg,) true SFA state counts
    _dist_fn: Any = field(default=None, repr=False)
    _spec_dist_fn: Any = field(default=None, repr=False)
    _spec_profile: Any = field(default=None, repr=False)  # memoised (Pg, m)

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
        self.n_patterns = len(dfas)
        self.n_max = max(d.n_states for d in dfas)
        self._dfas = dfas
        self.last_speculation: SpeculationStats | None = None
        #: trace id of the last traced compile/scan through this scanner —
        #: the key ``obs.trace_summary`` (and ``describe``) correlates on.
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

    def _check_mesh_docs(self, D: int) -> None:
        """The reference's check, before any collective, on every rank."""
        n_dev = mesh_size(self.mesh)
        if D % n_dev:
            raise ValueError(
                f"shard_map distribution needs doc count ({D}) divisible "
                f"by the mesh's {self.plan.data_axis} size ({n_dev})")

    def _head_mappings(self, g: PatternGroup, corpus: np.ndarray,
                       head: torch.Tensor, n_chunks: int) -> torch.Tensor:
        if self.mesh is not None:
            self._check_mesh_docs(head.shape[0])
            if g.mode == "sfa":
                return g._dist_fn(g.deltas, g.sfa_maps, head)
            return g._dist_fn(g.tables, head)
        if self.plan.backend == "reference":
            maps = _reference_doc_mappings(
                g.bank.tables, corpus[:, : head.shape[1]])
            return torch.as_tensor(maps, device=self.device)
        if g.mode == "sfa":
            return X.bank_doc_mappings_sfa(g.deltas, g.sfa_maps, head,
                                           n_chunks)
        return X.bank_doc_mappings(g.tables, head, n_chunks)

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
                    out = g._spec_dist_fn(g.tables, spec, starts, head)
                else:
                    out = speculative_bank_finals(
                        g.tables, spec, starts, head, n_chunks,
                        pol.max_repair_rounds)
                finals, resolved = out[0], out[1]
                stats = SpeculationStats.of(out, Pg * D * n_chunks)
                if stats.fallback_lanes:
                    bad = (~resolved).any(dim=0).nonzero()[:, 0]
                    with obs.span("speculative.fallback",
                                  lanes=int(bad.numel())):
                        maps = X.bank_doc_mappings(
                            g.tables, head[bad].contiguous(), n_chunks)
                    exact = maps.gather(2, g.starts[:, None, None].expand(
                        Pg, maps.shape[1], 1))[:, :, 0]
                    finals[:, bad] = torch.where(resolved[:, bad],
                                                 finals[:, bad], exact)
            else:
                finals = starts[:, None].expand(Pg, D)
            if head_len < L:
                finals = X.advance_states_sequential(
                    g.tables, finals, corpus_t[:, head_len:])
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

        Spans: ``scanner.scan.prepare`` once (encoding, one batch a doc
        length, the symbol check), then, as loop spans, for each batch and
        group ``scanner.scan.launch`` (the batch's upload in its first
        group, the walk and fold launches), ``scanner.scan.readback`` (the
        host waits for the device, then copies) and ``scanner.scan.scatter``
        (the group's hits into the (P, D) matrix)."""
        spec_stats: SpeculationStats | None = None
        with obs.span("scanner.scan", patterns=self.n_patterns) as span:
            self.last_trace_id = obs.current_trace_id() or self.last_trace_id
            with obs.span("scanner.scan.prepare"):
                batches = self._length_batches(docs)
                D = sum(len(idxs) for idxs, _ in batches)
                hits = np.zeros((self.n_patterns, D), dtype=bool)
            if span is not None:
                span.attrs["docs"] = D
            launch = obs.loop_span("scanner.scan.launch")
            readback = obs.loop_span("scanner.scan.readback")
            scatter = obs.loop_span("scanner.scan.scatter")
            for idxs, corpus in batches:
                corpus_t = None
                for g in self.groups:
                    with launch:
                        if corpus_t is None:
                            corpus_t = torch.as_tensor(corpus,
                                                       device=self.device)
                        if g.mode == "speculative" and corpus.shape[1]:
                            finals, st = self._group_doc_finals(g, corpus,
                                                                corpus_t)
                            spec_stats = st if spec_stats is None \
                                else spec_stats.merged(st)
                            acc = g.accepting.gather(1,
                                                     finals.to(torch.int64))
                        else:
                            maps = self._group_doc_mappings(g, corpus,
                                                            corpus_t)
                            acc = X.hits_of_mappings(maps, g.accepting,
                                                     g.starts)
                    with readback:
                        acc = acc.cpu().numpy()
                    with scatter:
                        hits[np.ix_(g.indices, idxs)] = acc
        obs.counter("engine.scans").inc()
        obs.counter("engine.docs_scanned").inc(D)
        self.last_speculation = spec_stats
        return ScanResult(hits=hits, ids=self.ids, speculation=spec_stats)

    def census(self, docs) -> np.ndarray:
        """Per-pattern hit counts over a corpus, (P,) int32."""
        return self.scan(docs).counts

    def mapping(self, doc) -> np.ndarray:
        """Transition function of one whole input under every pattern,
        (P, n_max) int32 on the scanner's padded layout (identity beyond
        each pattern's true state count). Speculative groups compute it
        through the enumeration executor: a whole transition function needs
        all n states, so there is nothing for speculation to skip."""
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
        if self.mesh is not None:
            # Blocks are the "docs" of the mesh path: pad the block axis to
            # a multiple of the mesh size with zero rows, cropped below.
            pad_rows = -B % mesh_size(self.mesh)
            blocks = np.concatenate(
                [blocks, np.zeros((pad_rows, stride), dtype=np.int32)])
        blocks_t = torch.as_tensor(blocks, device=self.device)
        for g in self.groups:
            maps = self._group_doc_mappings(g, blocks, blocks_t)[:, :B]
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
