"""Execution plans of the port's ``Scanner``.

A :class:`ScanPlan` says *how* to run a scan — matching mode, backend,
device, distribution, chunking, construction — while the
:class:`~.scanner.Scanner` says *what* to scan. The fields follow the
reference package's plan:

* ``mode``: ``"auto"``, ``"sfa"``, ``"enumeration"`` or
  ``"speculative"``;
* ``backend``: ``"kernel"`` (the CUDA chunk-matching kernel through
  :mod:`..kernels.ops`; its plain version for a CPU device) or
  ``"reference"`` (the pure NumPy oracle);
* ``device``: ``"cuda"`` by default; the tests pass ``"cpu"``;
* ``distribution``: ``"local"`` or ``"shard_map"`` (documents shard over
  a :mod:`torch.distributed` mesh, :mod:`..mesh`);
* ``construction``: with the content-addressed SFA cache (``"shared"`` by
  default, as in the reference), an optional persistent store, and its own
  ``distribution`` (patterns shard over a mesh);
* ``speculation``: the reference's :class:`SpeculationPolicy`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any

import torch

MODES = ("auto", "sfa", "enumeration", "speculative")
BACKENDS = ("reference", "kernel")
SPECULATION_SOURCES = ("sample", "store")
DISTRIBUTIONS = ("local", "shard_map")
CONSTRUCTION_METHODS = ("auto", "batched", "loop")
CONSTRUCTION_ENGINES = ("vectorized", "sequential", "jax")
CONSTRUCTION_FP_BACKENDS = ("auto", "kernel", "plain")
CONSTRUCTION_EXPAND_BACKENDS = ("auto", "kernel", "plain")
CONSTRUCTION_BUCKETINGS = ("auto", "size", "off")

#: Default SFA state budget for ``mode="auto"``: patterns whose exact SFA
#: closes within this many states get the paper's single-lookup inner loop;
#: the rest fall back to speculation or enumeration.
DEFAULT_SFA_STATE_BUDGET = 512


@dataclass(frozen=True)
class ChunkPolicy:
    """How inputs are cut into the paper's parallel chunks.

    ``n_chunks``: chunk-level parallelism per document and per stream
    block (the paper's thread count). ``block_len``: symbols per chunk in
    the streaming path, so one stream block is ``n_chunks * block_len``
    symbols. ``bucket`` / ``bucket_edges``: size-bucketing of the pattern
    bank, so no pattern pays gathers more than ~2x wider than its own
    automaton.
    """

    n_chunks: int = 8
    block_len: int = 256
    bucket: bool = False
    bucket_edges: tuple = (8, 16, 32, 64, 128, 256, 1024)

    def validate(self) -> "ChunkPolicy":
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {self.n_chunks}")
        if self.block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {self.block_len}")
        if self.bucket and not self.bucket_edges:
            raise ValueError("bucket=True requires non-empty bucket_edges")
        return self


@dataclass(frozen=True)
class ConstructionPolicy:
    """How ``Scanner.compile`` builds the SFAs its plan needs (one
    :func:`~..construction.construct_bank` call for every pattern).

    ``method``: ``"batched"`` (all frontiers advance together in bank
    rounds), ``"loop"`` (one :func:`~..construction.construct_sfa` per
    pattern, ``engine`` picks the single-pattern engine) or ``"auto"``
    (batched for at least four patterns, loop for fewer — the reference's
    rule). ``engine``: ``"vectorized"``, ``"sequential"`` or ``"jax"`` (the
    reference's name for the one-pattern bank construction).
    ``cache``: ``"shared"`` (the process-wide content-addressed
    :class:`~..construction.SFACache` — recompiling the same patterns
    performs zero construction rounds), ``"off"``/``None``, or an explicit
    :class:`~..construction.SFACache` instance. ``store``: an optional
    persistent tier under the cache, a directory path (wrapped in
    :class:`~..scanservice.ArtifactStore`) or any object speaking its
    backing protocol; attached to the resolved cache, so SFAs persist across
    processes (and across the two packages: the artifacts are the
    reference's). Ignored when the cache is off.
    ``tile`` / ``max_retries``: frontier states per pattern per round, and
    the per-pattern polynomial retry budget. ``fingerprint_backend`` /
    ``expand_backend``: ``"kernel"``, ``"plain"`` or ``"auto"`` (kernel on a
    CUDA device). ``bucketing`` / ``bucket_growth``: size-bucketed banks and
    the shape schedule's bucket shrink factor.
    ``distribution``: ``"shard_map"`` shards the pattern axis of the
    batched rounds over ``mesh``'s ``pattern_axis`` (default: a one-axis
    mesh over the whole world named ``pattern_axis``); ``"local"`` keeps
    construction on one device.
    """

    method: str = "auto"
    engine: str = "vectorized"
    tile: int = 128
    cache: Any = "shared"
    store: Any = None
    distribution: str = "local"
    mesh: Any = None
    pattern_axis: str = "pattern"
    max_retries: int = 4
    fingerprint_backend: str = "auto"
    expand_backend: str = "auto"
    bucketing: str = "auto"
    bucket_growth: int = 4

    def validate(self) -> "ConstructionPolicy":
        checks = (
            ("method", self.method, CONSTRUCTION_METHODS),
            ("engine", self.engine, CONSTRUCTION_ENGINES),
            ("fingerprint_backend", self.fingerprint_backend,
             CONSTRUCTION_FP_BACKENDS),
            ("expand_backend", self.expand_backend,
             CONSTRUCTION_EXPAND_BACKENDS),
            ("bucketing", self.bucketing, CONSTRUCTION_BUCKETINGS),
            ("distribution", self.distribution, DISTRIBUTIONS),
        )
        for name, value, choices in checks:
            if value not in choices:
                raise ValueError(
                    f"construction {name} must be one of {choices}, "
                    f"got {value!r}")
        if self.tile < 1:
            raise ValueError(f"construction tile must be >= 1, got {self.tile}")
        if self.max_retries < 1:
            raise ValueError("construction max_retries must be >= 1")
        if self.bucket_growth < 2:
            raise ValueError(
                f"construction bucket_growth must be >= 2, "
                f"got {self.bucket_growth}")
        from ..construction import SFACache

        if not (isinstance(self.cache, SFACache)
                or self.cache in ("shared", "off", None)):
            raise ValueError(
                "construction cache must be 'shared', 'off', None, or an "
                f"SFACache instance, got {self.cache!r}")
        if not (self.store is None
                or isinstance(self.store, (str, os.PathLike))
                or (hasattr(self.store, "get")
                    and hasattr(self.store, "put_sfa"))):
            raise ValueError(
                "construction store must be None, a directory path, or an "
                "object with the ArtifactStore backing protocol "
                f"(get/put_sfa/put_blowup), got {self.store!r}")
        return self

    def resolve_store(self):
        """-> the backing store object, or None. Paths wrap lazily in an
        :class:`~..scanservice.ArtifactStore`."""
        if self.store is None:
            return None
        if isinstance(self.store, (str, os.PathLike)):
            from ..scanservice.store import ArtifactStore

            return ArtifactStore(self.store)
        return self.store

    def resolve_cache(self):
        """-> the SFACache to consult (with any configured backing store
        attached), or None when caching is off."""
        from ..construction import SFACache, shared_cache

        cache = None
        if isinstance(self.cache, SFACache):
            cache = self.cache
        elif self.cache == "shared":
            cache = shared_cache()
        if cache is not None:
            cache.attach_backing(self.resolve_store())
        return cache

    def with_(self, **overrides) -> "ConstructionPolicy":
        return replace(self, **overrides).validate()


@dataclass(frozen=True)
class SpeculationPolicy:
    """How ``mode="speculative"`` (and auto's speculative tier) speculates.

    ``m``: speculated boundary states per pattern — every chunk runs from
    all ``m`` at once, so cost scales with ``m`` where enumeration scales
    with the automaton's ``n``.
    ``sample_frac`` / ``max_sample``: how much of the input the hot-state
    profiler reads when the profile comes from sampling:
    ``min(max_sample, sample_frac · corpus_size)`` symbols off the corpus
    prefix.
    ``max_repair_rounds``: the bound of validate and repair. Each round
    re-walks exactly one chunk per broken (pattern, doc) lane from its
    now-known entry state; lanes still unresolved at the bound fall back to
    enumeration — results stay bit-identical either way.
    ``profile_source``: ``"sample"`` (profile the first scanned input,
    memoised per scanner), ``"store"`` (a persisted profile in the plan's
    ``construction.store`` by the pattern's ``dfa_cache_key``, sampling and
    persisting on a miss — the scan-service path), a mapping ``{pattern id:
    state sequence}``, or one explicit state sequence for every pattern.
    ``auto_states``: the ``auto``-mode tier threshold: a pattern whose SFA
    blows the state budget goes to speculation only when its DFA has at
    least this many states; smaller blowup patterns keep enumeration.
    """

    m: int = 8
    sample_frac: float = 0.05
    max_sample: int = 4096
    max_repair_rounds: int = 8
    profile_source: Any = "sample"
    auto_states: int = 128

    def validate(self) -> "SpeculationPolicy":
        if self.m < 1:
            raise ValueError(f"speculation m must be >= 1, got {self.m}")
        if not (0.0 < self.sample_frac <= 1.0):
            raise ValueError(
                f"speculation sample_frac must be in (0, 1], "
                f"got {self.sample_frac}")
        if self.max_sample < 1:
            raise ValueError("speculation max_sample must be >= 1")
        if self.max_repair_rounds < 1:
            raise ValueError("speculation max_repair_rounds must be >= 1")
        if self.auto_states < 1:
            raise ValueError("speculation auto_states must be >= 1")
        src = self.profile_source
        if isinstance(src, str):
            if src not in SPECULATION_SOURCES:
                raise ValueError(
                    f"speculation profile_source must be one of "
                    f"{SPECULATION_SOURCES}, a mapping, or a state sequence; "
                    f"got {src!r}")
        elif not (hasattr(src, "keys") or hasattr(src, "__len__")
                  or hasattr(src, "__iter__")):
            raise ValueError(
                "speculation profile_source must be 'sample', 'store', a "
                f"mapping, or a state sequence, got {src!r}")
        return self

    def with_(self, **overrides) -> "SpeculationPolicy":
        return replace(self, **overrides).validate()


@dataclass(frozen=True)
class ScanPlan:
    """One execution plan for a compiled :class:`~.scanner.Scanner`.

    ``mode``: ``"sfa"`` forces SFA matching (every pattern must close under
    ``sfa_state_budget``, else ``StateBlowup``); ``"enumeration"`` forces
    the all-states mode; ``"speculative"`` forces the hot-state speculation
    executor (no SFA construction); ``"auto"`` constructs each pattern's
    SFA under the budget and, for those that blow up, speculates when the
    DFA has at least ``speculation.auto_states`` states and enumerates
    otherwise.
    ``backend``: ``"kernel"`` or ``"reference"`` (bit-identical; a
    speculative group runs the speculative executor under either, as in
    the reference).
    ``device``: where construction and scans run.
    ``distribution``: ``"local"`` or ``"shard_map"``: documents shard over
    ``data_axis`` of ``mesh``, every rank of the process group calling with
    the whole corpus and getting the whole result. With ``mesh=None`` the
    mesh spans the whole world (the reference builds a one-device mesh:
    the same mesh at world size 1). ``shard_map`` needs
    ``backend="kernel"``, and a mesh on the plan's device type.
    """

    mode: str = "auto"
    backend: str = "kernel"
    device: Any = "cuda"
    distribution: str = "local"
    chunking: ChunkPolicy = field(default_factory=ChunkPolicy)
    construction: ConstructionPolicy = field(default_factory=ConstructionPolicy)
    speculation: SpeculationPolicy = field(default_factory=SpeculationPolicy)
    sfa_state_budget: int = DEFAULT_SFA_STATE_BUDGET
    mesh: Any = None
    data_axis: str = "data"

    def validate(self) -> "ScanPlan":
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        try:
            dev_type = torch.device(self.device).type
        except RuntimeError:
            dev_type = None
        if dev_type not in ("cpu", "cuda"):
            raise ValueError(f"device must be 'cpu' or 'cuda[:N]', "
                             f"got {self.device!r}")
        if self.sfa_state_budget < 1:
            raise ValueError("sfa_state_budget must be >= 1")
        if self.distribution not in DISTRIBUTIONS:
            raise ValueError(
                f"distribution must be one of {DISTRIBUTIONS}, "
                f"got {self.distribution!r}")
        if self.distribution == "shard_map" and self.backend != "kernel":
            raise ValueError(
                "distribution='shard_map' requires backend='kernel' (the "
                "reference backend has no mesh story)")
        for mesh in (self.mesh, self.construction.mesh):
            if mesh is not None and mesh.device_type != dev_type:
                raise ValueError(
                    f"a {mesh.device_type!r} mesh cannot run a plan on "
                    f"device {self.device!r}")
        self.chunking.validate()
        self.construction.validate()
        self.speculation.validate()
        return self

    def with_(self, **overrides) -> "ScanPlan":
        """Functional update (``dataclasses.replace`` with validation)."""
        return replace(self, **overrides).validate()
