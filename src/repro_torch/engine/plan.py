"""Execution plans of the port's ``Scanner``.

A :class:`ScanPlan` says *how* to run a scan — matching mode, backend,
device, chunking, construction — while the :class:`~.scanner.Scanner` says
*what* to scan. The fields follow the reference package's plan; this slice
of the port carries the subset it runs:

* ``mode``: ``"auto"``, ``"sfa"`` or ``"enumeration"`` (speculation is a
  later slice: a pattern ``"auto"`` would send there raises
  ``NotImplementedError``);
* ``backend``: ``"kernel"`` (the CUDA chunk-matching kernel through
  :mod:`..kernels.ops`; its plain version for a CPU device) or
  ``"reference"`` (the pure NumPy oracle);
* ``device``: ``"cuda"`` by default; the tests pass ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch

MODES = ("auto", "sfa", "enumeration")
BACKENDS = ("reference", "kernel")
CONSTRUCTION_FP_BACKENDS = ("auto", "kernel", "plain")
CONSTRUCTION_EXPAND_BACKENDS = ("auto", "kernel", "plain")
CONSTRUCTION_BUCKETINGS = ("auto", "size", "off")
CONSTRUCTION_CACHES = ("off",)

#: Default SFA state budget for ``mode="auto"``: patterns whose exact SFA
#: closes within this many states get the paper's single-lookup inner loop;
#: the rest fall back to enumeration.
DEFAULT_SFA_STATE_BUDGET = 512

#: ``auto``'s blowup tier, as in the reference plan's
#: ``SpeculationPolicy.auto_states``: a pattern whose SFA blows the budget
#: and whose DFA has at least this many states goes to speculation, which
#: this slice of the port does not have yet.
SPECULATION_AUTO_STATES = 128


@dataclass(frozen=True)
class ChunkPolicy:
    """How inputs are cut into the paper's parallel chunks.

    ``n_chunks``: chunk-level parallelism per document (the paper's thread
    count). ``bucket`` / ``bucket_edges``: size-bucketing of the pattern
    bank, so no pattern pays gathers more than ~2x wider than its own
    automaton.
    """

    n_chunks: int = 8
    bucket: bool = False
    bucket_edges: tuple = (8, 16, 32, 64, 128, 256, 1024)

    def validate(self) -> "ChunkPolicy":
        if self.n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {self.n_chunks}")
        if self.bucket and not self.bucket_edges:
            raise ValueError("bucket=True requires non-empty bucket_edges")
        return self


@dataclass(frozen=True)
class ConstructionPolicy:
    """How ``Scanner.compile`` builds the SFAs its plan needs (one
    :func:`~..construction.construct_bank` call for every pattern).

    ``cache``: ``"off"`` — the content-addressed construction cache is a
    later slice.
    ``tile`` / ``max_retries``: frontier states per pattern per round, and
    the per-pattern polynomial retry budget. ``fingerprint_backend`` /
    ``expand_backend``: ``"kernel"``, ``"plain"`` or ``"auto"`` (kernel on a
    CUDA device). ``bucketing`` / ``bucket_growth``: size-bucketed banks and
    the shape schedule's bucket shrink factor.
    """

    tile: int = 128
    cache: Any = "off"
    max_retries: int = 4
    fingerprint_backend: str = "auto"
    expand_backend: str = "auto"
    bucketing: str = "auto"
    bucket_growth: int = 4

    def validate(self) -> "ConstructionPolicy":
        checks = (
            ("cache", self.cache, CONSTRUCTION_CACHES),
            ("fingerprint_backend", self.fingerprint_backend,
             CONSTRUCTION_FP_BACKENDS),
            ("expand_backend", self.expand_backend,
             CONSTRUCTION_EXPAND_BACKENDS),
            ("bucketing", self.bucketing, CONSTRUCTION_BUCKETINGS),
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
        return self

    def with_(self, **overrides) -> "ConstructionPolicy":
        return replace(self, **overrides).validate()


@dataclass(frozen=True)
class ScanPlan:
    """One execution plan for a compiled :class:`~.scanner.Scanner`.

    ``mode``: ``"sfa"`` forces SFA matching (every pattern must close under
    ``sfa_state_budget``, else ``StateBlowup``); ``"enumeration"`` forces
    the all-states mode; ``"auto"`` constructs each pattern's SFA under the
    budget and falls back to enumeration for those that blow up.
    ``backend``: ``"kernel"`` or ``"reference"`` (bit-identical).
    ``device``: where construction and scans run.
    """

    mode: str = "auto"
    backend: str = "kernel"
    device: Any = "cuda"
    chunking: ChunkPolicy = field(default_factory=ChunkPolicy)
    construction: ConstructionPolicy = field(default_factory=ConstructionPolicy)
    sfa_state_budget: int = DEFAULT_SFA_STATE_BUDGET

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
        self.chunking.validate()
        self.construction.validate()
        return self

    def with_(self, **overrides) -> "ScanPlan":
        """Functional update (``dataclasses.replace`` with validation)."""
        return replace(self, **overrides).validate()
