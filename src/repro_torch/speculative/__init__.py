"""Speculative scanning: parallel matching for blowup-regime patterns.

A pattern whose SFA blows the plan's ``sfa_state_budget`` used to fall back
to full ``n``-state enumeration per chunk — the slowest path, for exactly
the large automata users most want scanned in parallel. Speculation
(*A Speculative Parallel DFA Membership Test*, arXiv:1210.5093, and
*PaREM*, arXiv:1412.1741) runs each chunk from ``m`` *likely* boundary
states — a hot-state profile measured from a sampled prefix of the input
or persisted corpus statistics — then validates every chunk's speculated
entry against its predecessor's exact exit and re-walks only the chunks
whose speculation missed. The result is **bit-identical to enumeration**: a
chunk's result is only used when its entry state was verified exactly, and
lanes the repair bound leaves unresolved fall back to the enumeration
executor.

Layout:

* :mod:`.profile`  — the hot-state profiler (:class:`HotStateProfile`,
  :func:`profile_hot_states`), a copy of the reference's NumPy pass;
  profiles persist next to SFA artifacts in the
  :class:`repro_torch.scanservice.ArtifactStore`;
* :mod:`.executor` — :func:`speculative_bank_finals` (the m-lane chunk
  walk and the ``spec_resolve`` kernel) and :class:`SpeculationStats`.

The engine plumbing lives in :mod:`repro_torch.engine`:
``ScanPlan(mode="speculative", speculation=SpeculationPolicy(...))``
forces every pattern through this subsystem, and ``mode="auto"`` routes a
pattern here when its SFA blows the state budget *and* its DFA has at least
``SpeculationPolicy.auto_states`` states.
"""

from .executor import (
    SpeculationStats,
    distributed_speculative_finals_fn,
    speculative_bank_finals,
)
from .profile import (
    HotStateProfile,
    profile_hot_states,
    stack_profile_states,
)

__all__ = [
    "HotStateProfile",
    "SpeculationStats",
    "distributed_speculative_finals_fn",
    "profile_hot_states",
    "speculative_bank_finals",
    "stack_profile_states",
]
