"""Re-export shim: SFA construction lives in :mod:`repro_torch.construction`.

The reference keeps this module for the long-standing ``core.sfa`` names
(its ``data/protein.py`` imports them from here); new code imports from
:mod:`repro_torch.construction`.
"""

from __future__ import annotations

from ..construction import (  # noqa: F401
    SFA,
    FingerprintCollision,
    SFAStats,
    StateBlowup,
    construct_sfa,
    construct_sfa_sequential,
    construct_sfa_vectorized,
)

__all__ = [
    "SFA",
    "FingerprintCollision",
    "SFAStats",
    "StateBlowup",
    "construct_sfa",
    "construct_sfa_sequential",
    "construct_sfa_vectorized",
]
