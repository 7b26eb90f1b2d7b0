"""Re-export shim under the reference's module name: ``construct_sfa_jax``
is the ``P = 1`` case of :func:`repro_torch.construction.construct_bank`;
new code imports it from :mod:`repro_torch.construction`."""

from __future__ import annotations

from ..construction import (  # noqa: F401
    SFA,
    FingerprintCollision,
    SFAStats,
    StateBlowup,
    construct_sfa_jax,
)

__all__ = ["construct_sfa_jax"]
