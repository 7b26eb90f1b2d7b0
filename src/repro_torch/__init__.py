"""PyTorch/CUDA port of the SFA construction and scan system.

The JAX package ``repro`` is the reference; this package computes the same
exact integer results (state ids, u32 fingerprints, mapping vectors) with
PyTorch around three hand-written CUDA kernels (``kernels/csrc``). It never
imports ``jax`` or ``repro``: the host-side NumPy modules it needs are its
own copies under the same module names.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
asking for CUDA where there is no card raises.
"""

__all__ = ["resolve_device"]

from .device import resolve_device
