"""Parallelize a left fold by lifting each step into a monoid (paper §I).

An SFA state *is* the lifted element — the transition function of a string
chunk — and combining chunk results by function composition is the monoid
reduce. The port carries the function monoid and its three execution
strategies: the sequential ``reduce`` the scan engine folds its chunk
functions with, and the inclusive and exclusive ``scan``s behind
``locate``'s entry states and ``census_windows``' sliding windows.

The function monoid's combine is the ``compose`` kernel
(``kernels/csrc/compose.cu`` for CUDA tensors, its plain ``torch.gather``
version for CPU tensors), so every reduce and scan here runs on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Monoid:
    """An associative combine with identity.

    ``combine(a, b)`` means "a happens first, then b" — order matters for
    function composition. ``identity(like)`` builds the identity element
    shaped like one element.
    """

    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: Callable[[torch.Tensor], torch.Tensor]
    name: str = "monoid"


def function_monoid(compose=None) -> Monoid:
    """Elements: int32 mapping vectors ``f`` of shape (..., n);
    ``combine(f, g)[..., q] = g[..., f[..., q]]`` (apply f, then g).

    ``compose`` is the (B, n) x (B, n) -> (B, n) combine the elements are
    flattened to: ``kernels.ops.compose`` by default; ``chip_smoke.py``
    passes the plain version to run a path without the kernel.
    """

    def combine(f, g):
        fn = compose
        if fn is None:
            # Imported here: kernels.ops -> kernels.ref -> core.fingerprint
            # would otherwise import in a cycle with this package.
            from ..kernels import ops

            fn = ops.compose
        f, g = torch.broadcast_tensors(f, g)
        shape = f.shape
        n = shape[-1]
        # reshape materialises broadcast identities and strided slices.
        out = fn(f.reshape(-1, n).contiguous(), g.reshape(-1, n).contiguous())
        return out.view(shape)

    def identity(like):
        n = like.shape[-1]
        ident = torch.arange(n, dtype=like.dtype, device=like.device)
        return ident.expand(like.shape)

    return Monoid(combine, identity, "function_composition")


def reduce(monoid: Monoid, xs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sequential left fold of ``xs`` along ``axis`` (cheap when the chunk
    count is small) — the same combine order as the reference's scan."""
    moved = torch.movedim(xs, axis, 0)
    out = moved[0]
    for i in range(1, moved.shape[0]):
        out = monoid.combine(out, moved[i])
    return out


def scan(monoid: Monoid, xs: torch.Tensor, axis: int = 0,
         reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix-combine along ``axis``: element ``i`` is the combine
    of elements ``0 .. i`` in order. ``reverse=True`` scans from the end, as
    ``jax.lax.associative_scan(reverse=True)`` does: element ``i`` folds
    ``x[L-1], x[L-2], .., x[i]`` in that order (pair it with an
    argument-flipped monoid for suffix compositions).

    Log-depth (Hillis–Steele): step ``d = 1, 2, 4, ..`` combines every
    element with the one ``d`` before it, one batched combine per step. The
    grouping differs from the reference's, which is exact for an associative
    combine such as function composition.
    """
    x = torch.movedim(xs, axis, 0)
    if reverse:
        x = torch.flip(x, (0,))
    L = x.shape[0]
    d = 1
    while d < L:
        x = torch.cat([x[:d], monoid.combine(x[:-d], x[d:])])
        d *= 2
    if reverse:
        x = torch.flip(x, (0,))
    return torch.movedim(x, 0, axis)


def exclusive_scan(monoid: Monoid, xs: torch.Tensor,
                   axis: int = 0) -> torch.Tensor:
    """Exclusive prefix: element ``i`` is the combine of elements
    ``[0, i)``, the identity for ``i = 0`` — each chunk's entry function."""
    inclusive = torch.movedim(scan(monoid, xs, axis=axis), axis, 0)
    first = monoid.identity(inclusive[:1])
    return torch.movedim(torch.cat([first, inclusive[:-1]]), 0, axis)
