"""Parallelize a left fold by lifting each step into a monoid (paper §I).

An SFA state *is* the lifted element — the transition function of a string
chunk — and combining chunk results by function composition is the monoid
reduce. The port carries the function monoid and its three execution
strategies: the sequential ``reduce`` the scan engine folds its chunk
functions with, and the inclusive and exclusive ``scan``s behind
``locate``'s entry states and ``census_windows``' sliding windows.

The function monoid's combine and fold are the ``compose`` kernel
(``kernels/csrc/compose.cu`` for CUDA tensors, its plain ``torch.gather``
versions for CPU tensors), so every reduce and scan here runs on it: a
scan one launch per log-depth step, a reduce one launch in all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..mesh import all_gather, axis_rank


@dataclass(frozen=True)
class Monoid:
    """An associative combine with identity.

    ``combine(a, b)`` means "a happens first, then b" — order matters for
    function composition. ``identity(like)`` builds the identity element
    shaped like one element. ``fold(first, xs)``, where a monoid has one,
    combines ``first`` (shaped like one element of ``xs``, or ``None`` for
    the identity) with the elements stacked along ``xs``'s second-to-last
    axis, in order, at once; :func:`reduce` uses it.
    """

    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: Callable[[torch.Tensor], torch.Tensor]
    name: str = "monoid"
    fold: Callable | None = None


def function_monoid(kernels=None) -> Monoid:
    """Elements: int32 mapping vectors ``f`` of shape (..., n);
    ``combine(f, g)[..., q] = g[..., f[..., q]]`` (apply f, then g).

    ``kernels`` provides ``compose`` ((B, n) x (B, n) -> (B, n)) and
    ``compose_fold`` (f (B, n) or None, gs (B, m, n) -> (B, n)), to which
    the elements are flattened: ``kernels.ops`` by default, the ``compose``
    kernel in both forms; ``chip_smoke.py`` passes ``kernels.ref`` to run a
    path on the plain versions.
    """

    def impl():
        if kernels is not None:
            return kernels
        # Imported here: kernels.ops -> kernels.ref -> core.fingerprint
        # would otherwise import in a cycle with this package.
        from ..kernels import ops

        return ops

    def combine(f, g):
        f, g = torch.broadcast_tensors(f, g)
        shape = f.shape
        n = shape[-1]
        # reshape materialises broadcast identities and strided slices.
        out = impl().compose(f.reshape(-1, n).contiguous(),
                             g.reshape(-1, n).contiguous())
        return out.view(shape)

    def fold(first, xs):
        lead, (m, n) = xs.shape[:-2], xs.shape[-2:]
        if first is not None:
            first = first.reshape(-1, n).contiguous()
        return impl().compose_fold(
            first, xs.reshape(-1, m, n).contiguous()).view(*lead, n)

    def identity(like):
        n = like.shape[-1]
        ident = torch.arange(n, dtype=like.dtype, device=like.device)
        return ident.expand(like.shape)

    return Monoid(combine, identity, "function_composition", fold)


def reduce(monoid: Monoid, xs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Left fold of ``xs`` along ``axis`` — the same combine order as the
    reference's ``lax.scan`` — in one ``monoid.fold`` (the function
    monoid's is one ``compose`` launch). The monoid must have a fold."""
    return monoid.fold(None, torch.movedim(xs, axis, -2))


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


def shard_reduce(monoid: Monoid, x_local: torch.Tensor, mesh,
                 axis_name: str) -> torch.Tensor:
    """Combine one element a rank along a mesh axis, in rank order: one
    ``all_gather`` of the lifted elements (an SFA mapping is n ints), then a
    local fold (paper §IV-C at pod scale). -> the total combine, the same
    on every rank of the axis."""
    return reduce(monoid, all_gather(x_local[None], mesh, axis_name), axis=0)


def shard_exclusive_scan(monoid: Monoid, x_local: torch.Tensor, mesh,
                         axis_name: str) -> torch.Tensor:
    """Exclusive prefix-combine across a mesh axis: rank ``i`` receives the
    combine of ranks ``[0, i)``'s elements (the identity on rank 0) — the
    entry functions of distributed matching."""
    gathered = all_gather(x_local[None], mesh, axis_name)
    return exclusive_scan(monoid, gathered, axis=0)[axis_rank(mesh,
                                                              axis_name)]
