"""Parallelize a left fold by lifting each step into a monoid (paper §I).

An SFA state *is* the lifted element — the transition function of a string
chunk — and combining chunk results by function composition is the monoid
reduce. The same machinery parallelizes the LM half's recurrences:

* ``function_monoid`` — finite-function composition (SFA matching);
* ``affine_monoid``   — diagonal affine maps ``h' = a·h + b`` (mamba2's
  inter-chunk recurrence, RG-LRU);
* ``softmax_monoid``  — flash-attention's partial-softmax ``(m, s, o)``.

An element is one tensor (the function monoid) or a tuple of tensors (the
other two). The execution strategies are the sequential ``reduce`` the
scan engine folds its chunk functions with, and the inclusive and
exclusive ``scan``s behind ``locate``'s entry states and the recurrences
(``census_windows``' sliding windows scan in place instead:
``engine/executors.py::_window_compositions``).

The function monoid's combine and fold are the ``compose`` kernel
(``kernels/csrc/compose.cu`` for CUDA tensors, its plain ``torch.gather``
versions for CPU tensors), so every reduce and scan of it runs on that
kernel: a scan one launch per log-depth step, a reduce one launch in all.
The affine and softmax monoids are plain elementwise PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

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

    combine: Callable[[Any, Any], Any]
    identity: Callable[[Any], Any]
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


def affine_monoid() -> Monoid:
    """Elements: pairs ``(a, b)`` of float tensors representing
    ``h' = a * h + b`` elementwise (``a`` may broadcast against ``b``);
    ``combine((a1, b1), (a2, b2)) = (a2 * a1, a2 * b1 + b2)``."""

    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return a2 * a1, a2 * b1 + b2

    def identity(like):
        a, b = like
        return torch.ones_like(a), torch.zeros_like(b)

    return Monoid(combine, identity, "affine")


def softmax_monoid() -> Monoid:
    """Elements: ``(m, s, o)`` — running max, unnormalized denominator and
    unnormalized weighted sum of a chunk of attention scores; the output is
    ``o / s``. Associative and commutative."""

    def combine(x, y):
        m1, s1, o1 = x
        m2, s2, o2 = y
        m = torch.maximum(m1, m2)
        e1 = torch.exp(m1 - m)
        e2 = torch.exp(m2 - m)
        return m, s1 * e1 + s2 * e2, o1 * e1 + o2 * e2

    def identity(like):
        m, s, o = like
        return (torch.full_like(m, float("-inf")), torch.zeros_like(s),
                torch.zeros_like(o))

    return Monoid(combine, identity, "softmax")


def _tmap(fn, *trees):
    """``fn`` on each tensor of an element (a tensor or a tuple of them),
    the element's structure kept."""
    if isinstance(trees[0], (tuple, list)):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


def _first_leaf(x) -> torch.Tensor:
    return x[0] if isinstance(x, (tuple, list)) else x


def reduce(monoid: Monoid, xs, axis: int = 0):
    """Left fold of ``xs`` along ``axis`` — the same combine order as the
    reference's ``lax.scan``. A one-tensor element of a monoid with a fold
    folds in one ``monoid.fold`` (the function monoid's is one ``compose``
    launch); otherwise the elements are combined one after another."""
    if monoid.fold is not None and not isinstance(xs, (tuple, list)):
        return monoid.fold(None, torch.movedim(xs, axis, -2))
    moved = _tmap(lambda x: torch.movedim(x, axis, 0), xs)
    out = _tmap(lambda x: x[0], moved)
    for i in range(1, _first_leaf(moved).shape[0]):
        out = monoid.combine(out, _tmap(lambda x: x[i], moved))
    return out


def scan(monoid: Monoid, xs, axis: int = 0, reverse: bool = False):
    """Inclusive prefix-combine along ``axis``: element ``i`` is the combine
    of elements ``0 .. i`` in order. ``reverse=True`` scans from the end, as
    ``jax.lax.associative_scan(reverse=True)`` does: element ``i`` folds
    ``x[L-1], x[L-2], .., x[i]`` in that order (pair it with an
    argument-flipped monoid for suffix compositions).

    Log-depth (Hillis–Steele): step ``d = 1, 2, 4, ..`` combines every
    element with the one ``d`` before it, one batched combine per step. The
    grouping differs from the reference's: exact for an exact associative
    combine such as function composition, within float rounding for the
    affine and softmax monoids.
    """
    x = _tmap(lambda t: torch.movedim(t, axis, 0), xs)
    if reverse:
        x = _tmap(lambda t: torch.flip(t, (0,)), x)
    L = _first_leaf(x).shape[0]
    d = 1
    while d < L:
        step = monoid.combine(_tmap(lambda t: t[:-d], x),
                              _tmap(lambda t: t[d:], x))
        x = _tmap(lambda t, c: torch.cat([t[:d], c]), x, step)
        d *= 2
    if reverse:
        x = _tmap(lambda t: torch.flip(t, (0,)), x)
    return _tmap(lambda t: torch.movedim(t, 0, axis), x)


def exclusive_scan(monoid: Monoid, xs, axis: int = 0):
    """Exclusive prefix: element ``i`` is the combine of elements
    ``[0, i)``, the identity for ``i = 0`` — each chunk's entry function.
    The identity is shaped like a length-1 slice of ``xs``, as in the
    reference."""
    inclusive = scan(monoid, xs, axis=axis)
    ident = monoid.identity(_tmap(lambda x: x.narrow(axis, 0, 1), xs))
    return _tmap(
        lambda inc, idn: torch.cat(
            [idn, inc.narrow(axis, 0, inc.shape[axis] - 1)], dim=axis),
        inclusive, ident)


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
