"""Parallelize a left fold by lifting each step into a monoid (paper §I).

An SFA state *is* the lifted element — the transition function of a string
chunk — and combining chunk results by function composition is the monoid
reduce. This slice of the port carries the function monoid and the
sequential ``reduce`` the scan engine folds its chunk functions with; that
fold runs outside any kernel in the reference too, so plain ``torch.gather``
is the whole implementation.
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


def function_monoid() -> Monoid:
    """Elements: mapping vectors ``f`` of shape (..., n), integer dtype;
    ``combine(f, g)[..., q] = g[..., f[..., q]]`` (apply f, then g)."""

    def combine(f, g):
        return torch.gather(g, -1, f.to(torch.int64))

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
