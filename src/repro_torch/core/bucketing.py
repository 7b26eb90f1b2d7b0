"""Size-bucketing: one shared partition helper for matchers and construction.

Padded bank execution charges every pattern the widest pattern's row cost —
``n_max``-wide gathers at match time, ``n_max``-wide frontier rows and
fingerprint words at construction time. Real signature sets span two orders
of magnitude in DFA size, so both subsystems split a bank into size buckets
before padding. The partition logic lives here, once:

* :func:`partition_by_size` — group item indices by the smallest edge that
  holds them (the matcher's ``bucket_by_size`` and the Scanner's group
  partition are both thin wrappers over it);
* :func:`geometric_edges` — the default construction edge ladder (powers of
  ``growth`` from ``start``), giving O(log n_max) buckets;
* :func:`merge_small_buckets` — collapse undersized buckets into their
  neighbors so a batched closure never pays a compiled round shape for a
  near-empty bucket (padding waste is bounded by the edge ladder; dispatch
  waste is bounded by the merge floor).

Buckets come back smallest edge first, preserving input order within each
bucket — the stable layout every caller relies on to scatter per-item
results back to the original order.
"""

from __future__ import annotations

from typing import Sequence

#: Overflow policies of :func:`partition_by_size`.
OVERFLOWS = ("raise", "extend")


def geometric_edges(max_size: int, *, start: int = 8,
                    growth: int = 2) -> tuple:
    """The default size-edge ladder: ``start, start·growth, …`` up to the
    first edge holding ``max_size`` — O(log(max_size)) buckets.

    ``start`` keeps tiny sizes together (a 3-state and a 7-state pattern
    share a bucket; splitting them buys nothing but round dispatches).
    """
    if max_size < 1:
        raise ValueError(f"max_size must be >= 1, got {max_size}")
    if start < 1 or growth < 2:
        raise ValueError(
            f"start must be >= 1 and growth >= 2, got start={start}, "
            f"growth={growth}"
        )
    edges = [start]
    while edges[-1] < max_size:
        edges.append(edges[-1] * growth)
    return tuple(edges)


def partition_by_size(sizes: Sequence[int], edges: Sequence[int], *,
                      overflow: str = "raise") -> list:
    """Group item indices by the smallest edge that holds their size.

    -> ``[(edge, [indices…]), …]``, smallest edge first, only non-empty
    buckets, input order preserved within each bucket. An item larger than
    every edge either raises (``overflow="raise"``, the matcher contract) or
    lands in a final ``float("inf")`` bucket (``overflow="extend"``, the
    Scanner/overflow contract).
    """
    if not edges:
        raise ValueError("partition_by_size needs at least one edge")
    if overflow not in OVERFLOWS:
        raise ValueError(
            f"overflow must be one of {OVERFLOWS}, got {overflow!r}"
        )
    sorted_edges = sorted(edges)
    buckets: dict = {}
    for i, sz in enumerate(sizes):
        for e in sorted_edges:
            if sz <= e:
                buckets.setdefault(e, []).append(i)
                break
        else:
            if overflow == "raise":
                raise ValueError(
                    f"item {i} has size {sz} > max edge {sorted_edges[-1]}"
                )
            buckets.setdefault(float("inf"), []).append(i)
    return sorted(buckets.items(), key=lambda kv: kv[0])


def merge_small_buckets(parts: list, min_count: int) -> list:
    """Collapse buckets holding fewer than ``min_count`` items.

    An undersized bucket merges into its next-*larger* neighbor (its items
    were already paying at most that padding before bucketing existed);
    an undersized largest bucket merges downward instead, which widens the
    receiving bucket's edge to its own. Repeats until every bucket holds
    ``min_count`` items — or only one bucket remains (the unbucketed bank).
    Input and output have the :func:`partition_by_size` shape; item order
    within merged buckets stays size-ladder order (smaller bucket's items
    keep preceding larger ones only when merging upward — downward merges
    append the big items after, preserving each side's internal order).
    """
    if min_count < 1:
        raise ValueError(f"min_count must be >= 1, got {min_count}")
    parts = [(e, list(idx)) for e, idx in parts if idx]
    while len(parts) > 1:
        victim = next(
            (j for j, (_, idx) in enumerate(parts) if len(idx) < min_count),
            None,
        )
        if victim is None:
            break
        if victim + 1 < len(parts):      # merge upward into the wider bucket
            edge, items = parts[victim + 1]
            merged = (edge, parts[victim][1] + items)
            parts[victim:victim + 2] = [merged]
        else:                            # largest bucket: widen the one below
            edge = parts[victim][0]
            merged = (edge, parts[victim - 1][1] + parts[victim][1])
            parts[victim - 1:victim + 1] = [merged]
    return parts
