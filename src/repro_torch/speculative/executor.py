"""The speculative executor: an m-lane chunk pass, then validate and repair.

Enumeration resolves a chunk's transition function for *all* ``n`` states
because it cannot know the chunk's entry state before its predecessor
finishes. Speculation (1210.5093 / PaREM 1412.1741) runs every chunk from
``m`` *likely* entry states instead, then walks the chunks once to check
each chunk's true entry state (its predecessor's exact exit) against the
speculated set: a hit adopts that lane's exit, a miss re-walks the chunk
from its now-known entry, at most ``max_rounds`` times per lane, and a lane
the bound leaves unresolved is reported for the caller's enumeration
fallback.

On the card that is two launches:

1. the m-lane pass, :func:`~..kernels.ops.match_bank_chunks` with explicit
   ``starts`` (the hot-state profile), over the corpus viewed as
   ``(D·C, L/C)`` chunks: its ``(P, D·C, m)`` output is the reference's
   ``exits (P, D, C, m)`` with no copy;
2. :func:`~..kernels.ops.spec_resolve`, one thread per (pattern, doc) lane
   walking the C chunks in order, with the totals read back in one sync.

:func:`distributed_speculative_finals_fn` runs the same two launches on
each rank's slice of the documents of a mesh.

The results equal the reference's ``speculative_bank_finals`` on all five
outputs; ``kernels/ref.py::spec_resolve`` runs the reference's rounds
literally and is the plain version of step 2.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..kernels import ops
from ..mesh import all_gather, all_reduce, local_shard


@dataclass(frozen=True)
class SpeculationStats:
    """What one speculative scan actually did.

    ``total_chunks`` counts every (pattern, doc, chunk) cell the executor
    resolved; ``hit_chunks`` of those were settled by speculation alone and
    ``repaired_chunks`` by targeted re-scans (on a fully resolved scan,
    ``hit_chunks + repaired_chunks == total_chunks``). ``repair_rounds`` is
    the deepest validate/repair iteration count any executor invocation
    needed (0 when every chunk's entry was speculated), and
    ``fallback_lanes`` counts (pattern, doc) lanes the round bound left for
    the enumeration fallback — still bit-identical, just not cheap.
    """

    total_chunks: int = 0
    hit_chunks: int = 0
    repaired_chunks: int = 0
    repair_rounds: int = 0
    fallback_lanes: int = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of chunks settled by speculation alone (1.0 when empty)."""
        if not self.total_chunks:
            return 1.0
        return self.hit_chunks / self.total_chunks

    @classmethod
    def of(cls, outputs: tuple, total_chunks: int) -> "SpeculationStats":
        """The stats of one :func:`speculative_bank_finals` result (its
        five outputs), read back in one host sync."""
        _, resolved, hits, repaired, rounds = outputs
        hits, repaired, rounds, fallback = torch.stack(
            [hits, repaired, rounds, (~resolved).sum()]).tolist()
        return cls(total_chunks=total_chunks, hit_chunks=hits,
                   repaired_chunks=repaired, repair_rounds=rounds,
                   fallback_lanes=fallback)

    def merged(self, other: "SpeculationStats") -> "SpeculationStats":
        """Combine stats across pattern groups / length batches of one scan."""
        return replace(
            self,
            total_chunks=self.total_chunks + other.total_chunks,
            hit_chunks=self.hit_chunks + other.hit_chunks,
            repaired_chunks=self.repaired_chunks + other.repaired_chunks,
            repair_rounds=max(self.repair_rounds, other.repair_rounds),
            fallback_lanes=self.fallback_lanes + other.fallback_lanes,
        )


def speculative_bank_finals(tables: torch.Tensor, spec_states: torch.Tensor,
                            starts: torch.Tensor, corpus: torch.Tensor,
                            n_chunks: int = 8, max_rounds: int = 8, *,
                            match_fn=None, resolve_fn=None) -> tuple:
    """Speculative final states of every (pattern, doc).

    ``tables`` (P, n, k) padded enumeration tables; ``spec_states`` (P, m)
    speculated boundary states (a hot-state profile stack); ``starts``
    (P,); ``corpus`` (D, L) with ``L`` divisible by ``n_chunks`` — int32
    tensors on one device.

    -> ``(finals (P, D) int32, resolved (P, D) bool, hit_chunks, repaired,
    rounds)``, the last three 0-d int64 tensors. ``finals[p, d]`` is
    **exact** wherever ``resolved[p, d]``; callers must recompute
    unresolved lanes (the enumeration fallback in ``Scanner``), whose
    finals hold their last verified state. ``match_fn`` / ``resolve_fn``
    swap in functions of the same signature as
    :func:`~..kernels.ops.match_bank_chunks` /
    :func:`~..kernels.ops.spec_resolve`, such as their plain versions.
    """
    match_fn = match_fn or ops.match_bank_chunks
    resolve_fn = resolve_fn or ops.spec_resolve
    D, L = corpus.shape
    if L % n_chunks:
        raise ValueError(f"corpus length {L} is not a multiple of "
                         f"n_chunks={n_chunks}")
    chunks = corpus.contiguous().view(D * n_chunks, L // n_chunks)
    spec = spec_states.contiguous()
    exits = match_fn(tables, chunks, spec.shape[1], spec)   # (P, D·C, m)
    return resolve_fn(tables, spec, starts.contiguous(), exits, chunks,
                      n_chunks, max_rounds)


def distributed_speculative_finals_fn(mesh, data_axis: str = "data",
                                      n_chunks: int = 8,
                                      max_rounds: int = 8):
    """The Scanner's ``shard_map`` path for speculative mode: docs shard
    over ``data_axis`` of ``mesh`` (tables and profiles replicated), each
    rank runs the whole local validate-and-repair on its docs — no
    collective inside it, so the ranks' repair depths may differ — then
    ``finals``/``resolved`` gather on the doc axis and the counters combine
    (a sum of the hit and repaired counts, the max of the rounds). ->
    ``fn(tables, spec_states, starts, corpus)`` with the output contract of
    :func:`speculative_bank_finals`, the same on every rank."""

    def fn(tables, spec_states, starts, corpus):
        shard = local_shard(corpus, mesh, data_axis, what="doc count")
        finals, resolved, hits, repaired, rounds = speculative_bank_finals(
            tables, spec_states, starts, shard, n_chunks, max_rounds)
        hits, repaired = all_reduce(torch.stack([hits, repaired]), mesh,
                                    data_axis, "sum")
        return (all_gather(finals, mesh, data_axis, dim=1),
                all_gather(resolved, mesh, data_axis, dim=1),
                hits, repaired, all_reduce(rounds, mesh, data_axis, "max"))

    return fn
