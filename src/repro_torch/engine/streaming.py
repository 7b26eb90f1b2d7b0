"""Streaming input: one input far larger than memory, fed in pieces.

The matching algorithm needs only each chunk's transition function and an
associative combine, so the input need not be resident. A
:class:`StreamSession` takes pieces (strings or encoded int arrays) of one
logically concatenated input, buffers them into fixed-shape blocks of
``n_chunks * block_len`` symbols, runs the full blocks of each piece through
the plan's chunk matcher on the scanner's device (``match_bank_chunks`` for
both scan modes), and folds their transition functions, in order, into a
running function-monoid prefix that stays on the device: one ``compose``
launch per piece and group folds the prefix and all the piece's blocks (the
SFA path's chunk fold is one more). Memory holds one piece plus the
``(P, n)`` prefix, whatever the input's length.

``StreamSession.finish()`` composes the ragged tail symbol by symbol and
returns a :class:`StreamResult` whose mapping is bit-identical to
``Scanner.mapping`` of the concatenated input.

Speculative groups carry exact running *states* instead of whole functions:
each block is one document whose start states are the stream's current
states. A piece's blocks take one m-lane chunk walk together and one
chained ``spec_resolve`` launch (``ops.spec_resolve_chain``): each block
starts where the one before it ends, and a lane the repair bound leaves
unresolved is walked on exactly, as the reference falls back to the
block's enumeration mapping at its entry state. The stats stay on the
device until ``finish()`` reads them in one sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from ..kernels import ops
from ..speculative import SpeculationStats
from . import executors as X

if TYPE_CHECKING:  # pragma: no cover
    from .scanner import PatternGroup, Scanner


@dataclass(frozen=True)
class StreamResult:
    """Outcome of a streamed scan over one concatenated input.

    ``mapping`` is the input's whole transition function, (P, n_max) on
    the scanner's padded layout — ``None`` when any pattern group ran
    speculatively: the speculative executor tracks exact *states*, not whole
    functions (that is the saving). ``final_states`` is the state each
    pattern ends in; ``accepted`` its accept flag; ``speculation`` the
    stream's aggregated :class:`~..speculative.SpeculationStats` (None
    without speculation).
    """

    mapping: np.ndarray | None  # (P, n_max) — None under speculation
    final_states: np.ndarray    # (P,)
    accepted: np.ndarray        # (P,) bool
    n_symbols: int
    ids: tuple
    single: bool = False
    speculation: Any = None

    @property
    def accepts(self):
        """bool for a single-pattern scanner, (P,) bool for a bank."""
        return bool(self.accepted[0]) if self.single else self.accepted


class StreamSession:
    """Incremental (push-style) scan; create with ``Scanner.open_stream()``."""

    def __init__(self, scanner: "Scanner"):
        self.scanner = scanner
        pol = scanner.plan.chunking
        self.n_chunks = pol.n_chunks
        self.block_len = pol.block_len
        self.super_len = self.n_chunks * self.block_len
        self._buf = np.zeros(0, dtype=np.int32)
        self._n_symbols = 0
        self._finished = False
        # Running prefix per group: the function-monoid fold of everything
        # consumed so far, on the scanner's device.
        self._prefix = [
            torch.arange(g.n, dtype=torch.int32, device=scanner.device)
            .expand(len(g.indices), g.n).contiguous()
            for g in scanner.groups
        ]
        # Speculative groups carry exact running states instead, (Pg,)
        # int32 on the device, and their hot-state profile, resolved from
        # the first block.
        self._state = [
            g.starts.to(torch.int32) if g.mode == "speculative" else None
            for g in scanner.groups
        ]
        self._spec_prof = [None] * len(scanner.groups)
        # The speculative blocks' stats: the chunks they held, and on the
        # device [hit_chunks, repaired, rounds, fallback_lanes] merged over
        # pieces and groups (None before the first block).
        self._spec_chunks = 0
        self._spec_totals: torch.Tensor | None = None
        self._has_spec = any(g.mode == "speculative" for g in scanner.groups)

    # -- feeding ------------------------------------------------------------

    def feed(self, piece) -> None:
        """Append one piece of the input (str or 1-D int array)."""
        if self._finished:
            raise RuntimeError("stream already finished")
        sc = self.scanner
        enc = (sc.encode(piece) if isinstance(piece, str)
               else np.asarray(piece, dtype=np.int32))
        if enc.ndim != 1:
            raise ValueError("stream pieces must be 1-D (one input's symbols)")
        if enc.size and (enc.min() < 0 or enc.max() >= sc.n_symbols):
            raise ValueError(
                f"stream symbols must lie in [0, {sc.n_symbols})")
        self._n_symbols += len(enc)
        self._buf = np.concatenate([self._buf, enc]) if len(self._buf) else enc
        if len(self._buf) < self.super_len:
            return
        n_full = len(self._buf) // self.super_len
        blocks = self._buf[: n_full * self.super_len].reshape(
            n_full, self.super_len)
        self._buf = self._buf[n_full * self.super_len:]
        self._advance(blocks)

    def _advance(self, blocks: np.ndarray) -> None:
        """Fold full (n_chunks * block_len) blocks, in order, into the
        prefix. The blocks of one piece go through the chunk matcher in one
        call, as the documents of a scan do."""
        sc = self.scanner
        blocks_t = torch.as_tensor(blocks, device=sc.device)
        for gi, g in enumerate(sc.groups):
            if g.mode == "speculative":
                self._advance_speculative(gi, g, blocks, blocks_t)
                continue
            if sc.plan.backend == "reference":
                from .scanner import _reference_doc_mappings

                bm = torch.as_tensor(
                    _reference_doc_mappings(g.bank.tables, blocks),
                    device=sc.device)
            elif g.mode == "sfa":
                bm = X.bank_doc_mappings_sfa(g.deltas, g.sfa_maps, blocks_t,
                                             self.n_chunks)
            else:
                bm = X.bank_doc_mappings(g.tables, blocks_t, self.n_chunks)
            # Apply the prefix first, then the blocks in order: one fold.
            self._prefix[gi] = X.FN.fold(self._prefix[gi], bm)

    def _advance_speculative(self, gi: int, g: "PatternGroup",
                             blocks: np.ndarray, blocks_t: torch.Tensor
                             ) -> None:
        """Advance a speculative group's exact running states through full
        blocks, in order: each block is one document whose start states are
        the stream's current states. The hot-state profile is resolved once
        per session, from the first block (it is advisory; staleness only
        costs repairs)."""
        sc = self.scanner
        pol = sc.plan.speculation
        prof = self._spec_prof[gi]
        if prof is None:
            prof = torch.as_tensor(sc._speculation_profile(g, blocks[:1]),
                                   device=sc.device)
            self._spec_prof[gi] = prof
        chunks = blocks_t.view(-1, self.block_len)     # (n_blocks·C, Lc)
        exits = ops.match_bank_chunks(g.tables, chunks, prof.shape[1], prof)
        self._state[gi], totals = ops.spec_resolve_chain(
            g.tables, prof, self._state[gi], exits, chunks, self.n_chunks,
            pol.max_repair_rounds)
        self._spec_chunks += len(g.indices) * chunks.shape[0]
        acc = self._spec_totals
        if acc is None:
            self._spec_totals = totals
        else:      # as SpeculationStats.merged: sums, the rounds' maximum
            self._spec_totals = acc + totals
            self._spec_totals[2] = torch.maximum(acc[2], totals[2])

    # -- finishing ----------------------------------------------------------

    def finish(self) -> StreamResult:
        """Compose the ragged tail, read off accepts, and close the stream."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._finished = True
        sc = self.scanner
        if len(self._buf):
            tail = torch.as_tensor(self._buf, device=sc.device)
            for gi, g in enumerate(sc.groups):
                if g.mode == "speculative":
                    self._state[gi] = X.advance_states_sequential(
                        g.tables, self._state[gi][:, None], tail[None])[:, 0]
                    continue
                # Each of the n prefix entries is a state walking the tail.
                n = self._prefix[gi].shape[1]
                self._prefix[gi] = X.advance_states_sequential(
                    g.tables, self._prefix[gi], tail.expand(n, len(tail)))
            self._buf = np.zeros(0, dtype=np.int32)

        mapping = None if self._has_spec else np.broadcast_to(
            np.arange(sc.n_max, dtype=np.int32), (sc.n_patterns, sc.n_max)
        ).copy()
        final_states = np.zeros(sc.n_patterns, dtype=np.int32)
        accepted = np.zeros(sc.n_patterns, dtype=bool)
        for gi, g in enumerate(sc.groups):
            if g.mode == "speculative":
                finals = self._state[gi][:, None]
            else:
                pref = self._prefix[gi]                      # (Pg, n_g)
                if mapping is not None:
                    mapping[g.indices, : g.n] = pref.cpu().numpy()
                finals = pref.gather(1, g.starts.to(torch.int64)[:, None])
            accepted[g.indices] = g.accepting.gather(
                1, finals.to(torch.int64))[:, 0].cpu().numpy()
            final_states[g.indices] = finals[:, 0].cpu().numpy()
        stats = None
        if self._spec_totals is not None:
            hits, repaired, rounds, fallback = self._spec_totals.tolist()
            stats = SpeculationStats(
                total_chunks=self._spec_chunks, hit_chunks=hits,
                repaired_chunks=repaired, repair_rounds=rounds,
                fallback_lanes=fallback)
        sc.last_speculation = stats or sc.last_speculation
        return StreamResult(
            mapping=mapping,
            final_states=final_states,
            accepted=accepted,
            n_symbols=self._n_symbols,
            ids=sc.ids,
            single=sc.single,
            speculation=stats,
        )
