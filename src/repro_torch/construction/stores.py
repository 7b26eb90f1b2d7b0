"""Pluggable state stores: membership + id assignment for discovered states.

The worklist closure (paper Alg. 1) is identical across every engine; what
differs is how "have we seen this transition-function vector before?" is
answered. That policy lives here, behind two small interfaces:

* scalar stores (one candidate at a time — the faithful sequential engine,
  host NumPy and Python as in the reference):

  - :class:`ExhaustiveStore`   — the paper's baseline: exact vector compare
    against every known state, O(|Q|·|Q_s|) per test;
  - :class:`FingerprintScanStore` — linear scan over 64-bit fingerprints,
    exact compare only on fingerprint equality (paper §III-A, fp only);
  - :class:`HashChainStore`    — dict keyed by fingerprint with exact-compare
    collision chains: the paper's hash table, O(1) expected.

* a bulk store (whole frontier × alphabet at once, on the construction's
  device):

  - :class:`SortedFingerprintStore` — membership is fingerprint
    ``searchsorted`` against the sorted known set, the bulk equivalent of the
    hash table; candidate tiles are fingerprinted by the ``fingerprint``
    kernel (``kernels/csrc/fingerprint.cu`` on the card), fingerprint hits
    are confirmed with exact vector compares and any mismatch raises
    :class:`~.types.FingerprintCollision`.

All stores share one exactness contract: equal fingerprints never merge
states silently, so the closure always yields the exact SFA (or raises).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.fingerprint import (
    BarrettConstants,
    fingerprint_int,
    fold_weights_u32,
    limbs_of,
    pack_states_np,
    pack_states_u32,
    u32_to_i32,
)
from ..kernels import ops as kernel_ops
from .types import FingerprintCollision, SFAStats


# --------------------------------------------------------------------------
# Scalar stores (sequential engine)
# --------------------------------------------------------------------------


class ExhaustiveStore:
    """Baseline membership: exact comparison against all known states."""

    def __init__(self, stats: SFAStats):
        self.stats = stats
        self.mappings: list = []

    def __len__(self) -> int:
        return len(self.mappings)

    def lookup_or_add(self, vec: np.ndarray) -> tuple:
        """-> (state id, is_new)."""
        for i, m in enumerate(self.mappings):
            self.stats.exact_compares += 1
            if np.array_equal(m, vec):
                return i, False
        return self._append(vec), True

    def _append(self, vec: np.ndarray) -> int:
        self.mappings.append(np.asarray(vec, dtype=np.int32))
        return len(self.mappings) - 1

    def fingerprint_pairs(self) -> np.ndarray:
        return np.zeros((len(self.mappings), 2), dtype=np.uint32)


class _FingerprintedStore(ExhaustiveStore):
    """Shared fingerprint bookkeeping for the fp-based scalar stores."""

    def __init__(self, stats: SFAStats, consts: BarrettConstants):
        super().__init__(stats)
        self.consts = consts
        self.fps: list = []

    def fp_of(self, vec: np.ndarray) -> int:
        return fingerprint_int(pack_states_np(vec), self.consts)

    def _append_fp(self, vec: np.ndarray, fp: int) -> int:
        idx = self._append(vec)
        self.fps.append(fp)
        return idx

    def fingerprint_pairs(self) -> np.ndarray:
        out = np.zeros((len(self.fps), 2), dtype=np.uint32)
        for i, f in enumerate(self.fps):
            out[i, 0] = (f >> 32) & 0xFFFFFFFF
            out[i, 1] = f & 0xFFFFFFFF
        return out


class FingerprintScanStore(_FingerprintedStore):
    """Fingerprints without hashing: linear 64-bit scan, exact confirm."""

    def lookup_or_add(self, vec: np.ndarray) -> tuple:
        f = self.fp_of(vec)
        for i, fi in enumerate(self.fps):
            self.stats.fp_compares += 1
            if fi == f:
                self.stats.exact_compares += 1
                if np.array_equal(self.mappings[i], vec):
                    return i, False
                self.stats.collisions_detected += 1
        return self._append_fp(vec, f), True


class HashChainStore(_FingerprintedStore):
    """The paper's hash table: dict keyed by fingerprint, exact-chain."""

    def __init__(self, stats: SFAStats, consts: BarrettConstants):
        super().__init__(stats, consts)
        self.table: dict = {}

    def lookup_or_add(self, vec: np.ndarray) -> tuple:
        f = self.fp_of(vec)
        chain = self.table.setdefault(f, [])
        self.stats.fp_compares += 1
        for i in chain:
            self.stats.exact_compares += 1
            if np.array_equal(self.mappings[i], vec):
                return i, False
            self.stats.collisions_detected += 1
        idx = self._append_fp(vec, f)
        chain.append(idx)
        return idx, True


# --------------------------------------------------------------------------
# Bulk store (vectorized frontier engine), on the device
# --------------------------------------------------------------------------


class SortedFingerprintStore:
    """Bulk membership: fingerprint sort + ``searchsorted`` (the paper's
    hash table, restated for data-parallel hardware). Holds the growing
    known set as tensors on ``device``; candidates arrive a whole tile at a
    time.

    A fingerprint is kept as one int64 holding the u64 bits ``hi << 32 |
    lo``. Membership needs only a consistent order, so the signed order of
    int64 serves (torch sorts no uint64); state ids come from first
    occurrence, never from fingerprint order, so they equal the reference's
    whatever the order.
    """

    def __init__(self, stats: SFAStats, consts: BarrettConstants, n: int,
                 device):
        self.stats = stats
        self.device = torch.device(device)
        W = (n + 1) // 2
        self._weights = u32_to_i32(fold_weights_u32(W, consts,
                                                    device=self.device))
        self._limbs = u32_to_i32(torch.tensor(limbs_of(consts),
                                              dtype=torch.int64,
                                              device=self.device))
        identity = torch.arange(n, dtype=torch.int32, device=self.device)[None]
        self.mappings = identity                        # (S, n) int32
        self.fps = self._fp64(identity)                 # (S,) int64
        self.order = torch.argsort(self.fps, stable=True)

    def __len__(self) -> int:
        return int(self.mappings.shape[0])

    def _fp64(self, states: torch.Tensor) -> torch.Tensor:
        words = u32_to_i32(pack_states_u32(states)).contiguous()
        pair = kernel_ops.fingerprint(words, self._weights, self._limbs)
        return ((pair[:, 0].to(torch.int64) << 32)
                | (pair[:, 1].to(torch.int64) & 0xFFFFFFFF))

    def assign(self, cand: torch.Tensor) -> torch.Tensor:
        """Map candidate rows (m, n) int32 to SFA ids (m,) int32, appending
        unseen states in first-occurrence order. Raises
        :class:`FingerprintCollision` on any fp-equal-but-vector-unequal
        pair (against the known set or inside the tile)."""
        n_cand = cand.shape[0]
        cfps = self._fp64(cand)

        # --- membership test against the known set -------------------------
        sorted_fps = self.fps[self.order]
        pos = torch.searchsorted(sorted_fps, cfps)
        pos_c = pos.clamp(max=sorted_fps.shape[0] - 1)
        fp_hit = sorted_fps[pos_c] == cfps
        self.stats.fp_compares += n_cand
        known_idx = torch.where(fp_hit, self.order[pos_c], -1)

        hit_rows = torch.nonzero(fp_hit)[:, 0]
        if hit_rows.numel():
            self.stats.exact_compares += int(hit_rows.numel())
            exact = (cand[hit_rows] == self.mappings[known_idx[hit_rows]]
                     ).all(1)
            bad = int((~exact).sum())
            if bad:
                self.stats.collisions_detected += bad
                raise FingerprintCollision(
                    f"{bad} fingerprint collisions detected")

        ids = known_idx.clone()

        # --- dedup + append the genuinely new candidates -------------------
        new_rows = torch.nonzero(known_idx < 0)[:, 0]
        if new_rows.numel():
            new_fps = cfps[new_rows]
            # Groups of equal fingerprints from one stable sort: a group's
            # first sorted element is its first occurrence.
            sorted_new, perm = torch.sort(new_fps, stable=True)
            head = torch.ones_like(sorted_new, dtype=torch.bool)
            head[1:] = sorted_new[1:] != sorted_new[:-1]
            group = torch.cumsum(head.to(torch.int64), 0) - 1
            inverse = torch.empty_like(group).scatter_(0, perm, group)
            first_pos = perm[head]                      # (U,) per group
            # Exactness within the tile: all rows in an fp-group must equal
            # the group representative.
            reps = cand[new_rows[first_pos]]            # (U, n)
            same = (cand[new_rows] == reps[inverse]).all(1)
            bad = int((~same).sum())
            if bad:
                self.stats.collisions_detected += bad
                raise FingerprintCollision("intra-round fingerprint collision")
            # Renumber unique states by first occurrence (BFS order).
            occ_order = torch.argsort(first_pos, stable=True)
            rank_of_uniq = torch.empty_like(occ_order)
            rank_of_uniq[occ_order] = torch.arange(
                occ_order.numel(), device=self.device)
            base = self.mappings.shape[0]
            ids[new_rows] = base + rank_of_uniq[inverse]

            self.mappings = torch.cat([self.mappings, reps[occ_order]])
            self.fps = torch.cat([self.fps, sorted_new[head][occ_order]])
            self.order = torch.argsort(self.fps, stable=True)
        return ids.to(torch.int32)

    def fingerprint_pairs(self) -> np.ndarray:
        """(S, 2) uint32 [hi, lo] on the host, as the reference returns."""
        fps = self.fps.cpu().numpy().view(np.uint64)
        out = np.empty((fps.shape[0], 2), dtype=np.uint32)
        out[:, 0] = (fps >> np.uint64(32)).astype(np.uint32)
        out[:, 1] = (fps & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return out
