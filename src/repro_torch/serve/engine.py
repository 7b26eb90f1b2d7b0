"""Batched serving engine with continuous batching.

Slot model, as in the reference: a fixed decode batch of ``n_slots``
sequences. Incoming requests queue; whenever a slot finishes (EOS / max
tokens), the next request is prefilled into that slot — prefill computes a
batch-1 cache that is scattered into the slot's row of the shared decode
cache (one contiguous region per slot). Decode advances all live slots one
token per step, each at its own position.

Everything runs under ``torch.inference_mode()`` (on a mesh
``torch.no_grad()``) on the parameters' device;
sampling draws from the engine's own ``torch.Generator`` there, seeded
0 (the reference seeds ``PRNGKey(0)``).

With a ``Dist`` on a mesh every rank runs the same engine: the decode cache
is placed by the rules (for qwen1.5-0.5B, ``cache_kv_heads`` over
``model``); a batch-1 prefill cannot shard its batch over the data axes, so
it runs with them replicated (as the reference's dry-run does for a batch
of one) and each rank writes its shard of the slot's row; the logits are
``full_tensor()`` before sampling, so every rank samples the same token
from its generator.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import RunConfig
from ..models import base
from ..models.model import Model
from ..sharding.rules import Dist
from .steps import make_decode_step, make_prefill_step, temperature_sample


@dataclass
class Request:
    prompt: np.ndarray                 # (L,) int32
    max_new_tokens: int = 32
    rid: int = 0
    out_tokens: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, run: RunConfig, dist: Dist, params,
                 *, n_slots: int = 4, max_len: int = 256, eos_id: int = -1,
                 temperature: float = 0.0):
        self.model = model
        self.run = run
        self.dist = dist
        self.params = model.params if params is None else params
        self.device = base.tree_leaves(self.params)[0].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature

        single = _batch_one(dist)
        self.cache = model.init_cache(n_slots, max_len, device=self.device,
                                      dist=dist)
        self.prefill_one = make_prefill_step(model, run, single)
        self.decode = make_decode_step(model, run, dist)
        self.slot_req: list = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int64)   # next position
        self.slot_last = np.zeros(n_slots, dtype=np.int32)  # last sampled token
        self.queue: deque = deque()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.completed: list = []
        self._single_cache = model.init_cache(1, max_len, device=self.device,
                                              dist=single)

    # -- admission ---------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                self._prefill_into(slot, req)

    def _no_grad(self):
        """``inference_mode``; on a mesh ``no_grad`` (DTensor's views of
        the parameters cannot be made in inference mode)."""
        return torch.no_grad() if self.dist.mesh is not None \
            else torch.inference_mode()

    def _prefill_into(self, slot: int, req: Request):
        with self._no_grad():
            self._prefill(slot, req)

    def _prefill(self, slot: int, req: Request):
        toks = torch.as_tensor(np.asarray(req.prompt, np.int32),
                               device=self.device)[None]
        single = self._single_cache
        for leaf in base.tree_leaves(single):
            leaf.zero_()
        logits, cache1 = self.prefill_one(self.params, single, {"tokens": toks})
        # scatter the batch-1 cache into this slot's row
        base.tree_map(lambda big, small: _put(big, small, slot), self.cache,
                      cache1)
        tok = self._sample(logits)[0]
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.slot_last[slot] = int(tok)
        req.out_tokens.append(int(tok))

    # -- decode loop ---------------------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        if hasattr(logits, "full_tensor"):          # a DTensor
            logits = logits.full_tensor()
        return temperature_sample(logits, self._gen, self.temperature).cpu().numpy()

    def step(self):
        """One decode step over all live slots."""
        with self._no_grad():
            return self._step()

    def _step(self):
        live = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
        if not live:
            self._admit()
            live = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
            if not live:
                return False
        tokens = torch.as_tensor(self.slot_last, device=self.device)[:, None]
        # per-slot positions: each row writes its own cache slot and masks
        # its own context length (true continuous batching)
        pos = torch.as_tensor(self.slot_pos.astype(np.int32), device=self.device)
        logits, self.cache = self.decode(self.params, self.cache, tokens, pos)
        next_tok = self._sample(logits)
        for s in live:
            req = self.slot_req[s]
            self.slot_pos[s] += 1
            t = int(next_tok[s])
            req.out_tokens.append(t)
            self.slot_last[s] = t
            if (t == self.eos_id or len(req.out_tokens) >= req.max_new_tokens
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                self.completed.append(req)
                self.slot_req[s] = None
        self._admit()
        return True

    def run_until_done(self, max_steps: int = 10_000):
        self._admit()
        steps = 0
        while steps < max_steps and (self.queue or any(r is not None for r in self.slot_req)):
            if not self.step():
                break
            steps += 1
        return self.completed


def _batch_one(dist: Dist) -> Dist:
    """``dist`` for a batch of one: the batch replicated over the data
    axes."""
    if dist.mesh is None:
        return dist
    return dataclasses.replace(dist, rules=dist.rules.with_overrides(
        {"batch": None, "cache_batch": None}))


def _put(big: torch.Tensor, small: torch.Tensor, slot: int) -> None:
    """``dynamic_update_slice_in_dim(big, small, slot, axis)`` in place, on
    the batch axis: the start clamped so ``small`` fits, as XLA clamps it.
    A ``DTensor`` ``big`` is written on this rank's shard (DTensor has no
    strategy for an in-place write into a slice of a sharded dim): ``small``
    goes to ``big``'s placements with the batch axis whole, and the rank
    whose shard holds the rows writes them."""
    axis = _batch_axis(big, small)
    start = min(max(slot, 0), big.shape[axis] - small.shape[axis])
    if not hasattr(big, "device_mesh"):
        big.narrow(axis, start, small.shape[axis]).copy_(small)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    want = [Replicate() if p == Shard(axis) else p for p in big.placements]
    small = small.redistribute(big.device_mesh, want).to_local()
    local = big.to_local()
    _, offset = compute_local_shape_and_global_offset(
        big.shape, big.device_mesh, big.placements)
    lo = max(start, offset[axis])
    hi = min(start + small.shape[axis], offset[axis] + local.shape[axis])
    if lo < hi:
        local.narrow(axis, lo - offset[axis], hi - lo).copy_(
            small.narrow(axis, lo - start, hi - lo))


def _batch_axis(big, small) -> int:
    """Axis where the slot (batch) dim lives — first axis whose size differs."""
    for i, (b, s) in enumerate(zip(big.shape, small.shape)):
        if b != s:
            return i
    return 0
