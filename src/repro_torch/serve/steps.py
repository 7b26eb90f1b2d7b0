"""Serving step functions (prefill / decode) and sampling — what the
continuous-batching engine drives."""

from __future__ import annotations

import torch

from ..config import RunConfig
from ..models.model import Model
from ..sharding.rules import Dist


def make_prefill_step(model: Model, run: RunConfig, dist: Dist):
    def prefill_step(params, cache, batch):
        kw = {}
        if "frames" in batch:
            kw["frames"] = batch["frames"]
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        logits, new_cache, _ = model.forward(
            params, batch["tokens"], dist, mode="prefill", cache=cache, **kw
        )
        return logits[:, -1], new_cache

    return prefill_step


def make_decode_step(model: Model, run: RunConfig, dist: Dist):
    def decode_step(params, cache, tokens, cache_pos):
        logits, new_cache, _ = model.forward(
            params, tokens, dist, mode="decode", cache=cache, cache_pos=cache_pos
        )
        return logits[:, 0], new_cache

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits: torch.Tensor, generator: torch.Generator | None,
                       temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Greedy at ``temperature <= 0``; otherwise a categorical draw by the
    Gumbel-max trick, as ``jax.random.categorical`` draws, from
    ``generator`` (on the logits' device) — the same distribution, not the
    reference's bits."""
    if temperature <= 0:
        return greedy_sample(logits)
    logits = logits / temperature
    if top_k:
        top_vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < top_vals[..., -1:], float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
