"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

As in the reference: the conv frontend is a stub, so the caller provides
precomputed frame embeddings ``(B, S_enc, d)``. The encoder is
bidirectional self-attention over frames with sinusoidal positions; the
decoder is causal self-attention + cross-attention to the encoder states.

Decode runs the *decoder*: a self-attention KV cache plus cross-attention
K/V computed once at prefill. The cache is written in place.
"""

from __future__ import annotations

import math

import torch

from ..config import ModelConfig
from ..sharding.rules import Dist
from .attention import (
    attention_layer,
    attention_specs,
    cross_attention_layer,
    encode_kv,
    init_cache_shape,
)
from .base import ParamSpec, stack_tree, torch_dtype, tree_map
from .layers import mlp, mlp_specs, rmsnorm, rmsnorm_spec, unembed


def sinusoidal(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_block_specs(cfg: ModelConfig) -> dict:
    return {
        "pre_norm": rmsnorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
        "post_norm": rmsnorm_spec(cfg.d_model),
        "ffn": mlp_specs(cfg),
    }


def _dec_block_specs(cfg: ModelConfig) -> dict:
    return {
        "pre_norm": rmsnorm_spec(cfg.d_model),
        "self_attn": attention_specs(cfg),
        "cross_norm": rmsnorm_spec(cfg.d_model),
        "cross_attn": attention_specs(cfg, cross=True),
        "post_norm": rmsnorm_spec(cfg.d_model),
        "ffn": mlp_specs(cfg),
    }


def whisper_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": ParamSpec(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), cfg.param_dtype, "normal"
        ),
        "enc_blocks": stack_tree(_enc_block_specs(cfg), cfg.n_encoder_layers),
        "enc_norm": rmsnorm_spec(cfg.d_model),
        "dec_blocks": stack_tree(_dec_block_specs(cfg), cfg.n_layers),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }


def whisper_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Decoder self-attn cache + cross-attn K/V (computed at prefill)."""
    kv = init_cache_shape(cfg, batch, max_len, 0)
    dh = cfg.resolved_head_dim()
    cross_shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, dh)
    log = ("layers", "cache_batch", None, "cache_kv_heads", "cache_head_dim")
    return {
        "self": {
            "k": ParamSpec((cfg.n_layers, *kv["k"]),
                           ("layers", "cache_batch", "cache_seq", "cache_kv_heads", "cache_head_dim"),
                           cfg.dtype, "zeros"),
            "v": ParamSpec((cfg.n_layers, *kv["v"]),
                           ("layers", "cache_batch", "cache_seq", "cache_kv_heads", "cache_head_dim"),
                           cfg.dtype, "zeros"),
        },
        "cross_k": ParamSpec(cross_shape, log, cfg.dtype, "zeros"),
        "cross_v": ParamSpec(cross_shape, log, cfg.dtype, "zeros"),
    }


def encode(params, frames: torch.Tensor, cfg: ModelConfig, dist: Dist) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed embeddings -> encoder states."""
    B, S, d = frames.shape
    dev = frames.device
    x = frames.to(torch_dtype(cfg.dtype))
    x = x + sinusoidal(torch.arange(S, device=dev), d, x.dtype)[None]
    positions = torch.broadcast_to(
        torch.arange(S, dtype=torch.int32, device=dev), (B, S))
    for layer in range(cfg.n_encoder_layers):
        bparams = tree_map(lambda t: t[layer], params["enc_blocks"])
        h = rmsnorm(x, bparams["pre_norm"], cfg.norm_eps)
        out, _ = attention_layer(
            bparams["attn"], h, cfg, dist.rules,
            mode="train", positions=positions, use_rope=False, causal=False,
        )
        x = x + out
        h2 = rmsnorm(x, bparams["post_norm"], cfg.norm_eps)
        x = x + mlp(bparams["ffn"], h2, cfg, dist.rules)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def whisper_forward(
    params: dict,
    tokens: torch.Tensor,            # (B, S_dec)
    cfg: ModelConfig,
    dist: Dist,
    *,
    frames: torch.Tensor | None = None,   # (B, S_enc, d) — train/prefill
    mode: str = "train",
    cache: dict | None = None,
    cache_pos=None,
) -> tuple:
    """Returns (logits, the cache updated in place | None, aux=0)."""
    B, S = tokens.shape
    dev = tokens.device
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if mode == "decode":
        pos = torch.as_tensor(cache_pos, device=dev)
        cp = pos[:, None] if pos.dim() else pos
        positions = torch.broadcast_to(cp, (B, S)).to(torch.int32)
        x = x + sinusoidal(positions, cfg.d_model, dtype)
    else:
        positions = torch.broadcast_to(
            torch.arange(S, dtype=torch.int32, device=dev), (B, S))
        x = x + sinusoidal(positions, cfg.d_model, dtype)[0][None]

    enc = None
    if mode in ("train", "prefill"):
        assert frames is not None
        enc = encode(params, frames, cfg, dist)

    use_cache = cache is not None
    for layer in range(cfg.n_layers):
        bparams = tree_map(lambda t: t[layer], params["dec_blocks"])
        h = rmsnorm(x, bparams["pre_norm"], cfg.norm_eps)
        blk_cache = ({"k": cache["self"]["k"][layer],
                      "v": cache["self"]["v"][layer]} if use_cache else None)
        out, _ = attention_layer(
            bparams["self_attn"], h, cfg, dist.rules,
            mode=mode, positions=positions, cache=blk_cache,
            cache_pos=cache_pos, use_rope=False,
        )
        x = x + out
        h2 = rmsnorm(x, bparams["cross_norm"], cfg.norm_eps)
        if mode == "decode":
            ck, cv = cache["cross_k"][layer], cache["cross_v"][layer]
        else:
            ck, cv = encode_kv(bparams["cross_attn"], enc, cfg)
            if use_cache:
                cache["cross_k"][layer] = ck
                cache["cross_v"][layer] = cv
        x = x + cross_attention_layer(bparams["cross_attn"], h2, (ck, cv), cfg, dist.rules)
        h3 = rmsnorm(x, bparams["post_norm"], cfg.norm_eps)
        x = x + mlp(bparams["ffn"], h3, cfg, dist.rules)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, dist.rules, transpose=True)
    return logits, cache, torch.zeros((), dtype=torch.float32, device=dev)
