"""Shared layers: norms, MLPs, embeddings, rotary positions, the loss.

As in the reference: matmuls run in the config's compute dtype (bf16 by
default); norm statistics, rope, logits and the loss in f32; parameters are
stored in ``param_dtype`` (f32) and cast at every use. GELU is the tanh
approximation, ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..sharding.rules import Rules, constrain
from .base import ParamSpec, torch_dtype


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


# --------------------------------------------------------------------------
# MLP (swiglu / gelu)
# --------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    if cfg.mlp_variant == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp"), pd, "uniform_scaled"),
            "w_up": ParamSpec((d, f), ("embed", "mlp"), pd, "uniform_scaled"),
            "w_down": ParamSpec((f, d), ("mlp", "embed"), pd, "uniform_scaled"),
        }
    return {
        "w_up": ParamSpec((d, f), ("embed", "mlp"), pd, "uniform_scaled"),
        "b_up": ParamSpec((f,), ("mlp",), pd, "zeros"),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), pd, "uniform_scaled"),
        "b_down": ParamSpec((d,), ("embed",), pd, "zeros"),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig, rules: Rules
        ) -> torch.Tensor:
    dtype = x.dtype
    if cfg.mlp_variant == "swiglu":
        gate = x @ params["w_gate"].to(dtype)
        up = x @ params["w_up"].to(dtype)
        h = F.silu(gate) * up
    else:
        h = gelu(x @ params["w_up"].to(dtype) + params["b_up"].to(dtype))
    h = constrain(h, rules, "batch", "attn_seq", "mlp")
    out = h @ params["w_down"].to(dtype)
    if cfg.mlp_variant != "swiglu":
        out = out + params["b_down"].to(dtype)
    return constrain(out, rules, "batch", "seq_act", "embed_act")


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------


def embedding_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec(
        (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), cfg.param_dtype, "normal"
    )


def embed(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
          rules: Rules) -> torch.Tensor:
    x = table[tokens.long()].to(torch_dtype(cfg.dtype))
    return constrain(x, rules, "batch", "seq_act", "embed_act")


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, rules: Rules,
            transpose: bool) -> torch.Tensor:
    w = table_or_head.to(x.dtype)
    logits = x @ (w.T if transpose else w)
    logits = constrain(logits, rules, "batch", "attn_seq", "vocab")
    return logits.float()


# --------------------------------------------------------------------------
# Rotary positions
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) int. Computed in f32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = (positions.float() / scaling)[..., None] * freqs  # (..., S, half)
    angles = angles[..., None, :]                              # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy in f32, with optional z-loss regularizer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)
