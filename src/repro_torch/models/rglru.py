"""RG-LRU recurrence (RecurrentGemma / Griffin temporal-mixing block).

The gated diagonal recurrence

    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

is another instance of the affine monoid — the same scan core as SFA
matching and mamba2. Decode state is one (B, width) vector: O(1) in context.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core import monoid as M
from ..sharding.rules import Rules, constrain
from .base import ParamSpec
from .layers import gelu
from .ssm import _causal_conv

AFF = M.affine_monoid()

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def rglru_width(cfg: ModelConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def rglru_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = rglru_width(cfg)
    pd = cfg.param_dtype
    return {
        "w_gate_in": ParamSpec((d, w), ("embed", "rnn"), pd, "uniform_scaled"),
        "w_rec_in": ParamSpec((d, w), ("embed", "rnn"), pd, "uniform_scaled"),
        "conv_w": ParamSpec((cfg.ssm_conv_width, w), ("conv", "rnn"), pd, "uniform_scaled"),
        "conv_b": ParamSpec((w,), ("rnn",), pd, "zeros"),
        "w_input_gate": ParamSpec((w, w), ("rnn", None), pd, "uniform_scaled"),
        "b_input_gate": ParamSpec((w,), ("rnn",), pd, "zeros"),
        "w_a_gate": ParamSpec((w, w), ("rnn", None), pd, "uniform_scaled"),
        "b_a_gate": ParamSpec((w,), ("rnn",), pd, "zeros"),
        "lam": ParamSpec((w,), ("rnn",), pd, "normal", 1.0),
        "w_out": ParamSpec((w, d), ("rnn", "embed"), pd, "uniform_scaled"),
    }


def _gates(params, xr):
    """Recurrence coefficients: returns (a, beta_x) in f32; xr (…, w)."""
    x32 = xr.float()
    i_gate = torch.sigmoid(
        x32 @ params["w_input_gate"].float() + params["b_input_gate"].float()
    )
    r_gate = torch.sigmoid(
        x32 @ params["w_a_gate"].float() + params["b_a_gate"].float()
    )
    log_a = -_C * F.softplus(params["lam"].float()) * r_gate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i_gate * x32


def rglru_layer(
    params: dict,
    x: torch.Tensor,               # (B, S, d)
    cfg: ModelConfig,
    rules: Rules,
    *,
    mode: str = "train",
    cache: dict | None = None,
) -> tuple:
    """Returns (out (B, S, d), new_cache)."""
    dtype = x.dtype
    gate = gelu(x @ params["w_gate_in"].to(dtype))
    xr = x @ params["w_rec_in"].to(dtype)

    if mode == "decode":
        W = cfg.ssm_conv_width
        hist = torch.cat([cache["conv"].to(dtype), xr], dim=1)         # (B,W,w)
        conv = sum(hist[:, i] * params["conv_w"][i].to(dtype) for i in range(W))
        xr1 = F.silu(conv + params["conv_b"].to(dtype))[:, None]       # (B,1,w)
        new_conv = hist[:, 1:]
        a, bx = _gates(params, xr1)
        h = a[:, 0] * cache["h"] + bx[:, 0]                            # (B,w)
        y = h[:, None].to(dtype)
        new_cache = {"conv": new_conv, "h": h}
    else:
        xr, conv_state = _causal_conv(xr, params["conv_w"], params["conv_b"],
                                      cache["conv"].to(dtype) if cache else None)
        a, bx = _gates(params, xr)
        if cache is not None and "h" in cache:
            bx[:, 0] += a[:, 0] * cache["h"]
        h = M.scan(AFF, (a, bx), axis=1)[1]                            # (B,S,w)
        y = h.to(dtype)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv": conv_state, "h": h[:, -1].float()}

    y = constrain(y * gate, rules, "batch", "seq_act", "rnn")
    out = y @ params["w_out"].to(dtype)
    return constrain(out, rules, "batch", "seq_act", "embed_act"), new_cache


def rglru_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    w = rglru_width(cfg)
    return {"conv": (batch, cfg.ssm_conv_width - 1, w), "h": (batch, w)}
