"""Mixture-of-Experts layer: sort-based capacity dispatch.

Token routing is the reference's idiom, the same as the paper's fingerprint
dedup: *sort by key, then operate on contiguous runs*. Tokens sort by
expert id (a stable sort), take their rank within the expert as a capacity
slot, and scatter into dense per-expert buffers; tokens past an expert's
capacity are dropped.

Only the reference's one-device branch (``mesh is None``) is ported; its
``shard_map`` branch waits for the sharded LM path (a ``Dist`` with a mesh
raises before it gets here).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..sharding.rules import Rules
from .base import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    return {
        "router": ParamSpec((d, E), ("embed", None), pd, "normal", 0.02),
        "w_gate": ParamSpec((E, d, f), ("experts", "embed", "mlp"), pd, "uniform_scaled"),
        "w_up": ParamSpec((E, d, f), ("experts", "embed", "mlp"), pd, "uniform_scaled"),
        "w_down": ParamSpec((E, f, d), ("experts", "mlp", "embed"), pd, "uniform_scaled"),
    }


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    return max(
        1,
        math.ceil(cfg.moe_capacity_factor * n_tokens * cfg.experts_per_token / cfg.n_experts),
    )


def _top_k(logits: torch.Tensor, k: int) -> tuple:
    """``lax.top_k``: the k largest, descending, ties to the lower index —
    a stable descending sort's first k (``torch.topk`` orders ties as it
    pleases)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _dispatch(top_ids: torch.Tensor, E: int, C: int) -> tuple:
    """Sort-based dispatch of (T, k) expert ids -> (order, counts, keep,
    buf_idx) over the T·k assignments: ``order`` groups them by expert
    (stable), ``keep`` marks those within capacity ``C``, ``buf_idx`` is
    their row of the (E·C) buffer (E·C for a dropped one)."""
    Tk = top_ids.numel()
    flat_ids = top_ids.reshape(Tk)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.bincount(flat_ids, minlength=E)
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    pos_in_expert = torch.arange(Tk, device=top_ids.device) - starts[sorted_ids]
    keep = pos_in_expert < C
    buf_idx = torch.where(keep, sorted_ids * C + pos_in_expert,
                          torch.full_like(sorted_ids, E * C))
    return order, counts, keep, buf_idx


def _moe_local(router, w_gate, w_up, w_down, x, cfg: ModelConfig,
               model_axis: str | None = None):
    """One device's MoE: x (T, d) tokens -> ((T, d), aux loss)."""
    if model_axis is not None:
        raise NotImplementedError("a model axis needs the sharded LM path")
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(T, cfg)
    dtype = x.dtype

    # --- routing ------------------------------------------------------------
    logits = x.float() @ router.float()                             # (T, E)
    top_logits, top_ids = _top_k(logits, k)                         # (T, k)
    weights = torch.softmax(top_logits, dim=-1)                     # renormalized

    # --- sort-based dispatch -------------------------------------------------
    order, counts, keep, buf_idx = _dispatch(top_ids, E, C)
    token_of = torch.div(order, k, rounding_mode="floor")           # source token
    # One spare row takes every dropped assignment (the reference's
    # ``mode="drop"``), then goes.
    buf = torch.zeros((E * C + 1, d), dtype=dtype, device=x.device)
    buf[buf_idx] = x[token_of]
    buf = buf[: E * C].reshape(E, C, d)

    # --- expert FFNs ------------------------------------------------------------
    gate = torch.einsum("ecd,edf->ecf", buf, w_gate.to(dtype))
    up = torch.einsum("ecd,edf->ecf", buf, w_up.to(dtype))
    h = F.silu(gate) * up
    out_partial = torch.einsum("ecf,efd->ecd", h, w_down.to(dtype))

    # --- combine back ----------------------------------------------------------
    y_sorted = out_partial.reshape(E * C, d)[torch.clamp(buf_idx, max=E * C - 1)]
    y_sorted = torch.where(keep[:, None], y_sorted, torch.zeros((), dtype=dtype,
                                                                device=x.device))
    w_sorted = weights.reshape(-1)[order].to(dtype)
    y = torch.zeros((T, d), dtype=dtype, device=x.device).index_add_(
        0, token_of, y_sorted * w_sorted[:, None])

    # auxiliary load-balance loss (Switch-style), returned for the trainer
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)           # (E,)
    ce = counts.float() / max(T * k, 1)
    aux = E * torch.sum(me * ce)
    return y, aux


def moe_layer(
    params: dict,
    x: torch.Tensor,              # (B, S, d)
    cfg: ModelConfig,
    rules: Rules,
    mesh=None,
    data_axes: tuple = ("data",),
    model_axis: str | None = "model",
) -> tuple:
    """Returns (out (B, S, d), aux_loss scalar)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_layer's shard_map branch waits for the sharded LM path")
    B, S, d = x.shape
    y, aux = _moe_local(
        params["router"], params["w_gate"], params["w_up"], params["w_down"],
        x.reshape(B * S, d), cfg, model_axis=None,
    )
    return y.reshape(B, S, d), aux
