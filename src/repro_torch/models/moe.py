"""Mixture-of-Experts layer: sort-based capacity dispatch.

Token routing is the reference's idiom, the same as the paper's fingerprint
dedup: *sort by key, then operate on contiguous runs*. Tokens sort by
expert id (a stable sort), take their rank within the expert as a capacity
slot, and scatter into dense per-expert buffers; tokens past an expert's
capacity are dropped.

On a mesh (the reference's ``shard_map`` branch) the sort and scatter stay
per-rank local: each rank routes the tokens of its data shard, with the
capacity of that shard (so a sharded MoE drops other assignments than the
one-device MoE); the expert weights are all-gathered over the data axes
(FSDP) and keep their ``mlp`` slice over ``model``, whose partial
down-projections are summed over ``model`` (the reference's ``psum``); the
load-balance loss is averaged over every mesh axis (its ``pmean``). The
router's product runs as ``DTensor`` ops; the rest runs under ``local_map``
on each rank's shards, with the placements of the gradients stated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..sharding.rules import Rules, constrain
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
    # bincount as a scatter-add: its length is E whatever the ids hold (the
    # dry-run's fake tensors have no values to size a bincount by).
    counts = torch.zeros(E, dtype=flat_ids.dtype, device=flat_ids.device
                         ).index_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    pos_in_expert = torch.arange(Tk, device=top_ids.device) - starts[sorted_ids]
    keep = pos_in_expert < C
    buf_idx = torch.where(keep, sorted_ids * C + pos_in_expert,
                          torch.full_like(sorted_ids, E * C))
    return order, counts, keep, buf_idx


def _moe_local(router, w_gate, w_up, w_down, x, cfg: ModelConfig,
               model_axis: str | None = None, mesh=None):
    """One rank's MoE: x (T, d) local tokens -> ((T, d), aux loss). With a
    ``model_axis`` the expert weights are this rank's ``mlp`` slices and
    the down-projection's partial sums are summed over that axis of
    ``mesh``."""
    logits = x.float() @ router.float()                             # (T, E)
    return _moe_routed(logits, w_gate, w_up, w_down, x, cfg,
                       _psum(mesh, model_axis))


def _psum(mesh, axis: str | None):
    """The reference's ``psum`` over ``axis`` of ``mesh`` on a rank's local
    tensor, differentiable (a ``Partial`` DTensor over the axis's submesh
    made ``Replicate``); the identity without an axis."""
    if axis is None:
        return lambda t: t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    sub = mesh[axis]
    return lambda t: DTensor.from_local(t, sub, [Partial()], run_check=False
                                        ).redistribute(sub, [Replicate()]
                                                       ).to_local()


def _moe_routed(logits, w_gate, w_up, w_down, x, cfg: ModelConfig, psum):
    """The MoE after the router's product: logits (T, E) f32, x (T, d)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(T, cfg)
    dtype = x.dtype

    # --- routing ------------------------------------------------------------
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

    # --- expert FFNs (TP over the mlp dim) ----------------------------------------
    gate = torch.einsum("ecd,edf->ecf", buf, w_gate.to(dtype))
    up = torch.einsum("ecd,edf->ecf", buf, w_up.to(dtype))
    h = F.silu(gate) * up
    out_partial = psum(torch.einsum("ecf,efd->ecd", h, w_down.to(dtype)))

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
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if mesh is None:
        y, aux = _moe_local(
            params["router"], params["w_gate"], params["w_up"],
            params["w_down"], xt, cfg, model_axis=None,
        )
        return y.reshape(B, S, d), aux
    y, aux = _moe_sharded(params, xt, cfg, mesh, data_axes, model_axis)
    y = constrain(y.reshape(B, S, d), rules, "batch", "seq_act", "embed_act")
    return y, aux


def _moe_sharded(params, xt, cfg: ModelConfig, mesh, data_axes, model_axis):
    """The reference's ``shard_map`` branch over a ``DeviceMesh``: tokens
    ``xt`` (T, d), a DTensor. -> (y (T, d) sharded over the data axes,
    aux replicated)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(xt, DTensor):
        raise TypeError("a MoE layer on a mesh takes DTensor activations "
                        f"(got {type(xt).__name__})")
    names = tuple(mesh.mesh_dim_names)
    data_axes = tuple(a for a in data_axes if a in names)
    model_in = model_axis if model_axis in names else None
    n_data = 1
    for a in data_axes:
        n_data *= mesh.size(names.index(a))

    def pl(data, model, other=Replicate()):
        """Placements: ``data`` on the data axes, ``model`` on the model
        axis, ``other`` elsewhere."""
        return tuple(data if a in data_axes else model if a == model_in
                     else other for a in names)

    R = Replicate()
    tokens = pl(Shard(0), R)
    xt = xt.redistribute(mesh, tokens)
    router = params["router"].redistribute(mesh, pl(R, R))
    w_gate = params["w_gate"].redistribute(mesh, pl(R, Shard(2)))
    w_up = params["w_up"].redistribute(mesh, pl(R, Shard(2)))
    w_down = params["w_down"].redistribute(mesh, pl(R, Shard(1)))
    # The router's product as DTensor ops: its gradient is DTensor's.
    logits = xt.float() @ router.float()

    def local(logits, w_gate, w_up, w_down, x):
        y, aux = _moe_routed(logits, w_gate, w_up, w_down, x, cfg,
                             _psum(mesh, model_in))
        # pmean over every axis: the per-shard losses are equal along the
        # model axis, so a sum of aux / n_data over the data axes.
        return y, aux / n_data

    # A rank's gradients: of its token rows (logits: replicated over the
    # model axis, since y is summed over it before the combine; x: a partial
    # sum over the model axis, as each rank's mlp slice gives its share);
    # of the experts, a partial sum over the data axes (each data shard's
    # tokens), its own mlp slice over the model axis.
    fn = local_map(
        local,
        out_placements=(tokens, pl(Partial(), R)),
        in_placements=(tokens, pl(R, Shard(2)), pl(R, Shard(2)),
                       pl(R, Shard(1)), tokens),
        in_grad_placements=(tokens, pl(Partial(), Shard(2)),
                            pl(Partial(), Shard(2)), pl(Partial(), Shard(1)),
                            pl(Shard(0), Partial())),
        device_mesh=mesh,
    )
    y, aux = fn(logits, w_gate, w_up, w_down, xt)
    return y, aux.redistribute(mesh, pl(R, R))
