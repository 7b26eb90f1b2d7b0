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
from ..sharding.rules import Rules, constrain, product
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
        gate, up = product("bsd,df->bsf", x, params["w_gate"].to(dtype),
                           params["w_up"].to(dtype))
        h = F.silu(gate) * up
    else:
        h = gelu(product("bsd,df->bsf", x, params["w_up"].to(dtype))
                 + params["b_up"].to(dtype))
    h = constrain(h, rules, "batch", "attn_seq", "mlp")
    # On a mesh the down-projection's partial sums are reduced before the
    # bias is added (DTensor cannot turn a sharded bias into a partial sum).
    out = constrain(product("bsf,fd->bsd", h, params["w_down"].to(dtype)),
                    rules, "batch", "seq_act", "embed_act")
    if cfg.mlp_variant != "swiglu":
        out = out + params["b_down"].to(dtype)
    return out


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------


def embedding_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec(
        (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), cfg.param_dtype, "normal"
    )


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A ``DTensor`` table is looked up on each rank's
    vocab shard under ``local_map``: ids outside the shard give zero rows,
    and the result is a partial sum over the vocab's mesh axes (the next
    ``constrain`` reduces it), the rows split as the tokens' are. DTensor's
    own strategy for this gather cannot take a partial gradient back in
    some PyTorch versions (the card's 2.11)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    vocab = [p == Shard(0) for p in table.placements]
    table = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                      for v in vocab])
    if not isinstance(tokens, DTensor):     # every rank's own: replicated
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = [Shard(0) if p == Shard(0) and not v else Replicate()
            for p, v in zip(tokens.placements, vocab)]
    tokens = tokens.redistribute(mesh, rows)
    _, (off, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)

    def local(tab, tok):
        t = tok.long() - off
        inside = ((t >= 0) & (t < tab.shape[0]))[..., None]
        return torch.where(inside, tab[t.clamp(0, tab.shape[0] - 1)],
                           torch.zeros((), dtype=tab.dtype, device=tab.device))

    return local_map(
        local,
        out_placements=[Partial() if v else r for v, r in zip(vocab, rows)],
        in_placements=(table.placements, rows),
        in_grad_placements=([Shard(0) if v else Partial() if r == Shard(0)
                             else Replicate() for v, r in zip(vocab, rows)],
                            rows),                  # ids: no gradient
        device_mesh=mesh)(table, tokens)


def embed(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
          rules: Rules) -> torch.Tensor:
    # The rows split as the rules split them before the lookup: a
    # micro-batch sliced from a row-split batch comes replicated, and its
    # lookup would make every rank the whole micro-batch's rows.
    tokens = constrain(tokens, rules, "batch", None)
    x = lookup(table, tokens).to(torch_dtype(cfg.dtype))
    return constrain(x, rules, "batch", "seq_act", "embed_act")


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, rules: Rules,
            transpose: bool) -> torch.Tensor:
    w = table_or_head.to(x.dtype)
    logits = product("bsd,vd->bsv" if transpose else "bsd,dv->bsv", x, w)
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
    """Mean token cross-entropy in f32, with optional z-loss regularizer.

    The vocab dim is kept (size 1) until the mean: on logits sharded over
    the vocab, the gold logit is a masked partial sum (``_gold``), which
    DTensor cannot reduce through a view that drops the dim."""
    logits = logits.float()
    lse = _logsumexp(logits)
    gold = _gold(logits, labels.long()[..., None])
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim, kept. On ``DTensor`` logits
    split over the vocab among several ranks: each rank's max and sum of
    exponentials under ``local_map``, a partial max and a partial sum over
    the vocab's mesh axes (DTensor's own strategies move the logits to
    gather the vocab). The max is a constant of the gradient (it cancels).
    A vocab whole on each rank takes ``torch.logsumexp`` itself, whose
    roundings are one device's."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    split = Shard(logits.ndim - 1)
    if not isinstance(logits, DTensor) or not any(
            p == split and logits.device_mesh.size(i) > 1
            for i, p in enumerate(logits.placements)):
        return torch.logsumexp(logits, dim=-1, keepdim=True)
    mesh, place = logits.device_mesh, logits.placements
    vocab = [p == split for p in place]
    whole = [Replicate() if v else p for v, p in zip(vocab, place)]

    def part(op):
        return [Partial(op) if v else p for v, p in zip(vocab, place)]

    m = local_map(lambda lg: torch.amax(lg, dim=-1, keepdim=True),
                  out_placements=part("max"), in_placements=(place,),
                  device_mesh=mesh)(logits.detach()).redistribute(mesh, whole)
    s = local_map(lambda lg, mx: torch.sum(torch.exp(lg - mx), dim=-1,
                                           keepdim=True),
                  out_placements=part("sum"), in_placements=(place, whole),
                  in_grad_placements=(place, whole), device_mesh=mesh)(
        logits, m).redistribute(mesh, whole)
    return m + torch.log(s)


def _gold(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(logits, -1, idx)``. On ``DTensor`` logits each rank
    gathers from its own vocab slice under ``local_map`` (an index outside
    the slice gives 0, and the result is a partial sum over the vocab's
    mesh axes), the rows split as the logits' are: DTensor's strategy for
    this gather fills, in its backward, a tensor of the whole batch's
    logits on every rank (the global batch, the global vocab)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx)
    mesh, place = logits.device_mesh, logits.placements
    vocab = [p == Shard(logits.ndim - 1) for p in place]
    rows = [Replicate() if v else p for v, p in zip(vocab, place)]
    if not isinstance(idx, DTensor):        # every rank's own: replicated
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    _, off = compute_local_shape_and_global_offset(logits.shape, mesh, place)

    def local(lg, ix):
        n = lg.shape[-1]
        t = ix - off[-1]
        inside = (t >= 0) & (t < n)
        return torch.where(inside, torch.gather(lg, -1, t.clamp(0, n - 1)),
                           torch.zeros((), dtype=lg.dtype, device=lg.device))

    return local_map(
        local, out_placements=[Partial() if v else p
                               for v, p in zip(vocab, place)],
        in_placements=(place, rows), in_grad_placements=(place, rows),
        device_mesh=mesh)(logits, idx.redistribute(mesh, rows))
