"""Decoder-only LM assembly: pattern-based blocks over stacked groups.

Layer kinds (cycled from ``cfg.layer_pattern``):
  "attn"   — global causal attention
  "swa"    — sliding-window attention (window = cfg.sliding_window)
  "lattn"  — local attention (window = cfg.local_attn_window; recurrentgemma)
  "rglru"  — RG-LRU recurrence
  "mamba2" — mamba-2 SSD

Each block is (norm → temporal-mixing → residual) and, when ``d_ff > 0``,
(norm → MLP/MoE → residual). Homogeneous *groups* (one full cycle of the
pattern) keep the reference's stacked layout, a leading ``n_groups`` axis on
every leaf, so weights carry over without a reshape; the reference's
``lax.scan`` over that axis is a loop here. A remainder (depth % pattern)
runs as unstacked tail blocks (recurrentgemma's 38 = 12×(2 rglru + 1 lattn)
+ 2 rglru).

``cfg.remat`` applies to a train-mode forward under autograd, block by
block: ``"full"`` checkpoints each block (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint`` on its scan body), ``"dots"`` checkpoints
it saving the outputs of its matrix products without batch dimensions
(the reference's ``checkpoint_dots_with_no_batch_dims`` policy). The
gradients do not depend on it.

A cache passed to ``lm_forward`` is updated in place and returned.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import ModelConfig
from ..sharding.rules import Dist
from .attention import attention_layer, attention_specs, init_cache_shape
from .base import ParamSpec, stack_tree, tree_map
from .layers import embed, embedding_spec, mlp, mlp_specs, rmsnorm, rmsnorm_spec, unembed
from .moe import moe_layer, moe_specs
from .rglru import rglru_cache_shapes, rglru_layer, rglru_specs
from .ssm import mamba2_cache_shapes, mamba2_layer, mamba2_specs


# --------------------------------------------------------------------------
# Parameter tree
# --------------------------------------------------------------------------


def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    specs: dict = {"pre_norm": rmsnorm_spec(cfg.d_model)}
    if kind in ("attn", "swa", "lattn"):
        specs["attn"] = attention_specs(cfg)
    elif kind == "rglru":
        specs["rglru"] = rglru_specs(cfg)
    elif kind == "mamba2":
        specs["mamba2"] = mamba2_specs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    if cfg.d_ff > 0:
        specs["post_norm"] = rmsnorm_spec(cfg.d_model)
        specs["ffn"] = moe_specs(cfg) if cfg.n_experts else mlp_specs(cfg)
    return specs


def pattern_of(cfg: ModelConfig) -> tuple:
    return tuple(cfg.layer_pattern)


def lm_specs(cfg: ModelConfig) -> dict:
    p = pattern_of(cfg)
    n_groups, rem = divmod(cfg.n_layers, len(p))
    group = {f"{i}_{kind}": _block_specs(cfg, kind) for i, kind in enumerate(p)}
    specs: dict = {
        "embed": embedding_spec(cfg),
        "final_norm": rmsnorm_spec(cfg.d_model),
        "blocks": stack_tree(group, n_groups) if n_groups else {},
    }
    if rem:
        specs["tail"] = {
            f"{i}_{kind}": _block_specs(cfg, kind) for i, kind in enumerate(p[:rem])
        }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), cfg.param_dtype, "normal"
        )
    return specs


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------


def _block_cache_shapes(cfg: ModelConfig, kind: str, batch: int, max_len: int) -> dict:
    if kind in ("attn", "swa", "lattn"):
        window = _window_of(cfg, kind)
        return init_cache_shape(cfg, batch, max_len, window)
    if kind == "rglru":
        return rglru_cache_shapes(cfg, batch)
    if kind == "mamba2":
        return mamba2_cache_shapes(cfg, batch)
    raise ValueError(kind)


def _cache_logical(kind: str, name: str, ndim: int) -> tuple:
    if kind in ("attn", "swa", "lattn"):
        return ("cache_batch", "cache_seq", "cache_kv_heads", "cache_head_dim")
    # recurrence caches: small, batch-sharded only
    return ("cache_batch",) + (None,) * (ndim - 1)


def lm_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """ParamSpec tree for the KV/state cache (KV in ``cfg.dtype``, the
    recurrent ``h``/``ssm`` state in f32)."""
    p = pattern_of(cfg)
    n_groups, rem = divmod(cfg.n_layers, len(p))

    def block(kind: str) -> dict:
        shapes = _block_cache_shapes(cfg, kind, batch, max_len)
        out = {}
        for name, shp in shapes.items():
            dtype = "float32" if kind in ("rglru", "mamba2") and name in ("h", "ssm") else cfg.dtype
            out[name] = ParamSpec(shp, _cache_logical(kind, name, len(shp)), dtype, "zeros")
        return out

    group = {f"{i}_{kind}": block(kind) for i, kind in enumerate(p)}
    specs: dict = {"blocks": stack_tree(group, n_groups) if n_groups else {}}
    if rem:
        specs["tail"] = {f"{i}_{kind}": block(kind) for i, kind in enumerate(p[:rem])}
    return specs


def _window_of(cfg: ModelConfig, kind: str) -> int:
    if kind == "swa":
        return cfg.sliding_window
    if kind == "lattn":
        return cfg.local_attn_window
    return 0


def write_back(dst, src) -> None:
    """Copy a block's new cache into its slot of the cache tree, leaf by
    leaf; a leaf the layer already wrote in place is left alone."""
    if isinstance(dst, dict):
        for k, v in src.items():
            write_back(dst[k], v)
    elif src is not dst:
        dst.copy_(src)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def block_forward(bparams, x, cfg, dist: Dist, kind: str, *, mode, positions,
                   cache, cache_pos):
    h = rmsnorm(x, bparams["pre_norm"], cfg.norm_eps)
    new_cache = None
    if kind in ("attn", "swa", "lattn"):
        out, new_cache = attention_layer(
            bparams["attn"], h, cfg, dist.rules,
            mode=mode, positions=positions, window=_window_of(cfg, kind),
            cache=cache, cache_pos=cache_pos,
        )
    elif kind == "rglru":
        out, new_cache = rglru_layer(
            bparams["rglru"], h, cfg, dist.rules, mode=mode, cache=cache
        )
    elif kind == "mamba2":
        out, new_cache = mamba2_layer(
            bparams["mamba2"], h, cfg, dist.rules, mode=mode, cache=cache
        )
    x = x + out
    aux = 0.0                   # a tensor from an MoE block only
    if cfg.d_ff > 0:
        h2 = rmsnorm(x, bparams["post_norm"], cfg.norm_eps)
        if cfg.n_experts:
            f_out, aux = moe_layer(
                bparams["ffn"], h2, cfg, dist.rules,
                mesh=dist.mesh, data_axes=dist.data_axes, model_axis=dist.model_axis,
            )
        else:
            f_out = mlp(bparams["ffn"], h2, cfg, dist.rules)
        x = x + f_out
    return x, new_cache, aux


def blocks_in_run_order(params: dict, cfg: ModelConfig, cache: dict | None = None):
    """The model's blocks in the order ``lm_forward`` runs them: each
    group's blocks in pattern order, then the tail blocks. Yields ``(kind,
    block params, block cache | None)``; a block cache is a view of the
    stacked cache, so writing into it updates ``cache``."""
    n_groups = cfg.n_layers // len(pattern_of(cfg))
    # The stacked weights are unbound once: under autograd the gradient of
    # a stack is then one ``stack`` of the groups' gradients, where an
    # index a group (``t[g]``) would add a stack-sized zero-filled tensor
    # a group (quadratic in depth, in traffic and live bytes).
    groups = tree_map(lambda t: t.unbind(0), params["blocks"])
    parts = [(tree_map(lambda t, g=g: t[g], groups),
              tree_map(lambda t, g=g: t[g], cache["blocks"]) if cache else None)
             for g in range(n_groups)]
    if "tail" in params:
        parts.append((params["tail"], cache.get("tail") if cache else None))
    for bparams, bcache in parts:
        for key in sorted(bparams, key=lambda s: int(s.split("_")[0])):
            yield (key.split("_", 1)[1], bparams[key],
                   bcache.get(key) if bcache else None)


def _no_batch_dot(op, args) -> bool:
    """A matrix product without batch dimensions: ``mm``/``addmm``, or a
    ``bmm`` over a batch of one (how ``einsum`` runs a weight product)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return True
    return op is torch.ops.aten.bmm.default and args[0].shape[0] == 1


def _save_dots(ctx, op, *args, **kwargs):
    if _no_batch_dot(op, args):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, remat: str, mode: str):
    """``fn`` under ``remat`` ("none" | "full" | "dots") when it runs a
    train-mode forward under autograd; ``fn`` itself otherwise."""
    if remat == "none" or mode != "train" or not torch.is_grad_enabled():
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **extra)


def lm_forward(
    params: dict,
    tokens: torch.Tensor,           # (B, S) int
    cfg: ModelConfig,
    dist: Dist,
    *,
    mode: str = "train",            # train | prefill | decode
    cache: dict | None = None,
    cache_pos=None,
    prefix_embeds: torch.Tensor | None = None,
) -> tuple:
    """Returns (logits (B, S, V) f32, the cache updated in place | None,
    aux_loss)."""
    B, S = tokens.shape
    dev = tokens.device
    x = embed(params["embed"], tokens, cfg, dist.rules)
    if prefix_embeds is not None:
        n_pref = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, n_pref:]], dim=1)

    if mode == "decode":
        assert cache_pos is not None
        pos = torch.as_tensor(cache_pos, device=dev).to(torch.int32)
        if pos.dim() == 0:
            positions = torch.broadcast_to(pos, (B, S))
        else:  # per-slot positions (continuous batching)
            positions = torch.broadcast_to(pos[:, None], (B, S))
    else:
        positions = torch.broadcast_to(
            torch.arange(S, dtype=torch.int32, device=dev), (B, S))

    aux_total = 0.0
    run_block = remat_wrap(block_forward, cfg.remat, mode)
    for kind, bparams, bcache in blocks_in_run_order(params, cfg, cache):
        x, new_cache, aux = run_block(
            bparams, x, cfg, dist, kind,
            mode=mode, positions=positions, cache=bcache, cache_pos=cache_pos,
        )
        aux_total = aux_total + aux
        if new_cache is not None:
            write_back(bcache, new_cache)

    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, dist.rules, transpose=True)
    else:
        logits = unembed(params["head"], x, dist.rules, transpose=False)
    if not torch.is_tensor(aux_total):
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, cache, aux_total
