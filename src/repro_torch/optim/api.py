"""Optimizer API, as in the reference (no optax there, none here).

An ``Optimizer`` exposes:
  * ``state_specs(param_specs)`` — a ParamSpec tree for its state, so
    checkpointing can restore without materializing params first;
  * ``init(params, param_specs, dist=None)`` — zero state on the
    parameters' device; with ``dist`` on a mesh, ``DTensor``s placed by its
    rules;
  * ``update(grads, state, params, step, param_specs)`` -> (params, state,
    stats).

On a mesh the update runs as ``DTensor`` ops, in place on each rank's
shards: the global gradient norm is the norm of the whole gradient (a
``DTensor`` reduction sums the shards' squares over the mesh), and
Adafactor's row and column means are the whole tensor's.

Implementations: AdamW, AdamW with block-quantized int8 moments (the 314B
config's memory plan), and Adafactor (factored second moments). The f32
arithmetic is the reference's, in its order.

Deliberate differences from the reference:
  * ``update`` runs under ``torch.no_grad()`` and writes the new parameters
    and state into the tensors it is given, returning the same trees (the
    reference returns new trees and donates the old buffers to its jitted
    step): one copy of the parameters and the state, not two. A caller that
    needs the old values clones them first.
  * The reference's ``_layerwise`` (a ``lax.map`` over the layer axis of
    stacked leaves, behind a flag that is off by default and that
    ``update`` never sets) is left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import OptimizerConfig
from ..models.base import (ParamSpec, leaves_with_paths, map_specs,
                           torch_dtype, tree_leaves, tree_map, zeros_on_mesh)
from ..sharding.rules import implicit_scope
from .schedule import make_schedule

QBLOCK = 256  # int8 quantization block (along the last dim)


@dataclass(frozen=True)
class Optimizer:
    cfg: OptimizerConfig
    state_specs: Callable
    init: Callable
    update: Callable


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return _adamw(cfg)
    if cfg.name == "adamw8bit":
        return _adamw(cfg, quantized=True)
    if cfg.name == "adafactor":
        return _adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.name}")


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """The norm of the whole tree; a ``DTensor`` leaf's sum of squares is
    its whole tensor's (reduced over the mesh), a plain tensor."""
    from torch.distributed.tensor import DTensor

    def sq(x):
        out = torch.sum(torch.square(x.float()))
        return out.full_tensor() if isinstance(out, DTensor) else out

    return torch.sqrt(torch.sum(torch.stack([sq(x) for x in
                                             tree_leaves(tree)])))


def clip_by_global_norm(grads, max_norm: float):
    scale, norm = clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _wd_mask(spec: ParamSpec) -> bool:
    """Decay matrices only (skip norms/biases/1-D params)."""
    return len(spec.shape) >= 2


def clip_scale(grads, max_norm: float):
    """Global-norm clip as a (scalar, norm) pair — the scale folds into the
    per-leaf update instead of materializing a scaled copy of the whole
    gradient tree."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0), norm


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _zeros_like_specs(specs, params, dist=None):
    """Zero state for ``specs`` on ``params``' device, or placed by
    ``dist``'s rules on its mesh."""
    if dist is not None and dist.mesh is not None:
        return zeros_on_mesh(specs, dist)
    device = tree_leaves(params)[0].device
    return map_specs(lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype),
                                           device=device), specs)


def _mesh_scope(params):
    """``implicit_scope`` when the parameters are ``DTensor``s: the step's
    plain scalars (learning rate, bias corrections) are replicated."""
    from torch.distributed.tensor import DTensor

    return implicit_scope(isinstance(tree_leaves(params)[0], DTensor))


def _per_leaf(one, grads, state, params, param_specs):
    """``one(g, s, p, spec)`` on every leaf, in the reference's order."""
    for path, spec in leaves_with_paths(param_specs):
        one(_at(grads, path), _at(state, path), _at(params, path), spec)


# --------------------------------------------------------------------------
# AdamW (f32 or int8-blocked moments)
# --------------------------------------------------------------------------


def _quantizable(spec: ParamSpec) -> bool:
    return len(spec.shape) >= 2 and spec.shape[-1] % QBLOCK == 0


def _q8(x: torch.Tensor) -> tuple:
    """Block-quantize along the last dim -> (int8 codes, f32 scales).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    blocked = x.reshape(*x.shape[:-1], x.shape[-1] // QBLOCK, QBLOCK)
    scale = torch.amax(torch.abs(blocked), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocked / scale), -127, 127).to(torch.int8)
    return codes.reshape(x.shape), scale[..., 0]


def _dq8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    blocked = codes.reshape(*codes.shape[:-1], codes.shape[-1] // QBLOCK,
                            QBLOCK)
    return (blocked.float() * scale[..., None]).reshape(codes.shape)


def _adamw(cfg: OptimizerConfig, quantized: bool = False) -> Optimizer:
    schedule = make_schedule(cfg)

    def state_specs(param_specs):
        def one(s: ParamSpec):
            if quantized and _quantizable(s):
                scale_shape = (*s.shape[:-1], s.shape[-1] // QBLOCK)
                scale_logical = (*s.logical[:-1], None)
                return {
                    "m_q": ParamSpec(s.shape, s.logical, "int8", "zeros"),
                    "m_s": ParamSpec(scale_shape, scale_logical, "float32", "zeros"),
                    "v_q": ParamSpec(s.shape, s.logical, "int8", "zeros"),
                    "v_s": ParamSpec(scale_shape, scale_logical, "float32", "zeros"),
                }
            return {
                "m": ParamSpec(s.shape, s.logical, "float32", "zeros"),
                "v": ParamSpec(s.shape, s.logical, "float32", "zeros"),
            }

        return map_specs(one, param_specs)

    def init(params, param_specs, dist=None):
        return _zeros_like_specs(state_specs(param_specs), params, dist)

    @torch.no_grad()
    def update(grads, state, params, step, param_specs):
        with _mesh_scope(params):
            return _update(grads, state, params, step, param_specs)

    def _update(grads, state, params, step, param_specs):
        scale, gnorm = clip_scale(grads, cfg.grad_clip)
        step = torch.as_tensor(step, device=gnorm.device)
        lr = schedule(step)
        t = step.float() + 1.0
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t

        def one(g, s, p, spec):
            g = g.float() * scale
            if quantized and _quantizable(spec):
                m = _dq8(s["m_q"], s["m_s"])
                v = _dq8(s["v_q"], s["v_s"])
            else:
                m, v = s["m"], s["v"]
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if _wd_mask(spec):
                upd = upd + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))
            if quantized and _quantizable(spec):
                for name, x in (("m", m), ("v", v)):
                    codes, scales = _q8(x)
                    s[f"{name}_q"].copy_(codes)
                    s[f"{name}_s"].copy_(scales)
            else:
                s["m"].copy_(m)
                s["v"].copy_(v)

        _per_leaf(one, grads, state, params, param_specs)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(cfg, state_specs, init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moments; the 314B default)
# --------------------------------------------------------------------------


def _adafactor(cfg: OptimizerConfig) -> Optimizer:
    schedule = make_schedule(cfg)

    def factored(spec: ParamSpec) -> bool:
        return len(spec.shape) >= 2

    def state_specs(param_specs):
        def one(s: ParamSpec):
            if factored(s):
                return {
                    "vr": ParamSpec(s.shape[:-1], s.logical[:-1], "float32", "zeros"),
                    "vc": ParamSpec(
                        (*s.shape[:-2], s.shape[-1]), (*s.logical[:-2], s.logical[-1]),
                        "float32", "zeros",
                    ),
                }
            return {"v": ParamSpec(s.shape, s.logical, "float32", "zeros")}

        return map_specs(one, param_specs)

    def init(params, param_specs, dist=None):
        return _zeros_like_specs(state_specs(param_specs), params, dist)

    @torch.no_grad()
    def update(grads, state, params, step, param_specs):
        with _mesh_scope(params):
            return _update(grads, state, params, step, param_specs)

    def _update(grads, state, params, step, param_specs):
        scale, gnorm = clip_scale(grads, cfg.grad_clip)
        step = torch.as_tensor(step, device=gnorm.device)
        lr = schedule(step)
        decay = 1.0 - (step.float() + 1.0) ** -0.8  # beta2 schedule

        def one(g, s, p, spec):
            g = g.float() * scale
            g2 = torch.square(g) + 1e-30
            if factored(spec):
                vr = decay * s["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
                vc = decay * s["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
                denom = (
                    vr[..., None] / torch.mean(vr, dim=-1, keepdim=True)[..., None]
                ) * vc[..., None, :]
                upd = g * torch.rsqrt(denom + 1e-30)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = decay * s["v"] + (1 - decay) * g2
                upd = g * torch.rsqrt(v + 1e-30)
                s["v"].copy_(v)
            # update clipping (Shazeer & Stern): RMS(upd) <= 1
            rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
            upd = upd / torch.clamp(rms, min=1.0)
            if _wd_mask(spec):
                upd = upd + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))

        _per_leaf(one, grads, state, params, param_specs)
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(cfg, state_specs, init, update)
