"""Step functions, as in the reference's ``train/steps.py``.

``make_train_step`` builds
    (params, opt_state, step, batch) -> (params, opt_state, metrics)
with gradient accumulation over ``run.micro_batches`` micro-batches (a
loop: activation memory stays at one micro-batch), mixed-precision
params→bf16 casting inside the loss, MoE aux-loss folding, clipping and the
optimizer update. ``batch`` holds tensors on the parameters' device.

Gradients are taken with ``torch.autograd.grad`` with respect to the tree
the loss passes to ``Model.forward`` (detached aliases of the stored
leaves, so the model's registered parameters stay frozen). Each
micro-batch's gradients are added into buffers of ``run.grad_accum_dtype``,
then divided by the micro-batch count. With ``run.gather_params_once`` the
f32 leaves of rank >= 2 are cast to bf16 once per step, outside the
micro-batch loop, and their gradients come back in f32.

On a mesh (``dist.mesh``; parameters, state and batch are ``DTensor``s
placed by the rules) the bf16 compute copy is redistributed with the data
axes dropped from every placement (the reference's ZeRO-1
``_gather_once``), and every gradient is redistributed back to its
parameter's placements in f32 (the reference's reshard: a reduce-scatter
of the data-parallel partial sums). Micro-batches slice the global batch
as the reference's do, and the loss and metrics come back replicated.

The optimizer updates ``params`` and ``opt_state`` in place
(``optim/api.py``); the returned trees are the ones passed in. Metrics are
0-d tensors on the device: ``loss``, ``aux_loss``, ``grad_norm``, ``lr``.
"""

from __future__ import annotations

import torch

from ..config import RunConfig
from ..models.base import leaves_with_paths, torch_dtype
from ..models.layers import cross_entropy
from ..models.model import Model
from ..optim import build_optimizer
from ..sharding.rules import Dist, mesh_scope

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def _model_kwargs(batch: dict) -> dict:
    kw = {}
    if "frames" in batch:
        kw["frames"] = batch["frames"]
    if "prefix_embeds" in batch:
        kw["prefix_embeds"] = batch["prefix_embeds"]
    return kw


def _unflatten(paths: list, leaves: list) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def make_train_step(model: Model, run: RunConfig, dist: Dist):
    opt = build_optimizer(run.optimizer)
    param_specs = model.param_specs()
    acc_dtype = torch_dtype(run.grad_accum_dtype)

    def loss_fn(params, micro):
        logits, _, aux = model.forward(
            params, micro["tokens"], dist, mode="train", **_model_kwargs(micro)
        )
        loss = cross_entropy(logits, micro["labels"])
        return loss + AUX_WEIGHT * aux, (loss, aux)

    def grad_fn(loss_params, micro):
        """(loss, aux, [gradient a leaf of ``loss_params``, in order])."""
        paths, leaves = zip(*leaves_with_paths(loss_params))
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(_unflatten(paths, leaves), micro)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return loss.detach(), aux.detach(), list(paths), grads

    def _gather_once(params):
        """The bf16 compute copy of the f32 matrices, made once a step; on
        a mesh, replicated over the data axes."""
        specs = dict(leaves_with_paths(param_specs))

        def one(path, p):
            x = (p.to(torch.bfloat16)
                 if p.dtype == torch.float32 and p.dim() >= 2 else p)
            if dist.mesh is None:
                return x
            return x.redistribute(dist.mesh, _drop_data(
                dist, specs[path].logical))

        paths, leaves = zip(*leaves_with_paths(params))
        return _unflatten(paths, [one(q, p) for q, p in zip(paths, leaves)])

    def _reshard(paths, grads):
        """Each gradient in its parameter's placements (on a mesh)."""
        if dist.mesh is None:
            return grads
        specs = dict(leaves_with_paths(param_specs))
        return [g.redistribute(dist.mesh, dist.rules.placements(
            dist.mesh, *specs[q].logical)) for q, g in zip(paths, grads)]

    def train_step(params, opt_state, step, batch):
        with mesh_scope(dist):
            return _train_step(params, opt_state, step, batch)

    def _train_step(params, opt_state, step, batch):
        n_micro = run.micro_batches
        loss_params = _gather_once(params) if run.gather_params_once else params

        if n_micro == 1:
            loss, aux, paths, grads = grad_fn(loss_params, batch)
        else:
            B = batch["tokens"].shape[0]
            assert B % n_micro == 0
            mb = B // n_micro
            g_acc = None
            loss = aux = 0.0
            for i in range(n_micro):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, a_i, paths, g = grad_fn(loss_params, micro)
                if g_acc is None:
                    g_acc = [torch.zeros_like(t, dtype=acc_dtype) for t in g]
                for a, b in zip(g_acc, g):
                    a.add_(b.to(acc_dtype))
                del g
                loss, aux = loss + l_i, aux + a_i
            grads = [g / n_micro for g in g_acc]
            loss, aux = loss / n_micro, aux / n_micro

        if run.gather_params_once:
            grads = [g.float() for g in grads]
        grads = _reshard(paths, grads)
        new_params, new_opt, stats = opt.update(
            _unflatten(paths, grads), opt_state, params, step, param_specs
        )
        metrics = {k: _replicated(v) for k, v in
                   {"loss": loss, "aux_loss": aux, **stats}.items()}
        return new_params, new_opt, metrics

    return train_step, opt


def _drop_data(dist: Dist, logical: tuple) -> list:
    """The rules' placements of ``logical`` with the data axes replicated."""
    from torch.distributed.tensor import Replicate

    names = dist.mesh.mesh_dim_names
    return [Replicate() if names[i] in dist.data_axes else p for i, p in
            enumerate(dist.rules.placements(dist.mesh, *logical))]


def _replicated(x):
    """A metric as a plain tensor: a ``DTensor``'s full value (a
    collective on every rank), else itself."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_eval_step(model: Model, run: RunConfig, dist: Dist):
    @torch.no_grad()
    def eval_step(params, batch):
        logits, _, _ = model.forward(
            params, batch["tokens"], dist, mode="train", **_model_kwargs(batch)
        )
        with mesh_scope(dist):
            return _replicated(cross_entropy(logits, batch["labels"]))

    return eval_step
