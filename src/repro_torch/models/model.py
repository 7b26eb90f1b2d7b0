"""Model facade: one API over decoder-only LMs and the enc-dec backbone.

``Model`` is an ``nn.Module`` whose parameters are registered from the
ParamSpec tree: a ``state_dict()`` key is the reference's tree path joined
by ``.`` (``blocks.0_attn.attn.wq``). A new model holds its parameters on
the ``meta`` device — nothing is allocated — until ``init`` draws them or
``load`` takes a tree (``base.params_from_numpy`` carries the reference's
over). ``forward``, ``init``, ``n_params``, ``cache_specs`` and
``init_cache`` keep the reference's signatures; ``forward(None, ...)`` uses
the model's own parameters. The registered parameters are frozen
(``requires_grad=False``): training (``train/steps.py``) takes gradients
with respect to the tree it passes to ``forward``.

On a mesh (``Dist.for_mesh``) the parameters, caches and inputs are
``DTensor``s placed by the rules: ``init``, ``load`` and ``init_cache``
take the ``Dist``. ``forward`` gathers the parameters over the data axes
first (FSDP at use, ``base.gather_data_axes``) and runs under
``implicit_replication``, so that the plain tensors it makes (positions,
masks) count as replicated.
``input_specs``, ``param_structs`` and ``cache_structs`` are the dry-run's
fake ``DTensor`` stand-ins (``base.shape_structs``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..sharding.rules import Dist, Rules, mesh_scope
from . import base
from .transformer import lm_cache_specs, lm_forward, lm_specs
from .whisper import whisper_cache_specs, whisper_forward, whisper_specs


def _register(module: nn.Module, specs: dict) -> None:
    """A submodule for every dict of ``specs``, a frozen ``meta`` parameter
    for every ParamSpec."""
    for name, spec in specs.items():
        if base.is_spec(spec):
            module.register_parameter(name, nn.Parameter(
                torch.empty(spec.shape, dtype=base.torch_dtype(spec.dtype),
                            device="meta"), requires_grad=False))
        else:
            child = nn.Module()
            _register(child, spec)
            module.add_module(name, child)


def _tree_of(module: nn.Module) -> dict:
    out: dict = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = _tree_of(child)
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        _register(self, self.param_specs())

    # -- parameters ----------------------------------------------------------
    def param_specs(self) -> dict:
        if self.cfg.is_encoder_decoder:
            return whisper_specs(self.cfg)
        return lm_specs(self.cfg)

    @property
    def params(self) -> dict:
        """The parameters as the reference's tree (nested dicts)."""
        return _tree_of(self)

    def load(self, tree: dict, dist: Dist | None = None) -> dict:
        """Take ``tree``'s tensors as the parameters (every leaf of the spec
        tree, each of its shape and dtype) -> the parameter tree. With a
        ``dist`` on a mesh, full tensors are distributed by its rules
        (``DTensor`` leaves are taken as they are)."""
        specs = self.param_specs()
        if dist is not None and dist.mesh is not None:
            tree = _onto_mesh(tree, specs, dist)
        got = base.leaves_against(tree, specs)
        for path, spec in base.leaves_with_paths(specs):
            t = base.check_leaf(path, got[path], spec)
            self.get_submodule(".".join(path[:-1])).register_parameter(
                path[-1], nn.Parameter(t, requires_grad=False))
        return self.params

    def init(self, generator: torch.Generator, device="cuda",
             dist: Dist | None = None) -> dict:
        """Draw every parameter from ``generator`` (on ``device``) -> the
        parameter tree; with ``dist`` on a mesh, every rank draws the same
        full tensors and keeps its shards."""
        return self.load(base.init_params(self.param_specs(), generator,
                                          device=device), dist)

    def param_pspecs(self, rules: Rules):
        return base.pspec_tree(self.param_specs(), rules)

    def param_structs(self, rules: Rules, mesh, mode=None):
        return base.shape_structs(self.param_specs(), rules, mesh, mode)

    def n_params(self) -> int:
        return base.param_count(self.param_specs())

    # -- cache ---------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int) -> dict:
        if self.cfg.is_encoder_decoder:
            return whisper_cache_specs(self.cfg, batch, max_len)
        return lm_cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, device=None,
                   dist: Dist | None = None) -> dict:
        """A zero cache on ``device`` (default: the parameters' device, or
        the card while they are unset); with ``dist`` on a mesh, zero
        ``DTensor``s placed by its rules on this rank's device."""
        specs = self.cache_specs(batch, max_len)
        if dist is not None and dist.mesh is not None:
            return base.zeros_on_mesh(specs, dist)
        if device is None:
            p = next(self.parameters(), None)
            device = ("cuda" if p is None or p.device.type == "meta"
                      else p.device)
        dev = resolve_device(device)
        return base.map_specs(
            lambda s: torch.zeros(s.shape, dtype=base.torch_dtype(s.dtype),
                                  device=dev), specs)

    def cache_structs(self, batch: int, max_len: int, rules: Rules, mesh,
                      mode=None):
        return base.shape_structs(self.cache_specs(batch, max_len), rules,
                                  mesh, mode)

    # -- forward ---------------------------------------------------------------
    def forward(self, params, tokens, dist: Dist, *, mode="train", cache=None,
                cache_pos=None, frames=None, prefix_embeds=None):
        """(logits (B, S, V) f32, the cache updated in place | None, aux)."""
        if params is None:
            params = self.params
        if dist.mesh is not None:
            params = base.gather_data_axes(params, dist)
        with mesh_scope(dist):
            if self.cfg.is_encoder_decoder:
                return whisper_forward(
                    params, tokens, self.cfg, dist,
                    frames=frames, mode=mode, cache=cache, cache_pos=cache_pos,
                )
            return lm_forward(
                params, tokens, self.cfg, dist,
                mode=mode, cache=cache, cache_pos=cache_pos,
                prefix_embeds=prefix_embeds,
            )


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def _onto_mesh(tree: dict, specs: dict, dist: Dist) -> dict:
    """``tree``'s plain leaves distributed by ``dist``'s rules; its
    ``DTensor`` leaves as they are."""
    from torch.distributed.tensor import DTensor

    got = base.leaves_against(tree, specs)
    return base.map_specs_with_paths(
        lambda path, spec: got[path] if isinstance(got[path], DTensor)
        else base.distribute_leaf(base.check_leaf(path, got[path], spec),
                                  spec, dist.rules, dist.mesh), specs)


# --------------------------------------------------------------------------
# Dry-run input stand-ins
# --------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules,
                mode=None) -> dict:
    """Fake ``DTensor``s for the step function of an (arch × shape) cell,
    placed by the rules (zero bytes; ``mode``: the ``FakeTensorMode``, the
    active one by default).

    train:   {tokens, labels [, frames | prefix_embeds]}
    prefill: {tokens [, frames | prefix_embeds]}
    decode:  {tokens (B,1), cache_pos ()} — the cache is built separately via
             Model.cache_structs (it is an *input-output* of serve_step).
    """
    B, S = shape.global_batch, shape.seq_len
    mode = mode or base._fake_mode()

    def struct(shp, dtype, *logical):
        return base.fake_dtensor(shp, base.torch_dtype(dtype) if isinstance(
            dtype, str) else dtype, mesh, rules.placements(mesh, *logical),
            mode)

    out: dict = {}
    if shape.kind == "train":
        out["tokens"] = struct((B, S), torch.int32, "batch", None)
        out["labels"] = struct((B, S), torch.int32, "batch", None)
    elif shape.kind == "prefill":
        out["tokens"] = struct((B, S), torch.int32, "batch", None)
    else:  # decode
        out["tokens"] = struct((B, 1), torch.int32, "batch", None)
        out["cache_pos"] = struct((), torch.int32)

    if cfg.is_encoder_decoder and shape.kind != "decode":
        out["frames"] = struct((B, cfg.encoder_seq, cfg.d_model), cfg.dtype,
                               "batch", None, "embed_act")
    if cfg.num_prefix_embeds and shape.kind != "decode":
        out["prefix_embeds"] = struct((B, cfg.num_prefix_embeds, cfg.d_model),
                                      cfg.dtype, "batch", None, "embed_act")
    return out
