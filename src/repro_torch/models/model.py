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

``input_specs``, ``param_structs`` and ``cache_structs`` (the reference's
dry-run stand-ins) wait for the dry-run slice (ROADMAP queue 1, item 9c).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..sharding.rules import Dist, Rules
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

    def load(self, tree: dict) -> dict:
        """Take ``tree``'s tensors as the parameters (every leaf of the spec
        tree, each of its shape and dtype) -> the parameter tree."""
        specs = self.param_specs()
        got = base.leaves_against(tree, specs)
        for path, spec in base.leaves_with_paths(specs):
            t = base.check_leaf(path, got[path], spec)
            self.get_submodule(".".join(path[:-1])).register_parameter(
                path[-1], nn.Parameter(t, requires_grad=False))
        return self.params

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Draw every parameter from ``generator`` (on ``device``) -> the
        parameter tree."""
        return self.load(base.init_params(self.param_specs(), generator,
                                          device=device))

    def param_pspecs(self, rules: Rules):
        return base.pspec_tree(self.param_specs(), rules)

    def n_params(self) -> int:
        return base.param_count(self.param_specs())

    # -- cache ---------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int) -> dict:
        if self.cfg.is_encoder_decoder:
            return whisper_cache_specs(self.cfg, batch, max_len)
        return lm_cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """A zero cache on ``device`` (default: the parameters' device, or
        the card while they are unset)."""
        if device is None:
            p = next(self.parameters(), None)
            device = ("cuda" if p is None or p.device.type == "meta"
                      else p.device)
        dev = resolve_device(device)
        return base.map_specs(
            lambda s: torch.zeros(s.shape, dtype=base.torch_dtype(s.dtype),
                                  device=dev),
            self.cache_specs(batch, max_len))

    # -- forward ---------------------------------------------------------------
    def forward(self, params, tokens, dist: Dist, *, mode="train", cache=None,
                cache_pos=None, frames=None, prefix_embeds=None):
        """(logits (B, S, V) f32, the cache updated in place | None, aux)."""
        if params is None:
            params = self.params
        if self.cfg.is_encoder_decoder:
            return whisper_forward(
                params, tokens, self.cfg, dist,
                frames=frames, mode=mode, cache=cache, cache_pos=cache_pos,
            )
        return lm_forward(
            params, tokens, self.cfg, dist,
            mode=mode, cache=cache, cache_pos=cache_pos, prefix_embeds=prefix_embeds,
        )


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
