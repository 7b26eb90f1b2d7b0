"""Logical-axis sharding rules (MaxText-style), as in the reference.

Every tensor of the model is annotated with *logical* axis names; a rule set
maps them to mesh axes (or ``None`` = replicated). The port keeps the same
vocabulary and defaults, so an annotation reads the same in both packages.

The reference is single-controller: ``Rules.spec`` gives a
``PartitionSpec`` and ``constrain`` is ``with_sharding_constraint``. The
port is multi-controller over PyTorch's ``DTensor``: every rank runs the
same code, the parameters, optimizer state, caches and batches are
``DTensor``s over a ``DeviceMesh`` with named axes, and their placements
come from the same rules (``Rules.placements``: one ``Shard(dim)`` or
``Replicate()`` a mesh axis). ``Rules.spec`` returns a plain tuple of
mesh-axis names, the ``PartitionSpec`` as a tuple. ``constrain``
redistributes a ``DTensor``; a plain tensor (one device, ``Dist()``)
passes through, as the reference's does without a mesh.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field, replace

# Logical axis vocabulary. Weights and activations use disjoint names for the
# model dim so FSDP (weights) and activation layout can differ.
DEFAULT_MAPPING: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq_act": None,
    "attn_seq": None,
    "embed_act": None,
    "heads_act": "model",
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",
    "cache_kv_heads": None,
    "cache_head_dim": None,
    # weights
    "layers": None,
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "experts": None,
    "rnn": "model",
    "state": None,
    "conv": None,
}


@dataclass(frozen=True)
class Rules:
    mapping: dict = field(default_factory=lambda: dict(DEFAULT_MAPPING))
    mesh_axes: tuple = ("data", "model")

    def with_overrides(self, overrides: dict) -> "Rules":
        m = dict(self.mapping)
        m.update(overrides)
        return replace(self, mapping=m)

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        axes = self.mapping.get(logical, None)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        # Drop axes absent from the active mesh (e.g. "pod" on single-pod).
        kept = tuple(a for a in axes if a in self.mesh_axes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    def spec(self, *logical_axes) -> tuple:
        """One entry a dimension: a mesh-axis name, a tuple of them, or
        ``None`` — the reference's ``PartitionSpec`` as a tuple."""
        return tuple(self.resolve(a) for a in logical_axes)

    def placements(self, mesh, *logical_axes) -> list:
        """The ``DTensor`` placements of a tensor whose dims carry
        ``logical_axes``: one a mesh dim, ``Shard(d)`` where the rules put
        tensor dim ``d`` on that mesh axis, else ``Replicate()``.

        The axes come from ``mesh.mesh_dim_names`` (those absent from the
        mesh drop out, as in ``resolve``). A tuple of mesh axes on one
        tensor dim shards it over each, the first the major one, as in a
        ``PartitionSpec``; DTensor splits a dim over mesh dims in mesh
        order, so the tuple must follow it (``ValueError`` otherwise, and
        for a mesh axis on two tensor dims)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(mesh.mesh_dim_names or ())
        rules = replace(self, mesh_axes=names)
        out: list = [Replicate()] * len(names)
        for d, logical in enumerate(logical_axes):
            axes = rules.resolve(logical)
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"{logical!r} -> {axes}: DTensor shards a "
                                 f"dim over mesh dims in mesh order {names}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {names[i]!r} shards two "
                                     f"dims ({logical_axes})")
                out[i] = Shard(d)
        return out


DEFAULT_RULES = Rules()


@dataclass(frozen=True)
class Dist:
    """Distribution context threaded through model code: the sharding
    rules, the mesh (a ``DeviceMesh`` with named axes; ``None``: one
    device) and the axis roles."""

    rules: Rules = DEFAULT_RULES
    mesh: object = None
    data_axes: tuple = ("pod", "data")
    model_axis: str = "model"

    def shardings(self, specs):
        """A ``Sharding`` a leaf of the ParamSpec tree ``specs`` (``None``
        without a mesh): the targets of ``restore_tree``."""
        if self.mesh is None:
            return None
        if isinstance(specs, dict):
            return {k: self.shardings(v) for k, v in specs.items()}
        return Sharding(self.mesh, tuple(self.rules.placements(
            self.mesh, *specs.logical)))

    @classmethod
    def for_mesh(cls, mesh, rules: Rules | None = None) -> "Dist":
        names = tuple(mesh.mesh_dim_names or ())
        rules = rules or Rules(mesh_axes=names)
        return cls(
            rules=replace(rules, mesh_axes=names),
            mesh=mesh,
            data_axes=tuple(a for a in names if a != "model"),
            model_axis="model" if "model" in names else None,
        )


@dataclass(frozen=True)
class Sharding:
    """Where a leaf goes: a ``DeviceMesh`` and one placement a mesh dim
    (the reference's ``NamedSharding``)."""

    mesh: object
    placements: tuple

    def place(self, t):
        """The full tensor ``t`` (the same on every rank) as a
        ``DTensor``."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(mesh_device(self.mesh)), self.mesh,
                                 list(self.placements))


def mesh_device(mesh):
    """This rank's device of ``mesh`` (the current CUDA device on a CUDA
    mesh)."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def implicit_scope(active: bool):
    """DTensor's ``implicit_replication`` when ``active``: a plain tensor
    that meets a ``DTensor`` (positions, masks, a step's learning rate) is
    taken as replicated, since every rank computes the same one. Nested
    scopes keep it on (DTensor's own context turns it off on leaving)."""
    if not active:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


def mesh_scope(dist: Dist | None):
    """``implicit_scope`` on ``dist``'s mesh; nothing on one device."""
    return implicit_scope(dist is not None and dist.mesh is not None)


def logical_spec(rules: Rules, *axes) -> tuple:
    return rules.spec(*axes)


def constrain(x, rules: Rules, *axes):
    """The reference's ``with_sharding_constraint``: a ``DTensor`` is
    redistributed to the rules' placements over its own mesh (a fault
    raises); a plain tensor passes through, as the reference's does when it
    traces without a mesh."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = rules.placements(x.device_mesh, *axes)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
