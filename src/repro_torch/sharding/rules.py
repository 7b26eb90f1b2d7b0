"""Logical-axis sharding rules (MaxText-style), as in the reference.

Every tensor of the model is annotated with *logical* axis names; a rule set
maps them to mesh axes (or ``None`` = replicated). The port keeps the same
vocabulary and defaults, so an annotation reads the same in both packages,
but it runs the LM half on one device: ``Rules.spec`` returns a plain tuple
of mesh-axis names (there is no ``PartitionSpec`` here), ``constrain`` is
the identity, and a ``Dist`` that carries a mesh raises until the sharded
LM path is ported (ROADMAP queue 1, item 9c: ``launch/{train,mesh,dryrun}``
with the sharded LM path).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

#: The ROADMAP item that brings a mesh to the LM half.
SHARDED_LM_ITEM = ("ROADMAP queue 1 item 9c: the sharded LM path "
                   "(launch/{train,mesh,dryrun}, constrain over a DeviceMesh, "
                   "moe.py's shard_map branch)")

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


DEFAULT_RULES = Rules()


@dataclass(frozen=True)
class Dist:
    """Distribution context threaded through model code: the sharding
    rules, the mesh (``None``: one device) and the axis roles.

    Only ``mesh=None`` runs: a mesh raises ``NotImplementedError`` rather
    than being ignored, since a sharded LM path is not ported yet."""

    rules: Rules = DEFAULT_RULES
    mesh: object = None
    data_axes: tuple = ("pod", "data")
    model_axis: str = "model"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                f"the LM half runs on one device (Dist(mesh=None)); a mesh "
                f"waits for {SHARDED_LM_ITEM}")

    @classmethod
    def for_mesh(cls, mesh, rules: Rules | None = None) -> "Dist":
        names = tuple(mesh.axis_names)
        rules = rules or Rules(mesh_axes=names)
        return cls(
            rules=replace(rules, mesh_axes=names),
            mesh=mesh,
            data_axes=tuple(a for a in names if a != "model"),
            model_axis="model" if "model" in names else None,
        )


def logical_spec(rules: Rules, *axes) -> tuple:
    return rules.spec(*axes)


def constrain(x, rules: Rules, *axes):
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh. The port's LM half has no mesh (a ``Dist`` with one raises), so
    this is the identity, as the reference's is when it traces without a
    mesh."""
    return x
