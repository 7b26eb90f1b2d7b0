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
import math
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
        tensor dim ``d`` on that mesh axis, else ``Replicate()``; none
        without a mesh (``None``: one device).

        The axes come from ``mesh.mesh_dim_names`` (those absent from the
        mesh drop out, as in ``resolve``). A tuple of mesh axes on one
        tensor dim shards it over each, the first the major one, as in a
        ``PartitionSpec``; DTensor splits a dim over mesh dims in mesh
        order, so the tuple must follow it (``ValueError`` otherwise, and
        for a mesh axis on two tensor dims)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
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


def product(eq: str, x, *ws):
    """The product of an activation ``x`` and each weight ``w`` (a tuple of
    results when there are several), as the einsum equation ``eq`` labels
    their dims, run as one matrix product (``_matmul``). Plain tensors go
    straight to it.

    On ``DTensor``s each product runs on each rank's shards under
    ``local_map``, the placements of its result and of its gradients
    stated, never through DTensor's strategy for the product: that
    flattens dims together, and some PyTorch versions (2.11) refuse to
    when a non-leading one is sharded (a sequence-sharded stream, a
    head_dim-sharded weight). On each mesh dim:

    * both operands split along dims the product keeps (the sequence and a
      weight's output dim): the activation is gathered first, once for all
      the weights — Megatron's sequence parallelism, the sequence gathered
      before a product whose weight is split over ``model``;
    * a contracted dim split in one operand is split alike in the other (a
      local slice), and the result is a partial sum there;
    * a kept dim split in one operand is split so in the result.

    A dim the mesh does not split evenly takes DTensor's own strategy:
    ``local_map`` infers global shapes from even shards."""
    from torch.distributed.tensor import DTensor, Replicate

    op = _matmul(eq)
    if not any(isinstance(t, DTensor) for t in (x, *ws)):
        outs = tuple(op(x, w) for w in ws)
        return outs if len(ws) > 1 else outs[0]
    mesh = next(t for t in (x, *ws) if isinstance(t, DTensor)).device_mesh
    x, *ws = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in (x, *ws))
    ins, _ = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    xp = [Replicate() if p.is_partial() else p for p in x.placements]
    for w in ws:
        for i, p in enumerate(w.placements):
            a, b = _letter(xp[i], lx), _letter(p, lw)
            if a is not None and b is not None and a != b:
                xp[i] = Replicate()                 # gather the activation
    x = x.redistribute(mesh, xp)
    outs = tuple(_local_product(eq, op, x, w, mesh) for w in ws)
    return outs if len(ws) > 1 else outs[0]


def _matmul(eq: str):
    """``eq`` (activation labels, weight labels -> result labels) as one
    matrix product: the activation's kept dims lead, its contracted dims
    trail, in the weight's order; the weight holds the contracted dims
    first or last, and the result is the activation's kept dims then the
    weight's. Anything else raises ``ValueError``."""
    ins, lo = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    con = "".join(c for c in lw if c in lx and c not in lo)
    kx = lx[:len(lx) - len(con)]
    kw = "".join(c for c in lw if c not in con)
    first = lw == con + kw
    if lx != kx + con or lo != kx + kw or not (first or lw == kw + con):
        raise ValueError(f"{eq!r} is not one matrix product")
    n, m = len(con), len(kw)

    def op(x, w):
        kept = w.shape[n:] if first else w.shape[:m]
        if n > 1:
            x = x.flatten(len(kx))
        w = (w.flatten(0, n - 1).flatten(1) if first
             else w.flatten(m).flatten(0, m - 1).T)
        y = x @ w
        return y.unflatten(-1, kept) if m > 1 else y
    return op


def _letter(p, labels: str):
    """The label of the dim a placement shards, else ``None``."""
    from torch.distributed.tensor import Shard

    return labels[p.dim] if isinstance(p, Shard) else None


def _local_product(eq: str, op, x, w, mesh):
    """``product`` of one weight, the activation ``x`` already gathered
    where the two would split kept dims on one mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ins, out = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    xp = list(x.placements)
    wp = [Replicate() if p.is_partial() else p for p in w.placements]
    for i in range(mesh.ndim):
        a, b = _letter(xp[i], lx), _letter(wp[i], lw)
        if a is not None and b is None and a in lw:
            wp[i] = Shard(lw.index(a))
        elif b is not None and a is None and b in lx:
            xp[i] = Shard(lx.index(b))
    sizes: dict = {}
    for t, labels, places in ((x, lx, xp), (w, lw, wp)):
        for i, p in enumerate(places):
            if isinstance(p, Shard):
                sizes.setdefault((labels[p.dim], t.shape[p.dim]), {})[i] = (
                    mesh.size(i))
    if any(n % math.prod(by.values()) for (_, n), by in sizes.items()):
        return op(x, w)
    out_p, gx, gw = [], [], []
    for i in range(mesh.ndim):
        a, b = _letter(xp[i], lx), _letter(wp[i], lw)
        c = a or b
        out_p.append(Replicate() if c is None else Shard(out.index(c))
                     if c in out else Partial())
        # a rank's gradient of an operand it holds whole sums over the
        # other's split of a dim it lacks
        gx.append(xp[i] if a else Partial() if b and b not in lx
                  else Replicate())
        gw.append(wp[i] if b else Partial() if a and a not in lw
                  else Replicate())
    fn = local_map(op, out_placements=out_p, in_placements=(xp, wp),
                   in_grad_placements=(gx, gw), device_mesh=mesh)
    return fn(x.redistribute(mesh, xp), w.redistribute(mesh, wp))
