"""Declarative parameter trees.

Models declare their parameters as a tree (nested dicts) of ``ParamSpec``
(shape + logical sharding axes + init), as in the reference, which serves:

* ``init_params``       — materialize real tensors from a ``torch.Generator``;
* ``params_from_numpy`` — carry the reference's arrays over, leaf for leaf;
* ``pspec_tree``        — the logical layout of every leaf (mesh-axis tuples);
* ``param_count`` / ``param_bytes`` — sizes without allocating anything.

``shape_structs`` (the reference's dry-run stand-ins) waits for the dry-run
slice (ROADMAP queue 1, item 9c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..sharding.rules import Rules

#: ParamSpec dtype names -> torch dtypes.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                  # logical axis name per dim (or None)
    dtype: str = "float32"
    init: str = "normal"            # normal | zeros | ones | uniform_scaled
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _build(specs, fn, path: tuple = ()):
    """A nested-dict tree of ``specs``' structure (empty dicts kept) with
    ``fn(path, spec)`` at every leaf, the leaves in the reference's order
    (``jax.tree`` flattens a dict by sorted keys)."""
    if is_spec(specs):
        return fn(path, specs)
    return {k: _build(specs[k], fn, path + (k,)) for k in sorted(specs)}


def map_specs(fn, tree):
    """``fn`` on every ``ParamSpec`` of a nested-dict tree, structure kept."""
    return _build(tree, lambda _, spec: fn(spec))


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path tuple, leaf)] in the reference's order (``jax.tree`` flattens a
    dict by sorted keys)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaves_with_paths(tree[k], prefix + (k,))
    return out


def init_params(tree, generator: torch.Generator, *, device="cuda",
                dtype_override: str | None = None):
    """Materialize a ParamSpec tree on ``device``, drawing from
    ``generator`` (which must live on that device): the reference's
    distributions (normal × scale, uniform ±√(1/fan_in), zeros, ones),
    leaf after leaf in the reference's order, but not its bits."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: draw on the parameters' device")

    def one(spec: ParamSpec):
        dtype = torch_dtype(dtype_override or spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        x = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        if spec.init == "normal":
            x.normal_(generator=generator).mul_(spec.scale)
        elif spec.init == "uniform_scaled":  # fan-in scaled
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            b = float(np.sqrt(1.0 / max(fan_in, 1)))
            x.uniform_(-b, b, generator=generator)
        else:
            raise ValueError(f"unknown init {spec.init}")
        return x.to(dtype)

    return map_specs(one, tree)


def leaves_against(tree, specs) -> dict:
    """{path: ``tree``'s leaf} for every leaf of ``specs``: a leaf missing
    from ``tree``, or one ``specs`` lacks, raises ``KeyError``."""
    want = {p for p, _ in leaves_with_paths(specs)}
    got = dict(leaves_with_paths(tree))
    missing, extra = sorted(want - set(got)), sorted(set(got) - want)
    if missing or extra:
        raise KeyError(f"tree differs from the specs: missing "
                       f"{['.'.join(p) for p in missing]}, extra "
                       f"{['.'.join(p) for p in extra]}")
    return got


def check_leaf(path: tuple, t: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
    """``t`` if it has ``spec``'s shape and dtype, else ``ValueError``."""
    if tuple(t.shape) != tuple(spec.shape) or t.dtype != torch_dtype(spec.dtype):
        raise ValueError(f"{'.'.join(path)}: {t.dtype}{list(t.shape)}, spec "
                         f"{spec.dtype}{list(spec.shape)}")
    return t


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # jax's arrays are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: 2-byte views
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, specs, device="cuda"):
    """The port's tree from a tree of NumPy arrays — the reference's
    parameters or cache as ``jax.tree.map(np.asarray, params)`` gives them.

    Every leaf's path, shape and dtype is held to ``specs`` (a ParamSpec
    tree: ``Model.param_specs()`` or ``Model.cache_specs(...)``); a missing
    or extra leaf raises ``KeyError``, a wrong shape or dtype ``ValueError``.
    """
    dev = resolve_device(device)
    got = leaves_against(tree, specs)
    return _build(specs, lambda path, spec: check_leaf(
        path, _numpy_to_torch(np.asarray(got[path])), spec).to(dev))


def pspec_tree(tree, rules: Rules):
    """Each leaf's layout: a tuple of mesh-axis names (``Rules.spec``)."""
    return map_specs(lambda s: rules.spec(*s.logical), tree)


def param_bytes(tree) -> int:
    return sum(int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
               for _, s in leaves_with_paths(tree) if is_spec(s))


def param_count(tree) -> int:
    return sum(int(np.prod(s.shape))
               for _, s in leaves_with_paths(tree) if is_spec(s))


def stack_specs(spec: ParamSpec, n: int, axis_name: str = "layers") -> ParamSpec:
    """Prepend a stacked-layer axis (the reference's scan-over-layers
    layout, kept so weights carry over without a reshape)."""
    return ParamSpec(
        shape=(n, *spec.shape),
        logical=(axis_name, *spec.logical),
        dtype=spec.dtype,
        init=spec.init,
        scale=spec.scale,
    )


def stack_tree(tree, n: int):
    return map_specs(lambda s: stack_specs(s, n), tree)


def tree_map(fn, *trees):
    """``fn`` on the tensors of nested-dict trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]
