"""Production mesh builders, as in the reference.

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module touches no process group: a ``DeviceMesh`` needs a
``torch.distributed`` world of its size (the dry-run starts a fake one of
256 or 512 ranks in one process; ``torchrun`` starts a real one).
"""

from __future__ import annotations

from ..config import MULTI_POD, SINGLE_POD, MeshConfig
from ..mesh import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A (data, model) mesh over the ranks this deployment has."""
    return make_mesh((data, model), ("data", "model"), device=device)
