"""Three-term roofline model for dry-run cells, with H100 SXM constants.

  compute    = FLOPs / (chips × peak)          peak = 989 TFLOP/s dense bf16
  memory     = bytes / (chips × HBM bw)        3.35 TB/s HBM3
  collective = coll_bytes / (chips × link bw)  50 GB/s a GPU

The formula and names are the reference's (``repro/analysis/roofline.py``,
whose constants are a TPU v5e's). The constants are NVIDIA's H100 SXM5
data sheet (989 TFLOP/s dense bf16, 3.35 TB/s) and, for the link, the
network a production mesh spans: a 16 × 16 mesh is 32 nodes of 8, so its
collectives leave the node, at one InfiniBand NDR port (400 Gb/s = 50 GB/s)
a GPU. Inside a node NVLink 4 gives 450 GB/s a direction; a cell whose
collectives stay in a node would be 9× faster than this term says.

All inputs are per-device (``analysis/trace.py`` counts each rank's local
ops), so each term is simply per-device quantity / per-chip rate. These
are estimates from stated constants, not measurements. ``model_flops``
(6·N·D train / 2·N·D forward per token) gives the useful-compute ratio
that catches remat and dispatch waste.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12       # dense bf16 FLOP/s per GPU
    hbm_bw: float = 3.35e12          # bytes/s per GPU
    link_bw: float = 50e9            # bytes/s per GPU (InfiniBand NDR)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train), 2·N_active·tokens
    (forward-only prefill/decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * n_active * tokens


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_device: float
    useful_ratio: float

    def to_json(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "useful_ratio": self.useful_ratio,
        }


def roofline_terms(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    per_device_flops: float,
    per_device_bytes: float,
    per_device_coll_bytes: float,
    n_chips: int,
    hw: HW = HW(),
) -> Roofline:
    """Each term is per-device quantity / per-GPU rate (identical to the
    global/(chips × rate) formulation). ``hlo_flops_per_device`` keeps the
    reference's key: here it is the traced step's per-device FLOPs."""
    compute = per_device_flops / hw.peak_flops
    memory = per_device_bytes / hw.hbm_bw
    coll = per_device_coll_bytes / hw.link_bw
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    traced_global = per_device_flops * n_chips
    return Roofline(
        compute_s=compute,
        memory_s=memory,
        collective_s=coll,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_per_device=per_device_flops,
        useful_ratio=(mf / traced_global) if traced_global else 0.0,
    )
