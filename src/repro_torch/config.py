"""Configuration system: model / shape / mesh / run configs.

A copy of the reference package's ``config.py`` (the port imports nothing
of it). Every assigned architecture is a ``ModelConfig`` in
``repro_torch.configs.<id>``;
shapes are the four assigned input-shape cells; a ``RunConfig`` bundles
model + shape + mesh + optimizer + sharding-rule overrides and is what the
launchers consume (``--arch`` / ``--shape`` CLI flags resolve to one).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention options
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    sliding_window: int = 0          # 0 = global attention (h2o-danube: 4096)
    rope_theta: float = 10_000.0
    rope_scaling: float = 1.0        # phi-3 longrope approximated as linear
    attn_logit_softcap: float = 0.0  # grok-style soft-capping
    mlp_variant: str = "swiglu"      # swiglu | gelu (whisper)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0               # N
    ssm_heads: int = 0               # H
    ssm_head_dim: int = 0            # P
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid / layer pattern: cycled over the depth. entries:
    #   "attn" | "swa" | "rglru" | "mamba2"
    layer_pattern: tuple = ("attn",)
    rglru_width: int = 0             # 0 -> d_model
    local_attn_window: int = 2048    # recurrentgemma local attention

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper 30 s of audio frames (stubbed)

    # modality stubs (vlm / audio): prefix embeddings provided by input_specs
    num_prefix_embeds: int = 0       # phi-3-vision: image patch embeddings

    # numerics / memory
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"              # none | full | dots
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    # per-arch sharding rule overrides (logical axis -> mesh axes)
    sharding_overrides: dict = field(default_factory=dict)
    # optional serving-specific overrides: training and serving want
    # different layouts (e.g. yi-34b trains FSDP+SP but serves head_dim-TP);
    # applied instead of sharding_overrides for prefill/decode shapes
    serving_overrides: dict = field(default_factory=dict)

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (reported in configs/docs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim()
        per_layer = 0
        pattern = self.layer_pattern
        for i in range(self.n_layers):
            kind = pattern[i % len(pattern)]
            if kind in ("attn", "swa", "lattn"):
                per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            elif kind == "rglru":
                w = self.rglru_width or d
                per_layer += 2 * d * w + w * d + 2 * w * w + w * self.ssm_conv_width + 5 * w
            elif kind == "mamba2":
                din = self.ssm_expand * d
                per_layer += d * (2 * din + 2 * self.ssm_state + self.ssm_heads) + din * d
            if self.d_ff > 0:
                if self.n_experts:
                    per_layer += self.n_experts * 3 * d * f + d * self.n_experts
                else:
                    n_mats = 3 if self.mlp_variant == "swiglu" else 2
                    per_layer += n_mats * d * f
            per_layer += 2 * d  # norms
        total = per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted above
            enc = self.n_encoder_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                + (3 if self.mlp_variant == "swiglu" else 2) * d * f + 2 * d
            )
            # decoder cross-attention
            total += enc + self.n_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d + d
            )
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of the experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * f
        return int(dense + self.n_layers * self.experts_per_token * 3 * d * f)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: tuple = (16, 16)
    axes: tuple = ("data", "model")
    multi_pod: bool = False

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> tuple:
        """Mesh axes that shard the batch (everything except "model")."""
        return tuple(a for a in self.axes if a != "model")


SINGLE_POD = MeshConfig((16, 16), ("data", "model"), multi_pod=False)
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"), multi_pod=True)
HOST_MESH = MeshConfig((1, 1), ("data", "model"), multi_pod=False)


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adamw8bit | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"         # cosine | linear | constant


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = SINGLE_POD
    optimizer: OptimizerConfig = OptimizerConfig()
    micro_batches: int = 1
    seed: int = 0
    # ZeRO-1 style: all-gather a bf16 compute copy of the FSDP-sharded f32
    # params ONCE per step (outside the microbatch loop) instead of per
    # microbatch per layer. Trades +params_bf16/TP HBM for a micro_batches×
    # reduction in weight-gather traffic. (§Perf iteration on yi_34b.)
    gather_params_once: bool = False
    # dtype of the microbatch gradient-accumulation buffer. bf16 halves the
    # largest train-step temporary on very large models (314B: 4.9 -> 2.45 GB
    # per device) at the cost of ~8-bit accumulation mantissa over
    # micro_batches partial sums.
    grad_accum_dtype: str = "float32"
    # serving
    max_cache_len: int = 0           # 0 -> shape.seq_len
    # checkpointing / fault tolerance
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    async_checkpoint: bool = True

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def reduced(model: ModelConfig, **overrides: Any) -> ModelConfig:
    """A smoke-test-sized model of the same family (per-arch tests use this)."""
    base = dict(
        n_layers=min(model.n_layers, 2 * len(model.layer_pattern)),
        d_model=min(model.d_model, 64),
        n_heads=min(model.n_heads, 4),
        n_kv_heads=min(model.n_kv_heads, 2),
        d_ff=min(model.d_ff, 128) if model.d_ff else 0,
        vocab_size=min(model.vocab_size, 256),
        head_dim=16,
        n_experts=min(model.n_experts, 4),
        experts_per_token=min(model.experts_per_token, 2),
        ssm_state=min(model.ssm_state, 16),
        ssm_heads=min(model.ssm_heads, 4) if model.ssm_heads else 0,
        ssm_head_dim=min(model.ssm_head_dim, 8) if model.ssm_head_dim else 0,
        ssm_chunk=8,
        rglru_width=min(model.rglru_width, 64) if model.rglru_width else 0,
        local_attn_window=32,
        sliding_window=min(model.sliding_window, 32) if model.sliding_window else 0,
        n_encoder_layers=min(model.n_encoder_layers, 2),
        encoder_seq=32,
        num_prefix_embeds=min(model.num_prefix_embeds, 8),
        sharding_overrides={},
        remat="none",
    )
    base.update(overrides)
    return dataclasses.replace(model, **base)
