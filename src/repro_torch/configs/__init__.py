"""Architecture registry: ``--arch <id>`` resolves here.

Copies of the reference package's ``configs/`` (the same hyperparameters),
importing ``repro_torch.config``.

Each module exposes ``get_config() -> ModelConfig`` with the exact assigned
hyperparameters, plus per-arch sharding overrides and training micro-batch
counts tuned for the production mesh (see DESIGN.md §6 / EXPERIMENTS.md).
"""

from __future__ import annotations

import importlib

from repro_torch.config import (
    SHAPES,
    SINGLE_POD,
    MULTI_POD,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
)

ARCH_IDS = [
    "phi3_vision_4p2b",
    "mamba2_370m",
    "grok1_314b",
    "granite_moe_1b",
    "h2o_danube_1p8b",
    "qwen3_8b",
    "qwen1p5_0p5b",
    "yi_34b",
    "whisper_base",
    "recurrentgemma_9b",
    "paper_sfa",          # the paper's own "architecture": SFA workloads
]

# micro-batch counts for train_4k on the production mesh (memory plan;
# validated by compiled.memory_analysis() in EXPERIMENTS.md §Dry-run)
TRAIN_MICROBATCHES = {
    "phi3_vision_4p2b": 8,
    "mamba2_370m": 8,     # SSD intra-chunk scores are the activation peak
    "grok1_314b": 16,
    "granite_moe_1b": 4,
    "h2o_danube_1p8b": 4,
    "qwen3_8b": 8,
    "qwen1p5_0p5b": 2,
    "yi_34b": 8,          # §Perf: sequence-parallel stash is tiny; fewer
                          # microbatches halve the per-step weight gathers
    "whisper_base": 2,
    "recurrentgemma_9b": 8,
}

# per-arch optimizer (the 314B MoE uses factored stats to fit HBM)
OPTIMIZERS = {
    "grok1_314b": OptimizerConfig(name="adafactor", lr=1e-4),
    # yi: attention weights are model-replicated (56 heads ∤ 16), so int8
    # Adam's transient f32 dequant of m/v peaks at ~14 GB — factored stats
    # sidestep it (§Perf iteration 6)
    "yi_34b": OptimizerConfig(name="adafactor", lr=1.5e-4),
    "recurrentgemma_9b": OptimizerConfig(name="adamw8bit", lr=2e-4),
}

# per-arch train-step flags (§Perf hillclimb outcomes; see EXPERIMENTS.md).
# gather-once (ZeRO-1) was tried for yi_34b and REFUTED — the collective cost
# was score all-reduces from head_dim TP, not weight gathers; see §Perf.
TRAIN_FLAGS: dict = {
    "grok1_314b": {"grad_accum_dtype": "bfloat16"},
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.get_config()


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(runnable, reason). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention: O(S^2)/unbounded cache at 500k (DESIGN.md §4)"
    return True, ""


def get_run(arch: str, shape_name: str, mesh: MeshConfig = SINGLE_POD) -> RunConfig:
    import dataclasses

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} × {shape_name} skipped: {why}")
    if shape.kind != "train":
        # inference serves bf16 weights (standard practice; halves HBM),
        # optionally with a serving-specific sharding layout
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        if cfg.serving_overrides:
            cfg = dataclasses.replace(cfg, sharding_overrides=cfg.serving_overrides)
    micro = TRAIN_MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1
    # each microbatch must still shard over the data axes
    n_data = 1
    for s, a in zip(mesh.shape, mesh.axes):
        if a != "model":
            n_data *= s
    micro = max(1, min(micro, shape.global_batch // max(n_data, 1)))
    opt = OPTIMIZERS.get(arch, OptimizerConfig())
    flags = TRAIN_FLAGS.get(arch, {}) if shape.kind == "train" else {}
    return RunConfig(model=cfg, shape=shape, mesh=mesh, optimizer=opt,
                     micro_batches=micro, max_cache_len=shape.seq_len, **flags)


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple so the vocab axis shards over model=16
    (standard practice; the tail ids are never produced by the tokenizer)."""
    return -(-v // multiple) * multiple
