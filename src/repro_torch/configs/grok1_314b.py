"""grok-1-314b [moe] — 8 experts, top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072 [hf:xai-org/grok-1].
Memory plan for v5e-16GB × 256 (§Perf iterations 7–8): params stored bf16
2-D sharded FSDP(data)×TP(model) (1.23 GB/chip), Adafactor stats (factored —
tiny, update in f32 from bf16 params, T5X low-memory style), bf16 gradient
accumulation, remat=full, 16 microbatches on train_4k. Attention logit
soft-capping at 30 as in the released model.
"""

from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="grok1_314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        head_dim=128,
        n_experts=8,
        experts_per_token=2,
        moe_capacity_factor=1.25,
        attn_logit_softcap=30.0,
        tie_embeddings=False,
        remat="full",
        param_dtype="bfloat16",
        subquadratic=False,
        # FSDP over the pod axis too: on the 2-pod mesh params/optimizer
        # shard 512-way (the "pod" entry is dropped on single-pod meshes)
        sharding_overrides={"embed": ("pod", "data")},
    )
