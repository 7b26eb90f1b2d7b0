"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427].
38 layers = 12 × (rglru, rglru, local-attn) + 2 rglru tail. The RG-LRU
recurrence runs on ``core.monoid`` (affine scan) — the paper technique's
second direct instantiation; local attention window 2048 bounds the cache,
so ``long_500k`` runs.
"""

from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256_000,
        head_dim=256,
        layer_pattern=("rglru", "rglru", "lattn"),
        rglru_width=4096,
        local_attn_window=2048,
        ssm_conv_width=4,
        tie_embeddings=True,
        remat="full",
        subquadratic=True,
    )
