"""granite-moe-1b-a400m [moe] — 32 experts, top-8 (400M active).

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base]. Vocab padded to 49408.
Tiny per-expert FFN (512) with many experts — the routing-bound regime;
the sort-based dispatch path dominates, which is why this config is one of
the §Perf hillclimb candidates.
"""

from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_1b",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=pad_vocab(49155),
        head_dim=64,
        n_experts=32,
        experts_per_token=8,
        moe_capacity_factor=1.25,
        tie_embeddings=True,
        remat="full",
        subquadratic=False,
        sharding_overrides={"mlp": None},  # f=512: TP slice (32) below MXU tile
    )
