"""qwen1.5-0.5b [dense] — QKV bias, MHA-ish GQA (kv=16). 24L d_model=1024
16H (kv=16) d_ff=2816 vocab=151936 [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1p5_0p5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        head_dim=64,
        qkv_bias=True,
        tie_embeddings=True,
        remat="full",
        subquadratic=False,
        # kv == heads == 16: shard both over model; cache shards heads (one
        # "model" mapping per spec, so cache_seq stays unsharded)
        sharding_overrides={
            "kv_heads": "model", "cache_kv_heads": "model", "cache_seq": None,
        },
    )
