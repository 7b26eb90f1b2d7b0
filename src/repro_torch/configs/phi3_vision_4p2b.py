"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (kv=32, i.e. MHA) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]. The vision tower is a stub per the
assignment: ``input_specs`` supplies 256 precomputed patch embeddings that
overwrite the first 256 token positions. LongRoPE approximated as linear
position scaling (DESIGN.md §8).
"""

from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3_vision_4p2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        head_dim=96,
        rope_scaling=16.0,
        num_prefix_embeds=256,
        tie_embeddings=False,
        remat="full",
        subquadratic=False,
        # MHA: kv heads shard over model like q heads (32 % 16 == 0); the
        # cache then shards heads, not sequence (one "model" mapping per spec)
        sharding_overrides={
            "kv_heads": "model", "cache_kv_heads": "model", "cache_seq": None,
        },
    )
