"""yi-34b [dense] — llama-arch GQA. 60L d_model=7168 56H (kv=8) d_ff=20480
vocab=64000 [arXiv:2403.04652].

56 heads do not divide the 16-way model axis. The naive fix — shard
``head_dim`` (128/16 = 8) — is catastrophic for training: every S×S attention
score block becomes a partial sum that GSPMD all-reduces (measured: 259k
all-reduces, 15.5 TB/device/step — EXPERIMENTS.md §Perf iteration 2-REFUTED).

Production layout instead: **no tensor parallelism**. Weights shard 2-D over
(data × model) = 256-way pure FSDP (0.54 GB/chip f32), activations shard
batch over ``data`` and *sequence over ``model``* (ring-attention style:
the per-layer K/V all-gather is 8 MB where score all-reduces were 3.5 TB).
"""

from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="yi_34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        head_dim=128,
        rope_theta=5_000_000.0,
        tie_embeddings=False,
        remat="full",
        subquadratic=False,
        sharding_overrides={
            # attention: FSDP over data only, heads unsharded (56 ∤ 16); the
            # model axis duplicates attention compute (~21% of FLOPs) — far
            # cheaper than score all-reduces (see §Perf iterations 2–4)
            "heads": None,
            "head_dim": None,
            "heads_act": None,
            # MLP + vocab: classic TP (20480/16, 64000/16)
            "mlp": "model",
            "vocab": "model",
            # activations: DP × sequence-parallel residual stream; attention
            # internally gathers seq (attn_seq default None)
            "seq_act": "model",
            "cache_head_dim": None,   # decode cache shards seq over model
        },
        # serving wants the opposite trade: no S×S scores exist at decode, so
        # head_dim TP is cheap there and keeps weights model-sharded
        # (args 5.1 -> 4.3 GB, decode fits 16 GB; §Perf)
        serving_overrides={
            "heads": None,
            "head_dim": "model",
            "heads_act": None,
            "cache_head_dim": None,
        },
    )
