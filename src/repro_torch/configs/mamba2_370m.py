"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2e·d = 2048, head_dim 64 → 32 SSD heads. Vocab padded to 50432 for
model-axis sharding (multiple of 256). 370M params; weights FSDP over the
data axis only — tensor-parallel splits of a d=1024 model waste ICI (see
DESIGN.md §4 sharding note). The SSD inter-chunk recurrence runs on
``core.monoid`` — the paper's technique, directly.
"""

from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=16,          # unused (attention-free); kept for param_count API
        n_kv_heads=16,
        d_ff=0,
        vocab_size=pad_vocab(50280),
        head_dim=64,
        layer_pattern=("mamba2",),
        ssm_state=128,
        ssm_heads=32,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        tie_embeddings=True,
        # remat="dots" was tried and REFUTED (§Perf mamba2 iteration B): the
        # saved dot outputs stack across the 48-layer scan (+3.4x traffic);
        # full recompute is cheaper for a 370M model.
        remat="full",
        subquadratic=True,
        sharding_overrides={"rnn": None, "heads": None, "state": None},
    )
