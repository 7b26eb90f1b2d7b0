"""whisper-base [audio] — encoder-decoder, conv frontend stubbed.

6L (enc) + 6L (dec) d_model=512 8H d_ff=2048 vocab=51865 [arXiv:2212.04356].
``input_specs`` provides precomputed frame embeddings (B, 1500, 512) — the
conv1d×2 + GELU frontend is the documented stub. Vocab padded to 51968.
72M params on a 256-chip mesh: attention is replicated (8 heads < 16-way
axis); only MLP (f=2048) and vocab shard over ``model`` (DESIGN.md §4).
Decode cells run the *decoder* with a self-attn cache of the assigned length
(whisper's real 448 ctx is a training detail, not an architecture limit).
"""

from repro_torch.config import ModelConfig
from repro_torch.configs import pad_vocab


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper_base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=pad_vocab(51865),
        head_dim=64,
        mlp_variant="gelu",
        is_encoder_decoder=True,
        n_encoder_layers=6,
        encoder_seq=1500,
        tie_embeddings=True,
        remat="none",        # 72M params: recompute buys nothing
        subquadratic=False,
        sharding_overrides={"heads": None, "kv_heads": None, "heads_act": None},
    )
