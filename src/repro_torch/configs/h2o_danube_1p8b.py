"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818].
SWA window 4096 (mistral-style) → bounded KV cache, so the ``long_500k``
decode cell runs with a 4096-slot ring cache.
"""

from repro_torch.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="h2o_danube_1p8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        head_dim=80,
        sliding_window=4096,
        layer_pattern=("swa",),
        tie_embeddings=False,
        remat="full",
        subquadratic=True,   # bounded attention window
    )
