"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048.  The EnCodec frontend is a stub: train/prefill consume
precomputed frame embeddings (models/multimodal.frame_embeddings);
decode embeds single-codebook tokens (vocab 2048).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        rope_theta=10_000.0,
        num_codebooks=4,
    )
