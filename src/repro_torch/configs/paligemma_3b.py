"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726; hf].
18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.

The SigLIP frontend is a stub: 256 precomputed patch embeddings
(models/multimodal.patch_embeddings) consumed as a bidirectional prefix
(prefix-LM masking); loss over the text suffix only.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        d_ff=16_384,
        vocab_size=257_216,
        head_dim=256,
        rope_theta=10_000.0,
        tie_embeddings=True,
        num_prefix_tokens=256,
    )
