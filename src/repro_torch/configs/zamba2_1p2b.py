"""zamba2-1.2b [hybrid] — Mamba2 blocks + one shared (weight-tied)
attention+MLP block [arXiv:2411.15242; hf].  38L d_model=2048 32H
(GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.

The shared block is applied every ``attn_every`` Mamba2 layers (weight-tied
across applications; the published LoRA per-application specialization is
omitted, as in the reference).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32_000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_groups=1,
        conv_width=4,
        attn_every=2,          # shared block every 2 mamba layers (19 applications)
        rope_theta=10_000.0,
        tie_embeddings=True,
        subquadratic=True,
    )
