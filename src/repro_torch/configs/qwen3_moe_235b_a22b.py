"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
94L d_model=4096 64H (GQA kv=4) d_ff=1536 (expert width) vocab=151936.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=1536,
        vocab_size=151_936,
        head_dim=128,
        num_experts=128,
        num_experts_per_tok=8,
        num_shared_experts=0,
        rope_theta=1_000_000.0,
        param_dtype=torch.bfloat16,
    )
