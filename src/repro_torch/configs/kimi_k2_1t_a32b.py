"""kimi-k2-1t-a32b [moe] — trillion-param MoE, paper-table dims
[arXiv:2501.kimi2; unverified].  61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (expert width) vocab=163840, MoE 384 experts top-8 + 1 shared.

Per the assignment's [unverified] tier we use standard GQA (not MLA), as
the reference does: head_dim = 7168 / 64 = 112.  bf16 params.
"""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=163_840,
        num_experts=384,
        num_experts_per_tok=8,
        num_shared_experts=1,
        rope_theta=50_000.0,
        param_dtype=torch.bfloat16,
    )
