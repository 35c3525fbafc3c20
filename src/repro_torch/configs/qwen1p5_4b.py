"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].
40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=5_000_000.0,
    )
