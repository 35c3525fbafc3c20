"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
12L d_model=768 4H d_ff=0 (proj-factor blocks instead of MLP) vocab=50304.

Block mix follows the paper's [x:1] notation: sLSTM at ``slstm_indices``,
mLSTM elsewhere.  O(1) decode state — runs long_500k.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50_304,
        slstm_indices=(5, 11),
        mlstm_proj_factor=2.0,
        conv_width=4,
        ssm_chunk=128,
        tie_embeddings=True,
        scan_layers=False,          # heterogeneous 12-layer stack: unrolled
        subquadratic=True,
    )
