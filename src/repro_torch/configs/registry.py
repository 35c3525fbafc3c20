"""Arch registry: ``get_config("<id>")`` + reduced smoke configs.

The port's copy of ``repro.configs.registry``.  It lists the reference's
ten architectures; the eight whose block composition the port carries,
``zamba2-1.2b`` (hybrid), ``llama3-8b``, ``qwen1.5-4b``, ``minitron-4b``
and ``granite-8b`` (dense), ``qwen3-moe-235b-a22b`` and ``kimi-k2-1t-a32b``
(moe) and ``xlstm-125m`` (ssm), have configs, and the other two raise
``NotImplementedError`` (ROADMAP queue 1, item 11: the ``audio`` and
``vlm`` families).  ``smoke(cfg)`` gives the reference's reduced config
field for field.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig, not_ported

ARCHS = {
    "musicgen-large": None,
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "qwen1.5-4b": "repro_torch.configs.qwen1p5_4b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "paligemma-3b": None,
}


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {list(ARCHS)}")
    if ARCHS[name] is None:
        raise not_ported(f"arch {name!r}", 11)
    return importlib.import_module(ARCHS[name]).config()


def smoke(cfg: ModelConfig, *, layers: int = 2) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    heads = (heads // kv) * kv or kv
    repl = dict(
        num_layers=max(layers, 2),
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        q_chunk=64,
        kv_chunk=64,
        remat="none",
    )
    if cfg.num_experts:
        repl.update(num_experts=8,
                    num_experts_per_tok=min(2, cfg.num_experts_per_tok),
                    num_shared_experts=min(1, cfg.num_shared_experts))
    if cfg.family == "hybrid":
        repl.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
                    attn_every=2)
    if cfg.family == "ssm":
        repl.update(slstm_indices=(1,), ssm_chunk=16, d_model=64,
                    num_heads=2, num_kv_heads=2)
    if cfg.num_prefix_tokens:
        repl.update(num_prefix_tokens=8)
    return dataclasses.replace(cfg, **repl)
