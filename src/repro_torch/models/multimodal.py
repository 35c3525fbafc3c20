"""Modality frontend stubs for the ``audio`` and ``vlm`` archs.

The port's copy of ``repro.models.multimodal``.  These archs specify the
transformer backbone only; the modality frontend provides precomputed
embeddings:

  musicgen-large — EnCodec frame embeddings (B, S, d_model), which replace
    the tokens (the backbone consumes the summed codebook embeddings of a
    frame; decode embeds single codebook tokens, vocab 2048).

  paligemma-3b — SigLIP patch embeddings (B, num_prefix_tokens, d_model),
    consumed as a bidirectional prefix in front of the text tokens
    (prefix-LM masking).

Both are N(0, 1) / sqrt(d_model), drawn in float32 and cast to ``dtype``
(the config's ``compute_dtype`` by default), from an explicit
``torch.Generator`` on the device the embeddings go to.  jax's threefry
stream is not reproduced: the same generator state gives the same
embeddings, but not the reference's values.
"""
from __future__ import annotations

import torch

from repro_torch.device import true_divide
from repro_torch.models.config import ModelConfig


def _normal(generator: torch.Generator, shape, d_model: int, dtype):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return true_divide(x, d_model ** 0.5).to(dtype)


def frame_embeddings(generator: torch.Generator, cfg: ModelConfig,
                     batch: int, seq: int, dtype=None) -> torch.Tensor:
    """musicgen: precomputed EnCodec frame embeddings (B, S, d_model)."""
    return _normal(generator, (batch, seq, cfg.d_model), cfg.d_model,
                   dtype or cfg.compute_dtype)


def patch_embeddings(generator: torch.Generator, cfg: ModelConfig,
                     batch: int, dtype=None) -> torch.Tensor:
    """paligemma: precomputed SigLIP patch embeddings (B, P, d_model)."""
    return _normal(generator, (batch, cfg.num_prefix_tokens, cfg.d_model),
                   cfg.d_model, dtype or cfg.compute_dtype)
