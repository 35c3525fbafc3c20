"""Model API for the serving path.

The port's copy of ``repro.models.model``:

    model = init_params(cfg, seed_or_generator, device=...)
    logits, caches = prefill(model, cfg, batch, caches)
    logits, caches = decode_step(model, cfg, token, caches, cache_len)

``model`` is an ``LM`` module whose ``state_dict`` keys follow the
reference's parameter tree (``embed.table``, ``stack.layers.<i>....``,
``stack.shared_attn....``, ``final_norm.scale``, ``unembed.w``).  ``batch``
is a dict with ``tokens`` (B, S) int; the reference's modality stubs
(``embeds``, ``prefix_embeds``) and the training loss (``loss_fn``,
``chunked_xent``) are ROADMAP queue 1, item 11.  ``template`` selects the
kernels: ``CUDA`` (the default on the card) or ``TORCH`` (their plain
versions).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.attention import MaskSpec
from repro_torch.models.config import LOCAL, ModelConfig, ShardCfg, not_ported


class LM(nn.Module):
    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        self.embed = layers.Embedding(gen, cfg.vocab_size, cfg.d_model,
                                      cfg.param_dtype, device)
        self.stack = transformer.init_layer_stack(gen, cfg, device)
        self.final_norm = layers.RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.unembed = layers.Dense(gen, cfg.d_model, cfg.vocab_size,
                                        cfg.param_dtype, device)


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                device=None) -> LM:
    """The model with its weights drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, or a seed for one), with the
    reference's distributions.  ``device="meta"`` allocates nothing."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(int(generator))
    return LM(gen, cfg, dev)


def _unembed_w(model: LM, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return model.embed.table.t()               # (d, V)
    return model.unembed.w


def embed_inputs(model: LM, cfg: ModelConfig, batch: dict, shard: ShardCfg):
    """Returns (x (B, S, d), prefix_len); the token path only."""
    for stub in ("embeds", "prefix_embeds"):
        if stub in batch:
            raise not_ported(f"the {stub!r} input", 11)
    x = layers.embed(model.embed, batch["tokens"], cfg.compute_dtype)
    return shard.constrain_act(x, None, None), 0


def prefill(model: LM, cfg: ModelConfig, batch: dict, caches,
            shard: ShardCfg = LOCAL, template=None):
    """Fill caches from a prompt; returns (last-position logits, caches)."""
    x, prefix_len = embed_inputs(model, cfg, batch, shard)
    positions = torch.arange(x.shape[1], device=x.device)
    mask = MaskSpec(causal=True, prefix_len=prefix_len)
    x, caches = transformer.stack_seq(model.stack, cfg, x, shard,
                                      positions=positions, mask=mask,
                                      caches=caches, mode="prefill",
                                      template=template)
    x = layers.rmsnorm(model.final_norm, x[:, -1:], cfg.norm_eps)
    logits = x @ _unembed_w(model, cfg).to(x.dtype)
    return logits, caches


def decode_step(model: LM, cfg: ModelConfig, token, caches, cache_len,
                shard: ShardCfg = LOCAL, template=None):
    """One decode step.  token (B, 1) int; cache_len: filled length (an int
    or a (B,) tensor)."""
    x = layers.embed(model.embed, token, cfg.compute_dtype)
    x = shard.constrain_act(x, None, None)
    x, caches = transformer.stack_step(model.stack, cfg, x, shard,
                                       caches=caches, cache_len=cache_len,
                                       template=template)
    x = layers.rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = x @ _unembed_w(model, cfg).to(x.dtype)
    return logits, caches


init_caches = transformer.init_caches
