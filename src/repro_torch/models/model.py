"""Model API: training loss, prefill and decode.

The port's copy of ``repro.models.model``:

    model = init_params(cfg, seed_or_generator, device=...)
    loss, metrics  = loss_fn(model, cfg, batch)                  # train
    logits, caches = prefill(model, cfg, batch, caches)
    logits, caches = decode_step(model, cfg, token, caches, cache_len)

``model`` is an ``LM`` module whose ``state_dict`` keys follow the
reference's parameter tree (``embed.table``, ``stack.layers.<i>....``,
``stack.shared_attn....``, ``final_norm.scale``, ``unembed.w``).  ``batch``
is a dict of tensors on the model's device:

    tokens        (B, S)  int      — all archs except pure-embeds input
    targets       (B, S)  int      — the loss only (next-token labels;
                                     negative ones are masked)
    embeds        (B, S, d) float  — musicgen's stub frame embeddings
                                     (``models/multimodal.py``), in place of
                                     tokens
    prefix_embeds (B, P, d) float  — paligemma's stub patch embeddings, a
                                     bidirectional prefix before the tokens;
                                     the loss scores the text after it

The ``ssm`` family's loss is ROADMAP queue 1, item 11 (it serves: prefill
and decode).
``reset_caches`` sets caches, or one slot's rows of them, back to
``init_caches``' values.  ``template`` selects the kernels: ``CUDA`` (the default on the card) or
``TORCH`` (their plain versions).

The loss is computed **chunked over the sequence** (``LOSS_CHUNK``
positions at a time, each chunk recomputed in the backward): the (B, S, V)
logits never exist in full, only (B, chunk, V) transients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.attention import MaskSpec
from repro_torch.models.config import LOCAL, ModelConfig, ShardCfg

LOSS_CHUNK = 512


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
    """Returns (x (B, S_total, d), prefix_len)."""
    if "embeds" in batch:                       # musicgen stub frontend
        x = batch["embeds"].to(cfg.compute_dtype)
    else:
        x = layers.embed(model.embed, batch["tokens"], cfg.compute_dtype)
    prefix_len = 0
    if "prefix_embeds" in batch:                # paligemma stub frontend
        pre = batch["prefix_embeds"].to(cfg.compute_dtype)
        x = torch.cat([pre, x], dim=1)
        prefix_len = pre.shape[1]
    return shard.constrain_act(x, None, None), prefix_len


# ---------------------------------------------------------------------------
# chunked cross-entropy head
# ---------------------------------------------------------------------------
def _xent_chunk(w, hx, tgt):
    """hx (B,c,d), tgt (B,c) -> (sum_loss, sum_correct, count)."""
    logits = (hx @ w).float()                                   # (B,c,V)
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    valid = (tgt >= 0).float()
    tgt_logit = torch.gather(logits, -1, tgt.clamp(min=0)[..., None])[..., 0]
    loss = torch.sum((lse - tgt_logit) * valid)
    correct = torch.sum((logits.argmax(dim=-1) == tgt).float() * valid)
    return loss, correct, torch.sum(valid)


def chunked_xent(model: LM, cfg: ModelConfig, hidden, targets,
                 shard: ShardCfg = LOCAL, chunk: int = LOSS_CHUNK):
    """(mean next-token CE, accuracy) over (B,S,d) hidden vs (B,S) targets.

    Targets < 0 are masked out.  Chunked over S, each chunk recomputed in
    the backward, so the full-vocab logits never materialise."""
    b, s, d = hidden.shape
    w = _unembed_w(model, cfg).to(cfg.compute_dtype)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    targets = targets.long()
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    hc = hidden.reshape(b, -1, chunk, d)
    tc = targets.reshape(b, -1, chunk)
    recompute = torch.is_grad_enabled()
    z = torch.zeros((), dtype=torch.float32, device=hidden.device)
    loss, correct, count = z, z, z
    for i in range(hc.shape[1]):
        args = (w, hc[:, i], tc[:, i])
        part = (checkpoint.checkpoint(_xent_chunk, *args, use_reentrant=False)
                if recompute else _xent_chunk(*args))
        loss, correct, count = (loss + part[0], correct + part[1],
                                count + part[2])
    count = torch.clamp(count, min=1.0)
    return loss / count, correct / count


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------
def loss_fn(model: LM, cfg: ModelConfig, batch: dict,
            shard: ShardCfg = LOCAL, template=None):
    """(total loss, metrics) of a batch with ``targets`` and ``tokens`` or
    ``embeds`` (and ``prefix_embeds``: the loss is over the text after
    the prefix)."""
    x, prefix_len = embed_inputs(model, cfg, batch, shard)
    positions = torch.arange(x.shape[1], device=x.device)
    mask = MaskSpec(causal=True, prefix_len=prefix_len)
    x, _, met = transformer.stack_seq(model.stack, cfg, x, shard,
                                      positions=positions, mask=mask,
                                      mode="train", template=template)
    x = layers.rmsnorm(model.final_norm, x, cfg.norm_eps)
    if prefix_len:
        x = x[:, prefix_len:]                  # loss over the text segment
    loss, acc = chunked_xent(model, cfg, x, batch["targets"], shard)
    total = loss + met.moe_aux + met.moe_z
    return total, {"ce": loss, "acc": acc, "moe_aux": met.moe_aux,
                   "moe_z": met.moe_z, "moe_dropped": met.moe_dropped}


def prefill(model: LM, cfg: ModelConfig, batch: dict, caches,
            shard: ShardCfg = LOCAL, template=None):
    """Fill caches from a prompt (``tokens`` or ``embeds``, after
    ``prefix_embeds`` where given, attended bidirectionally); returns
    (last-position logits, caches)."""
    x, prefix_len = embed_inputs(model, cfg, batch, shard)
    positions = torch.arange(x.shape[1], device=x.device)
    mask = MaskSpec(causal=True, prefix_len=prefix_len)
    x, caches, _ = transformer.stack_seq(model.stack, cfg, x, shard,
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
reset_caches = transformer.reset_caches


def model_flops_per_step(cfg: ModelConfig, batch: int, seq: int,
                         training: bool = True) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (fwd)."""
    n = cfg.active_param_count()
    mult = 6 if training else 2
    return float(mult) * n * batch * seq
