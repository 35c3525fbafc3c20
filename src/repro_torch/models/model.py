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

Every family trains and serves; the ``ssm`` family's stack takes no
remat in training, as the reference's.
``reset_caches`` sets caches, or one slot's rows of them, back to
``init_caches``' values.  ``template`` selects the kernels: ``CUDA`` (the default on the card) or
``TORCH`` (their plain versions).

The loss is computed **chunked over the sequence** (``LOSS_CHUNK``
positions at a time, each chunk recomputed in the backward): the (B, S, V)
logits never exist in full, only (B, chunk, V) transients.

Over a mesh whose placement splits the vocabulary over ``tp``
(``dist.sharding``), the embedding is vocab-parallel (each rank looks up
the ids in its rows, the others' give zeros, one all-reduce) and so is the
cross entropy: the (B, chunk, V/|tp|) logits stay on their rank, and the
row max, the sum of exponentials and the target logit are all-reduced over
``tp``.

Serving over a mesh (``prefill`` and ``decode_step`` given a meshed
``ShardCfg``), the model holds this rank's blocks of its parameters
(``dist.sharding.shard_params``, or ``serving_params``: the form their use
takes) and reads them inside ``dist.sharding.gathered``; ``batch``,
``token`` and ``cache_len`` are this rank's rows, ``caches`` its blocks
and ``kv_block`` the part of the KV caches' sequence they hold
(``dist.sharding.local_caches``).  The vocab-parallel logits are gathered
over ``tp``, and over ``dp`` where the batch is split there, so that every
rank returns every row's logits.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from repro_torch.device import resolve_device, true_divide
from repro_torch.dist.collectives import (all_gather, all_reduce, tp_copy,
                                          tp_reduce)
from repro_torch.models import layers, transformer
from repro_torch.models.attention import MaskSpec
from repro_torch.models.config import LOCAL, KVBlock, ModelConfig, ShardCfg

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


def _vocab_split(shard: ShardCfg, local: int, vocab: int) -> bool:
    return shard.tp_size() > 1 and local < vocab


def _embed_tokens(model: LM, cfg: ModelConfig, ids, shard: ShardCfg):
    """The ids' rows of the table; vocab-parallel where it is split."""
    table = model.embed.table
    vl = table.shape[0]
    if not _vocab_split(shard, vl, cfg.vocab_size):
        return layers.embed(model.embed, ids, cfg.compute_dtype)
    local = ids.long() - shard.tp_rank() * vl
    mine = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)] * mine[..., None].to(table.dtype)
    return tp_reduce(rows, shard).to(cfg.compute_dtype)


def embed_inputs(model: LM, cfg: ModelConfig, batch: dict, shard: ShardCfg):
    """Returns (x (B, S_total, d), prefix_len)."""
    if "embeds" in batch:                       # musicgen stub frontend
        x = batch["embeds"].to(cfg.compute_dtype)
    else:
        x = _embed_tokens(model, cfg, batch["tokens"], shard)
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


def _xent_chunk_tp(w, hx, tgt, shard: ShardCfg, start: int):
    """``_xent_chunk`` on this rank's vocabulary ids [start, start + V_l):
    the row max, the sum of exponentials and the target logit all-reduced
    over ``tp``; the argmax is the lowest id holding the global max."""
    mesh, tp = shard.mesh, shard.tp
    # the product rounded once to the compute dtype, as the whole product
    # is: the backward's input gradient stays float32 until its sum over tp
    logits = layers.split_product(hx.float(), w, w.dtype).to(
        w.dtype).float()                                       # (B,c,V_l)
    vl = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1, keepdim=True), mesh, tp,
                   "max")
    sumexp = tp_reduce(torch.sum(torch.exp(logits - m), dim=-1), shard)
    lse = torch.log(sumexp) + m[..., 0]
    valid = (tgt >= 0).float()
    local = tgt - start
    mine = (local >= 0) & (local < vl)
    tl = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    tgt_logit = tp_reduce(tl * mine.float(), shard)
    loss = torch.sum((lse - tgt_logit) * valid)
    with torch.no_grad():
        lmax, lidx = logits.max(dim=-1)
        gmax = all_reduce(lmax, mesh, tp, "max")
        cand = torch.where(lmax == gmax, lidx + start,
                           torch.full_like(lidx, torch.iinfo(lidx.dtype).max))
        first = all_reduce(cand, mesh, tp, "min")
        correct = torch.sum((first == tgt).float() * valid)
    return loss, correct, torch.sum(valid)


def chunked_xent(model: LM, cfg: ModelConfig, hidden, targets,
                 shard: ShardCfg = LOCAL, chunk: int = LOSS_CHUNK):
    """(mean next-token CE, accuracy) over (B,S,d) hidden vs (B,S) targets.

    Targets < 0 are masked out.  Chunked over S, each chunk recomputed in
    the backward, so the full-vocab logits never materialise.  Over data
    ranks the sums are divided by the ranks' mean count of valid targets
    (the mean over the ranks is then the global batch's mean)."""
    b, s, d = hidden.shape
    w = _unembed_w(model, cfg).to(cfg.compute_dtype)
    fn = _xent_chunk
    if _vocab_split(shard, w.shape[1], cfg.vocab_size):
        hidden = tp_copy(hidden, shard)
        fn = functools.partial(_xent_chunk_tp, shard=shard,
                               start=shard.tp_rank() * w.shape[1])
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
        part = (checkpoint.checkpoint(fn, *args, use_reentrant=False)
                if recompute else fn(*args))
        loss, correct, count = (loss + part[0], correct + part[1],
                                count + part[2])
    if shard.data_parallel():
        # over data ranks: divide by the mean count of the ranks, so that
        # the step's mean over them is the global batch's mean
        n = shard.dp_size()
        count = true_divide(torch.clamp(
            all_reduce(count, shard.mesh, shard.dp), min=1.0), float(n))
    else:
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


def _served(model: LM, cfg: ModelConfig, shard: ShardCfg, kv_block):
    """The context a prefill or decode step reads the parameters in: as
    they are on one process, gathered for their use over a mesh."""
    if shard.mesh is None:
        return contextlib.nullcontext()
    if kv_block is None and shard.tp_size() > 1 and cfg.family != "ssm":
        raise ValueError("serving over a mesh with tp > 1 takes the KV "
                         "caches' KVBlock (dist.sharding.local_caches)")
    from repro_torch.dist.sharding import gathered

    return gathered(model, shard)


def _logits(model: LM, cfg: ModelConfig, x, shard: ShardCfg):
    """(B, S, V) logits of the final hidden states: the vocab-parallel
    blocks gathered over ``tp``, and the rows over ``dp`` where the batch
    is split there."""
    w = _unembed_w(model, cfg)
    logits = x @ w.to(x.dtype)
    if _vocab_split(shard, w.shape[1], cfg.vocab_size):
        logits = all_gather(logits, shard.mesh, shard.tp, logits.dim() - 1)
    if shard.mesh is not None and shard.batch_sharded and \
            shard.dp_size() > 1:
        logits = all_gather(logits, shard.mesh, shard.dp, 0)
    return logits


def prefill(model: LM, cfg: ModelConfig, batch: dict, caches,
            shard: ShardCfg = LOCAL, template=None,
            kv_block: KVBlock | None = None):
    """Fill caches from a prompt (``tokens`` or ``embeds``, after
    ``prefix_embeds`` where given, attended bidirectionally); returns
    (last-position logits, caches).  Over a mesh: the module's text."""
    with _served(model, cfg, shard, kv_block):
        x, prefix_len = embed_inputs(model, cfg, batch, shard)
        positions = torch.arange(x.shape[1], device=x.device)
        mask = MaskSpec(causal=True, prefix_len=prefix_len)
        x, caches, _ = transformer.stack_seq(
            model.stack, cfg, x, shard, positions=positions, mask=mask,
            caches=caches, mode="prefill", template=template,
            kv_block=kv_block)
        x = layers.rmsnorm(model.final_norm, x[:, -1:], cfg.norm_eps)
        return _logits(model, cfg, x, shard), caches


def decode_step(model: LM, cfg: ModelConfig, token, caches, cache_len,
                shard: ShardCfg = LOCAL, template=None,
                kv_block: KVBlock | None = None):
    """One decode step.  token (B, 1) int; cache_len: filled length (an int
    or a (B,) tensor).  Over a mesh: the module's text."""
    with _served(model, cfg, shard, kv_block):
        x = _embed_tokens(model, cfg, token, shard)
        x = shard.constrain_act(x, None, None)
        x, caches = transformer.stack_step(
            model.stack, cfg, x, shard, caches=caches, cache_len=cache_len,
            template=template, kv_block=kv_block)
        x = layers.rmsnorm(model.final_norm, x, cfg.norm_eps)
        return _logits(model, cfg, x, shard), caches


init_caches = transformer.init_caches
reset_caches = transformer.reset_caches


def model_flops_per_step(cfg: ModelConfig, batch: int, seq: int,
                         training: bool = True) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (fwd)."""
    n = cfg.active_param_count()
    mult = 6 if training else 2
    return float(mult) * n * batch * seq
