"""The decoder layer stack for every family: ``dense``, ``audio``, ``vlm``,
``moe``, ``hybrid`` and ``ssm``.

The port's copy of ``repro.models.transformer``:

  dense / audio / vlm
          — GQA attention + SwiGLU MLP (pre-norm residual), per layer (the
            ``audio`` and ``vlm`` families differ from ``dense`` only in
            their inputs: ``models/model.py`` ``embed_inputs``)
  moe     — GQA attention + top-k MoE FFN (+ shared experts), per layer
            (``models/moe.py``); its load-balance and z losses and dropped
            fraction come back as ``StackMetrics`` summed over the layers
  hybrid  — Mamba2 blocks with ONE weight-tied shared attention+MLP block
            applied before each group of ``attn_every`` layers (zamba2):
            G = L / attn_every applications, each with its own KV cache;
            the Mamba states are stacked over all L layers
  ssm     — xLSTM: mLSTM blocks with sLSTM at ``slstm_indices``
            (``models/xlstm.py``), a heterogeneous stack: its caches are a
            tuple of per-layer ``MLSTMState``/``SLSTMState`` (batch axis
            0), as in the reference

Layers run as a Python loop (the reference's ``lax.scan``).  Caches are
stacked along a leading layer axis (but the ``ssm`` family's), as in the
reference, and are updated in place: each function returns the caches it
was given.  In ``mode="train"`` each layer (dense) or each group (hybrid)
runs under the config's rematerialisation policy (:func:`_remat`); the
shared block of a hybrid stack is one set of parameters, so its gradient
sums over all its applications, as in the reference.  The ``ssm`` stack
trains with no rematerialisation whatever ``cfg.remat`` says, as the
reference's ``_seq_xlstm_stack`` does.

Each layer reads its parameters inside :func:`_in_use`: as they are, or,
in the sharded train step (``LayerStack.layer_use`` set), gathered over
the ranks for that use; the gather then runs inside the layer's
rematerialised region, again in its recomputation, so that one layer's
(a hybrid group's) gathered leaves live at a time.

Serving over a mesh, the caches are this rank's blocks
(``dist.sharding.local_caches``): its data rows of every state, and of the
attention KV caches its block of the sequence, which ``kv_block`` names
(``models.blocks``); Mamba2 and xLSTM states are split by rows only.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.models import layers, mamba2, moe, xlstm
from repro_torch.models.attention import MaskSpec
from repro_torch.models.blocks import Attention, KVCache, attention
from repro_torch.models.config import KVBlock, ModelConfig, ShardCfg

FAMILIES = ("dense", "audio", "vlm", "moe", "hybrid", "ssm")
MODES = ("train", "prefill")
# the matrix products whose outputs ``remat="dots"`` keeps: those with no
# batch dimension (jax's ``dots_with_no_batch_dims_saveable``); a product
# of a (B, S, d) activation and a (d, n) weight is one ``mm``
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class StackMetrics(NamedTuple):
    moe_aux: torch.Tensor
    moe_z: torch.Tensor
    moe_dropped: torch.Tensor

    @staticmethod
    def zero(device=None):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return StackMetrics(z, z, z)


def _dots_policy(ctx, op, *args, **kwargs):
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's rematerialisation policy: ``none``;
    ``block`` saves only its inputs and recomputes the rest in the
    backward; ``dots`` saves the batch-free matrix products' outputs and
    recomputes the rest."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "block":
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _dots_policy)
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat policy {cfg.remat!r} (none, block or "
                     "dots)")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (one of "
                         f"{', '.join(FAMILIES)})")


def n_attn_layers(cfg: ModelConfig) -> int:
    """hybrid: number of applications of the shared attention block."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        return 0
    assert cfg.num_layers % cfg.attn_every == 0, (
        "hybrid stacks require attn_every | num_layers", cfg.num_layers,
        cfg.attn_every)
    return cfg.num_layers // cfg.attn_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class AttnBlock(nn.Module):
    """Pre-norm attention + SwiGLU MLP (the ``moe`` family: + MoE FFN)."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = layers.RMSNorm(cfg.d_model, device)
        self.attn = Attention(gen, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, cfg.param_dtype,
                              device, cfg.qkv_bias)
        self.ln2 = layers.RMSNorm(cfg.d_model, device)
        self.ffn = (moe.MoE(gen, cfg, device) if cfg.family == "moe"
                    else layers.MLP(gen, cfg.d_model, cfg.d_ff,
                                    cfg.param_dtype, device))


class MambaLayer(nn.Module):
    """Pre-norm Mamba2 block of the hybrid stack."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = layers.RMSNorm(cfg.d_model, device)
        self.mamba = mamba2.Mamba2(gen, cfg, device)


class LayerStack(nn.Module):
    """``layers`` (one module per layer) and, for hybrid, ``shared_attn``.

    ``stacked`` says whether the reference stacks the layers' parameters
    along a leading axis (every family but ``ssm``, whose layers are a
    tuple of per-layer trees): ``convert.py`` lays the tree out by it.
    ``layer_use``, None but in the sharded train step, maps a layer index
    to the context its parameters are used in (:func:`_in_use`)."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        _check_family(cfg)
        self.stacked = cfg.family != "ssm"
        self.layer_use = None
        if cfg.family == "ssm":
            block = lambda i: (xlstm.SLSTMBlock if i in cfg.slstm_indices
                               else xlstm.MLSTMBlock)
        else:
            block = lambda i: (MambaLayer if cfg.family == "hybrid"
                               else AttnBlock)
        self.layers = nn.ModuleList(block(i)(gen, cfg, device)
                                    for i in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared_attn = AttnBlock(gen, cfg, device)


def init_layer_stack(gen, cfg: ModelConfig, device=None) -> LayerStack:
    return LayerStack(gen, cfg, device)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                cache_dtype=torch.bfloat16, device=None) -> Any:
    """Decode-time state for the whole stack: a stacked ``KVCache`` (dense,
    audio, vlm, moe), {"mamba": stacked ``Mamba2State``, "attn": stacked ``KVCache``}
    (hybrid), or a tuple of per-layer ``SLSTMState``/``MLSTMState`` in
    float32 whatever ``cache_dtype`` (ssm)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return tuple(xlstm.slstm_init_state(cfg, batch, device)
                     if i in cfg.slstm_indices
                     else xlstm.mlstm_init_state(cfg, batch, device)
                     for i in range(cfg.num_layers))

    def kv(n):
        shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=cache_dtype, device=device),
                       v=torch.zeros(shape, dtype=cache_dtype, device=device))

    if cfg.family != "hybrid":
        return kv(cfg.num_layers)
    st = mamba2.mamba2_init_state(cfg, batch, device)
    stacked = mamba2.Mamba2State(*(
        torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype, device=device)
        for t in st))
    return {"mamba": stacked, "attn": kv(n_attn_layers(cfg))}


def reset_caches(cfg: ModelConfig, caches) -> None:
    """Set ``caches`` (or views of some of their rows) in place to the
    values :func:`init_caches` starts them at: zeros, but the sLSTM
    max-state's -1e30."""
    if cfg.family != "ssm":
        for leaf in (caches.values() if isinstance(caches, dict)
                     else (caches,)):
            for t in leaf:
                t.zero_()
        return
    fresh = init_caches(cfg, caches[0].c.shape[0], 0,
                        device=caches[0].c.device)
    for state, init in zip(caches, fresh):
        _copy_state(state, init)


def _copy_state(dst, src) -> None:
    """Each tensor of ``src`` into the same field of ``dst``, in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _in_use(stack: LayerStack, i: int):
    """The context layer ``i`` runs in: its parameters as they are, or as
    ``stack.layer_use`` gives them."""
    if stack.layer_use is None:
        return contextlib.nullcontext()
    return stack.layer_use(i)


def _layer_kv(caches: KVCache | None, i: int) -> KVCache | None:
    return None if caches is None else KVCache(caches.k[i], caches.v[i])


# ---------------------------------------------------------------------------
# one attention block (dense/moe families + the hybrid shared block)
# ---------------------------------------------------------------------------
def _attn_block(p: AttnBlock, cfg: ModelConfig, x, shard: ShardCfg, *,
                positions, mask: MaskSpec, cache=None, cache_len=None,
                template=None, kv_block: KVBlock | None = None):
    """Returns (x, cache, StackMetrics): the MoE layer's, or zeros."""
    h, new_cache = attention(
        p.attn, layers.rmsnorm(p.ln1, x, cfg.norm_eps),
        rope_theta=cfg.rope_theta, positions=positions, mask=mask,
        cache=cache, cache_len=cache_len,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, template=template,
        shard=shard, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        kv_block=kv_block)
    x = shard.constrain_act(x + h, None, None)
    y = layers.rmsnorm(p.ln2, x, cfg.norm_eps)
    if cfg.family == "moe":
        y, met = moe.moe_apply(p.ffn, cfg, y, shard)
        metrics = StackMetrics(met.aux_loss, met.z_loss, met.dropped_frac)
    else:
        y = layers.mlp(p.ffn, y, shard, cfg.d_ff)
        metrics = StackMetrics.zero(x.device)
    x = shard.constrain_act(x + y.to(x.dtype), None, None)
    return x, new_cache, metrics


# ---------------------------------------------------------------------------
# sequence mode (train / prefill)
# ---------------------------------------------------------------------------
def stack_seq(stack: LayerStack, cfg: ModelConfig, x, shard: ShardCfg, *,
              positions, mask: MaskSpec, caches=None, mode: str = "train",
              template=None, kv_block: KVBlock | None = None):
    """x (B,S,d) -> (x, caches, metrics).  mode: train (no caches; each
    layer or group under :func:`_remat`, but the ``ssm`` family's) | prefill (caches filled in
    place).  ``metrics`` are ``StackMetrics``: the MoE layers' summed over
    the layers (the reference's ``jax.tree.map(jnp.sum, mets)``), zero for
    the other families.  ``kv_block``: the part of the sequence the KV
    caches hold, serving over a mesh (the module's text)."""
    _check_family(cfg)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} ({' or '.join(MODES)})")
    if mode == "train" and caches is not None:
        raise ValueError("mode='train' takes no caches")
    if cfg.family == "hybrid":
        x = _seq_hybrid_stack(stack, cfg, x, shard, positions=positions,
                              mask=mask, caches=caches,
                              train=mode == "train", template=template,
                              kv_block=kv_block)
        return x, caches, StackMetrics.zero(x.device)
    if cfg.family == "ssm":
        x = _seq_xlstm_stack(stack, cfg, x, caches=caches, template=template)
        return x, caches, StackMetrics.zero(x.device)
    x, metrics = _seq_attn_stack(stack, cfg, x, shard, positions=positions,
                                 mask=mask, caches=caches,
                                 train=mode == "train", template=template,
                                 kv_block=kv_block)
    return x, caches, metrics


def _seq_attn_stack(stack, cfg, x, shard, *, positions, mask, caches, train,
                    template, kv_block=None):
    """(x, StackMetrics summed over the layers)."""
    def body(x, i, cache):
        with _in_use(stack, i):
            x, _, met = _attn_block(stack.layers[i], cfg, x, shard,
                                    positions=positions, mask=mask,
                                    cache=cache, template=template,
                                    kv_block=kv_block)
        return (x, *met)

    body = _remat(body, cfg) if train else body
    mets = []
    for i in range(len(stack.layers)):
        x, *met = body(x, i, _layer_kv(caches, i))
        mets.append(met)
    return x, StackMetrics(*(torch.stack(m).sum() for m in zip(*mets)))


def _seq_hybrid_stack(stack, cfg, x, shard, *, positions, mask, caches,
                      train, template, kv_block=None):
    """Each group: the shared attention block (its own KV cache), then
    ``attn_every`` Mamba2 layers (their states at layers g·E .. g·E+E-1)."""
    with_caches = caches is not None

    def group(x, g):
        acache = _layer_kv(caches["attn"], g) if with_caches else None
        x, _, _ = _attn_block(stack.shared_attn, cfg, x, shard,
                              positions=positions, mask=mask, cache=acache,
                              template=template, kv_block=kv_block)
        for e in range(cfg.attn_every):
            i = g * cfg.attn_every + e
            lp = stack.layers[i]
            ms = (mamba2.Mamba2State(*(t[i] for t in caches["mamba"]))
                  if with_caches else None)
            with _in_use(stack, i):
                h, nm = mamba2.mamba2_seq(
                    lp.mamba, cfg, layers.rmsnorm(lp.ln, x, cfg.norm_eps),
                    shard, state=ms, return_state=with_caches,
                    template=template)
            x = shard.constrain_act(x + h.to(x.dtype), None, None)
            if with_caches:
                _copy_state(ms, nm)
        return x

    group = _remat(group, cfg) if train else group
    for g in range(n_attn_layers(cfg)):
        x = group(x, g)
    return x


def _seq_xlstm_stack(stack, cfg, x, *, caches, template):
    """Each layer an sLSTM (at ``slstm_indices``) or an mLSTM block; with
    caches, each layer starts from its state and leaves its final state
    there.  Training runs the same loop with no remat."""
    for i, lp in enumerate(stack.layers):
        st = caches[i] if caches is not None else None
        fn = xlstm.slstm_seq if i in cfg.slstm_indices else xlstm.mlstm_seq
        with _in_use(stack, i):
            x, ns = fn(lp, cfg, x, state=st, return_state=caches is not None,
                       template=template)
        if caches is not None:
            _copy_state(st, ns)
    return x


# ---------------------------------------------------------------------------
# step mode (single-token decode)
# ---------------------------------------------------------------------------
def stack_step(stack: LayerStack, cfg: ModelConfig, x, shard: ShardCfg, *,
               caches, cache_len, template=None,
               kv_block: KVBlock | None = None):
    """x (B,1,d), caches filled to cache_len -> (x, caches).

    ``cache_len`` is an int (uniform batch) or a (B,) tensor (continuous
    batching: per-slot fill levels and rope positions).  Each layer runs
    inside :func:`_in_use`; ``kv_block`` as in :func:`stack_seq`."""
    _check_family(cfg)
    if torch.is_tensor(cache_len) and cache_len.dim() >= 1:
        positions = cache_len.reshape(-1, 1)     # (B, 1) per-slot rope
    else:
        positions = torch.as_tensor(cache_len, device=x.device).reshape(1)
    mask = MaskSpec(causal=True, q_offset=0)
    block = lambda p, x, cache: _attn_block(
        p, cfg, x, shard, positions=positions, mask=mask, cache=cache,
        cache_len=cache_len, template=template, kv_block=kv_block)[0]
    if cfg.family == "ssm":
        xt = x[:, 0]
        for i in range(len(stack.layers)):
            fn = (xlstm.slstm_step if i in cfg.slstm_indices
                  else xlstm.mlstm_step)
            with _in_use(stack, i):
                xt, ns = fn(stack.layers[i], cfg, xt, caches[i])
            _copy_state(caches[i], ns)
        return xt[:, None], caches
    if cfg.family != "hybrid":
        for i in range(len(stack.layers)):
            with _in_use(stack, i):
                x = block(stack.layers[i], x, _layer_kv(caches, i))
        return x, caches

    for g in range(n_attn_layers(cfg)):
        x = block(stack.shared_attn, x, _layer_kv(caches["attn"], g))
        for e in range(cfg.attn_every):
            i = g * cfg.attn_every + e
            ms = mamba2.Mamba2State(*(t[i] for t in caches["mamba"]))
            with _in_use(stack, i):
                lp = stack.layers[i]
                h, nm = mamba2.mamba2_step(
                    lp.mamba, cfg,
                    layers.rmsnorm(lp.ln, x[:, 0], cfg.norm_eps), ms)
            x = x + h[:, None].to(x.dtype)
            _copy_state(ms, nm)
    return x, caches
