"""Transformer building blocks: GQA attention (train/prefill/decode) with its
KV cache.

The port's copy of ``repro.models.blocks``.  The cache is written in place
(the reference returns updated copies): prefill writes positions [0, S),
decode writes one position per batch row with an index write, and the
function returns the same ``KVCache`` it was given.

Over a mesh of ranks (a ``ShardCfg`` with ``tp``) the block is
tensor-parallel over heads when its placement splits them
(``dist.sharding``): ``wq``/``wk``/``wv`` are column-parallel, ``wo``
row-parallel with one all-reduce over ``tp`` (:func:`wo_reduce`).  The
split products stay in float32 and round once to the compute dtype, after
the all-reduce, so that a split adds no rounding the single product does
not have (forward: the row-parallel partial sums; backward: the
column-parallel input gradients, summed over ``tp`` by ``tp_copy``); on
the card they run on TF32 tensor cores (``layers.split_product``).  Where
``num_kv_heads`` does not divide over ``tp`` but ``num_heads`` does, the
kv projections are whole on every rank and a rank takes its q heads' kv
groups; where neither divides, every ``tp`` rank computes the whole
attention.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.collectives import tp_copy, tp_reduce
from repro_torch.models import layers
from repro_torch.models.attention import MaskSpec, chunked_mha, decode_mha
from repro_torch.models.config import LOCAL, ShardCfg


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, KH, D)
    v: torch.Tensor


class Attention(nn.Module):
    """Projections of one GQA attention block, the reference's names."""

    def __init__(self, gen, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype, device=None, qkv_bias: bool = False):
        super().__init__()
        std = 1.0 / math.sqrt(d_model)
        tn = lambda shape, s: layers.param(
            layers.truncated_normal(gen, shape, s, dtype, device))
        self.wq = tn((d_model, num_heads, head_dim), std)
        self.wk = tn((d_model, num_kv_heads, head_dim), std)
        self.wv = tn((d_model, num_kv_heads, head_dim), std)
        self.wo = tn((num_heads, head_dim, d_model),
                     1.0 / math.sqrt(num_heads * head_dim))
        if qkv_bias:
            zeros = lambda *s: layers.param(torch.zeros(s, dtype=dtype,
                                                        device=device))
            self.bq = zeros(num_heads, head_dim)
            self.bk = zeros(num_kv_heads, head_dim)
            self.bv = zeros(num_kv_heads, head_dim)


def _matmul(x, w, dt):
    return x @ w.to(dt)


def _proj(x, w, dt, product=_matmul):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return product(x, w.reshape(d, h * k), dt).reshape(*x.shape[:-1], h, k)


def _out(o, wo, dt, product=_matmul):
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return product(o.reshape(*o.shape[:-2], h * k), wo.reshape(h * k, d), dt)


def wo_reduce(y, shard: ShardCfg):
    """The row-parallel ``wo``'s partial sums added over ``tp``."""
    return tp_reduce(y, shard)


def _kv_groups(rank: int, hl: int, rep: int, device) -> torch.Tensor:
    """Indices of the kv heads that q heads [rank·hl, (rank+1)·hl) read
    (q head h reads kv head h // rep), laid out so that local q head j
    reads local kv head j // (local rep): one a group where hl is a
    multiple of rep, one for all where rep is a multiple of hl, else one
    a q head."""
    kv = (rank * hl + torch.arange(hl, device=device)) // rep
    if hl % rep == 0:
        return kv[::rep]
    if rep % hl == 0:
        return kv[:1]
    return kv


def attention(
    p: Attention,
    x: torch.Tensor,                 # (B, S, D)
    *,
    rope_theta: float,
    positions: torch.Tensor,         # (S,) or (B, 1) absolute positions
    mask: MaskSpec,
    cache: KVCache | None = None,
    cache_len=None,                  # filled prefix length (decode)
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    template=None,
    shard: ShardCfg = LOCAL,
    num_heads: int | None = None,
    num_kv_heads: int | None = None,
):
    """Returns (y, cache).  Modes:
      train:    cache=None                    -> causal self-attention
      prefill:  cache empty, cache_len=None   -> fill cache[0:S]
      decode:   cache filled, cache_len=t     -> write at t, attend to [0:t]
                (t an int or a (B,) tensor: per-slot positions)
    ``num_heads``/``num_kv_heads`` are the config's (a sharded ``p`` holds
    fewer)."""
    dt = x.dtype
    wq, wk, wv = p.wq, p.wk, p.wv
    bias = [getattr(p, n) for n in ("bq", "bk", "bv")] \
        if hasattr(p, "bq") else None
    split = (shard.tp_size() > 1 and num_heads is not None
             and wq.shape[1] < num_heads)
    if split:
        x = tp_copy(x, shard)
        if wk.shape[1] == num_kv_heads:     # kv whole: take the q heads' groups
            idx = _kv_groups(shard.tp_rank(), wq.shape[1],
                             num_heads // num_kv_heads, x.device)
            wk, wv = (tp_copy(w, shard)[:, idx] for w in (wk, wv))
            if bias is not None:
                bias[1:] = [tp_copy(b, shard)[idx] for b in bias[1:]]
        # partial sums in float32, one rounding: as one product rounds
        xf = x.float()
        q, k, v = (_proj(xf, w, dt, layers.split_product).to(dt)
                   for w in (wq, wk, wv))
    else:
        q, k, v = (_proj(x, w, dt) for w in (wq, wk, wv))
    if bias is not None:
        q = q + bias[0].to(dt)
        k = k + bias[1].to(dt)
        v = v + bias[2].to(dt)
    q = layers.apply_rope(q, positions, rope_theta)
    k = layers.apply_rope(k, positions, rope_theta)

    if cache is not None and cache_len is not None:
        # decode: write one token at cache_len, attend to [0, cache_len]
        if torch.is_tensor(cache_len) and cache_len.dim() >= 1:
            rows = torch.arange(k.shape[0], device=k.device)
            cache.k[rows, cache_len] = k[:, 0].to(cache.k.dtype)
            cache.v[rows, cache_len] = v[:, 0].to(cache.v.dtype)
        else:
            t = int(cache_len)
            cache.k[:, t:t + q.shape[1]] = k.to(cache.k.dtype)
            cache.v[:, t:t + q.shape[1]] = v.to(cache.v.dtype)
        out = decode_mha(q, cache.k, cache.v, cache_len + q.shape[1],
                         template=template)
        return _out(out, p.wo, dt), cache
    if cache is not None:  # prefill: write [0:S]
        cache.k[:, :k.shape[1]] = k.to(cache.k.dtype)
        cache.v[:, :v.shape[1]] = v.to(cache.v.dtype)

    out = chunked_mha(q, k, v, mask, q_chunk=q_chunk, kv_chunk=kv_chunk,
                      template=template)
    if split:
        return wo_reduce(_out(out, p.wo, dt, layers.split_product),
                         shard).to(dt), cache
    return _out(out, p.wo, dt), cache
