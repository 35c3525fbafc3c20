"""Transformer building blocks: GQA attention (train/prefill/decode) with its
KV cache.

The port's copy of ``repro.models.blocks``.  The cache is written in place
(the reference returns updated copies): prefill writes positions [0, S),
decode writes one position per batch row with an index write, and the
function returns the same ``KVCache`` it was given.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.attention import MaskSpec, chunked_mha, decode_mha


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


def _proj(x, w, dt):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out(o, wo, dt):
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.to(dt).reshape(h * k, d)


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
):
    """Returns (y, cache).  Modes:
      train:    cache=None                    -> causal self-attention
      prefill:  cache empty, cache_len=None   -> fill cache[0:S]
      decode:   cache filled, cache_len=t     -> write at t, attend to [0:t]
                (t an int or a (B,) tensor: per-slot positions)
    """
    dt = x.dtype
    q, k, v = (_proj(x, w, dt) for w in (p.wq, p.wk, p.wv))
    if hasattr(p, "bq"):
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
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
    return _out(out, p.wo, dt), cache
