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

Serving over such a mesh (a ``KVBlock`` given), each rank's cache holds
its data rows and, as ``cache_spec_tree`` places it, its block of the
sequence, of every kv head:

* prefill: the rank attends over the prompt at its heads as in training;
  its cache block takes the prompt's positions in its block, of all kv
  heads: an all_to_all over ``tp`` from heads to sequence where the kv
  heads are split, a slice where they are whole on every rank;
* decode: q (and the new token's k and v where the kv heads are split) is
  gathered over ``tp``; the rank that holds position ``cache_len[b]``,
  and only it, writes the new token's k and v there
  (:func:`kv_owner`); each rank takes the decode of every head over its
  block with each row's log-sum-exp (``decode_mha_partial``); one
  all_to_all over ``tp`` hands each rank the partials of its heads, which
  it merges (``merge_partials``: weights exp(lse - max)); ``wo`` stays
  row-parallel with its one :func:`wo_reduce`.  A rank whose block holds
  no valid key of a row reports an lse of -1e30 there, a weight of 0.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.collectives import (all_gather, all_to_all, tp_copy,
                                          tp_reduce)
from repro_torch.kernels.ref import merge_partials
from repro_torch.models import layers
from repro_torch.models.attention import (MaskSpec, chunked_mha, decode_mha,
                                          decode_mha_partial)
from repro_torch.models.config import LOCAL, KVBlock, ShardCfg


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


def kv_owner(pos, kv_block: KVBlock, size: int):
    """Whether this rank's cache block (``size`` positions from
    ``kv_block.start``) holds position ``pos`` (an int, or one a batch
    row): the rank that writes a decoded token's k and v there."""
    if not kv_block.split:
        return torch.ones_like(pos, dtype=torch.bool) \
            if torch.is_tensor(pos) else True
    return (pos >= kv_block.start) & (pos < kv_block.start + size)


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
    kv_block: KVBlock | None = None,
):
    """Returns (y, cache).  Modes:
      train:    cache=None                    -> causal self-attention
      prefill:  cache empty, cache_len=None   -> fill cache[0:S]
      decode:   cache filled, cache_len=t     -> write at t, attend to [0:t]
                (t an int or a (B,) tensor: per-slot positions)
    ``num_heads``/``num_kv_heads`` are the config's (a sharded ``p`` holds
    fewer).  ``kv_block``: serving over a mesh with ``tp`` > 1, the part
    of the sequence ``cache`` holds (the module's text)."""
    dt = x.dtype
    wq, wk, wv = p.wq, p.wk, p.wv
    bias = [getattr(p, n) for n in ("bq", "bk", "bv")] \
        if hasattr(p, "bq") else None
    split = (shard.tp_size() > 1 and num_heads is not None
             and wq.shape[1] < num_heads)
    meshed = cache is not None and kv_block is not None
    groups = None
    if split:
        x = tp_copy(x, shard)
        if wk.shape[1] == num_kv_heads:     # kv whole: take the q heads' groups
            groups = _kv_groups(shard.tp_rank(), wq.shape[1],
                                num_heads // num_kv_heads, x.device)
        if groups is not None and not meshed:
            wk, wv = (tp_copy(w, shard)[:, groups] for w in (wk, wv))
            if bias is not None:
                bias[1:] = [tp_copy(b, shard)[groups] for b in bias[1:]]
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

    if meshed:
        out = _meshed_cache(q, k, v, cache, cache_len, kv_block, shard,
                            split, groups, num_kv_heads, mask, q_chunk,
                            kv_chunk, template)
        if split:
            return wo_reduce(_out(out, p.wo, dt, layers.split_product),
                             shard).to(dt), cache
        return _out(out, p.wo, dt), cache
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


# ---------------------------------------------------------------------------
# serving over a mesh: the cache's sequence in blocks over tp
# ---------------------------------------------------------------------------
def _gather_heads(ts: list, shard: ShardCfg) -> list:
    """Each (B, S, h, D) tensor of ``ts`` (one dtype) with its heads
    gathered over ``tp`` in rank order: one all-gather."""
    widths = [t.shape[2] for t in ts]
    got = all_gather(torch.cat(ts, dim=2)[None], shard.mesh, shard.tp, 0)
    out, at = [], 0
    for w in widths:
        part = got[:, :, :, at:at + w]                  # (T, B, S, w, D)
        out.append(part.permute(1, 2, 0, 3, 4).reshape(
            *part.shape[1:3], -1, part.shape[-1]))
        at += w
    return out


def _merge_over_tp(out, lse, shard: ShardCfg, heads_split: bool):
    """The ranks' partials (out (B, Sq, H, D), lse (B, Sq, H)) over their
    blocks of the sequence merged: this rank's heads (one all_to_all over
    ``tp``) where the heads are split, else all of them (one
    all-gather)."""
    packed = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    if heads_split:
        parts = all_to_all(packed, shard.mesh, shard.tp, 3, 0)
    else:
        parts = all_gather(packed, shard.mesh, shard.tp, 0)
    return merge_partials(parts[..., :-1], parts[..., -1]).to(out.dtype)


def _write_token(cache: KVCache, k, v, cache_len, kv_block: KVBlock) -> None:
    """The decoded tokens' k and v (B, Sq, KH, D) written at positions
    cache_len.. on the rank whose block holds them, and nowhere else."""
    size = cache.k.shape[1]
    if torch.is_tensor(cache_len) and cache_len.dim() >= 1:
        rows = torch.arange(k.shape[0], device=k.device)
        own = kv_owner(cache_len, kv_block, size)[:, None, None]
        at = (cache_len - kv_block.start).clamp(0, size - 1)
        for c, new in ((cache.k, k), (cache.v, v)):
            c[rows, at] = torch.where(own, new[:, 0].to(c.dtype),
                                      c[rows, at])
        return
    t = int(cache_len)
    for j in range(k.shape[1]):
        if kv_owner(t + j, kv_block, size):
            at = t + j - kv_block.start
            cache.k[:, at] = k[:, j].to(cache.k.dtype)
            cache.v[:, at] = v[:, j].to(cache.v.dtype)


def _fill_block(cache: KVCache, k, v, kv_block: KVBlock, shard: ShardCfg,
                kv_split: bool) -> None:
    """A prefill's k and v (B, S, kh, D) into this rank's block of the
    cache, of all kv heads: where the kv heads are split over ``tp``, one
    all_to_all takes each rank's heads of every block's positions to that
    block's rank (an all-gather where the sequence is whole on every
    rank)."""
    s, size = k.shape[1], cache.k.shape[1]
    if not kv_block.split:
        if kv_split:
            k, v = _gather_heads([k, v], shard)
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
        return
    n = min(max(s - kv_block.start, 0), size)
    if kv_split:
        # rank j gets the first c = min(S, size) positions of its block
        # [j * size, (j + 1) * size), zeros past S: one block size for all
        n_tp, c = shard.tp_size(), min(s, size)
        kv = torch.nn.functional.pad(torch.stack([k, v]),
                                     (0, 0, 0, 0, 0, n_tp * size - s))
        kv = kv.reshape(2, k.shape[0], n_tp, size, *k.shape[2:])[:, :, :, :c]
        got = all_to_all(kv.movedim(2, 0), shard.mesh, shard.tp, 0, 4)[0]
        k, v = got[0], got[1]
    else:
        k, v = (t[:, kv_block.start:kv_block.start + n] for t in (k, v))
    cache.k[:, :n] = k[:, :n].to(cache.k.dtype)
    cache.v[:, :n] = v[:, :n].to(cache.v.dtype)


def _meshed_cache(q, k, v, cache: KVCache, cache_len, kv_block: KVBlock,
                  shard: ShardCfg, split: bool, groups, num_kv_heads: int,
                  mask: MaskSpec, q_chunk: int, kv_chunk: int, template):
    """Attention's output (B, Sq, this rank's heads, D) of a prefill or a
    decode step whose cache is this rank's block (the module's text).
    ``groups``: the kv heads this rank's q heads read, where the kv
    projections are whole on every rank (k, v then hold every kv head)."""
    kv_split = k.shape[2] < num_kv_heads
    if cache_len is None:                          # prefill
        _fill_block(cache, k, v, kv_block, shard, kv_split)
        if groups is not None:
            k, v = k[:, :, groups], v[:, :, groups]
        return chunked_mha(q, k, v, mask, q_chunk=q_chunk, kv_chunk=kv_chunk,
                           template=template)
    hl = q.shape[2]
    if split:
        q, *kv = _gather_heads([q, k, v] if kv_split else [q], shard)
        if kv_split:
            k, v = kv
    _write_token(cache, k, v, cache_len, kv_block)
    out, lse = decode_mha_partial(q, cache.k, cache.v, cache_len + q.shape[1],
                                  kv_block.start, template=template)
    if kv_block.split:
        return _merge_over_tp(out, lse, shard, split)
    if split:
        return out.narrow(2, shard.tp_rank() * hl, hl)
    return out
