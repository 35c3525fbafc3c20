"""Attention: the chunked online-softmax path and the full O(S^2) path.

The port's copy of ``repro.models.attention``.  Layout is BSHD: q
(B, Sq, H, D), k/v (B, Skv, KH, D), H = KH * rep (GQA).  k and v are read in
q's dtype (the reference's callers always pass them so; the port's decode
passes its float32 cache and lets the kernel round it on load).

Masking supports causal, causal-with-offset (decode), prefix-LM
(bidirectional prefix + causal suffix) and a valid key length that is a
scalar or, in ``full_mha``, one per batch row.  The mask semantics
(``MaskSpec``, ``_mask``) live in ``kernels.ref`` beside the kernel's plain
versions; ``MaskSpec`` is re-exported here.

The reference marks two regions ``__kernel__attention`` as shipping as one
fused Pallas kernel on the TPU (``full_mha`` and each q chunk of
``chunked_mha``).  Here those regions are the FLASH_ATTENTION kernel: on the
``CUDA`` template (the default for tensors on the card) both functions call
``kernels.attention_cuda.flash_attention``; on ``TORCH`` they run the
kernel's plain versions, ``kernels.ref.full_mha_reference`` and
``kernels.attention.chunked_attention``.  When autograd records the call
(grad mode on, an input requiring grad), the ``CUDA`` template goes through
``kernels.autograd.FlashAttentionFn``: the kernel forward, and the gradient
of the plain version the ``TORCH`` template would run.
"""
from __future__ import annotations

import functools

from repro_torch.device import resolve_template
from repro_torch.kernels import attention_cuda, autograd
from repro_torch.kernels.attention import block_valid_len, chunked_attention
from repro_torch.kernels.ref import (MaskSpec, _per_batch,
                                     attention_lse_reference,
                                     full_mha_reference)


def full_mha(q, k, v, spec: MaskSpec = MaskSpec(), kv_valid_len=None,
             scale=None, template=None):
    """O(S^2)-memory attention (small-sequence / oracle / decode path)."""
    if resolve_template(template, q.device) == "CUDA":
        if autograd.wants_grad(q, k, v):
            return autograd.flash_attention(q, k, v, spec, kv_valid_len,
                                            scale, plain=full_mha_reference)
        return attention_cuda.flash_attention(q, k, v, spec, kv_valid_len,
                                              scale)
    return full_mha_reference(q, k, v, spec, kv_valid_len, scale)


def chunked_mha(q, k, v, spec: MaskSpec = MaskSpec(), *, q_chunk: int = 1024,
                kv_chunk: int = 1024, kv_valid_len=None, scale=None,
                template=None):
    """Online-softmax attention: O(chunk^2) transient memory.

    ``kv_valid_len`` is None or a scalar."""
    if _per_batch(kv_valid_len):
        raise ValueError("chunked_mha takes one valid length for the batch; "
                         "per-row lengths go through full_mha")
    plain = functools.partial(_chunked, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if resolve_template(template, q.device) == "CUDA":
        if autograd.wants_grad(q, k, v):
            return autograd.flash_attention(q, k, v, spec, kv_valid_len,
                                            scale, plain=plain)
        return attention_cuda.flash_attention(q, k, v, spec, kv_valid_len,
                                              scale)
    return plain(q, k, v, spec, kv_valid_len, scale)


def _chunked(q, k, v, spec, kv_valid_len, scale, *, q_chunk, kv_chunk):
    """``chunked_attention`` with ``full_mha``'s positional arguments."""
    return chunked_attention(q, k, v, spec, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, kv_valid_len=kv_valid_len,
                             scale=scale)


def decode_mha(q, k_cache, v_cache, cache_len, scale=None, template=None):
    """Single-step decode: q (B, 1, H, D) against a (B, S, KH, D) cache.

    Positions >= cache_len (a scalar or one per batch row) are masked."""
    return full_mha(q, k_cache, v_cache, MaskSpec(causal=False),
                    kv_valid_len=cache_len, scale=scale, template=template)


def decode_mha_partial(q, k_block, v_block, cache_len, start: int,
                       scale=None, template=None):
    """:func:`decode_mha` on one block of a cache whose sequence is split
    into blocks: q (B, 1, H, D) against the (B, Sl, KH, D) block that holds
    positions [start, start + Sl); positions >= cache_len (over the whole
    sequence: a scalar or one per batch row) are masked.  Returns (out,
    lse): the block's attention and each query row's log-sum-exp, which
    ``kernels.ref.merge_partials`` merges over the blocks.  A row that sees
    no key of the block averages its v and reports an lse of -1e30, a
    weight of 0 beside any block where the row sees a key (the block that
    holds position 0 always does).  On the ``CUDA`` template this is one
    FLASH_ATTENTION launch with ``return_lse`` (serving only: it has no
    backward)."""
    valid = block_valid_len(cache_len, start, k_block.shape[1])
    spec = MaskSpec(causal=False)
    if resolve_template(template, q.device) == "CUDA":
        if autograd.wants_grad(q, k_block, v_block):
            raise ValueError("decode_mha_partial has no backward")
        return attention_cuda.flash_attention(q, k_block, v_block, spec,
                                              valid, scale, return_lse=True)
    return attention_lse_reference(q, k_block, v_block, spec, valid, scale)
