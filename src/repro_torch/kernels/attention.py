"""Flash attention, plain version: the chunked online softmax.

``chunked_attention`` is the eager body of ``models.attention.chunked_mha``
in BSHD: outer loop over q chunks, inner loop over kv chunks (the
reference's ``lax.map`` and ``lax.scan``), an f32 accumulator, masked
logits at -1e30.  ``flash_attention`` is the port's twin of
``repro.kernels.attention.flash_attention`` in its (H, Sq, D) API: q
(H, Sq, D), k/v (Hkv, Sk, D), GQA, causal with ``q_offset``; unlike the
Pallas kernel it takes any Sq and Sk (no block divisibility).  The
hand-written kernel is ``kernels/attention_cuda.py``; ``ops.mha`` chooses
between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import _NEG_INF, MaskSpec, _mask

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128


def to_bshd(t):
    """(H, S, D) -> a (1, S, H, D) view."""
    return t.transpose(0, 1)[None]


def from_bshd(t):
    """(1, S, H, D) -> an (H, S, D) view."""
    return t[0].transpose(0, 1)


def chunked_attention(q, k, v, spec: MaskSpec = MaskSpec(), *,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      kv_valid_len=None, scale=None):
    """Online-softmax attention in BSHD with O(chunk^2) transient memory;
    ``kv_valid_len`` is None or a scalar (``chunked_mha`` checks it)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    rep = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq, nk = -(-sq // q_chunk), -(-sk // kv_chunk)
    # pad to chunk multiples
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
    qp = pad(q, nq * q_chunk - sq)
    kp = pad(k.to(q.dtype), nk * kv_chunk - sk)
    vp = pad(v.to(q.dtype), nk * kv_chunk - sk)
    valid = (sk if kv_valid_len is None
             else torch.clamp(torch.as_tensor(kv_valid_len, device=q.device),
                              max=sk))
    pos = lambda n: torch.arange(n, device=q.device)

    outs = []
    for qi in range(nq):
        qs = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        qs = qs.reshape(b, q_chunk, kh, rep, d).float()
        qpos = qi * q_chunk + pos(q_chunk)
        m_prev = torch.full((b, q_chunk, kh, rep), _NEG_INF,
                            dtype=torch.float32, device=q.device)
        l_prev = torch.zeros_like(m_prev)
        acc = torch.zeros((b, q_chunk, kh, rep, d), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            kc = kp[:, kj * kv_chunk:(kj + 1) * kv_chunk].float()
            vc = vp[:, kj * kv_chunk:(kj + 1) * kv_chunk].float()
            logits = torch.einsum("bqhrd,bkhd->bqhrk", qs, kc) * scale
            msk = _mask(qpos, kj * kv_chunk + pos(kv_chunk), spec, valid)
            logits = torch.where(msk[None, :, None, None, :], logits, _NEG_INF)
            m_cur = torch.maximum(m_prev, logits.amax(dim=-1))
            p = torch.exp(logits - m_cur[..., None])
            alpha = torch.exp(m_prev - m_cur)
            l_prev = l_prev * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhrk,bkhd->bqhrd", p, vc)
            m_prev = m_cur
        out = acc / torch.clamp(l_prev, min=1e-30)[..., None]
        outs.append(out.reshape(b, q_chunk, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def block_valid_len(kv_valid_len, start: int, size: int):
    """The valid length of a block of the keys, positions [start, start +
    size), from the valid length over the whole sequence (an int or one per
    batch row): clamp(kv_valid_len - start, 0, size)."""
    if torch.is_tensor(kv_valid_len):
        return torch.clamp(kv_valid_len - start, 0, size)
    return min(max(int(kv_valid_len) - start, 0), size)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    q_offset: int = 0, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """q (H, Sq, D), k/v (Hkv, Sk, D) -> (H, Sq, D) in q's dtype."""
    out = chunked_attention(to_bshd(q), to_bshd(k), to_bshd(v),
                            MaskSpec(causal=causal, q_offset=q_offset),
                            q_chunk=block_q, kv_chunk=block_k, scale=scale)
    return from_bshd(out)
