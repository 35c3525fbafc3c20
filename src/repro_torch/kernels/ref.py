"""Plain-torch oracles for the four stencil kernels and for attention.

These are written independently of the descriptor/generator machinery
(plain shifted slices of padded tensors), so kernel tests compare separate
implementations.  They mirror ``repro.kernels.ref`` line for line; the
attention mask (``MaskSpec``, ``_mask``) and ``full_mha_reference`` mirror
``repro.models.attention``, whose port imports them from here.

Conventions match stencil3d.py: inputs are halo-padded by the declared
stencil radii; outputs are interior-shaped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import true_divide


def _i(p, lo=(1, 1, 1), hi=(1, 1, 1), off=(0, 0, 0)):
    """Interior view of padded tensor ``p`` shifted by ``off``."""
    sl = tuple(
        slice(l + o, p.shape[a] - h + o) for a, (l, h, o) in enumerate(zip(lo, hi, off))
    )
    return p[sl]


def laplacian(u, h):
    """7-point Laplacian of a symmetric-padded (1,1,1) tensor."""
    c = lambda *o: _i(u, off=o)
    return true_divide(c(1, 0, 0) + c(-1, 0, 0) + c(0, 1, 0) + c(0, -1, 0)
                       + c(0, 0, 1) + c(0, 0, -1) - 6.0 * c(0, 0, 0), h * h)


def update_velocity(vx, vy, vz, *, dt, h, nu, fx=0.0, fy=0.0, fz=0.0):
    """MAC advection-diffusion; inputs padded (1,1,1) symmetric."""
    ih = 1.0 / h

    def a(f, o1, o2):
        return 0.5 * (_i(f, off=o1) + _i(f, off=o2))

    def lap(f):
        return laplacian(f, h)

    # x-momentum
    uc_r = a(vx, (0, 0, 0), (1, 0, 0)); uc_l = a(vx, (-1, 0, 0), (0, 0, 0))
    duu = (uc_r ** 2 - uc_l ** 2) * ih
    duv = (a(vx, (0, 0, 0), (0, 1, 0)) * a(vy, (0, 0, 0), (1, 0, 0))
           - a(vx, (0, -1, 0), (0, 0, 0)) * a(vy, (0, -1, 0), (1, -1, 0))) * ih
    duw = (a(vx, (0, 0, 0), (0, 0, 1)) * a(vz, (0, 0, 0), (1, 0, 0))
           - a(vx, (0, 0, -1), (0, 0, 0)) * a(vz, (0, 0, -1), (1, 0, -1))) * ih
    nvx = _i(vx) + dt * (-(duu + duv + duw) + nu * lap(vx) + fx)

    # y-momentum
    vc_r = a(vy, (0, 0, 0), (0, 1, 0)); vc_l = a(vy, (0, -1, 0), (0, 0, 0))
    dvv = (vc_r ** 2 - vc_l ** 2) * ih
    dvu = (a(vy, (0, 0, 0), (1, 0, 0)) * a(vx, (0, 0, 0), (0, 1, 0))
           - a(vy, (-1, 0, 0), (0, 0, 0)) * a(vx, (-1, 0, 0), (-1, 1, 0))) * ih
    dvw = (a(vy, (0, 0, 0), (0, 0, 1)) * a(vz, (0, 0, 0), (0, 1, 0))
           - a(vy, (0, 0, -1), (0, 0, 0)) * a(vz, (0, 0, -1), (0, 1, -1))) * ih
    nvy = _i(vy) + dt * (-(dvu + dvv + dvw) + nu * lap(vy) + fy)

    # z-momentum
    wc_r = a(vz, (0, 0, 0), (0, 0, 1)); wc_l = a(vz, (0, 0, -1), (0, 0, 0))
    dww = (wc_r ** 2 - wc_l ** 2) * ih
    dwu = (a(vz, (0, 0, 0), (1, 0, 0)) * a(vx, (0, 0, 0), (0, 0, 1))
           - a(vz, (-1, 0, 0), (0, 0, 0)) * a(vx, (-1, 0, 0), (-1, 0, 1))) * ih
    dwv = (a(vz, (0, 0, 0), (0, 1, 0)) * a(vy, (0, 0, 0), (0, 0, 1))
           - a(vz, (0, -1, 0), (0, 0, 0)) * a(vy, (0, -1, 0), (0, -1, 1))) * ih
    nvz = _i(vz) + dt * (-(dwu + dwv + dww) + nu * lap(vz) + fz)
    return nvx, nvy, nvz


def divergence(vx, vy, vz, *, h):
    """Cell divergence; velocity inputs padded (1,0) per axis (lo side)."""
    lo, hi = (1, 1, 1), (0, 0, 0)
    c = lambda f, *o: _i(f, lo, hi, o or (0, 0, 0))
    return true_divide((c(vx) - c(vx, -1, 0, 0)) + (c(vy) - c(vy, 0, -1, 0))
                       + (c(vz) - c(vz, 0, 0, -1)), h)


def jacobi_pressure(p, rhs, *, h, omega=1.0):
    """One weighted-Jacobi sweep; p padded (1,1,1), rhs interior-shaped."""
    c = lambda *o: _i(p, off=o)
    nbr = (c(1, 0, 0) + c(-1, 0, 0) + c(0, 1, 0) + c(0, -1, 0)
           + c(0, 0, 1) + c(0, 0, -1))
    jac = true_divide(nbr - h * h * rhs, 6.0)
    return (1.0 - omega) * _i(p) + omega * jac


def project_velocity(vx, vy, vz, p, *, dt, h):
    """Projection correction; velocities interior, p padded (0,1) per axis."""
    lo, hi = (0, 0, 0), (1, 1, 1)
    pc = lambda *o: _i(p, lo, hi, o or (0, 0, 0))
    s = true_divide(dt, h)
    return (vx - s * (pc(1, 0, 0) - pc()),
            vy - s * (pc(0, 1, 0) - pc()),
            vz - s * (pc(0, 0, 1) - pc()))


# ---------------------------------------------------------------------------
# attention: the mask semantics and the plain FLASH_ATTENTION
# ---------------------------------------------------------------------------
_NEG_INF = -1e30     # masked logits: a row with every key masked gives mean(v)


class MaskSpec(NamedTuple):
    causal: bool = True
    q_offset: int = 0          # absolute position of q[0]
    prefix_len: int = 0        # positions < prefix_len attend bidirectionally


def _per_batch(kv_valid_len) -> bool:
    return torch.is_tensor(kv_valid_len) and kv_valid_len.dim() >= 1


def _mask(qpos, kpos, spec: MaskSpec, kv_valid_len=None):
    """(Sq, Sk) boolean mask (True = attend); ``kv_valid_len`` a scalar."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if spec.causal:
        causal = kpos[None, :] <= (qpos[:, None] + spec.q_offset)
        if spec.prefix_len:
            causal = causal | (kpos[None, :] < spec.prefix_len)
        m = m & causal
    if kv_valid_len is not None:
        m = m & (kpos[None, :] < kv_valid_len)
    return m


def full_mha_reference(q, k, v, spec: MaskSpec = MaskSpec(),
                       kv_valid_len=None, scale=None):
    """O(S^2)-memory masked attention in BSHD: the eager body of
    ``models.attention.full_mha`` and the FLASH_ATTENTION kernel's plain
    version.  q (B, Sq, H, D), k/v (B, Sk, KH, D) read in q's dtype;
    ``kv_valid_len`` None, a scalar or one per batch row."""
    return _masked_attention(q, k, v, spec, kv_valid_len, scale)[0]


def attention_lse_reference(q, k, v, spec: MaskSpec = MaskSpec(),
                            kv_valid_len=None, scale=None):
    """:func:`full_mha_reference` and each query row's log-sum-exp of its
    masked logits: (out (B, Sq, H, D) in q's dtype, lse (B, Sq, H) float32),
    natural logs of the logits as scaled.  A row that sees no key has every
    logit at -1e30, and so an lse of -1e30: beside any real row of another
    part of the keys its weight ``exp(lse - max)`` in
    :func:`merge_partials` is exactly 0.  The plain version of the
    kernel's ``return_lse`` form."""
    out, logits = _masked_attention(q, k, v, spec, kv_valid_len, scale)
    b, sq, h = q.shape[:3]
    lse = torch.logsumexp(logits, dim=-1)                   # (B, KH, R, Sq)
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


def merge_partials(outs, lses):
    """Attention over keys split into parts, from each part's result:
    ``outs`` (P, B, Sq, H, D) and their log-sum-exps ``lses``
    (P, B, Sq, H) -> (B, Sq, H, D) in ``outs``' dtype.  Each part is
    weighted by exp(lse_p - max_p lse_p), in float32; a part whose row saw
    no key (lse -1e30 beside a real one) weighs exactly 0."""
    lse = lses.float()
    w = torch.exp(lse - lse.amax(dim=0, keepdim=True))
    num = (outs.float() * w[..., None]).sum(dim=0)
    return (num / w.sum(dim=0)[..., None]).to(outs.dtype)


def _masked_attention(q, k, v, spec, kv_valid_len, scale):
    """(out, masked float32 logits (B, KH, R, Sq, Sk))."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    rep = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.reshape(b, sq, kh, rep, d).float()
    kf = k.to(q.dtype).float()
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf) * scale
    per_batch = _per_batch(kv_valid_len)
    pos = lambda n: torch.arange(n, device=q.device)
    mask = _mask(pos(sq), pos(sk), spec, None if per_batch else kv_valid_len)
    logits = torch.where(mask[None, None, None], logits, _NEG_INF)
    if per_batch:  # continuous batching: per-slot valid length
        kmask = pos(sk)[None, :] < kv_valid_len.reshape(b, 1)     # (B, Sk)
        logits = torch.where(kmask[:, None, None, None, :], logits, _NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v.to(q.dtype).float())
    return out.reshape(b, sq, h, d).to(q.dtype), logits


def split_k_decode_reference(q, k, v, spec: MaskSpec = MaskSpec(),
                             kv_valid_len=None, scale=None, split=256):
    """The split-K decode route of FLASH_ATTENTION (``csrc/attention.cu``,
    route B) in plain torch, for the tests: the keys in splits of ``split``,
    each split's partial (m, l, acc) of every query row, then their merge.

    A batch row's splits that start at or past the last key any of its rows
    sees are empty (m = -inf, l = 0) and add nothing; inside a split, the
    keys past that end are masked and their v is not read (taken as 0).  A
    split whose keys are all masked for a row has m = -1e30 and weight
    exp(-1e30 - M) = 0 beside a real split; a row that sees no key walks
    every split at -1e30 and merges to the mean of v over all Sk keys.
    Same arguments and result as :func:`full_mha_reference`."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    rep = h // kh
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.reshape(b, sq, kh, rep, d).float()
    kf, vf = k.to(q.dtype).float(), v.to(q.dtype).float()
    pos = lambda n: torch.arange(n, device=q.device)
    valid = torch.as_tensor(sk if kv_valid_len is None else kv_valid_len,
                            device=q.device).reshape(-1).expand(b)
    mask = (_mask(pos(sq), pos(sk), spec)[None]
            & (pos(sk)[None, None, :] < valid[:, None, None]))   # (B, Sq, Sk)
    seen = mask.any(dim=1)                                      # (B, Sk)
    blind = ~mask.any(dim=2).all(dim=1)          # a row of b sees no key
    last = torch.where(seen, pos(sk)[None], -1).amax(dim=1)
    end = torch.where(blind, sk, last + 1)                      # (B,)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf) * scale
    logits = torch.where(mask[:, None, None], logits, _NEG_INF)
    ms, ls, accs = [], [], []
    for lo in range(0, sk, split):
        hi = min(sk, lo + split)
        kpos = pos(hi)[lo:]
        walked = kpos[None, :] < end[:, None]                   # (B, keys)
        z = logits[..., lo:hi]
        m = z.amax(dim=-1)
        p = torch.exp(z - m[..., None])
        vs = torch.where(walked[:, :, None, None], vf[:, lo:hi], 0.0)
        acc = torch.einsum("bhrqk,bkhd->bhrqd", p, vs)
        empty = (lo >= end)[:, None, None, None]
        ms.append(torch.where(empty, -torch.inf, m))
        ls.append(torch.where(empty, 0.0, p.sum(dim=-1)))
        accs.append(torch.where(empty[..., None], 0.0, acc))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = m.amax(dim=0)
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - big))
    out = ((acc * w[..., None]).sum(dim=0)
           / torch.clamp((l * w).sum(dim=0), min=1e-30)[..., None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def mha_reference(q, k, v, *, causal=True, scale=None, q_offset=0):
    """O(S^2)-memory reference attention.

    q: (Sq, H, D), k/v: (Sk, Hkv, D) with H a multiple of Hkv (GQA).
    ``q_offset``: absolute position of q[0] (for decode/causal masking).
    """
    sq, h, d = q.shape
    sk, hkv, _ = k.shape
    rep = h // hkv
    kf = k.repeat_interleave(rep, dim=1)
    vf = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("qhd,khd->hqk", q.float(), kf.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -torch.inf)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", w, vf.float()).to(q.dtype)


def tf32_round(t):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (the low 13
    bits of the float32 cleared after adding half of their range)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, equation, split):
    """einsum of a and b with TF32 operands.  ``split``: the 3xTF32 sum
    (a_lo.b_hi + a_hi.b_lo) + a_hi.b_hi, where hi = tf32(x) and
    lo = tf32(x - hi); else the single product tf32(a).tf32(b)."""
    ah, bh = tf32_round(a), tf32_round(b)
    big = torch.einsum(equation, ah, bh)
    if not split:
        return big
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (torch.einsum(equation, al, bh)
            + torch.einsum(equation, ah, bl)) + big


def ssd_intra_3xtf32_reference(x, log_decay, in_scale, b_, c_, s_in, *,
                               split=True):
    """The CPU twin of SSD_INTRA's tensor-core arithmetic (``csrc/ssd.cu``):
    the function of ``kernels.ssd.ssd_intra_reference`` with every product
    (C.B^T, W.X, C.s_in) taken on TF32 operands, in the 3xTF32 split by
    default or as one TF32 product (``split=False``), float32 sums.  As in
    the kernel, the causal mask comes before the exponential, and the
    inter-chunk term exp(cum) (C.s_in) is formed first and W.X added to it.
    It shows what the split buys; it does not repeat the tensor cores'
    summation order bit for bit."""
    cum = torch.cumsum(log_decay, dim=2)
    l = x.shape[2]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    mask = mask[None, None, :, :, None, None]
    diff = cum[:, :, :, None, :, :] - cum[:, :, None, :, :, :]
    scores = _tf32_product(c_, b_, "bclgn,bcmgn->bclmg", split)
    decay = torch.exp(torch.where(mask, diff, 0.0))
    w = torch.where(mask, scores[..., None] * decay
                    * in_scale[:, :, None, :, :, :], 0.0)
    y = (_tf32_product(c_, s_in, "bclgn,bcgrnp->bclgrp", split)
         * torch.exp(cum)[..., None])
    return y + _tf32_product(w, x, "bclmgr,bcmgrp->bclgrp", split)
