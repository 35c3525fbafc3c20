"""Intra-chunk SSD (Mamba2): the plain version of the SSD_INTRA kernel.

The port's copy of ``repro.kernels.ssd``'s oracle.  The chunked
linear-recurrence core (``models/mamba2.ssd_core``) splits into a cheap
inter-chunk state relay and a quadratic intra-chunk part, per (batch,
chunk, group):

    cum   = cumsum(log_decay)                       (L, R)
    S     = (C @ B^T)                               (L, L)
    for r: y[:, r] = (S * exp(cum_r_i - cum_r_j) * mask * dt_r) @ x[:, r]
    plus the inter-chunk contribution  y += (C @ state_r) * exp(cum_r)

``ssd_intra_reference`` is that math in plain PyTorch; the hand-written
kernel (``kernels/ssd_cuda.py``, ``csrc/ssd.cu``) replaces the reference's
Pallas ``ssd_intra_pallas`` and is checked against this function.

The causal mask is applied to ``cum_i - cum_j`` before the exponential,
as the kernel applies it.  Above the diagonal that difference is positive
and, once a chunk's decays sum past ~88, ``exp`` overflows to inf: the
reference's jnp body (``exp`` first, then ``where``) gives the same values
but a NaN gradient there (0 · inf), which a training step spreads to every
parameter.  Masking first gives the same output bit for bit and a finite
gradient (this function is also the backward of ``autograd.SSDIntraFn``).
"""
from __future__ import annotations

import torch


def ssd_intra_reference(x, log_decay, in_scale, b_, c_, s_in):
    """x (B,nc,L,G,R,P), gates (B,nc,L,G,R), b_/c_ (B,nc,L,G,N),
    s_in (B,nc,G,R,N,P) -> y (B,nc,L,G,R,P)."""
    cum = torch.cumsum(log_decay, dim=2)
    l = x.shape[2]
    diff = cum[:, :, :, None, :, :] - cum[:, :, None, :, :, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    mask = mask[None, None, :, :, None, None]
    lmat = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    scores = torch.einsum("bclgn,bcmgn->bclmg", c_, b_)
    attw = scores[..., None] * lmat * in_scale[:, :, None, :, :, :]
    y = torch.einsum("bclmgr,bcmgrp->bclgrp", attw, x)
    y = y + torch.einsum("bclgn,bcgrnp->bclgrp", c_, s_in) \
        * torch.exp(cum)[..., None]
    return y
