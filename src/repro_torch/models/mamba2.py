"""Mamba2 (SSD) block — chunked state-space dual for prefill, O(1)
recurrent decode.

The port's copy of ``repro.models.mamba2``.  The chunked SSD tiles the
sequence into chunks, computes the quadratic intra-chunk part locally and
passes a small carried state between chunks.  The intra-chunk part is the
reference's ``__kernel__ssd`` region: it goes through ``ops.ssd_intra``,
the SSD_INTRA kernel on the ``CUDA`` template and its plain version on
``TORCH`` (under autograd, the kernel forward with the plain version's
gradient, ``kernels.autograd.SSDIntraFn``); the inter-chunk relay stays
plain PyTorch (a loop over chunks, the reference's ``lax.scan``).

Layout: x (B, S, G, R, P) with H = G·R heads (G = ``ssm_groups`` share one
(B̄, C̄) pair).  All SSD math runs in float32.

Sequence parallelism (``ShardCfg(ssm_sp=True)``, :func:`_mamba2_seq_sp`,
the reference's ``_mamba2_seq_sp``) is the paper's ghost zone on the
sequence axis: each ``tp`` rank runs the block on its block of the
sequence, with

* the conv halo: the W-1 pre-activation rows before its block, the tail
  of the previous rank's block (zeros on rank 0, the causal start).  The
  tails are all-gathered over ``tp`` (``collectives.gather`` with the
  gradient summed back, so the rows a rank sent get the gradient of the
  rank that used them), and each rank keeps its predecessor's.  One
  all-gather of (B, W-1, conv_dim) a layer costs about what one send
  would, and, unlike a send and a receive that must pair up across ranks,
  it has the same collective on every rank in the forward and in the
  backward, where the gradient flows back through it;
* the chunk state relay, in two passes: a ``states_only`` pass (no
  SSD_INTRA) gives the block's final state and its total decay, one
  all-gather over ``tp`` brings every rank's, and the prefix product over
  the ranks before it is this rank's incoming state, which the exact
  pass (SSD_INTRA on the card, the state in ``s_in``) starts from.

The output is gathered back over ``tp``.  Each rank's parameters see only
its block's tokens, so their gradients are parts, summed over ``tp``
where they are gathered (``dist.sharding.gather_params``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.collectives import gather, gather_many, seq_split
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, ShardCfg


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim)
    ssm: torch.Tensor    # (B, G, R, N, P) fp32


class Mamba2(nn.Module):
    """Parameters of one Mamba2 block, the reference's names."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        w = cfg.conv_width
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = layers.Dense(gen, d, 2 * di + 2 * g * n + h,
                                    cfg.param_dtype, device)
        self.conv_w = layers.param(layers.truncated_normal(
            gen, (w, cfg.conv_dim), 1.0 / math.sqrt(w), torch.float32, device))
        self.conv_b = layers.param(torch.zeros(cfg.conv_dim, **f32))
        self.A_log = layers.param(torch.log(torch.linspace(1.0, 16.0, h, **f32)))
        self.D = layers.param(torch.ones(h, **f32))
        # dt_bias: inverse-softplus of dt ~ exp(U[log 1e-3, log 1e-1])
        u = torch.empty(h, **f32)
        if u.device.type != "meta":
            u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        dt0 = torch.exp(u)
        self.dt_bias = layers.param(dt0 + torch.log(-torch.expm1(-dt0)))
        self.norm = layers.RMSNorm(di, device)
        self.out_proj = layers.Dense(gen, di, d, cfg.param_dtype, device)


def _causal_conv(xbc, conv_w, conv_b, prefix):
    """Depthwise causal conv, width W.  ``prefix``: (B, W-1, C) carried
    context (zeros at sequence start)."""
    b, s, c = xbc.shape
    w = conv_w.shape[0]
    if prefix is None:
        prefix = torch.zeros((b, w - 1, c), dtype=xbc.dtype, device=xbc.device)
    xpad = torch.cat([prefix.to(xbc.dtype), xbc], dim=1)
    y = sum(xpad[:, i:i + s].float() * conv_w[i] for i in range(w))
    return F.silu(y + conv_b).to(xbc.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, h = cfg.d_inner, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _gr(cfg: ModelConfig):
    g = cfg.ssm_groups
    return g, cfg.ssm_heads // g


def ssd_chunked(x, dt, a, b_, c_, chunk: int, init_state=None,
                states_only: bool = False, template=None):
    """Chunked SSD.  x (B,S,G,R,P) fp32, dt (B,S,G,R) fp32 (post-softplus),
    a (G,R) fp32 (negative), b_/c_ (B,S,G,N) fp32.  Returns
    (y (B,S,G,R,P), final_state (B,G,R,N,P)); with ``states_only``
    (None, final_state), no SSD_INTRA run."""
    return ssd_core(x, dt * a, dt, b_, c_, chunk, init_state, states_only,
                    template=template)


def ssd_core(x, log_decay, in_scale, b_, c_, chunk: int, init_state=None,
             states_only: bool = False, template=None):
    """Chunked linear-recurrence core.

    State recursion  S_t = exp(log_decay_t) S_{t-1} + in_scale_t B_t (x) x_t
    with output      y_t = C_t^T S_t.
    Shapes: x (B,S,G,R,P), log_decay/in_scale (B,S,G,R), b_/c_ (B,S,G,N).
    ``states_only``: only the final state (the first pass of the
    sequence-parallel block), (None, final)."""
    bsz, s, g, r, p = x.shape
    n = b_.shape[-1]
    l = min(chunk, s)
    pad = (-s) % l
    if pad:
        x, log_decay, in_scale, b_, c_ = (
            F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
            for v in (x, log_decay, in_scale, b_, c_))
    nc = (s + pad) // l
    xc = x.reshape(bsz, nc, l, g, r, p)
    dtc = in_scale.reshape(bsz, nc, l, g, r)
    bc = b_.reshape(bsz, nc, l, g, n)
    cc = c_.reshape(bsz, nc, l, g, n)

    da = log_decay.reshape(bsz, nc, l, g, r)       # (B,nc,L,G,R)  negative
    cum = torch.cumsum(da, dim=2)                  # within-chunk cumulative

    # chunk-end states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)                 # (B,nc,L,G,R)
    sc = torch.einsum("bclgn,bclgr,bclgrp->bcgrnp",
                      bc, decay_to_end * dtc, xc)                  # (B,nc,G,R,N,P)
    chunk_decay = torch.exp(cum[:, :, -1])                         # (B,nc,G,R)

    carry = (torch.zeros((bsz, g, r, n, p), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    s_in = []
    for c in range(nc):                    # emit the incoming state
        s_in.append(carry)
        carry = carry * chunk_decay[:, c][..., None, None] + sc[:, c]
    if states_only:
        return None, carry
    s_in = torch.stack(s_in, dim=1)                                # (B,nc,G,R,N,P)

    # intra-chunk quadratic + inter-chunk contribution: the SSD_INTRA kernel
    y = ops.ssd_intra(xc, da, dtc, bc, cc, s_in, template=template)
    y = y.reshape(bsz, nc * l, g, r, p)[:, :s]
    return y, carry


def _prep_ssm_inputs(p: Mamba2, cfg: ModelConfig, xbc, dt_raw):
    """Split conv output into (x, B̄, C̄) and finalize dt/A in fp32."""
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    g_, r = _gr(cfg)
    xs = xbc[..., :di]
    b_ = xbc[..., di:di + g * n].reshape(*xbc.shape[:-1], g, n)
    c_ = xbc[..., di + g * n:].reshape(*xbc.shape[:-1], g, n)
    shp = xs.shape[:-1]
    xs = xs.reshape(*shp, g_, r, cfg.ssm_head_dim).float()
    dt = F.softplus(dt_raw.float() + p.dt_bias).reshape(*shp, g_, r)
    a = -torch.exp(p.A_log).reshape(g_, r)
    return xs, b_.float(), c_.float(), dt, a


def _finish(p: Mamba2, cfg: ModelConfig, y, xs, z):
    """D-skip, gated RMSNorm, out-projection."""
    d_skip = p.D.reshape(*_gr(cfg))
    y = y + d_skip[..., None] * xs
    y = y.reshape(*y.shape[:-3], cfg.d_inner)
    y = layers.rmsnorm(p.norm, y.to(cfg.compute_dtype), cfg.norm_eps) \
        * F.silu(z.to(cfg.compute_dtype))
    return layers.dense(p.out_proj, y)


def mamba2_seq(p: Mamba2, cfg: ModelConfig, x, shard: ShardCfg,
               state: Mamba2State | None = None, return_state: bool = False,
               template=None):
    """Full-sequence Mamba2: train / prefill.  x (B, S, d_model).  Under
    ``shard.ssm_sp`` over a mesh: :func:`_mamba2_seq_sp`."""
    if shard.ssm_sp and shard.mesh is not None:
        if state is not None or return_state:
            # the reference's _mamba2_seq_sp returns no state, and its
            # hybrid prefill then fails stacking it
            raise ValueError("ssm_sp runs a sequence from its start and "
                             "returns no state: a prefill that takes or "
                             "fills the Mamba2 caches is not sequence-"
                             "parallel (serve with ssm_sp=False)")
        return _mamba2_seq_sp(p, cfg, x, shard, template), None
    zxbcdt = layers.dense(p.in_proj, x.to(cfg.compute_dtype))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_prefix = state.conv if state is not None else None
    xbc = _causal_conv(xbc, p.conv_w, p.conv_b, conv_prefix)
    xs, b_, c_, dt, a = _prep_ssm_inputs(p, cfg, xbc, dt_raw)
    init = state.ssm if state is not None else None
    y, final = ssd_chunked(xs, dt, a, b_, c_, cfg.ssm_chunk, init,
                           template=template)
    out = _finish(p, cfg, y, xs, z)
    if not return_state:
        return out, None
    # conv state is the PRE-activation xbc tail
    w = cfg.conv_width
    tail = _split_proj(cfg, zxbcdt)[1][:, -(w - 1):, :]
    return out, Mamba2State(conv=tail.float(), ssm=final)


def _conv_halo(xbc, shard: ShardCfg, width: int):
    """(B, W-1, C): the previous ``tp`` rank's last W-1 rows of ``xbc``
    (pre-activation), zeros on the first rank (a planted fault's hook)."""
    tails = gather(xbc[None, :, xbc.shape[1] - (width - 1):], shard.mesh,
                   shard.tp, 0)                          # (|tp|, B, W-1, C)
    # rank i keeps tails[i - 1]: the same ops on every rank, so that each
    # rank's gather is reached by the backward (its reduce-scatter is a
    # collective of the whole line)
    shifted = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])
    return shifted[shard.tp_rank()]


def _relay(final, decay, shard: ShardCfg):
    """This ``tp`` rank's incoming state: every rank's block-final state
    ``final`` (B,G,R,N,P) and total decay ``decay`` (B,G,R) gathered in one
    collective, and the prefix product over the ranks before it (zeros on
    the first; a planted fault's hook)."""
    finals, decays = gather_many([final[None], decay[None]], shard.mesh,
                                 shard.tp, [0, 0])
    acc, s_in = torch.zeros_like(final), []
    for j in range(finals.shape[0]):       # every rank's, as the reference
        s_in.append(acc)
        acc = acc * decays[j][..., None, None] + finals[j]
    return torch.stack(s_in)[shard.tp_rank()]


def _mamba2_seq_sp(p: Mamba2, cfg: ModelConfig, x, shard: ShardCfg,
                   template=None):
    """Sequence-parallel Mamba2 over ``tp`` (the module's text): x
    (B, S, d_model) replicated on ``tp`` -> the block's output, gathered
    back over ``tp``."""
    n, s, w = shard.tp_size(), x.shape[1], cfg.conv_width
    if s % n:
        raise ValueError(f"ssm_sp splits the sequence over |tp| = {n} "
                         f"ranks: S = {s} does not divide")
    if s // n < w - 1:
        raise ValueError(f"ssm_sp: a rank's block of {s // n} tokens is "
                         f"shorter than the conv halo's W-1 = {w - 1}")
    x = seq_split(x, shard.mesh, shard.tp, 1)
    zxbcdt = layers.dense(p.in_proj, x.to(cfg.compute_dtype))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    prefix = _conv_halo(xbc, shard, w)
    xbc = _causal_conv(xbc, p.conv_w, p.conv_b, prefix)
    xs, b_, c_, dt, a = _prep_ssm_inputs(p, cfg, xbc, dt_raw)
    _, final = ssd_chunked(xs, dt, a, b_, c_, cfg.ssm_chunk,
                           states_only=True)
    s0 = _relay(final, torch.exp(torch.sum(dt * a, dim=1)), shard)
    y, _ = ssd_chunked(xs, dt, a, b_, c_, cfg.ssm_chunk, s0,
                       template=template)
    out = _finish(p, cfg, y, xs, z)
    return gather(out, shard.mesh, shard.tp, 1, reduce_back=False)


def mamba2_init_state(cfg: ModelConfig, batch: int, device=None) -> Mamba2State:
    g, r = _gr(cfg)
    return Mamba2State(
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim),
                         dtype=torch.float32, device=device),
        ssm=torch.zeros((batch, g, r, cfg.ssm_state, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device))


def mamba2_step(p: Mamba2, cfg: ModelConfig, x_t, state: Mamba2State):
    """Single-token decode.  x_t (B, d_model) -> (y (B, d_model), state)."""
    zxbcdt = layers.dense(p.in_proj, x_t.to(cfg.compute_dtype))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    # rolling conv window
    window = torch.cat([state.conv, xbc[:, None, :].float()], dim=1)  # (B,W,C)
    y_conv = torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b
    xbc_c = F.silu(y_conv).to(cfg.compute_dtype)
    new_conv = window[:, 1:]

    xs, b_, c_, dt, a = _prep_ssm_inputs(p, cfg, xbc_c, dt_raw)
    # xs (B,G,R,P), b_/c_ (B,G,N), dt (B,G,R)
    da = torch.exp(dt * a)                                         # (B,G,R)
    upd = torch.einsum("bgn,bgr,bgrp->bgrnp", b_, dt, xs)
    ssm = state.ssm * da[..., None, None] + upd
    y = torch.einsum("bgn,bgrnp->bgrp", c_, ssm)
    out = _finish(p, cfg, y, xs, z)
    return out, Mamba2State(conv=new_conv, ssm=ssm)
