"""Shared neural-net layers: RMSNorm, rotary embeddings, dense, embedding,
SwiGLU MLP, and the truncated-normal init.

The port's copy of ``repro.models.layers``.  Each layer is an
``nn.Module`` holding its parameters under the reference's names (so a
reference parameter tree maps onto ``state_dict`` keys one to one), and an
apply function on tensors.  Weights are stored in ``param_dtype`` and cast
to the compute dtype at use.  Initialisers draw from an explicit
``torch.Generator``; on the ``meta`` device they allocate nothing and draw
nothing (``ModelConfig.param_count``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter created frozen: the serving path records no autograd
    graph.  Training turns gradients on for the whole model
    (``model.requires_grad_(True)``, ``train.step.make_train_step``)."""
    return nn.Parameter(t, requires_grad=False)


def truncated_normal(gen, shape, stddev, dtype, device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``stddev``, in float32, then cast
    to ``dtype`` (the reference's ``truncated_normal``).  The scaling is in
    place (the same values as ``t * stddev``), so the draw holds one float32
    copy: kimi-k2's (384, 2048, 7168) expert leaf is 22.5 GB of it."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type == "meta":
        return t.to(dtype)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=torch.float32, device=device))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half convention)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    angles = angles[..., None, :]                              # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embeddings
# ---------------------------------------------------------------------------
class Dense(nn.Module):
    """A (d_in, d_out) weight; no layer of the ported families has a bias."""

    def __init__(self, gen, d_in: int, d_out: int, dtype, device=None, *,
                 stddev: float | None = None):
        super().__init__()
        stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
        self.w = param(truncated_normal(gen, (d_in, d_out), stddev, dtype,
                                        device))


def dense(p: Dense, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    dt = compute_dtype or x.dtype
    return x.to(dt) @ p.w.to(dt)


class _TF32:
    """Inside the context float32 products on the card may use TF32 tensor
    cores; the setting before it is put back after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        if self.on:
            torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


class _SplitProduct(torch.autograd.Function):
    """(..., k) @ (k, n) in float32 of the operands rounded to ``dt``; see
    :func:`split_product`.  The rounded operands are what the backward
    keeps; the gradients come back in the operands' own dtypes."""

    @staticmethod
    def forward(ctx, a, b, dt):
        a16, b16 = a.to(dt), b.to(dt)
        ctx.save_for_backward(a16, b16)
        ctx.dtypes = (a.dtype, b.dtype, dt)
        with _TF32(dt in (torch.bfloat16, torch.float16)):
            return a16.float() @ b16.float()

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        a_dt, b_dt, dt = ctx.dtypes
        k, n = b16.shape
        with _TF32(dt in (torch.bfloat16, torch.float16)):
            ga = g @ b16.float().t()
            gb = a16.reshape(-1, k).float().t() @ g.reshape(-1, n)
        return ga.to(a_dt), gb.to(b_dt), None


def split_product(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """``x @ w`` for one rank's part of a tensor-parallel product, kept in
    float32: both operands rounded to the compute dtype ``dt`` (as the
    single product rounds them), the products summed in float32, and the
    result left unrounded, so that its sum over ``tp`` rounds once, as the
    single product does; the backward's products and the gradients it
    returns stay in float32 where the operands were (a float32 ``x``).
    With a 16-bit ``dt`` every operand of the forward and of the backward
    holds a 16-bit value (the incoming gradient is that of a rounding to
    ``dt``), which TF32 holds exactly, so the products run on the card's
    tensor cores at float32 accumulation."""
    return _SplitProduct.apply(x, w, dt)


class Embedding(nn.Module):
    def __init__(self, gen, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = param(truncated_normal(gen, (vocab, d), 1.0 / math.sqrt(d),
                                            dtype, device))


def embed(p: Embedding, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p.table[ids].to(compute_dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, gen, d: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.gate = Dense(gen, d, d_ff, dtype, device)
        self.up = Dense(gen, d, d_ff, dtype, device)
        self.down = Dense(gen, d_ff, d, dtype, device,
                          stddev=1.0 / math.sqrt(d_ff))


def mlp(p: MLP, x: torch.Tensor, shard=None, d_ff: int | None = None):
    """SwiGLU.  Over a mesh whose placement splits the hidden width
    (``p`` then holds ``d_ff / |tp|`` of it; ``d_ff`` is the whole), gate
    and up are column-parallel and down row-parallel: one all-reduce over
    ``tp``.  The split products stay in float32 and round once, after the
    all-reduce (:func:`split_product`)."""
    split = (shard is not None and d_ff is not None and shard.tp_size() > 1
             and p.gate.w.shape[1] < d_ff)
    if not split:
        g = dense(p.gate, x)
        u = dense(p.up, x)
        return dense(p.down, F.silu(g) * u)
    from repro_torch.dist.collectives import tp_copy, tp_reduce

    dt = x.dtype
    x = tp_copy(x, shard).float()
    g = split_product(x, p.gate.w, dt).to(dt)
    u = split_product(x, p.up.w, dt).to(dt)
    y = split_product(F.silu(g) * u, p.down.w, dt)
    return tp_reduce(y, shard).to(dt)
