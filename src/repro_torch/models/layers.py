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


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = dense(p.gate, x)
    u = dense(p.up, x)
    return dense(p.down, F.silu(g) * u)
