"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, strictly sequential) — the ``ssm`` family.

The port's copy of ``repro.models.xlstm``.  The mLSTM is the linear
recurrence

    C_t = f_t C_{t-1} + i_t k_t v_t^T      n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (C_t q_t) / max(|n_t q_t|, 1)

which is :func:`repro_torch.models.mamba2.ssd_core` with decoupled
(decay, input scale) = (sigmoid(f̃), exp(ĩ)), the heads as its groups
(G, R) = (H, 1), and the normalizer n carried as one extra value column
(v augmented with a ones column): prefill goes through the chunked SSD and
so through the SSD_INTRA kernel on the ``CUDA`` template, at N = P_v = the
head dim and P = P_v + 1.  The input-gate logit is soft-capped (±8); the
cell runs in float32.

The sLSTM has per-head block-diagonal *recurrent* gate connections (the
gates at t see h_{t-1}), so it is sequential over time: a Python loop
(the reference's ``lax.scan``) of eager ops.  No kernel exists for it in
either package.  Decode is O(1)-state for both cells, in plain PyTorch
(the reference computes it in ``jnp``).

The arithmetic follows the reference's where PyTorch's idiom would round
otherwise: GeLU is the tanh approximation (``jax.nn.gelu``'s default);
prefill casts the float32 conv tail to the compute dtype before the conv
while the decode step keeps it in float32; prefill multiplies k by
1/sqrt(p) while the step divides by sqrt(p) (a true division on the card,
:func:`repro_torch.device.true_divide`); the sLSTM max-state starts at
-1e30.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import true_divide
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import ssd_core

_GATE_CAP = 8.0  # soft-cap on the mLSTM input-gate logit (stabilization)


class MLSTMState(NamedTuple):
    c: torch.Tensor      # (B, H, N, P) matrix memory (P = head dim + 1), fp32
    n: torch.Tensor      # (B, H, N)    normalizer, fp32
    conv: torch.Tensor   # (B, W-1, d_inner) causal-conv tail, fp32


class SLSTMState(NamedTuple):
    c: torch.Tensor      # (B, H, P) cell, fp32
    n: torch.Tensor      # (B, H, P) normalizer, fp32
    m: torch.Tensor      # (B, H, P) max-state (log-space stabilizer), fp32
    h: torch.Tensor      # (B, H, P) previous output (recurrent input), fp32


def _at_least_one(t):
    """max(t, 1.0) as ``jnp.maximum(t, 1.0)``: the same values, and at a tie
    the gradient split half to each side (``torch.clamp`` would pass all of
    it to ``t``)."""
    return torch.maximum(t, t.new_ones(()))


def _dims(cfg: ModelConfig):
    h = cfg.num_heads
    d_inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    d_inner = -(-d_inner // h) * h                    # round up to head mult
    return h, d_inner, d_inner // h


def _f32(*shape, value=0.0, device=None) -> nn.Parameter:
    return layers.param(torch.full(shape, value, dtype=torch.float32,
                                   device=device))


# ---------------------------------------------------------------------------
# mLSTM block: ln -> up-proj (u, z) -> conv(u) -> q,k | v -> mLSTM cell
#              -> group-norm -> *silu(z) -> down-proj -> residual
# ---------------------------------------------------------------------------
class MLSTMBlock(nn.Module):
    """Parameters of one mLSTM block, the reference's names."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        h, di, _ = _dims(cfg)
        dt, w = cfg.param_dtype, cfg.conv_width
        self.up = layers.Dense(gen, cfg.d_model, 2 * di, dt, device)
        self.conv_w = layers.param(layers.truncated_normal(
            gen, (w, di), 1.0 / math.sqrt(w), torch.float32, device))
        self.conv_b = _f32(di, device=device)
        self.wq = layers.Dense(gen, di, di, dt, device)
        self.wk = layers.Dense(gen, di, di, dt, device)
        self.wv = layers.Dense(gen, di, di, dt, device)
        # gates are scalar per head, computed from the block input
        self.wi = layers.Dense(gen, cfg.d_model, h, torch.float32, device)
        self.wf = layers.Dense(gen, cfg.d_model, h, torch.float32, device)
        # forget bias init positive => long memory at init (paper's init)
        self.bf = _f32(h, value=3.0, device=device)
        self.bi = _f32(h, value=-2.0, device=device)
        self.norm = layers.RMSNorm(di, device)
        self.down = layers.Dense(gen, di, cfg.d_model, dt, device,
                                 stddev=1.0 / math.sqrt(di))


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    h, di, p = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        c=torch.zeros((batch, h, p, p + 1), **f32),
        n=torch.zeros((batch, h, p), **f32),       # kept for API symmetry
        conv=torch.zeros((batch, cfg.conv_width - 1, di), **f32))


def _mlstm_gates(p: MLSTMBlock, x):
    """(B,S,H) fp32 (log_decay, in_scale) from the block input."""
    xf = x.float()
    f_logit = layers.dense(p.wf, xf) + p.bf
    i_logit = layers.dense(p.wi, xf) + p.bi
    i_logit = _GATE_CAP * torch.tanh(i_logit / _GATE_CAP)    # soft-cap
    log_decay = F.logsigmoid(f_logit)                        # (B,S,H) <= 0
    in_scale = torch.exp(i_logit)
    return log_decay, in_scale


def _mlstm_qkv(p: MLSTMBlock, cfg: ModelConfig, x, conv_prefix):
    """Up-project, causal-conv, and split into q,k,v,z.  Returns fp32 qkv
    and the new conv tail (in the compute dtype)."""
    h, di, hd = _dims(cfg)
    up = layers.dense(p.up, x.to(cfg.compute_dtype))
    u, z = up[..., :di], up[..., di:]
    w = cfg.conv_width
    b, s, _ = u.shape
    if conv_prefix is None:
        conv_prefix = torch.zeros((b, w - 1, di), dtype=u.dtype,
                                  device=u.device)
    upad = torch.cat([conv_prefix.to(u.dtype), u], dim=1)
    uc = sum(upad[:, i:i + s].float() * p.conv_w[i] for i in range(w))
    uc = F.silu(uc + p.conv_b)
    q = layers.dense(p.wq, uc.to(cfg.compute_dtype))
    k = layers.dense(p.wk, uc.to(cfg.compute_dtype))
    v = layers.dense(p.wv, u)                                # v skips the conv
    split = lambda t: t.reshape(b, s, h, hd).float()
    new_prefix = upad[:, -(w - 1):]
    return split(q), split(k), split(v), z, new_prefix


def _mlstm_out(p: MLSTMBlock, cfg: ModelConfig, hval, z, x):
    _, di, _ = _dims(cfg)
    b, s = hval.shape[:2]
    y = hval.reshape(b, s, di).to(cfg.compute_dtype)
    y = layers.rmsnorm(p.norm, y, cfg.norm_eps) * F.silu(z)
    return x + layers.dense(p.down, y).to(x.dtype)


def mlstm_seq(p: MLSTMBlock, cfg: ModelConfig, x,
              state: MLSTMState | None = None, return_state: bool = False,
              template=None):
    """Full-sequence mLSTM block (prefill).  x (B,S,d_model)."""
    h, di, hd = _dims(cfg)
    b, s, _ = x.shape
    q, k, v, z, new_conv = _mlstm_qkv(
        p, cfg, x, state.conv if state is not None else None)
    log_decay, in_scale = _mlstm_gates(p, x)
    # ssd_core layout: G=H heads, R=1; n_t carried as extra value channel
    scale = 1.0 / math.sqrt(hd)
    ones = torch.ones((b, s, h, 1), dtype=torch.float32, device=x.device)
    v_aug = torch.cat([v, ones], dim=-1)
    y_aug, final = ssd_core(
        v_aug[:, :, :, None, :],                 # x    (B,S,H,1,P+1)
        log_decay[..., None],                    # (B,S,H,1)
        in_scale[..., None],
        k * scale,                               # b_ (B,S,H,N)
        q,                                       # c_ (B,S,H,N)
        cfg.ssm_chunk,
        state.c[:, :, None] if state is not None else None,
        template=template)
    y_aug = y_aug[:, :, :, 0]                    # (B,S,H,P+1)
    hval = y_aug[..., :hd] / _at_least_one(torch.abs(y_aug[..., hd:]))
    out = _mlstm_out(p, cfg, hval, z, x)
    if not return_state:
        return out, None
    return out, MLSTMState(c=final[:, :, 0], n=final[:, :, 0, :, hd],
                           conv=new_conv.float())


def mlstm_step(p: MLSTMBlock, cfg: ModelConfig, x_t, state: MLSTMState):
    """Single-token decode.  x_t (B, d_model) -> (y, state).  O(1) state."""
    h, di, hd = _dims(cfg)
    b = x_t.shape[0]
    x1 = x_t[:, None, :]
    up = layers.dense(p.up, x1.to(cfg.compute_dtype))
    u, z = up[..., :di], up[..., di:]
    window = torch.cat([state.conv, u.float()], dim=1)
    uc = F.silu(torch.einsum("bwc,wc->bc", window, p.conv_w)
                + p.conv_b)[:, None]
    q = layers.dense(p.wq, uc.to(cfg.compute_dtype))
    k = layers.dense(p.wk, uc.to(cfg.compute_dtype))
    v = layers.dense(p.wv, u)
    rs = lambda t: t.reshape(b, h, hd).float()
    q, k, v = rs(q), rs(k), rs(v)
    log_decay, in_scale = _mlstm_gates(p, x1)
    f = torch.exp(log_decay[:, 0])[..., None, None]           # (B,H,1,1)
    i = in_scale[:, 0][..., None, None]
    k = true_divide(k, math.sqrt(hd))
    ones = torch.ones((b, h, 1), dtype=torch.float32, device=x_t.device)
    v_aug = torch.cat([v, ones], dim=-1)
    c_new = f * state.c + i * k[..., :, None] * v_aug[..., None, :]
    y_aug = torch.einsum("bhn,bhnp->bhp", q, c_new)           # (B,H,P+1)
    hval = y_aug[..., :hd] / _at_least_one(torch.abs(y_aug[..., hd:]))
    out = _mlstm_out(p, cfg, hval[:, None], z, x1)[:, 0]
    new_state = MLSTMState(c=c_new, n=c_new[..., hd], conv=window[:, 1:])
    return out, new_state


# ---------------------------------------------------------------------------
# sLSTM block: ln -> sLSTM cell (recurrent gates, a loop over time)
#              -> group norm -> GeLU MLP (pf 4/3) -> residual
# ---------------------------------------------------------------------------
class SLSTMBlock(nn.Module):
    """Parameters of one sLSTM block, the reference's names."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        h = cfg.num_heads
        p = cfg.d_model // h
        dt = cfg.param_dtype
        d_up = int(cfg.d_model * 4 / 3)
        gate = lambda: layers.Dense(gen, cfg.d_model, h * p, torch.float32,
                                    device)
        # recurrent block-diagonal per-head matrices (H, P, P)
        rec = lambda: layers.param(layers.truncated_normal(
            gen, (h, p, p), 1.0 / math.sqrt(p), torch.float32, device))
        self.wz, self.wi, self.wf, self.wo = gate(), gate(), gate(), gate()
        self.rz, self.ri, self.rf, self.ro = rec(), rec(), rec(), rec()
        self.bz = _f32(h, p, device=device)
        self.bi = _f32(h, p, device=device)
        self.bf = _f32(h, p, value=3.0, device=device)
        self.bo = _f32(h, p, device=device)
        self.norm = layers.RMSNorm(cfg.d_model, device)
        self.mlp_up = layers.Dense(gen, cfg.d_model, d_up, dt, device)
        self.mlp_down = layers.Dense(gen, d_up, cfg.d_model, dt, device,
                                     stddev=1.0 / math.sqrt(d_up))


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    h = cfg.num_heads
    p = cfg.d_model // h
    z = lambda v: torch.full((batch, h, p), v, dtype=torch.float32,
                             device=device)
    return SLSTMState(c=z(0.0), n=z(0.0), m=z(-1e30), h=z(0.0))


def _slstm_cell(p: SLSTMBlock, gx: dict, state: SLSTMState) -> SLSTMState:
    """One stabilized sLSTM step.  gx: (B,H,P) pre-activations from the
    input path; the recurrent contributions are added here.  From a fresh
    state n is 1.0 at the first step whatever the parameters (exp(i - m)
    with m = i), so the floor's tie there carries no gradient and
    ``clamp`` gives the reference's."""
    hp = state.h
    rec = lambda r: torch.einsum("bhp,hpq->bhq", hp, r)
    z = torch.tanh(gx["z"] + rec(p.rz) + p.bz)
    i_log = gx["i"] + rec(p.ri) + p.bi
    f_log = F.logsigmoid(gx["f"] + rec(p.rf) + p.bf)
    o = torch.sigmoid(gx["o"] + rec(p.ro) + p.bo)
    m_new = torch.maximum(f_log + state.m, i_log)
    i_s = torch.exp(i_log - m_new)
    f_s = torch.exp(f_log + state.m - m_new)
    c = f_s * state.c + i_s * z
    n = f_s * state.n + i_s
    h_new = o * c / torch.clamp(n, min=1.0)
    return SLSTMState(c=c, n=n, m=m_new, h=h_new)


def _slstm_gates_x(p: SLSTMBlock, cfg: ModelConfig, x) -> dict:
    """Input-path gate pre-activations: (B,S,H,P) each, fp32."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    xf = x.float()
    g = lambda w: layers.dense(w, xf).reshape(*x.shape[:-1], h, hd)
    return {"z": g(p.wz), "i": g(p.wi), "f": g(p.wf), "o": g(p.wo)}


def slstm_seq(p: SLSTMBlock, cfg: ModelConfig, x,
              state: SLSTMState | None = None, return_state: bool = False,
              template=None):
    """Full-sequence sLSTM (a sequential loop over time).  x (B,S,d)."""
    b, s, d = x.shape
    gx = _slstm_gates_x(p, cfg, x)
    st = state if state is not None else slstm_init_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        st = _slstm_cell(p, {k: v[:, t] for k, v in gx.items()}, st)
        hs.append(st.h)
    y = torch.stack(hs, dim=1).reshape(b, s, d)                # (B,S,d)
    out = _slstm_mlp(p, cfg, y, x)
    return out, (st if return_state else None)


def slstm_step(p: SLSTMBlock, cfg: ModelConfig, x_t, state: SLSTMState):
    """Single-token decode.  x_t (B, d)."""
    gx = _slstm_gates_x(p, cfg, x_t[:, None])
    st = _slstm_cell(p, {k: v[:, 0] for k, v in gx.items()}, state)
    y = st.h.reshape(x_t.shape)
    return _slstm_mlp(p, cfg, y[:, None], x_t[:, None])[:, 0], st


def _slstm_mlp(p: SLSTMBlock, cfg: ModelConfig, y, x):
    y = layers.rmsnorm(p.norm, y.to(cfg.compute_dtype), cfg.norm_eps)
    y = layers.dense(p.mlp_down, F.gelu(layers.dense(p.mlp_up, y),
                                        approximate="tanh"))
    return x + y.to(x.dtype)


def xlstm_flops_per_token(cfg: ModelConfig) -> int:
    """Approx fwd FLOPs/token of one mLSTM block (projections dominate)."""
    h, di, p = _dims(cfg)
    d = cfg.d_model
    proj = 2 * d * 2 * di + 3 * 2 * di * di + 2 * di * d
    cell = 2 * cfg.ssm_chunk * h * p * (p + 1) * 2
    return proj + cell
