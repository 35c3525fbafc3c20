"""Mixture-of-Experts layer: top-k router + capacity-bucketed sort dispatch.

The port's copy of ``repro.models.moe``.  ``moe_mode="local"``: the device
holds and computes every expert.  ``moe_mode="tp"`` over a mesh of ranks
(:func:`_tp_moe`): the experts are sharded E/|tp| a rank, the tokens are
replicated on ``tp``; each rank dispatches the assignments to its own
experts (the others' ids dropped to a masked slot), with a capacity from
its local tokens, and the combine is one all-reduce over ``tp``.  Over
data-parallel ranks the load-balance loss takes the global batch's
assignment fractions (all-reduced), as the reference's loss over the
whole batch does.

``moe_mode="a2a"`` (:func:`_a2a_moe`): each ``tp`` rank takes its block of
the sequence (the tokens are replicated on ``tp`` before it), routes its
own tokens, caps each expert at the capacity of its own tokens, and sends
the (E·C, d) dispatch buffer, grouped by the experts' ranks, through one
all_to_all; its E/|tp| experts run over the |tp|·C rows each received,
and a second all_to_all sends the rows back, where the combine is the one
above.  The output is gathered back over ``tp``.  Capacity follows each
source block's tokens, so at a capacity factor that drops assignments
``a2a`` computes another function than ``local`` or ``tp``; at one under
which nothing drops (E/k always) the same.  The load-balance and z
losses and the dropped fraction are the mean over the (data, tp) blocks
of each block's own values: the reference's ``_a2a_moe`` returns the mean
over ``tp`` of its blocks' values and leaves the mean over ``dp``
undefined (its ``out_specs`` claim them replicated there); with one data
rank the two agree.

Dispatch is the reference's sort-based capacity bucket: the (T·k,)
assignments are sorted by expert id (a *stable* sort, as ``jnp.argsort``
is), each expert keeps its first ``capacity`` assignments in that order and
drops the rest, and the kept ones gather into an (E, C, d) buffer, with no
(T, E, C) one-hot tensor.  The expert FFN is three batched matrix products
over that buffer (the reference's ``einsum``, outside any Pallas kernel),
every expert computed whether it holds a token or not.

The combine is deterministic: the reference scatter-adds the buffer in
its expert-major order, so each token's k contributions (distinct experts)
are added in ascending expert order, starting from zero, in the compute
dtype.  The port gathers each token's k contributions, orders them by
expert id and sums them in sequence, so a token's output is the same from
run to run on the card (``index_add_`` would add in the order its atomics
land).  The router's product stays in full float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.device import true_divide
from repro_torch.dist.collectives import (all_reduce, exchange, gather,
                                          seq_split, tp_copy, tp_reduce)
from repro_torch.models.config import LOCAL, ModelConfig, ShardCfg


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor          # load-balance loss (scalar)
    z_loss: torch.Tensor            # router logit z-loss (scalar)
    dropped_frac: torch.Tensor      # fraction of assignments over capacity


class Experts(nn.Module):
    """The routed experts' stacked SwiGLU weights: ``gate``/``up``
    (E, d, f), ``down`` (E, f, d)."""

    def __init__(self, gen, d: int, f: int, e: int, dtype, device=None):
        super().__init__()
        tn = lambda shape, std: layers.param(
            layers.truncated_normal(gen, shape, std, dtype, device))
        self.gate = tn((e, d, f), 1.0 / math.sqrt(d))
        self.up = tn((e, d, f), 1.0 / math.sqrt(d))
        self.down = tn((e, f, d), 1.0 / math.sqrt(f))


class MoE(nn.Module):
    """``router`` (d, E) float32, ``experts``, and ``shared`` (an MLP of
    width ``d_ff x num_shared_experts``) when the config has shared
    experts: the reference's ``init_moe`` tree."""

    def __init__(self, gen, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = layers.param(layers.truncated_normal(
            gen, (d, e), 1.0 / math.sqrt(d), torch.float32, device))
        self.experts = Experts(gen, d, f, e, cfg.param_dtype, device)
        if cfg.num_shared_experts:
            self.shared = layers.MLP(gen, d, f * cfg.num_shared_experts,
                                     cfg.param_dtype, device)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(math.ceil(tokens * cfg.num_experts_per_tok / cfg.num_experts
                        * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)  # round up to 8, as the reference


def _dispatch_indices(expert_ids: torch.Tensor, num_experts: int,
                      capacity: int):
    """Sort-based capacity bucketing.

    expert_ids: (A,) int in [0, num_experts] (== num_experts -> masked out).
    Returns (assign, valid, dropped): for each buffer slot (e, c) flattened
    to (E*C,), ``assign`` indexes the (A,) assignment list and ``valid``
    marks live slots; ``dropped`` is the fraction of the assignments to a
    real expert that fell past its capacity (GShard semantics)."""
    a = expert_ids.shape[0]
    dev = expert_ids.device
    order = torch.argsort(expert_ids, stable=True)  # masked ones at the end
    # assignments per expert, by an integer scatter-add (``bincount`` on the
    # card reads the ids' max back to the host: a wait in every layer)
    ids = expert_ids.long()
    counts = torch.zeros(num_experts + 1, dtype=torch.long, device=dev)
    counts = counts.scatter_add_(0, ids, torch.ones_like(ids))[:num_experts]
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    slot_e = torch.arange(num_experts, device=dev).repeat_interleave(capacity)
    slot_c = torch.arange(capacity, device=dev).repeat(num_experts)
    valid = slot_c < counts[slot_e]
    src = torch.where(valid, starts[slot_e] + slot_c, 0)
    assign = order[torch.clamp(src, max=a - 1)]
    kept = torch.sum(torch.clamp(counts, max=capacity)).float()
    dropped = 1.0 - kept / torch.clamp(torch.sum(counts), min=1).float()
    return assign, valid, dropped


def _expert_ffn(experts: Experts, xin: torch.Tensor,
                compute_dtype) -> torch.Tensor:
    """Grouped SwiGLU over the dispatch buffer xin (E, C, d)."""
    dt = compute_dtype
    g = torch.bmm(xin, experts.gate.to(dt))
    u = torch.bmm(xin, experts.up.to(dt))
    return torch.bmm(F.silu(g) * u, experts.down.to(dt))


def _route(params: MoE, cfg: ModelConfig, x2d: torch.Tensor, ids=None,
           shard: ShardCfg = LOCAL):
    """Router: returns (top-k ids (T,k) int32, renormalized gates (T,k)
    float32, aux loss, z loss).  ``ids`` (T, k), when given, replaces the
    top k: the gates are then the router's own probabilities at those
    experts, so the router keeps its gradient (a parity check holds two
    runs to one routing this way; at the top-k ids the outputs are
    bitwise the unforced ones)."""
    logits = x2d.float() @ params.router                       # (T, E) fp32
    probs = torch.softmax(logits, dim=-1)
    if ids is None:
        gates, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    else:
        ids = ids.long()
        gates = torch.gather(probs, -1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load balance: E * sum_e mean(one-hot assignments)_e * mean(probs)_e
    pe = probs.mean(dim=0)                                     # (E,)
    flat = ids.reshape(-1)
    fe = torch.zeros_like(pe).index_add(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            dtype=pe.dtype, device=pe.device))
    if shard.data_parallel():
        # the global batch's fractions: this rank's probabilities carry its
        # share of the gradient (the step averages over the data axes)
        n = shard.dp_size()
        fe = true_divide(all_reduce(fe.detach(), shard.mesh, shard.dp),
                         float(n))
    aux = cfg.num_experts * torch.sum(fe * pe) * cfg.router_aux_coef
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_coef
    return ids.to(torch.int32), gates.float(), aux, z


def _combine(contrib: torch.Tensor, assign, valid, ids):
    """(T, d): each token's kept contributions (rows of ``contrib``, the
    (E*C, d) buffer already weighted by its gates) summed in ascending
    expert order, from zero, in ``contrib``'s dtype."""
    t, k = ids.shape
    d = contrib.shape[1]
    slots = valid.shape[0]
    # the buffer row of each assignment, or the zero row past the buffer for
    # a dropped one: a valid slot writes its row at its assignment (each
    # assignment holds at most one), an invalid one at a discarded entry
    # (no boolean indexing: nothing waits for the device)
    row = torch.full((t * k + 1,), slots, dtype=torch.long, device=ids.device)
    at = torch.where(valid, assign, t * k)
    row.scatter_(0, at, torch.arange(slots, device=ids.device))
    row = row[:t * k]
    padded = torch.cat([contrib, contrib.new_zeros(1, d)])
    per = padded[row].reshape(t, k, d)
    by_expert = torch.argsort(ids, dim=1, stable=True)
    per = torch.take_along_dim(per, by_expert[..., None], dim=1)
    out = contrib.new_zeros(t, d)
    for j in range(k):
        out = out + per[:, j]
    return out


def _local_moe(params: MoE, cfg: ModelConfig, x2d, ids, gates,
               capacity: int, compute_dtype):
    """Dispatch/compute/combine over every expert: x2d (T, d) -> (T, d)."""
    d = x2d.shape[1]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    assign, valid, dropped = _dispatch_indices(ids.reshape(-1), e, capacity)
    tok = assign // k                                          # (E*C,)
    xin = x2d[tok] * valid[:, None].to(x2d.dtype)
    y = _expert_ffn(params.experts, xin.reshape(e, capacity, d),
                    compute_dtype).reshape(e * capacity, d)
    w = gates.reshape(-1)[assign] * valid                      # (E*C,)
    out = _combine(y * w[:, None].to(y.dtype), assign, valid, ids)
    return out, dropped


def _tp_moe(params: MoE, cfg: ModelConfig, x2d, ids, gates,
            shard: ShardCfg):
    """This rank's E/|tp| experts on the (replicated) local tokens; the
    combine is one all-reduce over ``tp``, ``dropped`` the ``tp`` mean."""
    ep = shard.tp_size()
    e_local = params.experts.gate.shape[0]
    assert e_local * ep == cfg.num_experts, (cfg.num_experts, ep)
    k = cfg.num_experts_per_tok
    d = x2d.shape[1]
    cap = _capacity(x2d.shape[0], cfg)
    x2d, gates = tp_copy(x2d, shard), tp_copy(gates, shard)
    lids = ids.long() - shard.tp_rank() * e_local
    lids = torch.where((lids >= 0) & (lids < e_local), lids, e_local)
    assign, valid, dropped = _dispatch_indices(lids.reshape(-1), e_local, cap)
    tok = assign // k
    xin = x2d[tok] * valid[:, None].to(x2d.dtype)
    y = _expert_ffn(params.experts, xin.reshape(e_local, cap, d),
                    cfg.compute_dtype).reshape(e_local * cap, d)
    w = gates.reshape(-1)[assign] * valid
    out = _combine(y * w[:, None].to(y.dtype), assign, valid, lids)
    dropped = true_divide(all_reduce(dropped.detach(), shard.mesh, shard.tp),
                          float(ep))
    return tp_reduce(out, shard), dropped


def _a2a_return(y: torch.Tensor, shard: ShardCfg) -> torch.Tensor:
    """The second all_to_all of :func:`_a2a_moe`: the expert outputs, in
    blocks by their source rank, back to it (a planted fault's hook)."""
    return exchange(y, shard.mesh, shard.tp, 0, 0)


def _a2a_moe(params: MoE, cfg: ModelConfig, x, shard: ShardCfg):
    """x (B, S, d), replicated on ``tp`` -> (out (B·S, d), aux, z,
    dropped): the module's ``a2a`` dispatch."""
    b, s, d = x.shape
    ep = shard.tp_size()
    e_local = params.experts.gate.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if s % ep:
        raise ValueError(f"moe_mode='a2a' splits the sequence over |tp| = "
                         f"{ep} ranks: S = {s} does not divide (a decode "
                         "step's one token cannot split)")
    if e_local * ep != e:
        raise ValueError(f"moe_mode='a2a' needs the {e} experts split over "
                         f"|tp| = {ep} ranks; this rank holds {e_local}")
    mesh, tp = shard.mesh, shard.tp
    sl = s // ep
    x2d = seq_split(x, mesh, tp, 1).reshape(b * sl, d)
    ids, gates, aux, z = _route(params, cfg, x2d)     # this block's own
    cap = _capacity(b * sl, cfg)
    assign, valid, dropped = _dispatch_indices(ids.reshape(-1), e, cap)
    tok = assign // k
    xin = x2d[tok] * valid[:, None].to(x2d.dtype)              # (E·C, d)
    # expert-major: block j holds the experts of rank j
    xin = exchange(xin.reshape(ep, e_local * cap, d), mesh, tp, 0, 0)
    xin = xin.reshape(ep, e_local, cap, d).transpose(0, 1)      # source-major
    y = _expert_ffn(params.experts, xin.reshape(e_local, ep * cap, d),
                    cfg.compute_dtype)
    y = y.reshape(e_local, ep, cap, d).transpose(0, 1)
    y = _a2a_return(y.reshape(ep, e_local * cap, d), shard)
    y = y.reshape(e * cap, d)
    w = gates.reshape(-1)[assign] * valid
    out = _combine(y * w[:, None].to(y.dtype), assign, valid, ids)
    out = gather(out.reshape(b, sl, d), mesh, tp, 1, reduce_back=False)
    # each block's aux, z and dropped: their mean over tp (one all-reduce;
    # the backward's identity gives each rank 1/|tp| of its block's loss)
    met = torch.stack([aux.float(), z.float(), dropped.float()])
    aux, z, dropped = true_divide(tp_reduce(met, shard), float(ep)).unbind()
    return out.reshape(b * s, d), aux, z, dropped.detach()


def moe_apply(params: MoE, cfg: ModelConfig, x: torch.Tensor,
              shard: ShardCfg) -> tuple[torch.Tensor, MoEMetrics]:
    """x: (B, S, d) -> (B, S, d).  Shared experts (if any) are always on.
    The capacity follows the B x S tokens of the call (this rank's under a
    mesh, pads included; under ``a2a`` its block of the sequence)."""
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    x2d = x.reshape(b * s, d)
    if shard.mesh is not None and shard.moe_mode == "a2a":
        out, aux, z, dropped = _a2a_moe(params, cfg, x, shard)
    else:
        ids, gates, aux, z = _route(params, cfg, x2d, shard=shard)
        if (shard.moe_mode == "tp" and shard.tp_size() > 1
                and params.experts.gate.shape[0] < cfg.num_experts):
            out, dropped = _tp_moe(params, cfg, x2d, ids, gates, shard)
        else:
            out, dropped = _local_moe(params, cfg, x2d, ids, gates,
                                      _capacity(b * s, cfg), cdt)
    if hasattr(params, "shared"):
        out = out + layers.mlp(params.shared, x2d.to(cdt), shard,
                               cfg.d_ff * cfg.num_shared_experts)
    return out.reshape(b, s, d).to(x.dtype), MoEMetrics(aux, z, dropped)


def moe_flops_per_token(cfg: ModelConfig) -> int:
    """Forward FLOPs/token of one MoE layer (routed active + shared)."""
    active = cfg.num_experts_per_tok + cfg.num_shared_experts
    return (2 * 3 * cfg.d_model * cfg.d_ff * active
            + 2 * cfg.d_model * cfg.num_experts)
