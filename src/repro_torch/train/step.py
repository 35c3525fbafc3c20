"""Train / prefill / serve step factories.

The port's copy of ``repro.train.step``.  ``make_train_step`` supports
gradient accumulation (microbatching): the global batch is split into
``grad_accum`` microbatches run one after another, their gradients summed
in float32 and scaled by ``1 / grad_accum``, as in the reference.

    step = make_train_step(cfg, LOCAL, AdamW(...), grad_accum=2)
    model, opt_state, metrics = step(model, opt_state, batch)

The step turns gradients on for the model's parameters (they are created
frozen for serving), takes them with ``backward`` (so each parameter's
``.grad`` holds the last microbatch's gradient afterwards,
``convert.grads_to_numpy``), and updates the parameters and the optimizer
state in place.  ``batch`` holds tensors on the model's device.

Over a mesh of ranks (one process a rank, ``launch.mesh``) the step takes
the reference's two postures:

* ``fsdp_tp`` (:func:`_make_sharded_train_step`; ``moe_mode`` ``tp`` or
  ``a2a`` and ``ssm_sp`` as the ``ShardCfg`` says): each rank holds its
  blocks of the parameters and of both moments
  (``dist.sharding.shard_params``) and its rows of the global batch
  (``dist.sharding.local_batch``; the ``tp`` ranks of one data index take
  the same rows).  The forward uses each parameter gathered for its use
  (``dist.sharding.gather_params``; a layer's leaves when the layer runs,
  ``dist.sharding.gathered``) with the tensor-parallel layers split over
  ``model``; the data-axis gradients are summed (by the
  gathers' reduce-scatter, or one all-reduce for leaves the data axes do
  not split) and divided by |dp| (:func:`data_mean`), so that a step is
  the single-process step on the global batch;
* ``dp`` (:func:`_make_dp_train_step`): parameters replicated, per-rank
  local autodiff under ``LOCAL``, one mean of the gradient over every
  axis, a replicated update; with ``compress_pod_grads`` the mean inside
  a pod is exact and the one across pods int8 with error feedback
  (``dist.compression``), its residual carried as explicit state.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import true_divide
from repro_torch.dist import collectives, sharding
from repro_torch.models import model as model_lib
from repro_torch.models.config import LOCAL, ModelConfig, ShardCfg
from repro_torch.optim.adamw import AdamW, AdamWState

METRICS = ("ce", "acc", "moe_aux", "moe_z", "moe_dropped")


def make_loss_fn(cfg: ModelConfig, shard: ShardCfg):
    def lfn(model, batch):
        return model_lib.loss_fn(model, cfg, batch, shard)

    return lfn


def _grads(params: dict, loss) -> dict:
    """d loss / d every parameter of ``params`` (by name), left on
    ``.grad`` and returned by name.  A parameter the loss does not reach
    (musicgen's embedding table when ``embeds`` replace the tokens) gets a
    zero gradient, as ``jax.grad`` gives it, so that AdamW still decays
    it."""
    for p in params.values():
        p.grad = None
    loss.backward()
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return {n: p.grad for n, p in params.items()}


def _loss_and_grads(lfn, model, batch, grad_accum: int,
                    around=contextlib.nullcontext):
    """(loss, metrics, grads by name) of a batch: one backward, or the
    mean over ``grad_accum`` microbatches (gradients summed in float32,
    metrics averaged).  Each microbatch's forward and backward run inside
    ``around()``."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def one(mb):
        with around():
            l, m = lfn(model, mb)
            return l.detach(), {k: v.detach() for k, v in m.items()}, \
                _grads(params, l)

    with torch.enable_grad():
        if grad_accum == 1:
            return one(batch)

        def split(x):
            b = x.shape[0]
            assert b % grad_accum == 0, (b, grad_accum)
            return x.reshape(grad_accum, b // grad_accum, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        dev = next(model.parameters()).device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        loss, met, acc = zero(), {k: zero() for k in METRICS}, None
        for i in range(grad_accum):
            l, m, g = one({k: v[i] for k, v in micro.items()})
            if acc is None:
                acc = {n: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device) for n, t in g.items()}
            for n, t in g.items():
                acc[n].add_(t.float())
            loss = loss + l
            met = {k: met[k] + m[k] for k in METRICS}
    inv = 1.0 / grad_accum
    for t in acc.values():
        t.mul_(inv)
    return loss * inv, {k: v * inv for k, v in met.items()}, acc


def make_train_step(cfg: ModelConfig, shard: ShardCfg, opt: AdamW,
                    grad_accum: int = 1):
    """The train step: single-device (``shard.mesh`` None; the kernels on
    the card, their plain versions on the CPU), ``dp`` over a mesh when
    ``shard.replicate_params``, else ``fsdp_tp``."""
    if shard.mesh is not None and shard.replicate_params:
        return _make_dp_train_step(cfg, shard, opt, grad_accum)
    if shard.mesh is not None:
        return _make_sharded_train_step(cfg, shard, opt, grad_accum)
    lfn = make_loss_fn(cfg, shard)

    def train_step(model, opt_state: AdamWState, batch):
        loss, met, grads = _loss_and_grads(lfn, model, batch, grad_accum)
        model, opt_state, stats = opt.update(grads, opt_state, model)
        return model, opt_state, {"loss": loss, **met, **stats}

    return train_step


# ---------------------------------------------------------------------------
# fsdp_tp over a mesh of ranks
# ---------------------------------------------------------------------------
def _mean_over(tree: dict, mesh, axes) -> dict:
    """Each 0-d tensor of ``tree`` averaged over the ranks of ``axes``
    (one all-reduce)."""
    keys = list(tree)
    packed = torch.stack([tree[k].float() for k in keys])
    n = collectives.size(mesh, axes)
    mean = true_divide(collectives.all_reduce(packed, mesh, axes), float(n))
    return dict(zip(keys, mean.unbind()))


def _sum_over(grads: dict, names: list, mesh, axes) -> None:
    """The gradients ``names`` summed over the ranks of ``axes`` in place
    (one all-reduce of their float32 concatenation)."""
    if not names:
        return
    flat = torch.cat([grads[n].float().reshape(-1) for n in names])
    flat = collectives.all_reduce(flat, mesh, axes)
    at = 0
    for n in names:
        g = grads[n]
        g.copy_(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()


def data_mean(grads: dict, shard: ShardCfg) -> None:
    """Divide every gradient by |dp|, in place: the data ranks' gradients
    were summed, and each is the gradient of its rows' mean loss."""
    n = float(shard.dp_size())
    for g in grads.values():
        g.copy_(true_divide(g, n))


def _make_sharded_train_step(cfg: ModelConfig, shard: ShardCfg, opt: AdamW,
                             grad_accum: int = 1):
    """FSDP×TP over ``shard.mesh``: ``model`` holds this rank's blocks
    (``dist.sharding.shard_params``), ``opt_state`` its blocks of the
    moments (``opt.init(model)``), ``batch`` its rows of the global batch
    (``dist.sharding.local_batch``).  Returns the loss and metrics averaged
    over the data axes, the same on every rank."""
    dp = shard.dp_axes
    lfn = make_loss_fn(cfg, shard)

    def train_step(model, opt_state: AdamWState, batch):
        loss, met, grads = _loss_and_grads(
            lfn, model, batch, grad_accum,
            lambda: sharding.gathered(model, shard))
        whole = [n for n, pl in model.placement.items()
                 if not any(collectives.axes_of(a) == dp for a in pl)]
        with torch.no_grad():
            _sum_over(grads, whole, shard.mesh, dp)
            data_mean(grads, shard)
            met = _mean_over({"loss": loss, **met}, shard.mesh, dp)
        loss = met.pop("loss")
        model, opt_state, stats = opt.update(grads, opt_state, model, shard)
        return model, opt_state, {"loss": loss, **met, **stats}

    return train_step


# ---------------------------------------------------------------------------
# dp over a mesh of ranks
# ---------------------------------------------------------------------------
def _make_dp_train_step(cfg: ModelConfig, shard: ShardCfg, opt: AdamW,
                        grad_accum: int = 1, compress_pod_grads: bool = False):
    """Pure data parallelism: per-rank local autodiff (no collective inside
    the model), one mean of the gradient over every axis, the replicated
    update.  ``batch`` is this rank's rows.

    ``compress_pod_grads``: the mean inside a pod at full precision, then
    the int8 error-feedback mean over ``pod``; the step then takes and
    returns (as ``out["ef_err"]``) this rank's residual, {name: float32
    tensor}, zeros when ``ef_err`` is None."""
    from repro_torch.dist.compression import ef_allreduce_mean

    lfn = make_loss_fn(cfg, LOCAL)
    mesh = shard.mesh
    axes = shard.dp_axes
    intra = tuple(a for a in axes if a != "pod")
    compress = compress_pod_grads and "pod" in axes

    def train_step(model, opt_state: AdamWState, batch, ef_err=None):
        loss, met, grads = _loss_and_grads(lfn, model, batch, grad_accum)
        names = list(grads)
        new_ef = None
        with torch.no_grad():
            if compress:
                if intra:       # full precision inside the pod
                    _sum_over(grads, names, mesh, intra)
                    n = float(collectives.size(mesh, intra))
                    for g in grads.values():
                        g.copy_(true_divide(g, n))
                if ef_err is None:
                    ef_err = {k: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device)
                              for k, g in grads.items()}
                new_ef = {}
                for k in names:
                    gm, new_ef[k] = ef_allreduce_mean(grads[k], ef_err[k],
                                                      mesh, "pod")
                    grads[k] = gm
            else:
                _sum_over(grads, names, mesh, axes)     # THE one collective
                n = float(collectives.size(mesh, axes))
                for g in grads.values():
                    g.copy_(true_divide(g, n))
            met = _mean_over({"loss": loss, **met}, mesh, axes)
        loss = met.pop("loss")
        model, opt_state, stats = opt.update(grads, opt_state, model)
        out = {"loss": loss, **met, **stats}
        if compress:
            out["ef_err"] = new_ef
        return model, opt_state, out

    return train_step


def make_prefill_step(cfg: ModelConfig, shard: ShardCfg, kv_block=None):
    """The prefill; over a mesh ``kv_block`` is the KV caches' block
    (``dist.sharding.local_caches``)."""
    def prefill_step(model, batch, caches):
        return model_lib.prefill(model, cfg, batch, caches, shard,
                                 kv_block=kv_block)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shard: ShardCfg, *, greedy: bool = True,
                    temperature: float = 1.0, kv_block=None):
    """One decode step: token -> (next_token, logits, caches).  Sampling
    draws from ``rng`` (a ``torch.Generator``), not the reference's bits.
    ``kv_block`` as in :func:`make_prefill_step`."""

    def serve_step(model, token, caches, cache_len, rng=None):
        logits, caches = model_lib.decode_step(model, cfg, token, caches,
                                               cache_len, shard,
                                               kv_block=kv_block)
        lg = logits[:, -1].float()
        if greedy or rng is None:
            nxt = lg.argmax(dim=-1)
        else:
            probs = torch.softmax(true_divide(lg, temperature), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
        return nxt.to(torch.int32)[:, None], logits, caches

    return serve_step
