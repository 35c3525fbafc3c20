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
state in place.  ``batch`` holds tensors on the model's device.  The
reference's data-parallel step over a mesh (``_make_dp_train_step``) is
ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import torch

from repro_torch.device import true_divide
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig, ShardCfg, not_ported
from repro_torch.optim.adamw import AdamW, AdamWState

METRICS = ("ce", "acc", "moe_aux", "moe_z", "moe_dropped")


def make_loss_fn(cfg: ModelConfig, shard: ShardCfg):
    def lfn(model, batch):
        return model_lib.loss_fn(model, cfg, batch, shard)

    return lfn


def _grads(model, loss) -> dict:
    """d loss / d every parameter, left on ``.grad`` and returned by name.
    A parameter the loss does not reach (musicgen's embedding table when
    ``embeds`` replace the tokens) gets a zero gradient, as ``jax.grad``
    gives it, so that AdamW still decays it."""
    for p in model.parameters():
        p.grad = None
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return {n: p.grad for n, p in model.named_parameters()}


def make_train_step(cfg: ModelConfig, shard: ShardCfg, opt: AdamW,
                    grad_accum: int = 1):
    """The single-device train step: the kernels on the card, their plain
    versions on the CPU."""
    if shard.mesh is not None:
        raise not_ported("the data-parallel train step over a mesh "
                         "(_make_dp_train_step)", 9)
    lfn = make_loss_fn(cfg, shard)

    def train_step(model, opt_state: AdamWState, batch):
        model.requires_grad_(True)
        with torch.enable_grad():
            if grad_accum == 1:
                loss, met = lfn(model, batch)
                grads = _grads(model, loss)
                loss = loss.detach()
                met = {k: v.detach() for k, v in met.items()}
            else:
                loss, met, grads = _accumulate(model, batch)
        model, opt_state, stats = opt.update(grads, opt_state, model)
        return model, opt_state, {"loss": loss, **met, **stats}

    def _accumulate(model, batch):
        def split(x):
            b = x.shape[0]
            assert b % grad_accum == 0, (b, grad_accum)
            return x.reshape(grad_accum, b // grad_accum, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        dev = next(model.parameters()).device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)
        loss, met, acc = zero(), {k: zero() for k in METRICS}, None
        for i in range(grad_accum):
            l, m = lfn(model, {k: v[i] for k, v in micro.items()})
            g = _grads(model, l)
            if acc is None:
                acc = {n: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device) for n, t in g.items()}
            for n, t in g.items():
                acc[n].add_(t.float())
            loss = loss + l.detach()
            met = {k: met[k] + m[k].detach() for k in METRICS}
        inv = 1.0 / grad_accum
        for t in acc.values():
            t.mul_(inv)
        return loss * inv, {k: v * inv for k, v in met.items()}, acc

    return train_step


def make_prefill_step(cfg: ModelConfig, shard: ShardCfg):
    def prefill_step(model, batch, caches):
        return model_lib.prefill(model, cfg, batch, caches, shard)

    return prefill_step


def make_serve_step(cfg: ModelConfig, shard: ShardCfg, *, greedy: bool = True,
                    temperature: float = 1.0):
    """One decode step: token -> (next_token, logits, caches).  Sampling
    draws from ``rng`` (a ``torch.Generator``), not the reference's bits."""

    def serve_step(model, token, caches, cache_len, rng=None):
        logits, caches = model_lib.decode_step(model, cfg, token, caches,
                                               cache_len, shard)
        lg = logits[:, -1].float()
        if greedy or rng is None:
            nxt = lg.argmax(dim=-1)
        else:
            probs = torch.softmax(true_divide(lg, temperature), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
        return nxt.to(torch.int32)[:, None], logits, caches

    return serve_step
