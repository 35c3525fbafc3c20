"""AdamW with dtype-configurable state.

The port's copy of ``repro.optim.adamw``.  The update math always runs in
float32; the moments are cast on read and write, so ``m_dtype`` /
``v_dtype`` = bfloat16 halves their memory.  The clip scale is
``min(1, clip_norm / max(|g|, 1e-12))`` and the bias corrections use the
incremented step, as in the reference; every division is a true division
on the card too (``device.true_divide``, or a tensor by a tensor).

The state holds the moments by parameter name (``model.named_parameters``).
``update`` writes the new parameters and moments **in place** (the
reference returns new trees): at 1.1 G parameters a second copy of the
parameters and of both moments would cost 11 GB.

The update runs **slice by slice** along a leaf's first axis, at most
:data:`UPDATE_SLICE` elements at a time: its float32 temporaries (the
gradient, both moments, the step, the parameter) then take a few GB at
most instead of several copies of the largest leaf (qwen3-moe's expert
leaves: 3.2 GB a float32 copy, seven at once).  Every operation is
elementwise, so the result is bitwise that of the whole leaf at once.

``decay_filter`` sees the reference's ``/``-joined path of each parameter
(``convert.reference_path``: the layer index of a stacked layer dropped,
kept for the ``ssm`` family's per-layer stack), so it masks exactly the
reference's leaves — including the reference's
quirk that ``"/b"`` does not match ``mamba/conv_b``, which is decayed.

Sharded over a mesh (the ``fsdp_tp`` train step), each rank holds its
blocks of the parameters and of both moments and updates them alone; the
one collective is the global norm of the gradient
(:func:`sharded_global_norm`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.convert import reference_path
from repro_torch.device import true_divide


# elements of a leaf updated at once (1 GiB of float32 a temporary)
UPDATE_SLICE = 1 << 28


def _slices(p: torch.Tensor):
    """Index expressions that cover ``p`` along its first axis, each at
    most UPDATE_SLICE elements (one row at least)."""
    if p.dim() == 0 or p.numel() <= UPDATE_SLICE:
        yield ...
        return
    rows = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
    for i in range(0, p.shape[0], rows):
        yield slice(i, i + rows)


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any                  # {parameter name: tensor}
    v: Any


def default_decay_filter(path: str) -> bool:
    """The reference's mask: paths whose params skip weight decay (norms,
    biases)."""
    return not any(s in path for s in ("norm", "scale", "bias", "/b",
                                       "A_log", "dt_bias"))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    m_dtype: Any = torch.float32
    v_dtype: Any = torch.float32
    clip_norm: float | None = 1.0
    decay_filter: Callable[[str], bool] = default_decay_filter

    def init(self, model) -> AdamWState:
        named = dict(model.named_parameters())
        dev = next(iter(named.values())).device
        zeros = lambda dt: {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                            for n, p in named.items()}
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=zeros(self.m_dtype), v=zeros(self.v_dtype))

    def decays(self, name: str, stacked: bool = True) -> bool:
        """Whether the parameter ``name`` takes weight decay; ``stacked``
        is the model's ``LayerStack.stacked``."""
        return bool(self.weight_decay) and \
            self.decay_filter(reference_path(name, stacked))

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, model, shard=None):
        """One step: ``grads`` by parameter name.  Returns (model, state,
        stats), the model's parameters and the moments updated in place.

        With a sharded ``model`` (``dist.sharding.shard_params``) and its
        ``shard``, each rank updates its blocks; the clip scale is
        :func:`global_norm` over the shards, the same on every rank."""
        step = state.step + 1
        if shard is not None and getattr(model, "placement", None):
            gnorm = sharded_global_norm(grads, model.placement, shard.mesh)
        else:
            gnorm = global_norm(grads.values())
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        if self.clip_norm is not None:
            scale = torch.clamp(true_divide(
                self.clip_norm, torch.clamp(gnorm, min=1e-12)), max=1.0)

        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        lr = self._lr(step)
        stacked = getattr(getattr(model, "stack", None), "stacked", True)

        for name, leaf in model.named_parameters():
            decays = self.decays(name, stacked)
            for at in _slices(leaf):
                p, g = leaf.data[at], grads[name][at]
                m, v = state.m[name][at], state.v[name][at]
                gf = g.float() * scale
                mf = b1 * m.float() + (1 - b1) * gf
                vf = b2 * v.float() + (1 - b2) * gf * gf
                upd = (mf / bc1) / (torch.sqrt(vf / bc2) + self.eps)
                if decays:
                    upd = upd + self.weight_decay * p.float()
                p.copy_((p.float() - lr * upd).to(p.dtype))
                m.copy_(mf.to(self.m_dtype))
                v.copy_(vf.to(self.v_dtype))
        return (model, AdamWState(step=step, m=state.m, v=state.v),
                {"grad_norm": gnorm, "lr": lr, "clip_scale": scale})


    def state_spec_tree(self, param_specs: dict) -> AdamWState:
        """Optimizer-state placements mirror the parameters'."""
        return AdamWState(step=(), m=param_specs, v=param_specs)


def sharded_global_norm(grads: dict, placement: dict, mesh) -> torch.Tensor:
    """The global norm of a gradient held in blocks: each distinct block's
    sum of squares counted exactly once — on the rank at index 0 of every
    mesh axis its leaf is not split over (its copies on the other ranks of
    those axes are left out) — summed over all ranks."""
    from repro_torch.dist import collectives

    coord = collectives.coordinate(mesh)
    names = tuple(coord)
    dev = next(iter(grads.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for name, g in grads.items():
        split = set()
        for axes in placement[name]:
            split.update(collectives.axes_of(axes))
        if all(coord[a] == 0 for a in names if a not in split):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(collectives.all_reduce(total, mesh, names))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))
