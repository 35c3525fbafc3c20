"""GPipe pipeline parallelism over a ``pod`` mesh axis.

The port of ``repro.dist.pipeline_parallel``.  The layer stack is cut into
``n_stage`` contiguous stages, one per rank of the axis; the batch is cut
into microbatches that relay through the stages bucket-brigade style
(point-to-point to the next stage — the paper's ghost-zone pattern applied
to the layer axis instead of the grid).  With M microbatches and S stages
the schedule runs M + S - 1 ticks: at tick t stage s works on microbatch
t - s, so every stage is busy but for the S - 1-tick fill and drain, and
only (mb, ...) activations cross a stage boundary.  The last stage's
outputs are broadcast to every stage.

The relay is numerically exact: each microbatch visits the same layers in
the same order as the sequential stack.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import mesh_extents
from repro_torch.models.config import ModelConfig


def stage_params(tree, mesh, axis: str = "pod"):
    """Placements slicing the leading (layer-stacked) axis of every leaf
    (a tensor, or a dict of them) over the pipeline ``axis``: stage s holds
    layers [s·L/S, (s+1)·L/S)."""
    n = mesh_extents(mesh)[axis]

    def spec(leaf):
        shape = tuple(leaf.shape)
        assert shape and shape[0] % n == 0, (
            f"layer dim {shape} must divide over {n} pipeline stages")
        return (axis, *([None] * (len(shape) - 1)))

    if isinstance(tree, dict):
        return {k: spec(v) for k, v in tree.items()}
    return spec(tree)


def gpipe_forward(cfg: ModelConfig, mesh, apply_layer, ws, x,
                  n_microbatch: int = 4, axis: str = "pod"):
    """Microbatched pipeline forward matching the sequential stack.

    ``apply_layer(w_i, h) -> h`` is one layer; ``ws`` is this stage's
    block (:func:`stage_params`) of the layer-stacked parameters (a tensor
    or a dict of them);
    ``x`` is the global (B, ...) activation, the same on every stage.
    Returns the stack's output on every stage."""
    from repro_torch.dist import collectives

    n_stage = mesh_extents(mesh)[axis]
    stage = collectives.coordinate(mesh)[axis]
    _, _, _, ranks = collectives.line(mesh, axis)
    layer = ((lambda i: {k: v[i] for k, v in ws.items()})
             if isinstance(ws, dict) else (lambda i: ws[i]))
    per_stage = (next(iter(ws.values())) if isinstance(ws, dict)
                 else ws).shape[0]
    assert per_stage * n_stage == cfg.num_layers, (per_stage, n_stage,
                                                   cfg.num_layers)
    b = x.shape[0]
    assert b % n_microbatch == 0, (b, n_microbatch)
    xm = x.reshape(n_microbatch, b // n_microbatch, *x.shape[1:])

    def apply_stage(h):
        for i in range(per_stage):
            h = apply_layer(layer(i), h)
        return h

    out = torch.zeros_like(xm)
    for t in range(n_microbatch + n_stage - 1):
        m = t - stage                       # this stage's microbatch
        if not 0 <= m < n_microbatch:
            continue
        h = xm[m] if stage == 0 else collectives.recv(xm[m],
                                                      ranks[stage - 1])
        h = apply_stage(h)
        if stage < n_stage - 1:
            collectives.send(h, ranks[stage + 1])
        else:
            out[m] = h
    out = collectives.broadcast(out, mesh, axis, n_stage - 1)
    return out.reshape(x.shape)
