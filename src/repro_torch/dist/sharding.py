"""Placement rules: the LM's parameter, cache and batch placements, the
mesh postures, and the grid and slot rules of the decomposed CFD path.

The port of ``repro.dist.sharding``.  A placement is a tuple with one entry
per tensor axis: the name of the mesh axis (or a tuple of names) that axis
is split over, or None where every rank holds the whole extent — the
reference's ``PartitionSpec``, entry by entry (``()`` is its canonical
replicated ``P()``).  The rules and their error texts are the reference's:

* :func:`make_shard_cfg` turns (mesh, config, batch) into a ``ShardCfg``:
  ``fsdp_tp`` (parameters FSDP-sharded over the data axes, tensor-parallel
  over ``model``) or ``dp`` (parameters replicated, one gradient mean);
* :func:`param_spec_tree` keys a placement by each parameter's name,
  computed on the reference's leaf (a stacked layer's leaf has the leading
  layer axis), so that it equals the reference's spec of the same path;
  :func:`param_placements` drops that layer entry for the port's per-layer
  tensors (a layer axis the reference splits — never at the registry's
  published widths — is held whole here);
* every rule is divisibility-guarded: a dim that does not divide stays
  replicated;
* a slot axis that does not divide over its mesh axis is *replicated*; a
  grid axis that does not divide *raises* (the halo exchange would shift a
  replicated axis as if it held true blocks).

A rank holds the block of every tensor its placement names
(:func:`block`, :func:`shard_params`); :func:`full_tensor` gathers the
whole tensor back, and :func:`gather_params` gives the sharded train step
each parameter in the form its use takes: gathered over the data axes, and
over ``model`` too unless the layer is tensor-parallel (attention heads,
the MLP's hidden width, the experts under ``moe_mode`` ``tp`` or ``a2a``,
the vocabulary).  A leaf a rank uses on its block of the sequence (a
Mamba2 block's under ``ssm_sp``, the router's under ``a2a``:
:func:`seq_use`) has a gradient that is a part, summed over ``model``.
A mesh here is a ``DeviceMesh`` or any object with the reference mesh's
``axis_names`` and ``shape`` mapping
(:func:`repro_torch.launch.mesh.mesh_extents`).

Serving over a mesh: :func:`local_caches` gives a rank its block of every
decode cache as ``cache_spec_tree`` places it, and the ``KVBlock`` (the
positions its block of the KV caches' sequence holds);
:func:`serving_params` puts a model's parameters in the form their use
takes once, so that a decode step gathers no parameter; :func:`gathered`
is the context the sharded forward reads its parameters in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch.convert import reference_path
from repro_torch.launch.mesh import mesh_extents
from repro_torch.models.config import KVBlock, ModelConfig, ShardCfg


def _axes_prod(mesh, axes) -> int:
    if axes is None:
        return 1
    ext = mesh_extents(mesh)
    if isinstance(axes, str):
        return ext[axes]
    return math.prod(ext[a] for a in axes)


def _guard(mesh, axis, dim: int):
    """``axis`` iff ``dim`` divides evenly over it (else replicated)."""
    if axis is None:
        return None
    if dim % _axes_prod(mesh, axis) != 0:
        return None
    return axis


def slot_spec(mesh, n_slots: int, axis: str = "data") -> tuple:
    """Placement of a leading ensemble *slot* axis over a data-parallel
    mesh axis (each rank of the axis advances ``n_slots / |axis|``
    resident simulations); a slot count that does not divide stays
    replicated."""
    names = tuple(mesh_extents(mesh))
    if axis not in names:
        raise ValueError(f"mesh {names} has no axis {axis!r}")
    return (_guard(mesh, axis, n_slots),)


def validate_decomposition(decomposition, n_axes: int, mesh_axis_names,
                           slot_axis: str | None = None) -> tuple:
    """Normalize + validate a grid decomposition: returns the
    ``((array_axis, mesh_axis), ...)`` pairs, raising on a duplicate array
    axis, an out-of-range array axis, an unknown mesh axis, or a grid axis
    decomposing over the slot axis."""
    pairs = tuple(decomposition.items() if isinstance(decomposition, dict)
                  else decomposition)
    if len({a for a, _ in pairs}) != len(pairs):
        raise ValueError(
            f"decomposition {pairs!r} maps some array axis more than "
            "once; each grid axis decomposes over at most one mesh axis")
    for a, name in pairs:
        if not 0 <= int(a) < n_axes:
            raise ValueError(
                f"decomposition names array axis {a}, but fields have "
                f"only {n_axes} grid axes")
        if name not in mesh_axis_names:
            raise ValueError(
                f"mesh {tuple(mesh_axis_names)} has no axis {name!r} "
                f"(decomposition of array axis {a})")
        if slot_axis is not None and name == slot_axis:
            raise ValueError(
                f"axis {name!r} is the slot axis; a grid axis cannot "
                "decompose over it")
    return pairs


def slot_field_spec(mesh, n_slots: int, shape: tuple, decomposition=(),
                    slot_axis: str = "slot") -> tuple:
    """Placement of a slot-stacked grid field ``(n_slots, *shape)`` on a
    slots × shards mesh: ``(slot_axis or None, <grid axes>)``, the slot
    axis guarded, the grid axes raising when they do not divide."""
    ext = mesh_extents(mesh)
    names = tuple(ext)
    if slot_axis not in names:
        raise ValueError(f"mesh {names} has no slot axis {slot_axis!r}")
    pairs = validate_decomposition(decomposition, len(shape), names,
                                   slot_axis=slot_axis)
    grid: list = [None] * len(shape)
    for a, name in pairs:
        a = int(a)
        if shape[a] % ext[name]:
            raise ValueError(
                f"grid extent {shape[a]} on array axis {a} is not "
                f"divisible by mesh axis {name!r} (size "
                f"{ext[name]}) — refusing to mis-shard")
        grid[a] = name
    return (_guard(mesh, slot_axis, n_slots), *grid)


# ---------------------------------------------------------------------------
# the LM: paths and postures
# ---------------------------------------------------------------------------
def make_shard_cfg(mesh, cfg: ModelConfig, global_batch: int, *,
                   mode: str = "fsdp_tp", moe_mode: str | None = None,
                   ssm_sp: bool = False) -> ShardCfg:
    """Distribution posture for ``cfg`` on ``mesh``.

    mode:
      fsdp_tp (default) — batch/FSDP over the ("pod", "data") axes, tensor
                          parallelism over "model" ("auto" is an alias)
      dp                — pure data parallelism over every mesh axis:
                          parameters replicated, the batch sharded over
                          all axes, one gradient mean a step
                          (``train.step._make_dp_train_step``)
    """
    names = tuple(mesh_extents(mesh))
    if mode in ("fsdp_tp", "auto"):
        dp_axes = tuple(a for a in ("pod", "data") if a in names)
        dp: Any = dp_axes[0] if len(dp_axes) == 1 else dp_axes
        tp = "model" if "model" in names else None
        replicate = False
    elif mode == "dp":
        dp = names if len(names) > 1 else names[0]
        tp = None
        replicate = True
    else:
        raise ValueError(f"unknown shard mode {mode!r}")
    if moe_mode is None:
        moe_mode = "tp" if (cfg.num_experts and tp is not None) else "local"
    batch_sharded = global_batch % _axes_prod(mesh, dp) == 0
    return ShardCfg(mesh=mesh, dp=dp, tp=tp, moe_mode=moe_mode,
                    ssm_sp=ssm_sp, batch_sharded=batch_sharded,
                    replicate_params=replicate)


# ---------------------------------------------------------------------------
# parameter placements
# ---------------------------------------------------------------------------
def _named_shapes(params, cfg: ModelConfig) -> tuple[dict, bool]:
    """({name: shape}, stacked) of an ``LM`` (any device, ``meta`` too) or
    a mapping of names to tensors."""
    if isinstance(params, Mapping):
        named = {n: tuple(t.shape) for n, t in params.items()}
        return named, cfg.family != "ssm"
    named = {n: tuple(p.shape) for n, p in params.named_parameters()}
    return named, getattr(getattr(params, "stack", None), "stacked", True)


def _is_layer(name: str, stacked: bool) -> bool:
    return stacked and name.split(".")[:2] == ["stack", "layers"]


def _rule(parts: tuple, shape: tuple, F, T):
    """Right-aligned entries for the trailing dims, or None for 'no rule'
    (the fallback)."""
    name = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if len(shape) <= 1:
        return tuple(None for _ in shape)
    if parent == "attn" and name in ("wq", "wk", "wv") and len(shape) >= 3:
        d, h, hd = shape[-3:]
        return (F(d), T(h), None)
    if parent == "attn" and name == "wo" and len(shape) >= 3:
        h, hd, d = shape[-3:]
        return (T(h), None, F(d))
    if parent == "attn" and name in ("bq", "bk", "bv") and len(shape) >= 2:
        h, hd = shape[-2:]
        return (T(h), None)
    if parent == "embed" and name == "table":
        v, d = shape[-2:]
        return (T(v), F(d))
    if parent == "unembed" and name == "w":
        d, v = shape[-2:]
        return (F(d), T(v))
    if parent == "experts" and len(shape) >= 3:
        e = shape[-3]
        if name == "down":                      # (E, f, d)
            return (T(e), None, F(shape[-1]))
        return (T(e), F(shape[-2]), None)       # gate/up (E, d, f)
    if name == "router":
        return tuple(None for _ in shape[-2:])
    if name == "w" and len(shape) >= 2:
        d_in, d_out = shape[-2:]
        if parent in ("down", "mlp_down", "out_proj"):
            return (T(d_in), F(d_out))          # contraction dim is TP
        return (F(d_in), T(d_out))              # gate/up/in_proj/...
    return None


def param_spec_tree(params, cfg: ModelConfig, mesh, shard: ShardCfg) -> dict:
    """{parameter name: the reference's spec of its leaf}.

    Rules match on the leaf's path, are right-aligned against its trailing
    dims and pad leading (layer-stack) axes with None; a leaf no rule
    names is FSDP-sharded on its largest divisible dim, else replicated.
    A stacked layer's spec is that of the reference's (L, ...) leaf."""
    fsdp = None if shard.replicate_params else shard.dp
    tp = None if shard.replicate_params else shard.tp
    F = lambda d: _guard(mesh, fsdp, d)
    T = lambda d: _guard(mesh, tp, d)
    named, stacked = _named_shapes(params, cfg)
    specs = {}
    for name, shape in named.items():
        if _is_layer(name, stacked):
            shape = (cfg.num_layers, *shape)
        parts = tuple(reference_path(name, stacked).split("/"))
        nd = len(shape)
        entries = _rule(parts, shape, F, T)
        if entries is None:
            entries = [None] * nd
            if nd and fsdp is not None:
                for i in sorted(range(nd), key=lambda i: -shape[i]):
                    if shape[i] and _guard(mesh, fsdp, shape[i]) is not None \
                            and shape[i] >= _axes_prod(mesh, fsdp):
                        entries[i] = fsdp
                        break
            entries = tuple(entries)
        else:
            entries = (None,) * (nd - len(entries)) + tuple(entries)
        specs[name] = () if all(e is None for e in entries) else entries
    return specs


def param_placements(params, cfg: ModelConfig, mesh, shard: ShardCfg) -> dict:
    """{parameter name: placement of the port's tensor}: the spec padded to
    the leaf's rank, a stacked layer's leading (layer) entry dropped."""
    named, stacked = _named_shapes(params, cfg)
    out = {}
    for name, spec in param_spec_tree(params, cfg, mesh, shard).items():
        nd = len(named[name]) + (1 if _is_layer(name, stacked) else 0)
        full = tuple(spec) + (None,) * (nd - len(spec))
        out[name] = full[1:] if _is_layer(name, stacked) else full
    return out


# ---------------------------------------------------------------------------
# cache and batch placements
# ---------------------------------------------------------------------------
def _map_tensors(fn, tree):
    """``fn`` on every tensor of dicts, tuples and ``NamedTuple``s."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree)


def cache_spec_tree(caches, cfg: ModelConfig, mesh, shard: ShardCfg):
    """Decode-cache placements (the reference's rule; a rank's blocks are
    :func:`local_caches`).  Batch over the data axes; attention KV caches
    also shard the sequence over ``tp``; recurrent states batch-sharded
    only."""
    dp = shard.dp if shard.batch_sharded else None
    tp = shard.tp
    batch_axis = 0 if cfg.family == "ssm" else 1

    def spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        entries = [None] * nd
        if nd > batch_axis:
            entries[batch_axis] = _guard(mesh, dp, shape[batch_axis])
        is_kv = (nd == 5 and shape[3] == cfg.num_kv_heads
                 and shape[4] == cfg.head_dim)
        if is_kv and tp is not None:
            entries[2] = _guard(mesh, tp, shape[2])
        return tuple(entries)

    return _map_tensors(spec, caches)


def batch_spec_tree(batch: dict, mesh, shard: ShardCfg) -> dict:
    """Input-batch placements: the leading (batch) dim over the data
    axes."""
    dp = shard.dp if shard.batch_sharded else None

    def spec(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        return (_guard(mesh, dp, leaf.shape[0]), *([None] * (nd - 1)))

    return {k: spec(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# blocks: this rank's part of a full tensor, and the full tensor back
# ---------------------------------------------------------------------------
def _coordinate(mesh) -> dict:
    from repro_torch.dist.collectives import coordinate

    return coordinate(mesh)


def _split(mesh, axes, coord: dict) -> tuple[int, int]:
    """(parts, this rank's index) of a dim split over ``axes`` (row-major
    in the order named)."""
    from repro_torch.dist.collectives import axes_of

    ext = mesh_extents(mesh)
    n, i = 1, 0
    for a in axes_of(axes):
        n *= ext[a]
        i = i * ext[a] + coord[a]
    return n, i


def block(full: torch.Tensor, placement: tuple, mesh,
          coord: dict | None = None) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coord`` (default: this
    rank) holds under ``placement`` (a view)."""
    coord = _coordinate(mesh) if coord is None else coord
    out = full
    for dim, axes in enumerate(placement):
        if axes is None:
            continue
        n, i = _split(mesh, axes, coord)
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        b = full.shape[dim] // n
        out = out.narrow(dim, i * b, b)
    return out


def full_tensor(local: torch.Tensor, placement: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (all ranks call it)."""
    from repro_torch.dist.collectives import all_gather

    out = local
    for dim, axes in enumerate(placement):
        if axes is not None:
            out = all_gather(out, mesh, axes, dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """A placement on a mesh (the reference's ``NamedSharding``); a leaf,
    not a container, in the trees ``named`` builds."""

    mesh: Any
    spec: tuple

    def _padded(self, t: torch.Tensor) -> tuple:
        return tuple(self.spec) + (None,) * (t.dim() - len(self.spec))

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor."""
        return block(full, self._padded(full), self.mesh)

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (all ranks call it)."""
        return full_tensor(local, self._padded(local), self.mesh)


def named(specs, mesh):
    """Placement tree -> ``NamedPlacement`` tree."""
    if isinstance(specs, dict):
        return {k: named(v, mesh) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(named(v, mesh) for v in specs))
    return NamedPlacement(mesh, tuple(specs))


def local_batch(batch: dict, mesh, shard: ShardCfg,
                grad_accum: int = 1) -> dict:
    """This rank's rows of a global batch (the ``tp`` ranks of one data
    index take the same rows).  With ``grad_accum`` microbatches, its
    block of each global microbatch, in order: the step's split of these
    rows into ``grad_accum`` microbatches then holds this rank's part of
    the global microbatch i as its i-th, as the reference's step on the
    global batch splits it."""
    specs = batch_spec_tree(batch, mesh, shard)
    out = {}
    for k, v in batch.items():
        micro = v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
        part = block(micro, (None, *specs[k]), mesh)
        out[k] = part.reshape(-1, *v.shape[1:]).contiguous()
    return out


# ---------------------------------------------------------------------------
# the sharded LM's parameters
# ---------------------------------------------------------------------------
def shard_params(lm, cfg: ModelConfig, shard: ShardCfg):
    """Replace every parameter of ``lm`` (the whole model) by this rank's
    block of it, in place; the placements stay on ``lm.placement``.
    Returns ``lm``."""
    from repro_torch.models.layers import param

    placements = param_placements(lm, cfg, shard.mesh, shard)
    for name, pl in placements.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name)
        full = mod._parameters[leaf]
        mod._parameters[leaf] = param(
            block(full.data, pl, shard.mesh).clone())
        del full
    lm.placement = placements
    return lm


def tp_compute(name: str, shard: ShardCfg, stacked: bool = True) -> bool:
    """Whether the layer that uses parameter ``name`` is tensor-parallel
    (its ``model`` axis is kept for the use): attention projections, the
    SwiGLU MLP's (dense and shared-expert) weights, the experts under
    ``moe_mode`` ``tp`` or ``a2a`` (each rank computes its E/|tp|), the
    embedding table and the unembedding."""
    parts = tuple(reference_path(name, stacked).split("/"))
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if parent == "attn":
        return leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
    if parent == "experts":
        return shard.moe_mode in ("tp", "a2a")
    if (parent, leaf) in (("embed", "table"), ("unembed", "w")):
        return True
    if leaf == "w" and parent in ("gate", "up", "down") and len(parts) >= 3:
        return parts[-3] == "ffn" or (parts[-3] == "shared"
                                      and len(parts) >= 4
                                      and parts[-4] == "ffn")
    return False


def seq_use(name: str, shard: ShardCfg, stacked: bool = True) -> bool:
    """Whether each ``tp`` rank uses parameter ``name`` on its own block of
    the sequence, so that its gradient there is a part, to be summed over
    ``tp``: every leaf of a Mamba2 block under ``ssm_sp``, the router under
    ``moe_mode="a2a"``."""
    if shard.mesh is None or shard.tp is None or shard.replicate_params:
        return False
    parts = tuple(reference_path(name, stacked).split("/"))
    if shard.moe_mode == "a2a" and parts[-1] == "router":
        return True
    return shard.ssm_sp and "mamba" in parts[:-1]


def gather_params(lm, shard: ShardCfg, within: str = "",
                  skip: str | None = None) -> dict:
    """{name: the tensor each parameter's use takes}, for the parameters
    whose names start with ``within`` and not with ``skip``: gathered over
    the data axes (the backward reduce-scatters the gradient, a sum), then
    over ``model`` unless its layer is tensor-parallel (every ``tp`` rank
    then uses the same whole leaf; the backward keeps this rank's block).
    Each of the two gathers is one collective a dtype
    (``collectives.gather_many``).  A leaf of :func:`seq_use` has its
    gradient summed over ``model`` instead: by its gather's reduce-scatter,
    or, where ``model`` splits none of its dims, by one all-reduce of all
    such leaves (``collectives.sum_back``)."""
    from repro_torch.dist.collectives import axes_of, gather_many, sum_back

    stacked = getattr(lm.stack, "stacked", True)
    dp, tp = shard.dp_axes, axes_of(shard.tp)
    out = {n: p for n, p in lm.named_parameters()
           if n.startswith(within) and not (skip and n.startswith(skip))}
    parts = {n for n in out if seq_use(n, shard, stacked)}
    for over_dp in (True, False):
        groups: dict = {}
        for name in out:
            keep_tp = tp_compute(name, shard, stacked)
            for dim, axes in enumerate(lm.placement[name]):
                if axes is None or (axes_of(axes) == dp) != over_dp:
                    continue
                if over_dp or not keep_tp:
                    back = over_dp or name in parts
                    key = (axes_of(axes), out[name].dtype, back)
                    groups.setdefault(key, []).append((name, dim))
        for (axes, _, back), members in groups.items():
            got = gather_many([out[n] for n, _ in members], shard.mesh, axes,
                              [d for _, d in members], reduce_back=back)
            out.update(zip((n for n, _ in members), got))
    whole = sorted(n for n in parts if not any(
        a is not None and axes_of(a) == tp for a in lm.placement[n]))
    if whole:
        out.update(zip(whole, sum_back([out[n] for n in whole], shard.mesh,
                                       tp)))
    return out


@contextlib.contextmanager
def using(model, use: dict):
    """Inside the context each parameter of ``model`` reads as its tensor
    in ``use`` (the backward's recomputation of a rematerialised block
    reads them too); the parameters are put back after."""
    saved = {}
    for name, t in use.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved[name] = (mod, leaf, mod._parameters[leaf])
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in saved.values():
            mod._parameters[leaf] = p


@contextlib.contextmanager
def gathered(model, shard: ShardCfg):
    """Inside the context ``model`` (this rank's blocks, its placements on
    ``model.placement``) reads each parameter as its use takes it
    (:func:`gather_params`): the leaves outside the layer stack gathered
    once, a layer's when it runs (``LayerStack.layer_use``), so that under
    ``remat="block"`` a layer's gathered leaves live only while it runs
    and while its recomputation in the backward does."""
    if getattr(model, "placement", None) is None:
        raise ValueError("over a mesh the model holds this rank's blocks: "
                         "dist.sharding.shard_params or serving_params")
    stack = model.stack

    def layer(i):
        return using(model, gather_params(model, shard,
                                          within=f"stack.layers.{i}."))

    with using(model, gather_params(model, shard, skip="stack.layers.")):
        stack.layer_use = layer
        try:
            yield
        finally:
            stack.layer_use = None


# ---------------------------------------------------------------------------
# serving over a mesh
# ---------------------------------------------------------------------------
def use_placements(lm, cfg: ModelConfig, shard: ShardCfg) -> dict:
    """{parameter name: the placement of the tensor its use takes}: the
    ``tp`` entries of the tensor-parallel layers' leaves
    (:func:`tp_compute`), nothing else split."""
    from repro_torch.dist.collectives import axes_of

    stacked = getattr(lm.stack, "stacked", True)
    tp = axes_of(shard.tp)
    return {n: tuple(a if tp and axes_of(a) == tp and tp_compute(
                n, shard, stacked) else None for a in pl)
            for n, pl in param_placements(lm, cfg, shard.mesh,
                                          shard).items()}


def serving_params(lm, cfg: ModelConfig, shard: ShardCfg):
    """``lm``'s parameters replaced in place by the tensors their use
    takes, once (:func:`use_placements`): taken from the whole model where
    ``lm`` is whole, gathered (collectives on every rank) where it holds
    this rank's blocks (:func:`shard_params`).  The model then serves with
    no parameter gathered at a step.  Returns ``lm``."""
    from repro_torch.models.layers import param

    use = use_placements(lm, cfg, shard)
    if getattr(lm, "placement", None) is None:
        tensors = {n: block(p.data, use[n], shard.mesh).clone()
                   for n, p in lm.named_parameters()}
    else:
        with torch.no_grad():
            tensors = gather_params(lm, shard)
    for name, t in tensors.items():
        mod_name, _, leaf = name.rpartition(".")
        lm.get_submodule(mod_name)._parameters[leaf] = param(t.detach())
    lm.placement = use
    return lm


def kv_block(cfg: ModelConfig, max_seq: int, shard: ShardCfg,
             coord: dict | None = None):
    """The ``KVBlock`` of this rank's (or ``coord``'s) attention caches at
    ``max_seq`` positions: None without a ``tp`` axis of more than one
    rank (the cache's sequence is then whole, as on one process), or
    without attention caches (the ``ssm`` family)."""
    if shard.mesh is None or shard.tp is None or shard.replicate_params \
            or mesh_extents(shard.mesh)[shard.tp] == 1 or cfg.family == "ssm":
        return None
    if _guard(shard.mesh, shard.tp, max_seq) is None:
        return KVBlock(start=0, split=False)
    coord = _coordinate(shard.mesh) if coord is None else coord
    n, i = _split(shard.mesh, shard.tp, coord)
    return KVBlock(start=i * (max_seq // n), split=True)


def local_rows(batch: int, shard: ShardCfg, coord: dict | None = None):
    """The slice of a global batch's rows this rank (or ``coord``) holds:
    its block over ``dp`` where the batch is split there, else all."""
    coord = _coordinate(shard.mesh) if coord is None else coord
    dp = shard.dp if shard.batch_sharded else None
    n, i = _split(shard.mesh, _guard(shard.mesh, dp, batch), coord)
    return slice(i * (batch // n), (i + 1) * (batch // n))


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, tuples and ``NamedTuple``s, in the
    reference's order (a dict's keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def local_caches(cfg: ModelConfig, batch: int, max_seq: int,
                 shard: ShardCfg, cache_dtype=torch.bfloat16, device=None,
                 coord: dict | None = None):
    """(this rank's block of every decode cache for ``batch`` rows at
    ``max_seq`` positions, as :func:`cache_spec_tree` places them, and its
    ``KVBlock``).  The blocks hold ``init_caches``' starting values;
    ``coord`` names the rank on a mesh with no process group."""
    from repro_torch.models import model

    coord = _coordinate(shard.mesh) if coord is None else coord
    whole = model.init_caches(cfg, batch, max_seq, cache_dtype, "meta")
    want = [tuple(block(t, cache_spec_tree(t, cfg, shard.mesh, shard),
                        shard.mesh, coord).shape) for t in tree_leaves(whole)]
    rows = local_rows(batch, shard, coord)
    kvb = kv_block(cfg, max_seq, shard, coord)
    seq = max_seq // shard.tp_size() if kvb is not None and kvb.split \
        else max_seq
    local = model.init_caches(cfg, rows.stop - rows.start, seq, cache_dtype,
                              device)
    got = [tuple(t.shape) for t in tree_leaves(local)]
    if got != want:
        raise AssertionError(f"cache blocks {got} are not the placement's "
                             f"{want}")
    return local, kvb
