"""Carry a simulation's state, or a language model, across from the
reference package.

For a CFD run the "weights" are the fields (``vx, vy, vz, p`` and the wall
masks) and the per-simulation scalars (``PARAM_KEYS``).  The reference's
arrays arrive as numpy arrays (``np.asarray`` of its ``jax.Array``s), so
this module needs neither package's internals: both packages can step the
same initial state, one farm request can feed both farms, and a result can
go back to numpy for comparison.

For a language model, :func:`lm_params_from_numpy` takes the reference's
parameter tree (nested dicts of numpy arrays, stacked ``(L, ...)`` leaves
under ``stack/layers``, or for the ``ssm`` family a tuple of per-layer
dicts there) and returns the port's ``LM`` with the same values bitwise,
and :func:`lm_params_to_numpy` goes back; :func:`caches_from_numpy` and
:func:`caches_to_numpy` carry the decode caches (``KVCache`` pairs,
``Mamba2State``, and the ``ssm`` family's tuple of per-layer
``MLSTMState``/``SLSTMState``) both ways.  For training, :func:`adamw_state_from_numpy`
and :func:`adamw_state_to_numpy` carry the optimizer state (its moments
stacked like the parameters) and :func:`grads_to_numpy` gives a model's
gradients in the reference's tree.  One name map serves all of them:
:func:`reference_path` (a port name to the reference's path).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Mapping

import numpy as np
import torch

from repro_torch.cfd.ns3d import CFDConfig
from repro_torch.ckpt.checkpointer import to_numpy
from repro_torch.device import resolve_device


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> dict:
    """Fields as contiguous float32 tensors on ``device`` (``None`` ->
    ``cuda``), bitwise equal to the numpy arrays."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in arrays.items()}


def params_from_numpy(params: Mapping[str, np.ndarray | float],
                      device=None) -> dict:
    """Per-simulation scalars as 0-d float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.float32(v), device=dev)
            for k, v in params.items()}


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """Tensors back to numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if torch.is_tensor(v)}


def _config_from(config, template: str | None = None) -> CFDConfig:
    """The port's :class:`CFDConfig` with the same values as ``config`` (the
    reference's, read field by field by name), on ``template``."""
    vals = {f.name: getattr(config, f.name)
            for f in dataclasses.fields(CFDConfig) if f.name != "template"}
    return CFDConfig(**vals, template=template)


def request_from_numpy(req, template: str | None = None, device="cpu"):
    """The port's ``SimRequest`` for a reference request (any object with
    its fields): the config carried by :func:`_config_from`, the initial
    fields (numpy, if any) as float32 tensors on ``device``."""
    from repro_torch.sim.farm import SimRequest

    init = (None if req.init_state is None
            else state_from_numpy(req.init_state, device))
    return SimRequest(config=_config_from(req.config, template),
                      steps=req.steps, tag=req.tag,
                      steady_tol=req.steady_tol,
                      residual_tol=req.residual_tol, priority=req.priority,
                      init_state=init, step0=req.step0)


def result_to_numpy(res):
    """A farm ``SimResult`` with its state as numpy arrays."""
    return dataclasses.replace(res, state=state_to_numpy(res.state))


# -- language models -----------------------------------------------------------
def _tensor(arr) -> torch.Tensor:
    """A tensor with the array's dtype and values, bitwise (bfloat16, which
    numpy holds as ml_dtypes' type, through its bits)."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix=()) -> Iterator[tuple[tuple, np.ndarray]]:
    """(path, leaf) pairs of nested dicts and lists or tuples; an element
    of a sequence is named by its index, as a string."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def reference_path(name: str, stacked: bool = True) -> str:
    """The reference's ``/``-joined tree path (``dist.sharding._path_str``)
    of a port parameter name: ``stack.layers.<i>.<path>`` is the stacked
    leaf ``stack/layers/<path>`` (``stacked``), or the per-layer leaf
    ``stack/layers/<i>/<path>`` (the ``ssm`` family's stack,
    ``LayerStack.stacked`` False); every other name keeps its parts.  It
    keys the placement rules (``dist.sharding``) and AdamW's decay
    filter."""
    parts = name.split(".")
    if stacked and parts[:2] == ["stack", "layers"]:
        del parts[2]
    return "/".join(parts)


def _port_named(tree: Mapping, device) -> dict:
    """A reference parameter-shaped tree as port names -> tensors: a
    stacked leaf ``stack/layers/<path>`` of shape (L, ...) becomes
    ``stack.layers.<i>.<path>`` for each layer i; a per-layer leaf
    ``stack/layers/<i>/<path>`` keeps its parts."""
    out = {}
    for path, arr in _flatten(tree):
        if path[:2] == ("stack", "layers") and not path[2].isdigit():
            for i in range(arr.shape[0]):
                key = ("stack", "layers", str(i)) + path[2:]
                out[".".join(key)] = _tensor(arr[i]).to(device)
        else:
            out[".".join(path)] = _tensor(arr).to(device)
    return out


def _put(tree: dict, parts, value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _reference_tree(named: Mapping[str, torch.Tensor],
                    stacked: bool = True) -> dict:
    """The inverse of :func:`_port_named`: numpy leaves (``to_numpy``: a
    bfloat16 tensor as float32, exactly) in the reference's nested dicts,
    the layers stacked along a leading axis in index order (``stacked``),
    or a tuple of per-layer dicts (the ``ssm`` family)."""
    tree: dict = {}
    by_path: dict = {}
    per_layer: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[:2] != ["stack", "layers"]:
            _put(tree, parts, to_numpy(t))
        elif stacked:
            by_path.setdefault(reference_path(name), {})[int(parts[2])] = t
        else:
            _put(per_layer.setdefault(int(parts[2]), {}), parts[3:],
                 to_numpy(t))
    for path, by_layer in by_path.items():
        _put(tree, path.split("/"),
             np.stack([to_numpy(by_layer[i]) for i in sorted(by_layer)]))
    if per_layer:
        _put(tree, ["stack", "layers"],
             tuple(per_layer[i] for i in sorted(per_layer)))
    return tree


def lm_params_from_numpy(cfg, tree: Mapping, device=None):
    """The port's ``LM`` holding the reference's parameters ``tree`` (its
    ``init_params`` pytree as numpy arrays) on ``device``, bitwise: names
    by :func:`reference_path`."""
    from repro_torch.models import model

    lm = model.init_params(cfg, device="meta")
    lm.load_state_dict(_port_named(tree, resolve_device(device)),
                       strict=True, assign=True)
    return lm


def lm_params_to_numpy(lm) -> dict:
    """The port model's parameters in the reference's tree (numpy; a
    bfloat16 parameter as float32)."""
    return _reference_tree(dict(lm.named_parameters()), lm.stack.stacked)


def grads_to_numpy(lm) -> dict:
    """The gradients held on the port model's parameters (``.grad``) in
    the reference's tree, as :func:`lm_params_to_numpy` lays it out."""
    missing = [n for n, p in lm.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(f"no gradient on {missing[:3]}... "
                         f"({len(missing)} parameters)")
    return _reference_tree({n: p.grad for n, p in lm.named_parameters()},
                           lm.stack.stacked)


def adamw_state_from_numpy(state, device=None):
    """The port's ``AdamWState`` for the reference's (numpy leaves; its
    moments stacked like the parameters): moments keyed by port name,
    the step a 0-d int32 tensor, on ``device``."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve_device(device)
    return AdamWState(step=_tensor(state.step).to(dev),
                      m=_port_named(state.m, dev),
                      v=_port_named(state.v, dev))


def adamw_state_to_numpy(state, stacked: bool = True):
    """The port's ``AdamWState`` with numpy leaves in the reference's
    layout: the step a 0-d array, the moments in its tree (``stacked``:
    the model's ``LayerStack.stacked``)."""
    return type(state)(step=to_numpy(state.step),
                       m=_reference_tree(state.m, stacked),
                       v=_reference_tree(state.v, stacked))


def caches_from_numpy(tree, device=None):
    """The reference's decode caches (numpy leaves; ``KVCache``,
    ``Mamba2State``, ``MLSTMState`` and ``SLSTMState`` named tuples, dicts
    and tuples of them) as the port's, on ``device``."""
    from repro_torch.models.blocks import KVCache
    from repro_torch.models.mamba2 import Mamba2State
    from repro_torch.models.xlstm import MLSTMState, SLSTMState

    if isinstance(tree, Mapping):
        return {k: caches_from_numpy(v, device) for k, v in tree.items()}
    if not hasattr(tree, "_fields"):               # the ssm family's layers
        return tuple(caches_from_numpy(v, device) for v in tree)
    cls = {c._fields: c for c in (KVCache, Mamba2State, MLSTMState,
                                  SLSTMState)}[tree._fields]
    dev = resolve_device(device)
    return cls(*(_tensor(a).to(dev) for a in tree))


def caches_to_numpy(caches):
    """The port's caches with numpy leaves, in the same structure."""
    if isinstance(caches, Mapping):
        return {k: caches_to_numpy(v) for k, v in caches.items()}
    if not hasattr(caches, "_fields"):
        return tuple(caches_to_numpy(v) for v in caches)
    return type(caches)(*(t.detach().cpu().numpy() for t in caches))
