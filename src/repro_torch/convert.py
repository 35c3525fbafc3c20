"""Carry a simulation's state across from the reference package.

For a CFD run the "weights" are the fields (``vx, vy, vz, p`` and the wall
masks) and the per-simulation scalars (``PARAM_KEYS``).  The reference's
arrays arrive as numpy arrays (``np.asarray`` of its ``jax.Array``s), so
this module needs neither package's internals: both packages can step the
same initial state, one farm request can feed both farms, and a result can
go back to numpy for comparison.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.cfd.ns3d import CFDConfig
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
