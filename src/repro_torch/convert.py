"""Carry a simulation's state across from the reference package.

For a CFD run the "weights" are the fields (``vx, vy, vz, p`` and the wall
masks) and the per-simulation scalars (``PARAM_KEYS``).  The reference's
arrays arrive as numpy arrays (``np.asarray`` of its ``jax.Array``s), so
this module needs neither package's internals: both packages can step the
same initial state, and a result can go back to numpy for comparison.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

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
