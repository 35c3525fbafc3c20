"""Device resolution: ``cuda`` unless the caller asks for the CPU.

Nothing in the package falls back to the CPU.  Asking for ``cuda`` on a
host without a usable card raises, so a run that was meant for the card
can never quietly measure the CPU instead.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` for ``device`` (``None`` -> ``cuda``).

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the eager path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def default_template(device) -> str:
    """The kernel template for tensors on ``device``: ``CUDA`` (the
    hand-written kernels) on the card, ``TORCH`` (the plain versions)
    elsewhere."""
    return "CUDA" if torch.device(device).type == "cuda" else "TORCH"


def resolve_template(template: str | None, device) -> str:
    """``template`` checked (``CUDA`` or ``TORCH``), or the device's
    :func:`default_template` when it is None."""
    tmpl = template or default_template(device)
    if tmpl not in ("CUDA", "TORCH"):
        raise ValueError(f"unknown template {tmpl!r} (CUDA or TORCH)")
    return tmpl


def resolve_backend(backend: str, device: torch.device) -> str:
    """The template of a backend name: ``torch`` -> ``TORCH``, ``cuda`` ->
    ``CUDA`` (raises unless ``device`` is a card), ``auto`` -> the
    device's :func:`default_template`."""
    if backend not in ("torch", "cuda", "auto"):
        raise ValueError(f"unknown backend {backend!r} (torch, cuda or auto)")
    if backend == "auto":
        return default_template(device)
    if backend == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(
            f"backend 'cuda' runs the hand-written CUDA kernels and needs a "
            f"CUDA device, got {device}; use backend='torch' on the CPU")
    return backend.upper()
