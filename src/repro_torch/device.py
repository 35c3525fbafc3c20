"""Device resolution: ``cuda`` unless the caller asks for the CPU.

Nothing in the package falls back to the CPU.  Asking for ``cuda`` on a
host without a usable card raises, so a run that was meant for the card
can never quietly measure the CPU instead.
"""
from __future__ import annotations

import functools

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
    hand-written kernels) on the card and on ``meta`` (a cost trace, which
    follows the card's path: each kernel wrapper books its declared cost),
    ``TORCH`` (the plain versions) elsewhere."""
    return ("CUDA" if torch.device(device).type in ("cuda", "meta")
            else "TORCH")


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


def true_divide(x, c):
    """``x / c`` as a true division, whatever the device.

    On the card PyTorch computes a division by a CPU scalar (a Python
    number or a 0-dim CPU tensor) as a product with the divisor's rounded
    reciprocal, which can miss the true quotient by an ulp; the CPU
    divides.  Dividing by a 0-dim tensor of ``x``'s dtype on ``x``'s
    device gives the true quotient on both, and on the CPU the same bits
    as ``x / c``.  With no tensor among ``x`` and ``c`` it is Python's
    division; a Python ``x`` over a tensor ``c`` becomes a 0-dim tensor
    first (``x / c`` would multiply by ``c``'s reciprocal on any device)."""
    if not torch.is_tensor(x):
        if not torch.is_tensor(c):
            return x / c
        x = _scalar(float(x), c.dtype, c.device)
    if torch.is_tensor(c):
        if c.dim() == 0 and c.device != x.device:
            c = c.to(x.device)
        return x / c
    return x / _scalar(float(c), x.dtype, x.device)


@functools.lru_cache(maxsize=256)
def _scalar(value: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """A read-only 0-dim constant on ``device``, made once."""
    return torch.full((), value, dtype=dtype, device=device)
