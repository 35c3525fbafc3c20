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
