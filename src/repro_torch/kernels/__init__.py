"""The port's kernels: the four CFD stencils (hand-written CUDA plus their
plain versions), the plain fused Jacobi smoother and the op surface.

With ``REPRO_TORCH_LAUNCHES=<path>`` in its environment a process writes
:func:`launch_counts` to ``<path>`` as JSON when it exits, so a program run
as a user runs it (``python3 examples/...``) can show which kernels it
launched on the card."""
import atexit
import json
import os


def launch_counts() -> dict:
    """Every kernel's CUDA launches since its wrapper's last reset, by
    name (a kernel generated from a body under its descriptor's name)."""
    from repro_torch.kernels import (
        attention_cuda, jacobi_cuda, ssd_cuda, stencil3d_cuda,
    )

    out = {}
    for w in (stencil3d_cuda, jacobi_cuda, attention_cuda, ssd_cuda):
        out.update(w.LAUNCHES)
    out.update(stencil3d_cuda.GENERATED_LAUNCHES)
    return out


def _write_launch_counts(path: str) -> None:
    with open(path, "w") as f:
        json.dump(launch_counts(), f)


if os.environ.get("REPRO_TORCH_LAUNCHES"):
    atexit.register(_write_launch_counts, os.environ["REPRO_TORCH_LAUNCHES"])
