"""Public wrappers around the stencil kernels of this package.

Each op dispatches between the CUDA template (the hand-written Hopper
kernels) and the TORCH template (the eager expansion of the body).  The CFD
solver calls these, never the launch wrappers directly.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.generator import generate
from repro_torch.kernels import stencil3d


def default_template(device) -> str:
    """CUDA for tensors on the card, TORCH elsewhere."""
    return "CUDA" if torch.device(device).type == "cuda" else "TORCH"


@functools.lru_cache(maxsize=None)
def _kernel(name: str, template: str):
    return generate(stencil3d.DESCRIPTORS[name], stencil3d.BODIES[name],
                    template=template)


def apply_kernel(name: str, arrays: dict, *, template: str | None = None,
                 tile=None, **params):
    """Run one descriptor kernel.  ``tile`` is accepted and ignored, as on
    the reference's JNP template: neither template here has tiles (the
    tile autotuner is ROADMAP queue 1, item 10)."""
    first = arrays[stencil3d.DESCRIPTORS[name].inputs[0]]
    tmpl = template or default_template(first.device)
    return _kernel(name, tmpl)(arrays, **params)


# -- convenience wrappers (the public op surface) ---------------------------
def update_velocity(vx, vy, vz, *, dt, h, nu, fx=0.0, fy=0.0, fz=0.0, **kw):
    out = apply_kernel(
        "UPDATE_VELOCITY", {"vx": vx, "vy": vy, "vz": vz},
        dt=dt, h=h, nu=nu, fx=fx, fy=fy, fz=fz, **kw)
    return out["vx"], out["vy"], out["vz"]


def divergence(vx, vy, vz, *, h, **kw):
    return apply_kernel("DIVERGENCE", {"vx": vx, "vy": vy, "vz": vz}, h=h, **kw)["div"]


def jacobi_pressure(p, rhs, *, h, omega=1.0, **kw):
    return apply_kernel("JACOBI_PRESSURE", {"p": p, "rhs": rhs},
                        h=h, omega=omega, **kw)["p"]


def project_velocity(vx, vy, vz, p, *, dt, h, **kw):
    out = apply_kernel(
        "PROJECT_VELOCITY", {"vx": vx, "vy": vy, "vz": vz, "p": p},
        dt=dt, h=h, **kw)
    return out["vx"], out["vy"], out["vz"]
