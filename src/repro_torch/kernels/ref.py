"""Plain-torch oracles for the four stencil kernels.

These are written independently of the descriptor/generator machinery
(plain shifted slices of padded tensors), so kernel tests compare separate
implementations.  They mirror ``repro.kernels.ref`` line for line.

Conventions match stencil3d.py: inputs are halo-padded by the declared
stencil radii; outputs are interior-shaped.
"""
from __future__ import annotations


def _i(p, lo=(1, 1, 1), hi=(1, 1, 1), off=(0, 0, 0)):
    """Interior view of padded tensor ``p`` shifted by ``off``."""
    sl = tuple(
        slice(l + o, p.shape[a] - h + o) for a, (l, h, o) in enumerate(zip(lo, hi, off))
    )
    return p[sl]


def laplacian(u, h):
    """7-point Laplacian of a symmetric-padded (1,1,1) tensor."""
    c = lambda *o: _i(u, off=o)
    return (c(1, 0, 0) + c(-1, 0, 0) + c(0, 1, 0) + c(0, -1, 0)
            + c(0, 0, 1) + c(0, 0, -1) - 6.0 * c(0, 0, 0)) / (h * h)


def update_velocity(vx, vy, vz, *, dt, h, nu, fx=0.0, fy=0.0, fz=0.0):
    """MAC advection-diffusion; inputs padded (1,1,1) symmetric."""
    ih = 1.0 / h

    def a(f, o1, o2):
        return 0.5 * (_i(f, off=o1) + _i(f, off=o2))

    def lap(f):
        return laplacian(f, h)

    # x-momentum
    uc_r = a(vx, (0, 0, 0), (1, 0, 0)); uc_l = a(vx, (-1, 0, 0), (0, 0, 0))
    duu = (uc_r ** 2 - uc_l ** 2) * ih
    duv = (a(vx, (0, 0, 0), (0, 1, 0)) * a(vy, (0, 0, 0), (1, 0, 0))
           - a(vx, (0, -1, 0), (0, 0, 0)) * a(vy, (0, -1, 0), (1, -1, 0))) * ih
    duw = (a(vx, (0, 0, 0), (0, 0, 1)) * a(vz, (0, 0, 0), (1, 0, 0))
           - a(vx, (0, 0, -1), (0, 0, 0)) * a(vz, (0, 0, -1), (1, 0, -1))) * ih
    nvx = _i(vx) + dt * (-(duu + duv + duw) + nu * lap(vx) + fx)

    # y-momentum
    vc_r = a(vy, (0, 0, 0), (0, 1, 0)); vc_l = a(vy, (0, -1, 0), (0, 0, 0))
    dvv = (vc_r ** 2 - vc_l ** 2) * ih
    dvu = (a(vy, (0, 0, 0), (1, 0, 0)) * a(vx, (0, 0, 0), (0, 1, 0))
           - a(vy, (-1, 0, 0), (0, 0, 0)) * a(vx, (-1, 0, 0), (-1, 1, 0))) * ih
    dvw = (a(vy, (0, 0, 0), (0, 0, 1)) * a(vz, (0, 0, 0), (0, 1, 0))
           - a(vy, (0, 0, -1), (0, 0, 0)) * a(vz, (0, 0, -1), (0, 1, -1))) * ih
    nvy = _i(vy) + dt * (-(dvu + dvv + dvw) + nu * lap(vy) + fy)

    # z-momentum
    wc_r = a(vz, (0, 0, 0), (0, 0, 1)); wc_l = a(vz, (0, 0, -1), (0, 0, 0))
    dww = (wc_r ** 2 - wc_l ** 2) * ih
    dwu = (a(vz, (0, 0, 0), (1, 0, 0)) * a(vx, (0, 0, 0), (0, 0, 1))
           - a(vz, (-1, 0, 0), (0, 0, 0)) * a(vx, (-1, 0, 0), (-1, 0, 1))) * ih
    dwv = (a(vz, (0, 0, 0), (0, 1, 0)) * a(vy, (0, 0, 0), (0, 0, 1))
           - a(vz, (0, -1, 0), (0, 0, 0)) * a(vy, (0, -1, 0), (0, -1, 1))) * ih
    nvz = _i(vz) + dt * (-(dwu + dwv + dww) + nu * lap(vz) + fz)
    return nvx, nvy, nvz


def divergence(vx, vy, vz, *, h):
    """Cell divergence; velocity inputs padded (1,0) per axis (lo side)."""
    lo, hi = (1, 1, 1), (0, 0, 0)
    c = lambda f, *o: _i(f, lo, hi, o or (0, 0, 0))
    return ((c(vx) - c(vx, -1, 0, 0)) + (c(vy) - c(vy, 0, -1, 0))
            + (c(vz) - c(vz, 0, 0, -1))) / h


def jacobi_pressure(p, rhs, *, h, omega=1.0):
    """One weighted-Jacobi sweep; p padded (1,1,1), rhs interior-shaped."""
    c = lambda *o: _i(p, off=o)
    nbr = (c(1, 0, 0) + c(-1, 0, 0) + c(0, 1, 0) + c(0, -1, 0)
           + c(0, 0, 1) + c(0, 0, -1))
    jac = (nbr - h * h * rhs) / 6.0
    return (1.0 - omega) * _i(p) + omega * jac


def project_velocity(vx, vy, vz, p, *, dt, h):
    """Projection correction; velocities interior, p padded (0,1) per axis."""
    lo, hi = (0, 0, 0), (1, 1, 1)
    pc = lambda *o: _i(p, lo, hi, o or (0, 0, 0))
    s = dt / h
    return (vx - s * (pc(1, 0, 0) - pc()),
            vy - s * (pc(0, 1, 0) - pc()),
            vz - s * (pc(0, 0, 1) - pc()))
