"""Communication-avoiding fused Jacobi smoother — the plain version.

``k`` weighted-Jacobi sweeps on a halo-``k`` block: each sweep consumes one
ghost ring, so one padding (width ``k``) feeds ``k`` sweeps.  The solver's
``fused_sweeps > 1`` branch reaches it through ``ops.jacobi_smooth``: the
``TORCH`` template runs :func:`jacobi_fused_ref`, the ``CUDA`` template the
hand-written kernel of :mod:`repro_torch.kernels.jacobi_cuda`, which is
checked against this function.  Slicing acts on the last three axes, so a
leading slot axis passes through.
"""
from __future__ import annotations

from repro_torch.device import true_divide


def _sweep(p, rhs, h2, omega):
    """One weighted-Jacobi sweep; p padded by 1 relative to output, rhs
    padded to match p (its outer ring is unused)."""
    nbr = (p[..., 2:, 1:-1, 1:-1] + p[..., :-2, 1:-1, 1:-1]
           + p[..., 1:-1, 2:, 1:-1] + p[..., 1:-1, :-2, 1:-1]
           + p[..., 1:-1, 1:-1, 2:] + p[..., 1:-1, 1:-1, :-2])
    jac = true_divide(nbr - h2 * rhs[..., 1:-1, 1:-1, 1:-1], 6.0)
    return (1.0 - omega) * p[..., 1:-1, 1:-1, 1:-1] + omega * jac


def jacobi_fused_ref(p, rhs, *, h, omega=1.0, sweeps=1):
    """k fused sweeps; p and rhs padded by ``sweeps`` cells."""
    h2 = h * h
    for _ in range(sweeps):
        p = _sweep(p, rhs, h2, omega)
        rhs = rhs[..., 1:-1, 1:-1, 1:-1]
    return p
