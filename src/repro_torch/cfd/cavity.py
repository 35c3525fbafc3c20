"""Lid-driven cavity at Re=100 — the paper's validation case (its Fig. 3).

The paper compares midsection centerline velocity against Ghia, Ghia & Shin
(1982).  We do the same: the 3D solver runs a z-periodic (quasi-2D) cavity,
and the x-velocity profile u(y) through the vertical centerline x=0.5 is
interpolated to Ghia's tabulated points.
"""
from __future__ import annotations

import numpy as np

from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D

# Ghia, Ghia & Shin (1982), Table I: u through the geometric center, Re=100.
# (y, u) — lid at y=1 moving with u=1.
GHIA_RE100_U = np.array([
    [0.0000, 0.00000],
    [0.0547, -0.03717],
    [0.0625, -0.04192],
    [0.0703, -0.04775],
    [0.1016, -0.06434],
    [0.1719, -0.10150],
    [0.2813, -0.15662],
    [0.4531, -0.21090],
    [0.5000, -0.20581],
    [0.6172, -0.13641],
    [0.7344, 0.00332],
    [0.8516, 0.23151],
    [0.9531, 0.68717],
    [0.9609, 0.73722],
    [0.9688, 0.78871],
    [0.9766, 0.84123],
    [1.0000, 1.00000],
])

# Ghia Table II: v through the horizontal centerline y=0.5, Re=100.
GHIA_RE100_V = np.array([
    [0.0000, 0.00000],
    [0.0625, 0.09233],
    [0.0703, 0.10091],
    [0.0781, 0.10890],
    [0.0938, 0.12317],
    [0.1563, 0.16077],
    [0.2266, 0.17507],
    [0.2344, 0.17527],
    [0.3125, 0.15662],
    [0.5000, 0.05454],
    [0.8047, -0.24533],
    [0.8594, -0.22445],
    [0.9063, -0.16914],
    [0.9453, -0.10313],
    [0.9531, -0.08864],
    [0.9609, -0.07391],
    [1.0000, 0.00000],
])


def config(n: int = 64, nz: int = 4, re: float = 100.0,
           lid_velocity: float = 1.0, **kw) -> CFDConfig:
    nu = 1.0 / re
    base = CFDConfig(shape=(n, n, nz), nu=nu)
    dt = kw.pop("dt", 0.8 * base.cfl(1.0))
    return CFDConfig(shape=(n, n, nz), extent=1.0, nu=nu, dt=dt,
                     case="cavity", lid_velocity=lid_velocity, **kw)


def sim_request(n: int = 32, re: float = 100.0, *, steps: int | None = None,
                t_end: float | None = None, tag: str = "",
                steady_tol: float | None = None,
                residual_tol: float | None = None, priority: int = 0, **kw):
    """A farm request for one cavity run (slot-parameterized setup).

    ``re``/``lid_velocity``/``forcing`` land in the per-slot scalar struct;
    grid and solver structure come from ``config(n, **kw)`` and must match
    the farm's static signature.  Give either ``steps`` or ``t_end``.
    ``residual_tol`` terminates at steady state on the residual norm
    ``||u^{n+1}-u^n||_inf / dt``; ``steady_tol`` is the legacy KE-drift
    heuristic.  ``priority`` orders farm admission (higher first).
    """
    from repro_torch.sim.farm import SimRequest  # lazy: cfd must not require sim

    cfg = config(n, re=re, **kw)
    if steps is None:
        if t_end is None:
            raise ValueError("give either steps= or t_end=")
        steps = int(round(t_end / cfg.dt))
    return SimRequest(config=cfg, steps=steps,
                      tag=tag or f"cavity-re{re:g}", steady_tol=steady_tol,
                      residual_tol=residual_tol, priority=priority)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def centerline_u(solver: NavierStokes3D, state) -> tuple[np.ndarray, np.ndarray]:
    """u(y) at the vertical centerline x=0.5 (z-averaged)."""
    n = solver.config.shape[0]
    h = solver.config.h
    vx = _host(state["vx"]).mean(axis=2)  # z average
    # vx[i, j] lives at x=(i+1)h, y=(j+.5)h; centerline x=0.5 -> i = n/2 - 1
    i = n // 2 - 1
    y = (np.arange(n) + 0.5) * h
    return y, vx[i, :]


def centerline_v(solver: NavierStokes3D, state) -> tuple[np.ndarray, np.ndarray]:
    """v(x) at the horizontal centerline y=0.5 (z-averaged)."""
    n = solver.config.shape[0]
    h = solver.config.h
    vy = _host(state["vy"]).mean(axis=2)
    j = n // 2 - 1
    x = (np.arange(n) + 0.5) * h
    return x, vy[:, j]


def ghia_errors(solver: NavierStokes3D, state) -> dict:
    """RMS/max deviation from Ghia's tabulated centerline profiles."""
    y, u = centerline_u(solver, state)
    x, v = centerline_v(solver, state)
    ui = np.interp(GHIA_RE100_U[1:-1, 0], y, u)  # skip the wall/lid endpoints
    vi = np.interp(GHIA_RE100_V[1:-1, 0], x, v)
    du = ui - GHIA_RE100_U[1:-1, 1]
    dv = vi - GHIA_RE100_V[1:-1, 1]
    return {
        "u_rms": float(np.sqrt(np.mean(du ** 2))),
        "u_max": float(np.abs(du).max()),
        "v_rms": float(np.sqrt(np.mean(dv ** 2))),
        "v_max": float(np.abs(dv).max()),
    }


def run(n: int = 64, t_end: float = 20.0, device=None, progress=None,
        mesh=None, decomposition=(), **kw):
    """Run the cavity to (near) steady state; return solver, state, errors.
    With a mesh and a ``decomposition`` every rank of the mesh steps its
    block; ``state`` is the rank's block, the errors are the global
    grid's (its fields gathered)."""
    cfg = config(n, decomposition=tuple(decomposition), **kw)
    solver = NavierStokes3D(cfg, device, mesh)
    state = solver.init_state()
    step = solver.make_step()
    steps = int(round(t_end / cfg.dt))
    for i in range(steps):
        state = step(state)
        if progress and i % progress == 0:
            ke = solver.kinetic_energy(state)
            print(f"  step {i:6d}/{steps} t={i*cfg.dt:7.3f} KE={ke:.6f}")
    whole = ({f: solver.driver.gather(state[f]) for f in ("vx", "vy")}
             if solver.driver.links else state)
    return solver, state, ghia_errors(solver, whole)
