"""Taylor-Green vortex: analytic validation of the full NS pipeline.

2D Taylor-Green (z-invariant in our 3D solver) on the periodic box
[0, 2*pi]^2:  u =  sin(x) cos(y) F(t),  v = -cos(x) sin(y) F(t),
F(t) = exp(-2 nu t).  The nonlinear terms are balanced by pressure, so the
numerical solution must track the analytic decay — this exercises advection,
diffusion, the Poisson solve, and projection at once, with a known answer.
"""
from __future__ import annotations

import math

import torch

from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D


def config(n: int = 32, nz: int = 4, nu: float = 0.1, dt: float | None = None,
           **kw) -> CFDConfig:
    h = 2.0 * math.pi / n
    dt = dt if dt is not None else min(0.25 * h, 0.2 * h * h / (6 * nu))
    kw.setdefault("jacobi_iters", 60)
    kw.setdefault("jacobi_omega", 1.0)
    return CFDConfig(
        shape=(n, n, nz), extent=2.0 * math.pi, nu=nu, dt=dt,
        case="taylor_green", **kw)


def sim_request(n: int = 32, nu: float = 0.1, *, steps: int = 50,
                tag: str = "", steady_tol: float | None = None,
                residual_tol: float | None = None, priority: int = 0, **kw):
    """A farm request for one Taylor-Green run (slot-parameterized setup).

    Heterogeneous ``nu`` across slots decays each vortex at its own rate
    under one batched step; ``forcing`` may be set through ``kw`` to drive
    a sustained variant.  ``residual_tol``/``steady_tol``/``priority`` as
    in :func:`repro_torch.cfd.cavity.sim_request`.
    """
    from repro_torch.sim.farm import SimRequest  # lazy: cfd must not require sim

    cfg = config(n, nu=nu, **kw)
    return SimRequest(config=cfg, steps=steps,
                      tag=tag or f"tg-nu{nu:g}", steady_tol=steady_tol,
                      residual_tol=residual_tol, priority=priority)


def analytic(solver: NavierStokes3D, t: float):
    """vx, vy sampled at their staggered face positions."""
    x, y, _ = solver.driver.coords()
    h = solver.config.h
    f = math.exp(-2.0 * solver.config.nu * t)
    vx = torch.sin(x + 0.5 * h) * torch.cos(y) * f
    vy = -torch.cos(x) * torch.sin(y + 0.5 * h) * f
    return vx, vy


def run(n: int = 32, steps: int = 50, nu: float = 0.1, device=None,
        mesh=None, decomposition=(), **kw):
    """Integrate and report errors vs the analytic solution.  With a mesh
    and a ``decomposition`` every rank of the mesh steps its block and the
    errors are reduced over the ranks (the same report on each)."""
    cfg = config(n, nu=nu, decomposition=tuple(decomposition), **kw)
    solver = NavierStokes3D(cfg, device, mesh)
    state = solver.init_state()
    step = solver.make_step()
    for _ in range(steps):
        state = step(state)
    t = steps * cfg.dt
    ax, ay = analytic(solver, t)
    # one report (div_linf + ke ride the health diagnostics vector) plus
    # one host fetch for the analytic-error reductions
    rep = solver.health_report(state)
    errs = torch.stack([(state["vx"] - ax).abs().max(),
                        (state["vy"] - ay).abs().max()])
    exact = 0.5 * (torch.mean(ax ** 2) + torch.mean(ay ** 2))
    if solver.driver.links:
        errs, exact = solver.driver.pmax(errs), solver.driver.pmean(exact)
    err_x, err_y, energy_exact = (float(v) for v in torch.cat(
        [errs, exact.reshape(1)]).cpu())
    energy = rep["ke"]
    return {
        "t": t, "err_vx": err_x, "err_vy": err_y, "div_max": rep["div_linf"],
        "energy": energy, "energy_exact": energy_exact,
        "energy_rel_err": abs(energy - energy_exact) / energy_exact,
    }
