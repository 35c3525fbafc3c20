"""3D incompressible Navier-Stokes on a staggered MAC grid — the paper's §4.

Chorin/Hirt-Nichols explicit projection scheme, built entirely from the
framework's descriptor-generated kernels + driver-managed halo padding:

  1. UPDATE_VELOCITY   u* = u + dt (-adv + nu lap + f)         [stencil kernel]
  2. wall masks        enforce zero wall-normal faces
  3. DIVERGENCE        rhs = div(u*)/dt                        [stencil kernel]
  4. JACOBI_PRESSURE   iterate lap p = rhs                     [stencil kernel]
                       (optionally the fused communication-avoiding smoother)
  5. PROJECT_VELOCITY  u = u* - dt grad p                      [stencil kernel]

On the CUDA template JACOBI_PRESSURE and UPDATE_VELOCITY (without the
interior/shell split) take the unpadded fields and make their own ghost
values from the BC rules' declared forms, only the decomposed faces' strips
travelling (``kernels.ops.ghosted_inputs``; where none travels, p's faces
are bound once a step, ``kernels.ops.bound_ghosts``); the TORCH template
pads every input (``exchange_pad``) and expands the body, as the other two
kernels do on both templates.

Grid convention (see kernels/stencil3d.py): vx[i] at the right x-face of
cell i; the hi wall face is vx[N-1].  Cases: ``cavity`` (lid-driven, lid at
y-hi moving in +x; z periodic so the Ghia 2D profile is recovered),
``taylor_green`` and ``kelvin_helmholtz`` (fully periodic).

The step runs on one grid ``(X, Y, Z)`` with 0-d per-simulation scalars,
or on a slot batch ``(S, X, Y, Z)`` with ``(S,)`` scalars (the farm's
ensemble step, which the reference gets from ``vmap``): per slot the two
compute the same arithmetic, so a farm slot equals a serial run bitwise.
With ``config.decomposition`` and a mesh, the grid is split over ranks and
every rank steps its own block, its ghosts exchanged with its neighbours
(``core.halo``); the one reduction of the step, the pressure's mean, is
taken in a fixed order over the ranks, so a decomposed farm slot still
equals the serial decomposed run bitwise.  Without a decomposition nothing
in the step synchronises with the host: the per-simulation scalars are
float32 tensors on the device, and on the CUDA template every parameter
table is built there.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.core.driver import Domain, GridDriver
from repro_torch.core.halo import (
    AxisSpec, GhostForm, bc_dirichlet, bc_neumann, exchange_pad,
    exchange_pad_start, exchange_strips, field_ghosts, stencil_step_overlap,
    tensor_axis, with_form,
)
from repro_torch.device import resolve_device, true_divide
from repro_torch.kernels import ops
from repro_torch.obs.spans import span


def bc_moving_wall(u_wall):
    """Tangential-velocity ghost across a wall moving at ``u_wall``:
    ghost = 2 u_wall - mirrored interior (wall value is the face average).
    ``u_wall`` may be a float, a 0-d tensor on the fields' device, or a
    per-slot ``(S, 1, 1, 1)`` tensor for a slot batch.  Its declared form
    (``core.halo.GhostForm``) is a = -1, b = 2 u_wall."""
    b = 2.0 * u_wall

    def rule(strip, side, axis):
        return b - torch.flip(strip, dims=(axis,))

    return with_form(rule, GhostForm("affine", a=-1.0, b=b))


@dataclasses.dataclass(frozen=True)
class CFDConfig:
    shape: tuple[int, int, int] = (64, 64, 4)
    extent: float = 1.0                      # cubic cells: h = extent/shape[0]
    nu: float = 0.01
    dt: float = 2.5e-3
    case: str = "cavity"                     # "cavity" | "taylor_green" | ...
    lid_velocity: float = 1.0
    forcing: tuple[float, float, float] = (0.0, 0.0, 0.0)
    jacobi_iters: int = 40
    jacobi_omega: float = 1.0
    fused_sweeps: int = 1                    # >1: communication-avoiding smoother
    template: str | None = None              # None -> TORCH; or CUDA
    overlap: bool = True                     # interior/boundary split
    decomposition: tuple = ()                # e.g. ((0,"data"), (1,"model"))

    @property
    def h(self) -> float:
        return self.extent / self.shape[0]

    def cfl(self, umax: float = 1.0) -> float:
        """Stable dt bound: advective + viscous."""
        h = self.h
        return min(0.5 * h / max(umax, 1e-12), h * h / (6.0 * self.nu) * 0.9)


# The per-simulation runtime parameters: everything that may vary between
# simulations sharing one step.  Grid geometry (shape, h) and solver
# structure (iterations, overlap, template) stay static.
PARAM_KEYS = ("nu", "dt", "lid_velocity", "fx", "fy", "fz")


def params_from_config(c: CFDConfig, device=None) -> dict:
    """The per-simulation scalar struct for ``c``: 0-d float32 tensors on
    ``device`` (``None`` -> ``cuda``), made by device fills."""
    dev = resolve_device(device)
    fx, fy, fz = c.forcing
    vals = dict(nu=c.nu, dt=c.dt, lid_velocity=c.lid_velocity,
                fx=fx, fy=fy, fz=fz)
    return {k: torch.full((), float(vals[k]), dtype=torch.float32, device=dev)
            for k in PARAM_KEYS}


# Cases whose domain is fully periodic (no wall BCs, no wall masks).
# "kelvin_helmholtz" shares the solver structure of "taylor_green" — its
# shear-layer initial condition is owned by the scenario registry
# (repro_torch.sim.scenarios), not by the solver.
PERIODIC_CASES = ("taylor_green", "kelvin_helmholtz")

# Physics columns of one in-situ health frame, in the order
# ``health_diagnostics`` stacks them.
HEALTH_DIAGS = ("div_linf", "ke", "umax", "cfl", "finite")


class NavierStokes3D:
    """The CFD application object: owns the driver, BCs, and the step."""

    FIELDS = ("vx", "vy", "vz", "p")

    def __init__(self, config: CFDConfig, device=None, mesh=None):
        self.config = config
        self.device = resolve_device(device)
        periodic = config.case in PERIODIC_CASES
        self.domain = Domain(
            shape=config.shape,
            spacing=(config.h,) * 3,
            decomposition=dict(config.decomposition),
            periodic=(periodic, periodic, True),
        )
        self.driver = GridDriver(self.domain, self.device, mesh)
        self._build_bcs()

    @property
    def field_pspec(self) -> tuple:
        """Placement of one field under this solver's decomposition: the
        mesh axis of each grid axis, or None (``dist.sharding``'s
        convention).  The farm puts a slot axis in front."""
        return tuple(self.domain.decomposition.get(a) for a in range(3))

    # ------------------------------------------------------------------ BCs
    def _bcs_for(self, lid_velocity) -> dict:
        """BC rule table; ``lid_velocity`` may be a 0-d device tensor."""
        c = self.config
        if c.case in PERIODIC_CASES:
            # fully periodic: no BC rules needed anywhere
            return {f: ((None,) * 3, (None,) * 3) for f in self.FIELDS}
        noslip = bc_moving_wall(0.0)
        lid = bc_moving_wall(lid_velocity)
        zero = bc_dirichlet(0.0)
        neum = bc_neumann()
        # (bc_lo per axis, bc_hi per axis); z is periodic via Domain.periodic
        return {
            # vx: normal to x walls (ghost faces 0), tangential in y (lid at hi)
            "vx": ((zero, noslip, None), (zero, lid, None)),
            # vy: tangential in x, normal to y walls
            "vy": ((noslip, zero, None), (noslip, zero, None)),
            # vz: tangential to x and y walls
            "vz": ((noslip, noslip, None), (noslip, noslip, None)),
            # p: homogeneous Neumann at all walls
            "p": ((neum, neum, None), (neum, neum, None)),
        }

    def _build_bcs(self):
        self.bc = self._bcs_for(self.config.lid_velocity)

    def _specs(self, field: str, bc: dict | None = None
               ) -> tuple[AxisSpec, AxisSpec, AxisSpec]:
        bc_lo, bc_hi = (bc or self.bc)[field]
        return self.driver.axis_specs(bc_lo=bc_lo, bc_hi=bc_hi)

    # --------------------------------------------------------------- fields
    def init_state(self) -> dict:
        c = self.config
        state = self.driver.allocate(self.FIELDS, 0.0)
        state["mask_vx"], state["mask_vy"], state["mask_vz"] = self._masks()
        if c.case == "taylor_green":
            x, y, z = self.driver.coords()
            h = c.h
            # face-centered sample positions (vx at x+(h/2), vy at y+(h/2))
            state["vx"] = torch.sin(x + 0.5 * h) * torch.cos(y)
            state["vy"] = -torch.cos(x) * torch.sin(y + 0.5 * h)
        return state

    def _masks(self):
        """Zero the wall-normal boundary faces (vx[N-1] on x, etc.) of this
        rank's block: only the block that ends the grid on an axis holds
        that wall's face."""
        c = self.config
        ones = np.ones(self.driver.local_shape, np.float32)
        mx, my, mz = ones.copy(), ones.copy(), ones.copy()
        if c.case not in PERIODIC_CASES:
            if self.driver.is_last(0):
                mx[-1, :, :] = 0.0
            if self.driver.is_last(1):
                my[:, -1, :] = 0.0
            # z periodic: no vz mask
        return [torch.from_numpy(m).to(self.device) for m in (mx, my, mz)]

    # ----------------------------------------------------------------- step
    def _global_mean(self, x):
        """Mean over the grid: 0-d for one grid, ``(S,)`` for a slot batch.

        Sequential per-axis sums, innermost first, as the reference does.
        A slot batch reduces each slot's grid with exactly the calls of the
        unbatched path: a batched reduction may be split differently on the
        card (its launch shape depends on the number of outputs), and the
        farm's contract is slot == serial bitwise.  On a decomposed grid the
        blocks' means are then combined in rank order
        (``GridDriver.pmean``), once for the whole slot vector."""
        if self.driver.links:
            return self.driver.pmean(self._block_mean(x))
        return self._block_mean(x)

    def _block_mean(self, x):
        if x.dim() == 4:
            return torch.stack([self._block_mean(x[s])
                                for s in range(x.shape[0])])
        m = x
        for _ in range(3):
            m = m.sum(dim=-1)
        return true_divide(m, float(np.prod(np.asarray(x.shape[-3:],
                                                      np.float32))))

    def _step_local(self, state: dict, params: dict | None = None) -> dict:
        """One dt on the whole grid, or on every grid of a slot batch.

        ``params`` is the per-simulation scalar struct (see ``PARAM_KEYS``),
        float32 tensors on the fields' device: 0-d for fields ``(X, Y, Z)``,
        ``(S,)`` for a slot batch ``(S, X, Y, Z)``, where the kernels take
        them per slot and elementwise terms see them as ``(S, 1, 1, 1)``.
        No host sync: every launch is enqueued and the loop never reads a
        device value.
        """
        with span("ns3d.step"):
            return self._step_phases(state, params)

    def _step_phases(self, state: dict, params: dict | None) -> dict:
        """:meth:`_step_local`'s body: its four phases, each in a span."""
        c = self.config
        if params is None:
            params = params_from_config(c, self.device)
        kw = dict(template=c.template or "TORCH")
        # the stencils' launch tile: the chip-aware choice, resolved per
        # local interior and memoized (autotune.tile_for), so serial and
        # farm runs of one grid launch the same tiles
        cuda = kw["template"] == "CUDA"
        skw = dict(kw, tile="auto") if cuda else kw
        h = c.h
        batched = state["vx"].dim() == 4

        def grid(v):
            """A per-slot scalar shaped to broadcast over (S, X, Y, Z)."""
            return v.reshape(-1, 1, 1, 1) if batched else v

        dt, nu = params["dt"], params["nu"]
        bc = self._bcs_for(grid(params["lid_velocity"]))
        specs = functools.partial(self._specs, bc=bc)
        vx, vy, vz, p = state["vx"], state["vy"], state["vz"], state["p"]
        mvx, mvy, mvz = state["mask_vx"], state["mask_vy"], state["mask_vz"]

        # -- 1. advection-diffusion (interior/shell split if enabled)
        with span("ns3d.advect"):
            vel_params = dict(dt=dt, h=h, nu=nu, fx=params["fx"],
                              fy=params["fy"], fz=params["fz"])

            def upd_packed(padded):
                out = ops.update_velocity(padded[0], padded[1], padded[2],
                                          **vel_params, **skw)
                return torch.stack(out)

            if c.overlap:
                # pack the components on a leading axis; the deep interior runs
                # without any ghost dependency, shells are computed from the
                # padded pack
                def pad_packed(pack):
                    started = [exchange_pad_start(pack[i], (1, 1, 1), specs(f))
                               for i, f in enumerate(("vx", "vy", "vz"))]
                    return lambda: torch.stack([wait() for wait in started])

                packed = torch.stack([vx, vy, vz])
                # width 0 on the pack axis and on the slot axis, if any
                widths = (0,) * (packed.dim() - 3) + (1, 1, 1)
                out = stencil_step_overlap(
                    packed, widths, specs=None, kernel=upd_packed,
                    pad_fn=pad_packed)
                vx_s, vy_s, vz_s = out[0], out[1], out[2]
            elif cuda:
                # the kernel fills its own ghost zones: only the strips travel
                ins, ghosts = ops.ghosted_inputs(
                    "UPDATE_VELOCITY", (vx, vy, vz),
                    [specs(f) for f in ("vx", "vy", "vz")])
                vx_s, vy_s, vz_s = ops.update_velocity(*ins, **vel_params,
                                                       ghosts=ghosts, **skw)
            else:
                pads = [exchange_pad(v, (1, 1, 1), specs(f))
                        for f, v in (("vx", vx), ("vy", vy), ("vz", vz))]
                vx_s, vy_s, vz_s = ops.update_velocity(*pads, **vel_params,
                                                       **skw)

            vx_s, vy_s, vz_s = vx_s * mvx, vy_s * mvy, vz_s * mvz

        # -- 2. divergence rhs
        with span("ns3d.rhs"):
            pads = [exchange_pad(v, ((1, 0),) * 3, specs(f))
                    for f, v in (("vx", vx_s), ("vy", vy_s), ("vz", vz_s))]
            rhs = ops.divergence(*pads, h=h, **skw) / grid(dt)

        # -- 3. pressure Poisson (warm start from previous p)
        with span("ns3d.pressure"):
            p_specs = specs("p")
            k = c.fused_sweeps
            # where no strip travels every sweep reads the same faces:
            # bound once
            p_bound = (ops.bound_ghosts("JACOBI_PRESSURE", (p,), [p_specs])
                       if k <= 1 and cuda else None)

            def jacobi_body(pcur):
                if p_bound is not None:
                    return ops.jacobi_pressure(pcur, rhs, h=h,
                                               omega=c.jacobi_omega,
                                               ghosts=p_bound, **skw)
                if k <= 1 and cuda:
                    (pp,), ghosts = ops.ghosted_inputs(
                        "JACOBI_PRESSURE", (pcur,), [p_specs])
                    return ops.jacobi_pressure(pp, rhs, h=h,
                                               omega=c.jacobi_omega,
                                               ghosts=ghosts, **skw)
                if k <= 1:
                    pp = exchange_pad(pcur, (1, 1, 1), p_specs)
                    return ops.jacobi_pressure(pp, rhs, h=h,
                                               omega=c.jacobi_omega, **skw)
                pp = exchange_pad(pcur, (k, k, k), p_specs)
                rr = exchange_pad(rhs, (k, k, k), p_specs)
                return ops.jacobi_smooth(pp, rr, h=h, omega=c.jacobi_omega,
                                         sweeps=k, **kw)

            iters = max(c.jacobi_iters // max(k, 1), 1)
            p_new = p
            for _ in range(iters):
                p_new = jacobi_body(p_new)
            # pin the Neumann null space
            p_new = p_new - grid(self._global_mean(p_new))

        # -- 4. projection
        with span("ns3d.project"):
            pp = exchange_pad(p_new, ((0, 1),) * 3, p_specs)
            vx_n, vy_n, vz_n = ops.project_velocity(vx_s, vy_s, vz_s, pp,
                                                    dt=dt, h=h, **skw)
            vx_n, vy_n, vz_n = vx_n * mvx, vy_n * mvy, vz_n * mvz

        return dict(state, vx=vx_n, vy=vy_n, vz=vz_n, p=p_new)

    def cost_twin(self) -> "NavierStokes3D":
        """This solver on the ``meta`` device with the CUDA template: the
        twin a cost trace runs (``repro_torch.launch.op_cost``).  Its
        stencil wrappers book their declared cost and launch nothing; its
        fields and parameters must be given as ``meta`` tensors (it makes
        none itself).  A decomposed solver's twin sits at this rank's place
        on virtual links whose :class:`~repro_torch.core.halo.CountTransport`
        (``twin.driver.transport``) books the exchanges."""
        twin = copy.copy(self)
        twin.config = dataclasses.replace(self.config, template="CUDA")
        twin.device = torch.device("meta")
        virtual = ({lk.name: (lk.size, lk.index)
                    for lk in self.driver.links.values()}
                   if self.driver.links else None)
        twin.driver = GridDriver(self.domain, twin.device, virtual)
        twin._build_bcs()
        return twin

    def make_step(self) -> Callable[[dict], dict]:
        """The step with this config's scalars as device tensors, threaded
        through the same parameterized step a slot batch will run."""
        params = params_from_config(self.config, self.device)
        step = self.driver.sharded_step_tree(self._step_local)
        return lambda s: step(s, params)

    # ------------------------------------------------------------ analysis
    def divergence_of(self, state: dict) -> torch.Tensor:
        """The divergence of this rank's block (ghosts exchanged)."""
        pads = [exchange_pad(state[f], ((1, 0),) * 3, self._specs(f))
                for f in ("vx", "vy", "vz")]
        return ops.divergence(*pads, h=self.config.h, template="TORCH")

    def kinetic_energy(self, state: dict) -> float:
        return float(self.kinetic_energy_device(state))

    def kinetic_energy_device(self, state: dict) -> torch.Tensor:
        """0.5 * sum of the velocity components' mean squares, on the
        device: 0-d for one grid, ``(S,)`` for a slot batch, each slot
        reduced by the unbatched calls on its own grid.  On a decomposed
        grid the blocks' values are averaged over the ranks in rank
        order."""
        if state["vx"].dim() == 4:
            ke = torch.stack([
                self._block_ke({f: state[f][s] for f in ("vx", "vy", "vz")})
                for s in range(state["vx"].shape[0])])
        else:
            ke = self._block_ke(state)
        return self.driver.pmean(ke) if self.driver.links else ke

    @staticmethod
    def _block_ke(state: dict) -> torch.Tensor:
        return 0.5 * sum(torch.mean(state[f] ** 2) for f in ("vx", "vy", "vz"))

    def health_diagnostics(self, state: dict,
                           params: dict | None = None) -> torch.Tensor:
        """One ``(len(HEALTH_DIAGS),)`` float32 vector of in-situ health
        diagnostics: divergence L∞, kinetic energy, max|u|, CFL number,
        and a finite-fields sentinel (1.0 = no NaN/Inf in any dynamic
        field — the velocities and the pressure).  Computed on the device;
        read-only.  On a slot batch ``(S, X, Y, Z)`` with ``(S,)``
        parameters each diagnostic is per slot: an ``(S, 5)`` tensor.  On a
        decomposed grid the blocks' values are reduced over the ranks
        (``pmax``/``pmin``, and ``pmean`` in rank order): max, min and the
        sentinel equal the serial grid's exactly, the energy to rounding."""
        c = self.config
        if params is None:
            params = params_from_config(c, self.device)

        def absmax(x):
            return torch.linalg.vector_norm(x, ord=float("inf"),
                                            dim=(-3, -2, -1))

        # interior one-sided divergence: identical to the ghost-padded
        # stencil on every cell that has real (non-BC) neighbours
        vx, vy, vz = state["vx"], state["vy"], state["vz"]
        links = self.driver.links
        if links:
            # a block's first plane on a decomposed axis has its neighbour's
            # last plane as the lower neighbour: exchange that one plane, so
            # the blocks together cover exactly the serial grid's cells
            specs = self.driver.axis_specs()
            widths = tuple((1, 0) if a in links else 0 for a in range(3))
            gx, gy, gz = (exchange_pad(v, widths, specs)
                          for v in (vx, vy, vz))
        else:
            gx, gy, gz = vx, vy, vz
        div = true_divide((gx[..., 1:, 1:, 1:] - gx[..., :-1, 1:, 1:])
                          + (gy[..., 1:, 1:, 1:] - gy[..., 1:, :-1, 1:])
                          + (gz[..., 1:, 1:, 1:] - gz[..., 1:, 1:, :-1]), c.h)
        for a, link in links.items():
            if link.index == 0:     # the grid's first plane has no ghost
                ax = tensor_axis(a)
                div = div.narrow(ax, 1, div.shape[ax] - 1)
        drv = self.driver
        # max |x| in one read of x (exact, NaN propagates, -0 gives +0):
        # the same bits as the max over |x| materialized first
        div_linf = absmax(div)
        umax = torch.maximum(torch.maximum(absmax(vx), absmax(vy)),
                             absmax(vz))
        ke2 = vx * vx + vy * vy + vz * vz
        for _ in range(3):      # sequential per-axis sums like _global_mean
            ke2 = ke2.sum(dim=-1)
        ke = true_divide(0.5 * ke2, float(np.prod(np.asarray(vx.shape[-3:],
                                                             np.float32))))
        psum = state["p"]
        for _ in range(3):
            psum = psum.sum(dim=-1)
        finite = torch.isfinite(div_linf + ke + umax + psum).to(torch.float32)
        if links:
            div_linf, umax = drv.pmax(div_linf), drv.pmax(umax)
            ke, finite = drv.pmean(ke), drv.pmin(finite)
        cfl = true_divide(umax * params["dt"], c.h)
        return torch.stack([div_linf, ke, umax, cfl, finite],
                           dim=-1).to(torch.float32)

    def health_report(self, state: dict) -> dict:
        """Named health diagnostics of ``state`` as plain floats — one host
        fetch, however many numbers come back."""
        vec = self.health_diagnostics(state).cpu().numpy()
        return {k: float(v) for k, v in zip(HEALTH_DIAGS, vec)}
