"""Scenario registry — the Cactus "thorn list" for the simulation runtime.

Cactus applications are assemblies: physics *thorns* declare their grid
functions, parameters, and schedule-bin routines, and the flesh derives
everything else (storage, halo padding, execution order).  A
:class:`Scenario` is this package's thorn descriptor: it names a problem
(config builder + parameter schema), optionally supplies an initial-condition
routine and analysis routines, and wires them into the
:class:`repro_torch.core.schedule.Schedule` bins —

    INITIAL    allocate fields + apply the scenario's IC
    EVOLVE     the solver step (alias of the Cactus EVOL bin)
    ANALYSIS   diagnostics computed on demand over a finished state

``@register_scenario`` puts a scenario into the process-wide registry so
:mod:`repro_torch.api` can resolve it by name; ``Scenario.request`` turns a
run of it into farm intake.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D
from repro_torch.core.schedule import Schedule


class UnknownScenarioError(KeyError):
    """Raised when resolving a scenario name that was never registered."""


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One entry of a scenario's parameter schema: a default plus a
    one-line doc, so the front door can list and validate per-run
    parameters without knowing any physics."""

    default: float
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A registered problem: config builder, parameter schema, IC, analyses.

    ``builder(n, **kw)`` returns the :class:`CFDConfig`; runtime parameters
    (``params`` schema — Reynolds number, viscosity, lid velocity, ...)
    are builder keyword arguments, while ``ic_params`` shape only the
    initial condition (``init_fields``) and never enter the config.
    ``analyses`` maps a diagnostic name to ``fn(solver, state, ctx)``
    where ``ctx`` carries ``{"t", "steps"}``.
    """

    name: str
    description: str
    builder: Callable[..., CFDConfig]
    params: Mapping[str, ParamSpec] = dataclasses.field(default_factory=dict)
    ic_params: Mapping[str, ParamSpec] = dataclasses.field(
        default_factory=dict)
    init_fields: Callable[..., dict] | None = None
    analyses: Mapping[str, Callable] = dataclasses.field(default_factory=dict)

    # -- parameter plumbing ---------------------------------------------------
    def split_kwargs(self, kw: Mapping[str, Any]) -> tuple[dict, dict]:
        """Split mixed per-run kwargs into ``(builder_kw, ic_kw)``.

        IC-schema keys go to ``init_fields`` (with defaults filled in);
        everything else — runtime parameters and static solver knobs
        (``jacobi_iters``, ``dt``, ...) — flows to the builder, whose
        :class:`CFDConfig` constructor rejects unknown names.
        """
        kw = dict(kw)
        ic = {k: v.default for k, v in self.ic_params.items()}
        for k in list(kw):
            if k in self.ic_params:
                ic[k] = kw.pop(k)
        return kw, ic

    def config(self, n: int = 32, **kw) -> CFDConfig:
        """The scenario's :class:`CFDConfig` at resolution ``n``."""
        builder_kw, _ = self.split_kwargs(kw)
        return self.builder(n, **builder_kw)

    # -- schedule wiring ------------------------------------------------------
    def initial_state(self, solver: NavierStokes3D, **ic_kw) -> dict:
        """INITIAL bin, as a plain call: allocate + scenario IC."""
        return self.schedule(solver, ic=ic_kw).compile_bin("INITIAL")({})

    def schedule(self, solver: NavierStokes3D, step_fn: Callable | None = None,
                 ic: Mapping[str, Any] | None = None) -> Schedule:
        """The scenario's schedule tree against a concrete solver.

        INITIAL composes field allocation with the scenario IC (ordered
        AFTER allocation); EVOLVE holds the solver step (``step_fn``
        defaults to ``solver.make_step()``); ANALYSIS entries accumulate
        diagnostics into ``state["diagnostics"]`` reading run context from
        ``state["_ctx"]``.
        """
        _, ic_kw = self.split_kwargs(dict(ic or {}))
        sched = Schedule()
        sched.register("INITIAL", "allocate_fields")(
            lambda _state: solver.init_state())
        if self.init_fields is not None:
            sched.register("INITIAL", f"ic_{self.name}",
                           after=("allocate_fields",))(
                lambda state: self.init_fields(solver, state, **ic_kw))
        if step_fn is None:
            # build the step on first use, so running only the INITIAL or
            # ANALYSIS bin never builds the parameter tensors
            cache: list = []

            def step_fn(state):
                if not cache:
                    cache.append(solver.make_step())
                return cache[0](state)
        sched.register("EVOLVE", "ns3d_step")(step_fn)
        for diag_name, fn in self.analyses.items():
            def entry(state, fn=fn, diag_name=diag_name):
                diags = dict(state.get("diagnostics", {}))
                diags[diag_name] = fn(solver, state, state.get("_ctx", {}))
                return dict(state, diagnostics=diags)
            sched.register("ANALYSIS", diag_name)(entry)
        return sched

    def analyze(self, solver: NavierStokes3D, state: dict,
                ctx: Mapping[str, Any] | None = None) -> dict:
        """Run the ANALYSIS bin over ``state``; returns the diagnostics."""
        st = dict(state, _ctx=dict(ctx or {}), diagnostics={})
        return self.schedule(solver).compile_bin("ANALYSIS")(st)["diagnostics"]

    # -- farm intake ----------------------------------------------------------
    def request(self, n: int = 32, *, steps: int | None = None,
                t_end: float | None = None, tag: str = "",
                steady_tol: float | None = None,
                residual_tol: float | None = None, priority: int = 0,
                config: CFDConfig | None = None, device="cpu", **kw):
        """A :class:`~repro_torch.sim.farm.SimRequest` for one run of this
        scenario.  When the scenario owns an IC, the initial fields are
        built on ``device`` (the farm's, so that they equal a serial run's
        bitwise) and ride in ``init_state`` as CPU tensors: per-request
        ICs under one batched step.

        ``config`` short-circuits the builder with an already-resolved
        CFDConfig (the Runtime passes its fully-configured one, so step
        counts and the executed config can never drift apart); only
        IC-schema kwargs are honoured alongside it.
        """
        from repro_torch.sim.farm import SimRequest   # lazy: avoid a cycle

        builder_kw, ic_kw = self.split_kwargs(kw)
        cfg = config if config is not None else self.builder(n, **builder_kw)
        if steps is None:
            if t_end is None:
                raise ValueError("give either steps= or t_end=")
            steps = int(round(t_end / cfg.dt))
        init_state = None
        if self.init_fields is not None:
            # the global grid's fields: a decomposed farm cuts each
            # rank's block from them
            solver = NavierStokes3D(
                dataclasses.replace(cfg, decomposition=()), device)
            state = self.init_fields(solver, solver.init_state(), **ic_kw)
            init_state = {k: v.cpu() for k, v in state.items()}
        return SimRequest(config=cfg, steps=steps,
                          tag=tag or f"{self.name}-{n}",
                          steady_tol=steady_tol, residual_tol=residual_tol,
                          priority=priority, init_state=init_state)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Scenario] = {}


def register_scenario(obj=None, *, replace: bool = False):
    """Register a :class:`Scenario` — as a plain call, or as a decorator
    over a zero-argument factory function (the factory is invoked once at
    registration; the decorator returns the Scenario)."""
    def _register(scenario: Scenario) -> Scenario:
        if callable(scenario) and not isinstance(scenario, Scenario):
            scenario = scenario()
        if not isinstance(scenario, Scenario):
            raise TypeError(f"expected a Scenario, got {type(scenario)!r}")
        if scenario.name in _REGISTRY and not replace:
            raise ValueError(
                f"scenario {scenario.name!r} is already registered "
                "(pass replace=True to override)")
        _REGISTRY[scenario.name] = scenario
        return scenario

    if obj is None:             # @register_scenario(replace=...)
        return _register
    return _register(obj)       # @register_scenario / register_scenario(s)


def unregister_scenario(name: str) -> None:
    """Remove a registered scenario (tests / plugin teardown)."""
    _REGISTRY.pop(name, None)


def get_scenario(name) -> Scenario:
    """Resolve a scenario by name (a Scenario passes through unchanged)."""
    if isinstance(name, Scenario):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownScenarioError(
            f"unknown scenario {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def scenario_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in scenarios
# ---------------------------------------------------------------------------
def _cavity_builder(n: int = 32, **kw) -> CFDConfig:
    from repro_torch.cfd import cavity

    return cavity.config(n, **kw)


def _cavity_ghia(solver, state, ctx):
    from repro_torch.cfd import cavity

    return cavity.ghia_errors(solver, state)


def _cavity_centerline_u(solver, state, ctx):
    from repro_torch.cfd import cavity

    return cavity.centerline_u(solver, state)


def _kinetic_energy(solver, state, ctx):
    return solver.kinetic_energy(state)


register_scenario(Scenario(
    name="cavity",
    description="Lid-driven cavity (z-periodic quasi-2D), validated "
                "against Ghia et al. (1982) centerline profiles",
    builder=_cavity_builder,
    params={"re": ParamSpec(100.0, "Reynolds number (sets nu = 1/re)"),
            "lid_velocity": ParamSpec(1.0, "lid speed in +x at the y-hi "
                                           "wall")},
    analyses={"ghia": _cavity_ghia,
              "centerline_u": _cavity_centerline_u,
              "kinetic_energy": _kinetic_energy},
))


def _tg_builder(n: int = 32, **kw) -> CFDConfig:
    from repro_torch.cfd import taylor_green

    return taylor_green.config(n, **kw)


def _tg_error(solver, state, ctx):
    from repro_torch.cfd import taylor_green

    t = float(ctx.get("t", 0.0))
    ax, ay = taylor_green.analytic(solver, t)
    # both reductions in one host fetch
    ex, ey = torch.stack([(state["vx"] - ax).abs().max(),
                          (state["vy"] - ay).abs().max()]).cpu().tolist()
    return {"t": t, "err_vx": ex, "err_vy": ey}


register_scenario(Scenario(
    name="taylor_green",
    description="Periodic Taylor-Green vortex with analytic decay "
                "(end-to-end solver validation)",
    builder=_tg_builder,
    params={"nu": ParamSpec(0.1, "kinematic viscosity (decay rate)")},
    analyses={"analytic_error": _tg_error,
              "kinetic_energy": _kinetic_energy},
))


# -- Kelvin-Helmholtz: the "third-party thorn" --------------------------------
def _kh_builder(n: int = 32, nz: int = 4, nu: float = 2e-3,
                dt: float | None = None, **kw) -> CFDConfig:
    h = 2.0 * math.pi / n
    dt = dt if dt is not None else min(0.2 * h, 0.2 * h * h / (6 * nu))
    kw.setdefault("jacobi_iters", 60)
    return CFDConfig(shape=(n, n, nz), extent=2.0 * math.pi, nu=nu, dt=dt,
                     case="kelvin_helmholtz", **kw)


def _kh_init(solver, state, *, delta: float, eps: float) -> dict:
    """Double shear layer on the periodic box [0, 2pi]^2 (z-invariant):
    vx = tanh across two interfaces at y = pi/2 and y = 3pi/2, seeded with
    a sinusoidal vy perturbation that triggers the roll-up.  Fields are
    sampled at their staggered face positions (see taylor_green.analytic).
    """
    x, y, _ = solver.driver.coords()
    vx = torch.where(y < math.pi,
                     torch.tanh((y - 0.5 * math.pi) / delta),
                     torch.tanh((1.5 * math.pi - y) / delta))
    vy = eps * torch.sin(x)
    return dict(state, vx=vx.to(torch.float32), vy=vy.to(torch.float32))


def _kh_amplitude(solver, state, ctx):
    """max |vy|: the instability amplitude (grows through roll-up)."""
    return float(state["vy"].abs().max())


@register_scenario
def kelvin_helmholtz() -> Scenario:
    return Scenario(
        name="kelvin_helmholtz",
        description="Double shear layer on the periodic box: "
                    "Kelvin-Helmholtz roll-up from a seeded perturbation",
        builder=_kh_builder,
        params={"nu": ParamSpec(2e-3, "kinematic viscosity")},
        ic_params={"delta": ParamSpec(math.pi / 15, "shear layer width"),
                   "eps": ParamSpec(0.05, "vy perturbation amplitude")},
        init_fields=_kh_init,
        analyses={"amplitude": _kh_amplitude,
                  "kinetic_energy": _kinetic_energy},
    )
