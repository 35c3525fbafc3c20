"""repro_torch.api — the runtime front door: serial runs and the farm.

Applications declare *what* to run (a registered
:class:`~repro_torch.sim.scenarios.Scenario` + per-run parameters) and a
:class:`RuntimeConfig` declares *where/how* (resolution, device, kernel
backend, slots, static solver overrides); the :class:`Runtime` resolves a
serial solver step, or a ``SimulationService`` farm per static signature:

    rt = repro_torch.api.runtime(n=256, nz=256)     # device="cuda" default
    res = rt.run("cavity", steps=20, re=100.0)      # one run, blocking
    sid = rt.submit("cavity", steps=400, re=250.0)  # farm intake
    rt.result(sid)                                  # ... poll/evict/drain

Not ported in this slice, each raising ``NotImplementedError`` that names
its ROADMAP item: telemetry, health, ``ckpt_dir``, the job store and
``enqueue``/``claim``/``recover`` (queue 1, item 8); meshes and
decomposition (item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D
from repro_torch.core.schedule import Schedule
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.sim.farm import SimResult, not_ported, static_key
from repro_torch.sim.scenarios import (
    ParamSpec, Scenario, UnknownScenarioError, get_scenario,
    register_scenario, scenario_names, unregister_scenario,
)
from repro_torch.sim.service import SimulationService

__all__ = [
    "BACKENDS", "ParamSpec", "PreparedRun", "RunResult", "Runtime",
    "RuntimeConfig", "Scenario", "SimResult", "UnknownScenarioError",
    "get_scenario", "register_scenario", "runtime", "scenario_names",
    "unregister_scenario",
]

# backend name -> (CFDConfig.template, overlap override)
# "torch" is the eager template on any device (the reference's "jnp");
# "cuda" runs the hand-written kernels and, like the reference's "pallas",
# turns the interior/boundary split off: the monolithic kernel covers the
# whole interior in one launch, and the split would add six thin-shell
# launches per step for no overlap gain on one device.
# "auto" resolves AT CONFIGURE TIME to "cuda" on the card and "torch" on
# the CPU — the resolved config always carries an explicit template.
BACKENDS = {
    "torch": ("TORCH", None),
    "cuda": ("CUDA", False),
    "auto": None,
}


def _resolve_backend(name: str, device: torch.device) -> tuple:
    return BACKENDS[resolve_backend(name, device).lower()]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Everything the runtime needs to resolve an execution stack.

    ``device`` is where fields live (``None`` -> ``cuda``; resolved when the
    :class:`Runtime` is built, which raises without a card).  ``n_slots``
    is the slot count of each farm.  ``solver`` carries static solver
    overrides (``jacobi_iters``, ``fused_sweeps``, ``overlap``, ...)
    applied to every scenario config this runtime builds.  The postures
    after ``solver`` are the reference's; the port takes only their
    defaults (off) so far and raises on any other value.
    """

    n: int = 32                          # grid resolution (n, n, nz)
    nz: int | None = None                # None -> scenario default
    backend: str = "auto"                # see BACKENDS
    device: str | None = None            # None -> "cuda"
    n_slots: int = 4                     # farm slots per service
    check_every: int = 16                # convergence-check interval
    solver: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    ckpt_dir: str | None = None          # queue 1, item 8
    telemetry: Any = False               # queue 1, item 8
    health: Any = False                  # queue 1, item 8
    store: Any = None                    # queue 1, item 8
    mesh_shape: tuple = ()               # queue 1, item 9
    decomposition: tuple = ()            # queue 1, item 9

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(have {sorted(BACKENDS)})")
        for what in ("ckpt_dir", "telemetry", "health", "store",
                     "decomposition"):
            if getattr(self, what):
                raise not_ported(what)
        if self.mesh_shape:
            raise not_ported("mesh")


@dataclasses.dataclass
class RunResult:
    """A finished single run: host state (CPU tensors) + diagnostics."""

    scenario: str
    state: dict
    steps_done: int
    terminated: str              # "steps" | "residual" | "steady"
    config: CFDConfig
    diagnostics: dict


@dataclasses.dataclass
class PreparedRun:
    """A resolved-but-not-run single simulation: the solver, its schedule,
    the initial state (INITIAL bin output) and the EVOLVE step.  The
    escape hatch for benchmarks and custom drive loops that need the raw
    step function while still resolving everything through the runtime."""

    scenario: Scenario
    solver: NavierStokes3D
    schedule: Schedule
    state: dict
    step: Callable[[dict], dict]
    config: CFDConfig

    def analyze(self, state: dict, steps_done: int = 0) -> dict:
        ctx = {"t": steps_done * self.config.dt, "steps": steps_done}
        return self.scenario.analyze(self.solver, state, ctx)


def _residual_norm(new: dict, old: dict, dt: float) -> torch.Tensor:
    """``||u_new - u_old||_inf / dt`` over the velocity fields, on the
    device."""
    m = torch.stack([(new[f] - old[f]).abs().max()
                     for f in ("vx", "vy", "vz")]).max()
    # divide by a float32 tensor on the device, as the farm does with its
    # per-slot dt (a Python divisor becomes a reciprocal multiply on the card)
    return m / torch.full((), max(dt, 1e-30), dtype=torch.float32,
                          device=m.device)


class Runtime:
    """The front door: resolves scenarios against one RuntimeConfig."""

    def __init__(self, config: RuntimeConfig | None = None):
        self.config = config if config is not None else RuntimeConfig()
        self.device = resolve_device(self.config.device)
        self._services: dict[tuple, SimulationService] = {}
        self._routes: dict[int, tuple[SimulationService, int]] = {}
        self._failed: dict[int, SimResult] = {}
        self._scenario_of: dict[int, str] = {}
        self._next_sid = 0

    # -- resolution -----------------------------------------------------------
    def configure(self, scenario, n: int | None = None, **kw) -> CFDConfig:
        """The fully-resolved CFDConfig for ``scenario`` under this
        runtime: scenario builder -> static solver overrides -> backend
        template."""
        sc = get_scenario(scenario)
        template, overlap = _resolve_backend(self.config.backend, self.device)
        builder_kw = dict(self.config.solver)
        if self.config.nz is not None:
            builder_kw["nz"] = self.config.nz
        builder_kw.update(kw)
        cfg = sc.config(self.config.n if n is None else n, **builder_kw)
        return dataclasses.replace(
            cfg, template=template,
            overlap=cfg.overlap if overlap is None else overlap)

    def prepare(self, scenario, n: int | None = None,
                **params) -> PreparedRun:
        """Resolve one serial run: solver, schedule, INITIAL state, EVOLVE
        step."""
        sc = get_scenario(scenario)
        builder_kw, ic_kw = sc.split_kwargs(params)
        cfg = self.configure(sc, n=n, **builder_kw)
        solver = NavierStokes3D(cfg, self.device)
        sched = sc.schedule(solver, ic=ic_kw)
        state = sched.compile_bin("INITIAL")({})
        step = sched.compile_bin("EVOLVE")
        return PreparedRun(scenario=sc, solver=solver, schedule=sched,
                           state=state, step=step, config=cfg)

    # -- single-run drive -----------------------------------------------------
    def run(self, scenario, *, n: int | None = None,
            steps: int | None = None,
            t_end: float | None = None, residual_tol: float | None = None,
            steady_tol: float | None = None, progress: int | None = None,
            **params) -> RunResult:
        """Run one simulation to completion, blocking.

        Termination: ``steps``/``t_end`` bound the run; ``residual_tol``
        additionally stops at steady state once
        ``||u^{n+1} - u^n||_inf / dt`` falls below it (checked every
        ``RuntimeConfig.check_every`` steps, one host sync per check);
        ``steady_tol`` is the legacy kinetic-energy-drift heuristic.
        Convergence checks read snapshots; they never perturb the state.
        """
        pr = self.prepare(scenario, n=n, **params)
        cfg = pr.config
        if steps is None:
            if t_end is None:
                raise ValueError("give either steps= or t_end=")
            steps = int(round(t_end / cfg.dt))
        check = max(int(self.config.check_every), 1)
        state, terminated, done = pr.state, "steps", 0
        ke_prev: float | None = None
        for i in range(steps):
            # keep the previous state only when this step lands on a
            # residual check boundary
            prev = state if (residual_tol is not None
                             and (i + 1) % check == 0) else None
            state = pr.step(state)
            done = i + 1
            if progress and (done % progress == 0):
                print(f"  step {done:6d}/{steps} "
                      f"t={done * cfg.dt:8.3f} "
                      f"KE={pr.solver.kinetic_energy(state):.6f}")
            if residual_tol is not None and done % check == 0:
                resid = float(_residual_norm(state, prev, cfg.dt))
                if resid <= residual_tol:
                    terminated = "residual"
                    break
            if steady_tol is not None and done % check == 0:
                ke = pr.solver.kinetic_energy(state)
                if ke_prev is not None and abs(ke - ke_prev) <= \
                        steady_tol * max(abs(ke), 1e-12):
                    terminated = "steady"
                    break
                ke_prev = ke
        diagnostics = pr.analyze(state, done)
        return RunResult(scenario=pr.scenario.name,
                         state={k: v.cpu() for k, v in state.items()},
                         steps_done=done, terminated=terminated, config=cfg,
                         diagnostics=diagnostics)

    # -- ensemble / service routing -------------------------------------------
    def _service_for(self, cfg: CFDConfig
                     ) -> tuple[SimulationService | None, str | None]:
        key = static_key(cfg, self.config.n_slots)
        if key in self._services:
            return self._services[key], None
        try:
            svc = SimulationService(
                cfg, n_slots=self.config.n_slots,
                check_steady_every=self.config.check_every,
                device=self.device)
        except Exception as e:
            return None, f"{type(e).__name__}: {e}"
        self._services[key] = svc
        return svc, None

    def submit(self, scenario, *, n: int | None = None,
               steps: int | None = None,
               t_end: float | None = None, tag: str = "",
               steady_tol: float | None = None,
               residual_tol: float | None = None, priority: int = 0,
               **params) -> int:
        """Queue one simulation on the farm; returns its sid.

        Requests of an unseen static signature lazily build their
        ``SimulationService``; a signature whose stack cannot build
        resolves this sid to a ``terminated="failed"`` result (surfaced by
        ``poll``/``result``/``drain``) rather than raising into the submit
        path or blocking a later drain.
        """
        sc = get_scenario(scenario)
        builder_kw, ic_kw = sc.split_kwargs(params)
        cfg = self.configure(sc, n=n, **builder_kw)
        req = sc.request(
            self.config.n if n is None else n, config=cfg,
            steps=steps, t_end=t_end, tag=tag,
            steady_tol=steady_tol, residual_tol=residual_tol,
            priority=priority, device=self.device, **ic_kw)
        sid = self._next_sid
        self._next_sid += 1
        self._scenario_of[sid] = sc.name
        svc, err = self._service_for(cfg)
        if svc is None:
            self._failed[sid] = SimResult(
                sid=sid, tag=req.tag, steps_done=0, terminated="failed",
                state={}, config=cfg, error=err)
            return sid
        self._routes[sid] = (svc, svc.submit(req))
        return sid

    def poll(self, sid: int) -> dict:
        if sid in self._failed:
            res = self._failed[sid]
            return {"status": "failed", "steps_done": 0, "error": res.error}
        if sid not in self._routes:
            raise KeyError(f"unknown simulation id {sid}")
        svc, inner = self._routes[sid]
        return svc.poll(inner)

    def result(self, sid: int, block: bool = True) -> SimResult:
        if sid in self._failed:
            res = self._failed[sid]
            raise RuntimeError(
                f"simulation {sid} ({res.tag or 'untagged'}) failed: "
                f"{res.error}")
        if sid not in self._routes:
            raise KeyError(f"unknown simulation id {sid}")
        svc, inner = self._routes[sid]
        return dataclasses.replace(svc.result(inner, block=block), sid=sid)

    def evict(self, sid: int) -> bool:
        if sid not in self._routes:
            return False
        svc, inner = self._routes[sid]
        return svc.evict(inner)

    def readmit(self, sid: int) -> bool:
        if sid not in self._routes:
            return False
        svc, inner = self._routes[sid]
        return svc.readmit(inner)

    def drain(self, max_device_steps: int = 100_000) -> dict[int, SimResult]:
        """Run every farm dry; always returns one result per submitted sid,
        failed sims included (``terminated="failed"`` + error)."""
        for svc in self._services.values():
            svc.drain(max_device_steps)
        out: dict[int, SimResult] = {}
        for sid, (svc, inner) in self._routes.items():
            res = svc.farm.results.get(inner)
            if res is not None:
                out[sid] = dataclasses.replace(res, sid=sid)
        out.update(self._failed)
        return out

    def enqueue(self, *args, **kw):
        raise not_ported("enqueue")

    def claim(self, *args, **kw):
        raise not_ported("claim")

    def recover(self, *args, **kw):
        raise not_ported("recover")

    # -- introspection --------------------------------------------------------
    def device_steps(self) -> int:
        """Total batched steps across every resolved farm."""
        return sum(svc.farm.device_steps for svc in self._services.values())

    def services(self) -> tuple[SimulationService, ...]:
        return tuple(self._services.values())

    def analyze(self, result: RunResult | SimResult) -> dict:
        """Scenario ANALYSIS diagnostics for a finished run (equal to
        ``result.diagnostics``) or farm result, recomputed on this
        runtime's device."""
        if isinstance(result, RunResult):
            sc = get_scenario(result.scenario)
        else:
            sc = get_scenario(self._scenario_of[result.sid])
        solver = NavierStokes3D(result.config, self.device)
        state = {k: v.to(self.device) for k, v in result.state.items()}
        ctx = {"t": result.steps_done * result.config.dt,
               "steps": result.steps_done}
        return sc.analyze(solver, state, ctx)


def runtime(n: int = 32, *, backend: str = "auto", device: str | None = None,
            n_slots: int = 4, check_every: int = 16, nz: int | None = None,
            ckpt_dir: str | None = None, telemetry: Any = False,
            health: Any = False, store: Any = None, mesh_shape: tuple = (),
            decomposition: tuple = (), mesh=None, **solver) -> Runtime:
    """Build a :class:`Runtime` — the one-call front door.

    >>> rt = repro_torch.api.runtime(n=48)
    >>> res = rt.run("cavity", t_end=12.0, re=100.0)
    >>> res.diagnostics["ghia"]
    >>> sids = [rt.submit("cavity", steps=100, re=re) for re in (50, 100)]
    >>> rt.drain()
    """
    if mesh is not None:
        raise not_ported("mesh")
    cfg = RuntimeConfig(n=n, nz=nz, backend=backend, device=device,
                        n_slots=n_slots, check_every=check_every,
                        solver=dict(solver), ckpt_dir=ckpt_dir,
                        telemetry=telemetry, health=health, store=store,
                        mesh_shape=tuple(mesh_shape),
                        decomposition=tuple(decomposition))
    return Runtime(cfg)
