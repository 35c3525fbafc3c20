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

The reference's observability and durability postures come with it:
``telemetry`` (timers, metrics, lifecycle traces; :meth:`Runtime.report`,
and with it the perf accounting, :meth:`Runtime.perf_report`),
``health`` (in-situ diagnostics, NaN quarantine, flight records;
:meth:`Runtime.watch`), ``ckpt_dir`` (evictions spilled to disk) and
``store`` (the durable job store: ``enqueue``/``claim``/``recover``, a
restart resumes incomplete work first).

Meshes: ``mesh_shape``/``mesh_axes`` lay the ranks of an initialised
``torch.distributed`` process group out as a mesh (built when the Runtime
is; ``repro_torch.launch.mesh.spawn`` starts the ranks), and
``decomposition`` splits each run's grid over named mesh axes, as the
reference's front door does.  Every rank builds the same Runtime and makes
the same calls.  A serial run returns the gathered global fields on every
rank; a farm result carries its fields on global rank 0
(``repro_torch.sim.farm``).  A job store on a mesh is global rank 0's
alone (:class:`repro_torch.jobs.MeshStore`): rank 0 opens it, holds the
leases and writes rows, events and snapshots, and every answer it gives
(job ids, claimed rows, ``jobs()``, whether ``drain`` claims once more)
reaches every rank, so ``job_id``, ``jobs`` and ``poll`` agree on every
rank.  ``load_result`` and ``flight_record`` follow the farm's rule:
metadata on every rank, fields on rank 0 (``{}`` elsewhere).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Mapping

import torch

from repro_torch import obs
from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D
from repro_torch.core.schedule import Schedule
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.sim.ensemble import plan_decomposition
from repro_torch.sim.farm import SimResult, static_key
from repro_torch.sim.scenarios import (
    ParamSpec, Scenario, UnknownScenarioError, get_scenario,
    register_scenario, scenario_names, unregister_scenario,
)
from repro_torch.sim.service import SimulationService

__all__ = [
    "BACKENDS", "ParamSpec", "PreparedRun", "RunResult", "Runtime",
    "RuntimeConfig", "Scenario", "SimResult", "UnknownScenarioError",
    "compile_cache_stats", "get_scenario", "register_scenario", "runtime",
    "scenario_names", "unregister_scenario",
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


def compile_cache_stats() -> dict:
    """Process-wide ensemble-step cache stats (re-export)."""
    from repro_torch.sim.farm import compile_cache_stats as _stats

    return _stats()


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Everything the runtime needs to resolve an execution stack.

    ``device`` is where fields live (``None`` -> ``cuda``; resolved when the
    :class:`Runtime` is built, which raises without a card).  ``n_slots``
    is the slot count of each farm.  ``solver`` carries static solver
    overrides (``jacobi_iters``, ``fused_sweeps``, ``overlap``, ...)
    applied to every scenario config this runtime builds.  The postures
    after ``solver`` are the reference's: ``ckpt_dir``, ``telemetry``,
    ``health`` and ``store`` as it takes them.  ``mesh_shape``/``mesh_axes``
    name the mesh of ranks (an empty shape means one process);
    ``decomposition`` maps grid axes to mesh axes, validated and degraded
    (extent-1 axes dropped) by the farm's ``plan_decomposition`` rules.
    """

    n: int = 32                          # grid resolution (n, n, nz)
    nz: int | None = None                # None -> scenario default
    backend: str = "auto"                # see BACKENDS
    device: str | None = None            # None -> "cuda"
    n_slots: int = 4                     # farm slots per service
    check_every: int = 16                # convergence-check interval
    solver: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    ckpt_dir: str | None = None          # eviction spill directory
    # observability: False (default, invisible), True, a
    # repro_torch.obs.TelemetryConfig / Telemetry, or a TelemetryConfig
    # kwargs dict ({"trace_path": ...}); see repro_torch.obs.resolve
    telemetry: Any = False
    # in-situ health + NaN quarantine on the farm: False (default), True, a
    # HealthConfig or its kwargs; flight records default to
    # <ckpt_dir>/flight.  Independent of telemetry.
    health: Any = False
    # the durable job store: None (default), a JobStore, True
    # (<ckpt_dir>/jobs.sqlite), a sqlite path, or JobStore kwargs; see
    # repro_torch.jobs.resolve_store
    store: Any = None
    mesh_shape: tuple = ()               # e.g. (2, 2)
    mesh_axes: tuple = ()                # e.g. ("slot", "shard")
    slot_axis: str = "slot"              # farm slot axis when meshed
    decomposition: tuple = ()            # e.g. ((0, "shard"),)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(have {sorted(BACKENDS)})")
        if bool(self.mesh_shape) != bool(self.mesh_axes) or \
                len(self.mesh_shape) != len(self.mesh_axes):
            raise ValueError(
                f"mesh_shape {self.mesh_shape!r} and mesh_axes "
                f"{self.mesh_axes!r} must pair up axis-for-axis")


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


def _residual_norm(new: dict, old: dict, dt: float,
                   driver=None) -> torch.Tensor:
    """``||u_new - u_old||_inf / dt`` over the velocity fields, on the
    device (over every rank's block when ``driver`` is decomposed)."""
    m = torch.stack([(new[f] - old[f]).abs().max()
                     for f in ("vx", "vy", "vz")]).max()
    if driver is not None and driver.links:
        m = driver.pmax(m)
    # divide by a float32 tensor on the device, as the farm does with its
    # per-slot dt (a Python divisor becomes a reciprocal multiply on the card)
    return m / torch.full((), max(dt, 1e-30), dtype=torch.float32,
                          device=m.device)


class Runtime:
    """The front door: resolves scenarios against one RuntimeConfig.

    With a job store, building the Runtime first runs :meth:`recover`:
    in-flight jobs whose process died resume before any queued work is
    claimed.  ``mesh`` (a ``DeviceMesh``) wins over the config's
    ``mesh_shape``, which is built here, on every rank.  With both, the
    store is opened on global rank 0 alone (``jobs.resolve_store``); a
    ``JobStore`` handed in on another rank is closed there and ignored."""

    def __init__(self, config: RuntimeConfig | None = None, mesh=None):
        from repro_torch.jobs import resolve_store

        self.config = config if config is not None else RuntimeConfig()
        self.device = resolve_device(self.config.device)
        if mesh is None and self.config.mesh_shape:
            from repro_torch.launch.mesh import make_mesh

            mesh = make_mesh(self.config.mesh_shape, self.config.mesh_axes)
        self.mesh = mesh
        # one telemetry handle per runtime, shared by its farms; NULL when
        # disabled, which makes every hook a no-op
        self.telemetry = obs.resolve(self.config.telemetry)
        health = obs.resolve_health(self.config.health)
        if (health is not None and health.flight_dir is None
                and self.config.ckpt_dir is not None):
            health = dataclasses.replace(
                health,
                flight_dir=os.path.join(self.config.ckpt_dir, "flight"))
        self.health = health
        self._services: dict[tuple, SimulationService] = {}
        self._routes: dict[int, tuple[SimulationService, int]] = {}
        self._failed: dict[int, SimResult] = {}
        self._scenario_of: dict[int, str] = {}
        # latest PreparedRun per scenario, kept only under telemetry so the
        # perf accounting can trace the serial EVOLVE bin; the off path
        # pins no extra field state
        self._prepared: dict[str, PreparedRun] = {}
        self._next_sid = 0
        self.store = resolve_store(self.config.store, self.config.ckpt_dir,
                                   mesh=self.mesh)
        # job_ids this process admitted itself: a claim never returns one
        # of them, even if its lease lapsed between two heartbeats
        self._jobs_local: set[int] = set()
        if self.store is not None:
            self.recover()

    # -- resolution -----------------------------------------------------------
    def configure(self, scenario, n: int | None = None, **kw) -> CFDConfig:
        """The fully-resolved CFDConfig for ``scenario`` under this
        runtime: scenario builder -> static solver overrides -> backend
        template -> decomposition."""
        sc = get_scenario(scenario)
        template, overlap = _resolve_backend(self.config.backend, self.device)
        builder_kw = dict(self.config.solver)
        if self.config.nz is not None:
            builder_kw["nz"] = self.config.nz
        builder_kw.update(kw)
        cfg = sc.config(self.config.n if n is None else n, **builder_kw)
        return dataclasses.replace(
            cfg, template=template,
            overlap=cfg.overlap if overlap is None else overlap,
            decomposition=tuple(self.config.decomposition) or
            cfg.decomposition)

    def _slot_axis(self) -> str | None:
        if self.mesh is None:
            return None
        names = self.mesh.mesh_dim_names
        return self.config.slot_axis if self.config.slot_axis in names \
            else None

    def prepare(self, scenario, n: int | None = None,
                **params) -> PreparedRun:
        """Resolve one serial run: solver (+ decomposition over the mesh's
        shard axes), schedule, INITIAL state, EVOLVE step.  On a mesh every
        rank prepares its block; the slot axis, if any, holds copies."""
        sc = get_scenario(scenario)
        builder_kw, ic_kw = sc.split_kwargs(params)
        cfg = self.configure(sc, n=n, **builder_kw)
        # the farm's resolution rules: validate against the mesh, drop
        # extent-1 axes, run meshless when nothing decomposes
        solver_cfg, active = plan_decomposition(cfg, self.mesh,
                                                slot_axis=self._slot_axis())
        solver = NavierStokes3D(solver_cfg, self.device,
                                self.mesh if active else None)
        sched = sc.schedule(solver, ic=ic_kw)
        tel = self.telemetry if self.telemetry.enabled else None
        state = sched.compile_bin("INITIAL", telemetry=tel)({})
        step = sched.compile_bin("EVOLVE", telemetry=tel)
        pr = PreparedRun(scenario=sc, solver=solver, schedule=sched,
                         state=state, step=step, config=cfg)
        if self.telemetry.enabled:
            self._prepared[sc.name] = pr
        return pr

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
        On a decomposed grid the checks reduce over the ranks, and the
        result holds the gathered global fields on every rank.
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
        with self.telemetry.span(f"run.{pr.scenario.name}"):
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
                    resid = float(_residual_norm(state, prev, cfg.dt,
                                                 pr.solver.driver))
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
        if self.telemetry.enabled:
            self.telemetry.metrics.inc("sim.steps_total", done)
        if pr.solver.driver.links:
            whole = {k: pr.solver.driver.gather(v) for k, v in state.items()}
            whole_solver = NavierStokes3D(
                dataclasses.replace(cfg, decomposition=()), self.device)
            diagnostics = pr.scenario.analyze(
                whole_solver, {k: v.to(self.device) for k, v in whole.items()},
                {"t": done * cfg.dt, "steps": done})
        else:
            whole = {k: v.cpu() for k, v in state.items()}
            diagnostics = pr.analyze(state, done)
        return RunResult(scenario=pr.scenario.name, state=whole,
                         steps_done=done, terminated=terminated, config=cfg,
                         diagnostics=diagnostics)

    # -- ensemble / service routing -------------------------------------------
    def _service_for(self, cfg: CFDConfig
                     ) -> tuple[SimulationService | None, str | None]:
        key = static_key(cfg, self.config.n_slots)
        if key in self._services:
            return self._services[key], None
        ckpt = None
        if self.config.ckpt_dir is not None:
            # one spill directory per signature: service-local sids double
            # as checkpoint step keys and must not collide across farms
            ckpt = os.path.join(self.config.ckpt_dir,
                                f"sig{len(self._services):03d}")
        try:
            svc = SimulationService(
                cfg, n_slots=self.config.n_slots,
                check_steady_every=self.config.check_every,
                device=self.device, ckpt_dir=ckpt, mesh=self.mesh,
                slot_axis=self.config.slot_axis,
                telemetry=self.telemetry, health=self.health,
                farm_id=f"{cfg.case}/sig{len(self._services):03d}",
                store=self.store)
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
            if self.store is not None:
                # even a sim whose stack cannot build leaves a durable row:
                # submitted, failed, never silently dropped
                from repro_torch import jobs

                jid = self.store.submit(
                    req, signature=str(static_key(cfg, self.config.n_slots)),
                    lease=True)
                self.store.transition(jid, jobs.FAILED, error=err,
                                      event="result")
                self._jobs_local.add(jid)
            self._failed[sid] = SimResult(
                sid=sid, tag=req.tag, steps_done=0, terminated="failed",
                state={}, config=cfg, error=err)
            return sid
        inner = svc.submit(req)
        self._routes[sid] = (svc, inner)
        jid = svc.job_of(inner)
        if jid is not None:
            self._jobs_local.add(jid)
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

    # -- durable jobs (repro_torch.jobs) --------------------------------------
    def _job_gauges(self):
        if self.store is None or not self.telemetry.enabled:
            return
        self.telemetry.metrics.set("jobs.lease_takeovers",
                                   self.store.takeovers)
        self.telemetry.metrics.set("jobs.store_queue_depth",
                                   self.store.queue_depth())

    def _admit_job(self, job, resumed: bool = False) -> int:
        """Admit one claimed store row into this process's farms, resuming
        from its latest eviction snapshot when asked (on a mesh the
        snapshot is read on the store's writer, global rank 0, and
        scattered from there)."""
        from repro_torch import jobs

        req = job.request()
        if resumed:
            snap = self.store.latest_snapshot(job.job_id, "evict")
            if snap is not None and snap["fields"]:
                steps_done, state = self.store.load_snapshot(job.job_id,
                                                             "evict")
                req = dataclasses.replace(
                    req, init_state=state, step0=steps_done,
                    init_rank=jobs.WRITER if self.mesh is not None else None)
            # no snapshot: the job never reached a spill point, so it
            # restarts from its payload (step0 intact)
        sid = self._next_sid
        self._next_sid += 1
        self._jobs_local.add(job.job_id)
        svc, err = self._service_for(req.config)
        if svc is None:
            self.store.transition(job.job_id, jobs.FAILED, error=err,
                                  event="result")
            self._failed[sid] = SimResult(
                sid=sid, tag=req.tag, steps_done=0, terminated="failed",
                state={}, config=req.config, error=err)
            return sid
        try:
            inner = svc.submit(req, job_id=job.job_id)
        except Exception as e:
            # service.submit already moved the row to failed
            self._failed[sid] = SimResult(
                sid=sid, tag=req.tag, steps_done=0, terminated="failed",
                state={}, config=req.config,
                error=f"{type(e).__name__}: {e}")
            return sid
        self._routes[sid] = (svc, inner)
        return sid

    def enqueue(self, scenario, *, n: int | None = None,
                steps: int | None = None, t_end: float | None = None,
                tag: str = "", steady_tol: float | None = None,
                residual_tol: float | None = None, priority: int = 0,
                **params) -> int:
        """Queue one simulation durably WITHOUT admitting it here; returns
        its store job_id.  Any process sharing the store — this one
        included — picks it up through ``claim()``/``drain()``."""
        if self.store is None:
            raise RuntimeError(
                "enqueue() needs a job store — RuntimeConfig(store=...)")
        sc = get_scenario(scenario)
        builder_kw, ic_kw = sc.split_kwargs(params)
        cfg = self.configure(sc, n=n, **builder_kw)
        req = sc.request(
            self.config.n if n is None else n, config=cfg,
            steps=steps, t_end=t_end, tag=tag,
            steady_tol=steady_tol, residual_tol=residual_tol,
            priority=priority, device=self.device, **ic_kw)
        job_id = self.store.submit(
            req, signature=str(static_key(cfg, self.config.n_slots)),
            lease=False)
        if self.telemetry.enabled:
            self.telemetry.trace.emit("job_enqueue", job_id=job_id, tag=tag)
        self._job_gauges()
        return job_id

    def claim(self, max_jobs: int | None = None) -> list[int]:
        """Lease up to ``max_jobs`` queued store jobs (default: one farm's
        worth) and admit them here; returns their sids.  Jobs this process
        admitted itself are never claimed again."""
        if self.store is None:
            return []
        limit = max_jobs if max_jobs is not None else self.config.n_slots
        claimed = [j for j in self.store.claim(limit=limit)
                   if j.job_id not in self._jobs_local]
        sids = [self._admit_job(j) for j in claimed]
        if self.telemetry.enabled:
            for j in claimed:
                self.telemetry.trace.emit("job_claim", job_id=j.job_id,
                                          tag=j.tag)
        self._job_gauges()
        return sids

    def recover(self, limit: int = 64) -> list[int]:
        """Claim orphaned in-flight jobs (``running``/``evicted`` rows whose
        lease expired: their process died) and readmit each from its
        latest snapshot.  Runs when a store-configured Runtime is built,
        before any queued work is claimed."""
        if self.store is None:
            return []
        claimed = [j for j in self.store.claim_incomplete(limit=limit)
                   if j.job_id not in self._jobs_local]
        sids = [self._admit_job(j, resumed=True) for j in claimed]
        if self.telemetry.enabled:
            if claimed:
                self.telemetry.metrics.inc("jobs.resumed", len(claimed))
            for j in claimed:
                self.telemetry.trace.emit("job_resume", job_id=j.job_id,
                                          tag=j.tag, status=j.status)
        self._job_gauges()
        return sids

    def job_id(self, sid: int) -> int | None:
        """The durable job_id behind a sid (None without a store)."""
        if sid not in self._routes:
            return None
        svc, inner = self._routes[sid]
        return svc.job_of(inner)

    def jobs(self, status=None):
        """Store job rows (optionally filtered by status)."""
        if self.store is None:
            return []
        return self.store.jobs(status)

    def load_result(self, job_id: int) -> dict:
        """A done job's persisted final fields (CPU tensors), from any
        process; on a mesh, on global rank 0 (``{}`` on the others)."""
        if self.store is None:
            raise RuntimeError("load_result() needs a job store")
        return self.store.load_result(job_id)

    def flight_record(self, job_id: int) -> dict:
        """The flight record of a diverged job, resolved through its store
        registration — also after a restart, when the farm that recorded
        it is gone.  On a mesh it is read on global rank 0: its ``meta``
        and ``frames`` reach every rank, its ``state`` is ``{}`` on the
        others."""
        from repro_torch.jobs import MeshStore
        from repro_torch.obs.health import load_flight_record

        snap = (self.store.latest_snapshot(job_id, "flight")
                if self.store is not None else None)
        if snap is None:
            raise KeyError(f"job {job_id} has no registered flight record")
        if isinstance(self.store, MeshStore):
            return self.store.on_writer(
                load_flight_record, snap["dir"], snap["step_key"],
                strip=lambda rec: dict(rec, state={}))
        return load_flight_record(snap["dir"], snap["step_key"])

    def drain(self, max_device_steps: int = 100_000) -> dict[int, SimResult]:
        """Run every farm dry; always returns one result per submitted sid,
        failed sims included (``terminated="failed"``).  With a job store
        it also keeps claiming queued store jobs until the shared queue is
        empty (or every remaining job is leased by a live peer)."""
        while self.store is not None and self.claim():
            for svc in self._services.values():
                svc.drain(max_device_steps)
        for svc in self._services.values():
            svc.drain(max_device_steps)
        out: dict[int, SimResult] = {}
        for sid, (svc, inner) in self._routes.items():
            res = svc.farm.results.get(inner)
            if res is not None:
                out[sid] = dataclasses.replace(res, sid=sid)
        out.update(self._failed)
        return out

    def watch(self, refresh_s: float | None = None,
              iterations: int | None = None) -> str:
        """Live per-slot health dashboard over every farm (text).  Bare, it
        renders and returns one frame; with ``refresh_s`` it prints a frame
        every ``refresh_s`` seconds until the farms go idle (or
        ``iterations`` frames), returning the last."""
        import time

        from repro_torch.obs.health import render_dashboard

        def frame() -> str:
            return render_dashboard([svc.farm.health_snapshot()
                                     for svc in self._services.values()])

        if refresh_s is None:
            return frame()
        n, text = 0, frame()
        while True:
            text = frame()
            print(text, flush=True)
            n += 1
            if iterations is not None and n >= iterations:
                break
            if all(svc.farm.table.idle for svc in self._services.values()):
                break
            time.sleep(refresh_s)
        return text

    # -- introspection --------------------------------------------------------
    def device_steps(self) -> int:
        """Total batched steps across every resolved farm."""
        return sum(svc.farm.device_steps for svc in self._services.values())

    def services(self) -> tuple[SimulationService, ...]:
        return tuple(self._services.values())

    def perf_report(self, chip="auto", dtype: str = "f32"):
        """Cost-model-grounded accounting of every step this runtime ran:
        one :class:`repro_torch.obs.perf.PerfReport` row per farm signature
        and prepared serial scenario, with the predicted FLOPs and HBM bytes
        (the op-cost trace) joined against the measured spans (see
        ``repro_torch.obs.perf``)."""
        from repro_torch.obs import perf

        return perf.report_for_runtime(self, chip=chip, dtype=dtype)

    def report(self, perf: bool = False, chip="auto") -> str:
        """This runtime's telemetry report (timers + metrics); ``perf=True``
        appends the roofline-attributed perf accounting."""
        text = obs.report(self.telemetry)
        if perf:
            text += "\n" + self.perf_report(chip=chip).render()
        return text

    def analyze(self, result: RunResult | SimResult) -> dict:
        """Scenario ANALYSIS diagnostics for a finished run (equal to
        ``result.diagnostics``) or farm result, recomputed on this
        runtime's device."""
        if isinstance(result, RunResult):
            sc = get_scenario(result.scenario)
        else:
            sc = get_scenario(self._scenario_of[result.sid])
        solver = NavierStokes3D(
            dataclasses.replace(result.config, decomposition=()), self.device)
        state = {k: v.to(self.device) for k, v in result.state.items()}
        ctx = {"t": result.steps_done * result.config.dt,
               "steps": result.steps_done}
        return sc.analyze(solver, state, ctx)


def runtime(n: int = 32, *, backend: str = "auto", device: str | None = None,
            n_slots: int = 4, check_every: int = 16, nz: int | None = None,
            ckpt_dir: str | None = None, telemetry: Any = False,
            health: Any = False, store: Any = None, mesh_shape: tuple = (),
            mesh_axes: tuple = (), slot_axis: str = "slot",
            decomposition: tuple = (), mesh=None, **solver) -> Runtime:
    """Build a :class:`Runtime` — the one-call front door.

    >>> rt = repro_torch.api.runtime(n=48)
    >>> res = rt.run("cavity", t_end=12.0, re=100.0)
    >>> res.diagnostics["ghia"]
    >>> sids = [rt.submit("cavity", steps=100, re=re) for re in (50, 100)]
    >>> rt.drain()
    >>> rt = repro_torch.api.runtime(n=16, device="cpu", ckpt_dir="ck",
    ...                              store=True, health=True, telemetry=True)
    >>> print(rt.report())        # Cactus-style timers + farm metrics
    >>> print(rt.watch())         # per-slot health dashboard

    In each rank of ``repro_torch.launch.mesh.spawn(fn, 4)``:

    >>> rt = repro_torch.api.runtime(
    ...     n=16, device="cpu", mesh_shape=(2, 2),
    ...     mesh_axes=("slot", "shard"), decomposition=((0, "shard"),))
    >>> rt.run("cavity", steps=10)           # each rank steps its block
    """
    cfg = RuntimeConfig(n=n, nz=nz, backend=backend, device=device,
                        n_slots=n_slots, check_every=check_every,
                        solver=dict(solver), ckpt_dir=ckpt_dir,
                        telemetry=telemetry, health=health, store=store,
                        mesh_shape=tuple(mesh_shape),
                        mesh_axes=tuple(mesh_axes), slot_axis=slot_axis,
                        decomposition=tuple(decomposition))
    return Runtime(cfg, mesh=mesh)
