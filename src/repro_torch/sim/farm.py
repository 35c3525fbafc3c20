"""The simulation farm: continuous batching of CFD runs over fixed slots.

The port of ``repro.sim.farm``, the scheduling policy for the
:class:`~repro_torch.sim.ensemble.EnsembleExecutor`: requests queue up
host-side; whenever a slot frees (target step count hit or steady state
detected), the next request is admitted into it and the whole batch keeps
stepping — the vLLM pattern with CFD steps in place of token decodes.
Admission writes the case's initial fields (or an evicted simulation's saved
fields) into the slot and installs its per-simulation scalars; nothing is
ever rebuilt, because the batched step depends only on the *static*
configuration (case, grid shape, template, solver structure, slot count).

Those steps live in a process-wide cache keyed by that static signature, so
a second farm of an already-seen shape reuses the solver and its step
(hit/miss counters via :func:`compile_cache_stats`, and per telemetry
registry as ``farm.compile_cache{result}``).  On the port nothing is
compiled at admission at all: the CUDA kernels are built once per process,
and per-simulation physics rides in their parameter tables.

Telemetry (timers, metrics, lifecycle traces) and in-situ health
(a device ring drained at harvest boundaries, NaN/divergence quarantine
with a flight record) are the reference's; off, the farm launches exactly
what it launched without them.

On a mesh (slots × shards, ``repro_torch.sim.ensemble``) every rank builds
the same farm and runs the same host scheduling: every decision that reads
the fields reads a per-slot vector that all ranks hold alike, so all take
the same branch.  A finished slot is gathered to global rank 0: a
:class:`SimResult` carries the same metadata on every rank and its fields
on rank 0 only (``state == {}`` elsewhere).  An eviction gathers the slot
to the first rank of its shard group (``EnsembleExecutor.slot_root``),
which holds or spills it, or — with a job store, whose writer is global
rank 0 (``repro_torch.jobs.MeshStore``) — to rank 0; readmission sends it
back from there.  The service's store hook (``on_transition``) fires on
every rank alike, and the store writes on rank 0 alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

from repro_torch import obs
from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D
from repro_torch.device import resolve_device
from repro_torch.serve.slots import SlotTable
from repro_torch.sim.ensemble import (
    EnsembleExecutor, host_params, make_ensemble_step, plan_decomposition,
)

# -- step cache --------------------------------------------------------------
_STEP_CACHE: dict[tuple, tuple[NavierStokes3D, Any]] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}
CACHE_METRIC = "farm.compile_cache"


def static_key(config: CFDConfig, n_slots: int) -> tuple:
    """The step signature: everything that selects the batched step.

    Per-simulation physics (nu, dt, lid velocity, forcing) is deliberately
    absent — it rides in the per-slot scalars, so admitting a new parameter
    variant of a seen shape never builds anything.
    """
    return (
        config.case, config.shape, config.extent, config.jacobi_iters,
        config.jacobi_omega, config.fused_sweeps, config.template,
        config.overlap, config.decomposition, n_slots,
    )


def compiled_ensemble_step(config: CFDConfig, n_slots: int, device=None,
                           mesh=None, slot_axis: str = "data", metrics=None,
                           health_window: int = 0):
    """(solver, batched chunk step) for the static signature on ``device``.

    ``mesh`` extends the key: a farm on a mesh caches apart from a
    one-process farm of the same shape.  With ``config.decomposition`` the
    solver is built against the mesh, so each slot's grid is split over
    the named axes; a mesh whose decomposed axes all have extent 1
    degrades to the plain slot-parallel step (``plan_decomposition``).

    ``health_window`` extends the cache key (the step then also writes the
    health ring) but not ``static_key``: requests match a farm on physics
    alone, so the same requests run on farms with health on and off.
    ``metrics`` (a telemetry registry) also counts the hit or miss."""
    dev = resolve_device(device)
    key = static_key(config, n_slots) + (
        str(dev), mesh, slot_axis if mesh is not None else None,
        health_window)
    hit = _STEP_CACHE.get(key)
    result = "hit" if hit is not None else "miss"
    _CACHE_STATS["hits" if hit is not None else "misses"] += 1
    if metrics is not None:
        metrics.inc(CACHE_METRIC, result=result)
    if hit is not None:
        return hit
    solver_cfg, active = plan_decomposition(
        config, mesh, slot_axis=slot_axis if mesh is not None else None)
    solver = NavierStokes3D(solver_cfg, dev, mesh if active else None)
    _STEP_CACHE[key] = (solver, make_ensemble_step(solver, health_window))
    return _STEP_CACHE[key]


def compile_cache_stats() -> dict:
    """Process-wide hit/miss/entry counts of the step cache."""
    return dict(_CACHE_STATS, entries=len(_STEP_CACHE))


def reset_compile_cache():
    _STEP_CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)


# -- requests / results ------------------------------------------------------
@dataclasses.dataclass
class SimRequest:
    """One simulation: a full per-run config + how long to run it.

    The config's static part must match the farm's; its scalar part (nu, dt,
    lid velocity, forcing) is what makes this run *this* run.  ``steps`` is
    the target step count.  Two early-termination criteria compose (first
    hit wins): ``residual_tol`` stops once the steady-state residual
    ``||u^{n+1} - u^n||_inf / dt`` falls below it; ``steady_tol`` is the
    legacy relative kinetic-energy-drift heuristic.  Both are evaluated on
    the farm's global ``check_steady_every`` cadence, so a sim admitted off
    a check boundary may terminate at another step than a serial run of
    the same request — admissions into an idle farm are boundary-aligned
    and match exactly.  ``priority`` orders admission: higher levels leave
    the queue first, FIFO within a level.  ``init_state``/``step0`` readmit
    an evicted simulation mid-flight (``init_state`` also carries a
    scenario's initial fields): a dict of tensors of the global grid.  On
    a mesh, ``init_rank`` names the one global rank that holds
    ``init_state`` (an eviction's gather; None elsewhere); None means every
    rank holds it.
    """

    config: CFDConfig
    steps: int
    tag: str = ""
    steady_tol: float | None = None
    residual_tol: float | None = None
    priority: int = 0
    init_state: dict | None = None
    step0: int = 0
    sid: int | None = None   # assigned by the farm
    init_rank: int | None = None


@dataclasses.dataclass
class SimResult:
    sid: int
    tag: str
    steps_done: int
    terminated: str    # "steps" | "steady" | "residual" | "failed" | "diverged"
    state: dict        # CPU tensors: vx, vy, vz, p (+ masks); on a mesh,
                       # global rank 0's only ({} on the other ranks)
    config: CFDConfig
    error: str | None = None   # set iff terminated is "failed"/"diverged"


class _SlotEntry:
    """Host bookkeeping for one resident simulation."""

    __slots__ = ("req", "steps_done", "ke_prev", "started")

    def __init__(self, req: SimRequest):
        self.req = req
        self.steps_done = req.step0
        self.ke_prev: float | None = None
        self.started = False           # first step-chunk already traced?


class SimulationFarm:
    """Queue + slots + termination around one batched ensemble step.

    ``telemetry`` (any :func:`repro_torch.obs.resolve` spec) instruments the
    farm: spans (timers) around the admit / step-chunk / harvest phases,
    ``farm.*`` and ``sim.*`` metrics, and per-sim lifecycle trace events.
    Disabled (the default) every hook records nothing, and its spans are
    profiler ranges only while a profiler records: the farm launches what
    an uninstrumented farm launches.  No span synchronises, on or off.
    ``farm_id`` tags this farm's events when farms share one handle.

    ``health`` (any :func:`repro_torch.obs.health.resolve_health` spec)
    turns on in-situ health monitoring: each chunk appends the slots'
    diagnostics to a device ring, drained at the ``check_steady_every``
    boundary the steady checks use (one device-to-host copy there, none
    between), and a NaN/diverged sim is quarantined — released with
    ``terminated="diverged"`` and flight-recorded — while the other slots
    keep stepping bitwise as if it had never been admitted.  Health works
    with telemetry off: events and metrics then no-op.
    """

    def __init__(self, base_config: CFDConfig, n_slots: int = 8,
                 check_steady_every: int = 16, device=None, mesh=None,
                 slot_axis: str = "data", telemetry=None,
                 farm_id: str | None = None, health=None):
        from repro_torch.obs.health import (
            FlightRecorder, HealthMonitor, resolve_health,
        )

        self.base_config = base_config
        self.n_slots = n_slots
        self.check_steady_every = check_steady_every
        self.tel = obs.resolve(telemetry)
        self.farm_id = farm_id if farm_id is not None else base_config.case
        self.health = resolve_health(health)
        hw = self.health.window if self.health is not None else 0
        solver, run_k = compiled_ensemble_step(
            base_config, n_slots, device, mesh=mesh, slot_axis=slot_axis,
            metrics=self.tel.metrics, health_window=hw)
        self.exec = EnsembleExecutor(base_config, n_slots, solver=solver,
                                     run_k=run_k, mesh=mesh,
                                     slot_axis=slot_axis, telemetry=self.tel,
                                     health_window=hw)
        self.monitor = (HealthMonitor(self.health, telemetry=self.tel,
                                      farm_id=self.farm_id)
                        if self.health is not None else None)
        self.flight = (FlightRecorder(self.health.flight_dir)
                       if self.health is not None
                       and self.health.flight_dir else None)
        self.table = SlotTable(n_slots)
        self.results: dict[int, SimResult] = {}
        self.device_steps = 0
        self._next_sid = 0
        self._live: set[int] = set()   # queued or resident sids
        self._submit_ts: dict[int, float] = {}   # sid -> submit wall time
        self.heartbeat = None          # service-installed: fn(chunk_wall_s)
        # service-installed job-store hook: fn(kind, req, result, **info),
        # fired at admission ("running") and at every terminal resolution
        # ("done"/"failed"/"diverged"); None keeps the in-memory path
        self.on_transition = None

    def _gauge_load(self):
        """Refresh the occupancy/queue-depth gauges (telemetry only)."""
        if not self.tel.enabled:
            return
        self.tel.metrics.set("farm.slot_occupancy", self.table.n_active)
        for prio, depth in self.table.queue_depths().items():
            self.tel.metrics.set("farm.queue_depth", depth, priority=prio)

    # -- intake ---------------------------------------------------------------
    def submit(self, req: SimRequest) -> int:
        """Queue a simulation; returns its sid (poll/result handle)."""
        if static_key(req.config, self.n_slots) != static_key(
                self.base_config, self.n_slots):
            raise ValueError(
                "request's static config does not match this farm: "
                f"{static_key(req.config, self.n_slots)} vs "
                f"{static_key(self.base_config, self.n_slots)}")
        if req.steps < 0:
            raise ValueError(f"steps must be >= 0, got {req.steps}")
        if req.sid is None:
            req.sid = self._next_sid
            self._next_sid += 1
        elif req.sid in self._live or req.sid in self.results:
            # a request object is a one-shot ticket: resubmitting it while
            # its sid is queued/resident/finished would alias two
            # simulations onto one handle
            raise ValueError(f"sid {req.sid} is already submitted")
        else:
            # caller-set sid (readmission): reserve it so auto-assignment
            # can never alias a fresh request onto the same handle
            self._next_sid = max(self._next_sid, req.sid + 1)
        self._live.add(req.sid)
        self.table.submit(req, priority=req.priority)
        if self.tel.enabled:
            self._submit_ts.setdefault(req.sid, time.perf_counter())
            kind = "submit" if req.step0 == 0 else "readmit_submit"
            self.tel.trace.emit(
                kind, sid=req.sid, farm=self.farm_id, tag=req.tag,
                priority=req.priority, steps=req.steps, step0=req.step0,
                signature=str(static_key(req.config, self.n_slots)))
            self._gauge_load()
        return req.sid

    def _admit(self):
        with self.tel.span("farm.admit"):
            while True:
                admitted = self.table.admit_next()
                if admitted is None:
                    break
                slot, req = admitted
                entry = _SlotEntry(req)
                self.table.replace(slot, entry)
                self.tel.trace.emit("admit", sid=req.sid, farm=self.farm_id,
                                    slot=slot, step0=req.step0, tag=req.tag)
                if self.monitor is not None:
                    # ring rows stamped before this device step belong to
                    # the slot's previous occupant
                    self.monitor.admit(req.sid, slot, tag=req.tag,
                                       last_step=self.device_steps - 1)
                try:
                    self.exec.write_slot(slot, host_params(req.config),
                                         state=req.init_state,
                                         src=req.init_rank)
                except Exception as e:
                    # a request whose admission raises (bad readmission
                    # state, mis-shaped fields, ...) fails alone, as a
                    # per-sim result
                    self._fail(slot, entry, e)
                    continue
                if self.on_transition is not None:
                    self.on_transition("running", req, None)
                if entry.steps_done >= req.steps:
                    # already at its target: harvest without stepping, so
                    # a steps=0 request never advances the batch
                    self._finish(slot, entry, "steps")
            self._gauge_load()

    # -- stepping -------------------------------------------------------------
    def _chunk_size(self, max_chunk: int | None) -> int:
        """Steps until the next host decision point: a slot reaching its
        target, the next steady-state check boundary (when a resident sim
        watches one, or health is on: the ring drains there), or the
        caller's budget.  Chunking is numerics-neutral — tested bitwise
        against single-stepping."""
        chunk = min(e.req.steps - e.steps_done
                    for _, e in self.table.occupied())
        if self.monitor is not None or any(
                e.req.steady_tol is not None or e.req.residual_tol is not None
                for _, e in self.table.occupied()):
            boundary = self.check_steady_every - (
                self.device_steps % self.check_steady_every)
            chunk = min(chunk, boundary)
        if max_chunk is not None:
            chunk = min(chunk, max_chunk)
        return max(chunk, 1)

    def step(self, max_chunk: int | None = None) -> int:
        """Admit waiting work, advance the batch one chunk, harvest
        finishers.  Returns the number of steps taken (0 when the farm is
        empty, or when the chunk failed — the failure is recorded as
        per-sim "failed" results, never re-raised into the drive loop)."""
        self._admit()
        if self.table.n_active == 0:
            return 0
        chunk = self._chunk_size(max_chunk)
        watch_resid = any(e.req.residual_tol is not None
                          for _, e in self.table.occupied())
        at_boundary = (self.device_steps + chunk) % self.check_steady_every == 0
        resid = None
        want_wall = self.tel.enabled or self.heartbeat is not None
        t_chunk = time.perf_counter() if want_wall else 0.0
        try:
            # with telemetry on a card, a pair of timing events books the
            # chunk's device time (Telemetry.device_seconds); nothing waits
            with self.tel.span("farm.step_chunk", device=self.exec.device,
                               steps=chunk):
                if watch_resid and at_boundary:
                    # land the chunk's last step alone: the residual
                    # compares consecutive states
                    if chunk > 1:
                        self.exec.step_many(chunk - 1)
                    prev = self.exec.state
                    self.exec.step_many(1)
                    # the farm's one wait on the device in steady stepping
                    with self.tel.span("farm.residuals"):
                        resid = self.exec.residuals(prev)
                else:
                    self.exec.step_many(chunk)
        except Exception as e:
            # the batched step is shared by every resident sim, so all fail
            for slot, entry in list(self.table.occupied()):
                self._fail(slot, entry, e)
            return 0
        if self.tel.enabled:
            self.tel.metrics.inc("sim.steps_total",
                                 chunk * self.table.n_active)
            for _, entry in self.table.occupied():
                if not entry.started:
                    entry.started = True
                    self.tel.trace.emit("first_step", sid=entry.req.sid,
                                        farm=self.farm_id,
                                        device_step=self.device_steps)
        if self.heartbeat is not None:
            # the service's watchdog hook: chunk wall time + liveness beat
            self.heartbeat(time.perf_counter() - t_chunk)
        self.device_steps += chunk
        for _, entry in self.table.occupied():
            entry.steps_done += chunk
        # drain and quarantine BEFORE the steps-target harvest: a sim that
        # goes bad in the chunk that would have finished it reports
        # "diverged", not a healthy-looking "steps" result
        self._drain_health()
        for slot, entry in list(self.table.occupied()):
            if entry.steps_done >= entry.req.steps:
                self._finish(slot, entry, "steps")
        self._check_steady(resid)
        return chunk

    def _drain_health(self):
        """Copy the device health ring to the host (one copy) at a harvest
        boundary, run every resident sim's state machine, quarantine the
        NaN/diverged ones."""
        if (self.monitor is None
                or self.device_steps % self.check_steady_every):
            return
        occupied = list(self.table.occupied())
        if not occupied:
            return
        with self.tel.span("farm.health_drain"):
            rings = self.exec.read_health()
        self.tel.metrics.inc("health.drains")
        from repro_torch.obs.health import DIVERGED, NAN

        for slot, entry in occupied:
            rec = self.monitor.observe(entry.req.sid, rings[slot])
            if rec.state in (DIVERGED, NAN) and self.health.quarantine:
                self._quarantine(slot, entry, rec)
        self.monitor.export_gauges()

    def _quarantine(self, slot: int, entry: _SlotEntry, rec):
        """Release a NaN/diverged sim: flight-record its last-K health
        frames and final (poisoned) state, resolve it with
        ``terminated="diverged"``, free the slot.  The other slots never
        see any of this: slots never interact, so they step on bitwise as
        if the bad sim had never been admitted."""
        req = entry.req
        with self.tel.span("farm.quarantine"):
            state = self.exec.read_slot(slot) or {}
        flight_path = None
        if self.flight is not None and not state:
            # a mesh's other ranks: the record is global rank 0's
            flight_path = self.flight.path_of(req.sid)
        elif self.flight is not None:
            flight_path = self.flight.record(
                req.sid, frames=rec.frames_array(), state=state,
                meta={"tag": req.tag, "farm": self.farm_id, "slot": slot,
                      "state": rec.state, "cause": rec.cause,
                      "steps_done": entry.steps_done,
                      "device_step": self.device_steps,
                      "thresholds": dataclasses.asdict(self.health),
                      "signature": str(static_key(req.config,
                                                  self.n_slots))})
        err = (f"health: {rec.state} ({rec.cause}) at device step "
               f"{self.device_steps}"
               + (f"; flight record: {flight_path}" if flight_path else ""))
        self.results[req.sid] = SimResult(
            sid=req.sid, tag=req.tag, steps_done=entry.steps_done,
            terminated="diverged", state=state, config=req.config,
            error=err)
        self._live.discard(req.sid)
        self.table.release(slot)
        self.exec.clear_slot(slot)
        self.monitor.release(req.sid)
        self.tel.metrics.inc("health.quarantines")
        self._resolved(req, entry.steps_done, "diverged", error=err)
        if self.on_transition is not None:
            self.on_transition("diverged", req, self.results[req.sid],
                               flight_path=flight_path)

    def _check_steady(self, resid=None):
        if self.device_steps % self.check_steady_every:
            return
        if resid is not None:
            for slot, entry in list(self.table.occupied()):
                tol = entry.req.residual_tol
                if tol is not None and float(resid[slot]) <= tol:
                    self._finish(slot, entry, "residual")
        watched = [(s, e) for s, e in self.table.occupied()
                   if e.req.steady_tol is not None]
        if not watched:
            return
        ke = self.exec.kinetic_energy()
        for slot, entry in watched:
            k = float(ke[slot])
            prev = entry.ke_prev
            entry.ke_prev = k
            if prev is not None and abs(k - prev) <= entry.req.steady_tol * max(
                    abs(k), 1e-12):
                self._finish(slot, entry, "steady")

    def _release(self, slot: int, entry: _SlotEntry, result: SimResult):
        self.results[entry.req.sid] = result
        self._live.discard(entry.req.sid)
        self.table.release(slot)
        self.exec.clear_slot(slot)
        if self.monitor is not None:
            self.monitor.release(entry.req.sid)
        self._resolved(entry.req, result.steps_done, result.terminated,
                       error=result.error)

    def _finish(self, slot: int, entry: _SlotEntry, reason: str):
        req = entry.req
        with self.tel.span("farm.harvest"):
            state = self.exec.read_slot(slot) or {}
        self._release(slot, entry, SimResult(
            sid=req.sid, tag=req.tag, steps_done=entry.steps_done,
            terminated=reason, state=state, config=req.config))
        if self.on_transition is not None:
            self.on_transition("done", req, self.results[req.sid])

    def _fail(self, slot: int, entry: _SlotEntry, exc: BaseException):
        """Record a per-sim failure as a harvestable result and free the
        slot — a sim whose admission or step raised surfaces through
        poll/result/drain instead of wedging the farm."""
        req = entry.req
        self._release(slot, entry, SimResult(
            sid=req.sid, tag=req.tag, steps_done=entry.steps_done,
            terminated="failed", state={}, config=req.config,
            error=f"{type(exc).__name__}: {exc}"))
        if self.on_transition is not None:
            self.on_transition("failed", req, self.results[req.sid])

    def _resolved(self, req: SimRequest, steps_done: int, reason: str,
                  error: str | None = None):
        """Telemetry for a sid leaving the farm (finished or failed)."""
        if not self.tel.enabled:
            return
        if reason in ("steady", "residual"):
            self.tel.trace.emit("steady", sid=req.sid, farm=self.farm_id,
                                criterion=reason, steps_done=steps_done)
        extra = {"error": error} if error else {}
        self.tel.trace.emit("result", sid=req.sid, farm=self.farm_id,
                            terminated=reason, steps_done=steps_done,
                            tag=req.tag, **extra)
        self.tel.metrics.inc("sim.results", terminated=reason)
        t0 = self._submit_ts.pop(req.sid, None)
        if t0 is not None:
            self.tel.metrics.observe("service.submit_to_result_seconds",
                                     time.perf_counter() - t0,
                                     priority=req.priority)
        self._gauge_load()

    def run(self, max_device_steps: int, until=None) -> int:
        """Step until the budget, the farm drains, or ``until()`` is true.
        ``max_device_steps`` budgets *this call*.  Returns the steps taken."""
        taken = 0
        while taken < max_device_steps and not (until is not None and until()):
            t = self.step(max_chunk=max_device_steps - taken)
            taken += t
            if not t:
                if self.table.n_active == 0 and self.table.n_queued:
                    # the resident batch just failed out: keep admitting so
                    # every queued sim resolves
                    continue
                break
        return taken

    def run_until_drained(self, max_device_steps: int = 100_000
                          ) -> dict[int, SimResult]:
        """Step until queue and slots are empty; returns all results."""
        self.run(max_device_steps)
        return self.results

    # -- eviction (service hook) ---------------------------------------------
    def evict(self, sid: int, dst: int | None = None
              ) -> tuple[SimRequest, dict, int] | None:
        """Pull a *running* simulation off the device mid-flight.

        Returns ``(request, host_state, steps_done)`` and frees the slot;
        None if ``sid`` is not currently resident.  Readmission goes through
        ``submit`` with ``init_state``/``step0`` set (see the service).  On
        a mesh the fields land on global rank ``dst`` alone (None: the
        slot's root rank): the request comes back with ``init_rank``
        naming it, and ``host_state`` is None on every other rank.
        """
        for slot, entry in self.table.occupied():
            if entry.req.sid == sid:
                req = entry.req
                with self.tel.span("farm.evict"):
                    if self.exec.mesh is None:
                        state = self.exec.read_slot(slot)
                    else:
                        root = (dst if dst is not None
                                else self.exec.slot_root(slot))
                        state = self.exec.read_slot(slot, dst=root)
                        req = dataclasses.replace(req, init_rank=root)
                self._live.discard(sid)
                self.table.release(slot)
                self.exec.clear_slot(slot)
                if self.monitor is not None:
                    self.monitor.release(sid)
                if self.tel.enabled:
                    self.tel.metrics.inc("sim.evictions")
                    self.tel.trace.emit("evict", sid=sid, farm=self.farm_id,
                                        slot=slot,
                                        steps_done=entry.steps_done)
                    self._gauge_load()
                return req, state, entry.steps_done
        return None

    def known(self, sid: int) -> bool:
        """Has this sid ever been issued by the farm?"""
        return 0 <= sid < self._next_sid

    def steps_done(self, sid: int) -> int | None:
        for _, entry in self.table.occupied():
            if entry.req.sid == sid:
                return entry.steps_done
        return None

    def health_snapshot(self) -> dict:
        """One dashboard frame: farm id, device step, queue depth, and one
        row per slot (free slots included), with each resident sim's latest
        health frame when monitoring is on.  Rendered by
        ``repro_torch.obs.health.render_dashboard`` / ``Runtime.watch``."""
        slots = []
        for slot, entry in enumerate(self.table.slots()):
            if not isinstance(entry, _SlotEntry):
                slots.append({"slot": slot, "sid": None})
                continue
            row = {"slot": slot, "sid": entry.req.sid, "tag": entry.req.tag,
                   "steps_done": entry.steps_done, "steps": entry.req.steps}
            if self.monitor is not None:
                row["health"] = self.monitor.frame_of(entry.req.sid)
            slots.append(row)
        return {"farm": self.farm_id, "device_steps": self.device_steps,
                "queued": self.table.n_queued, "slots": slots,
                "states": (self.monitor.counts()
                           if self.monitor is not None else {})}
