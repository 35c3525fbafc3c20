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
(hit/miss counters via :func:`compile_cache_stats`).  On the port nothing is
compiled at admission at all: the CUDA kernels are built once per process,
and per-simulation physics rides in their parameter tables.

Not ported in this slice: telemetry and in-situ health monitoring (ROADMAP
queue 1, item 8) and the farm mesh (item 9); asking for either raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.cfd.ns3d import CFDConfig, NavierStokes3D
from repro_torch.device import resolve_device
from repro_torch.serve.slots import SlotTable
from repro_torch.sim.ensemble import (
    EnsembleExecutor, host_params, make_ensemble_step,
)

_ITEM_OF = {"telemetry": 8, "health": 8, "ckpt_dir": 8, "store": 8,
            "enqueue": 8, "claim": 8, "recover": 8,
            "mesh": 9, "decomposition": 9}


def not_ported(what: str) -> NotImplementedError:
    """The error for a posture the port does not take yet, naming its
    ROADMAP item."""
    item = _ITEM_OF[what]
    topic = ("observability and durability" if item == 8
             else "slots x shards over torch.distributed")
    return NotImplementedError(
        f"{what!r} is not ported yet (ROADMAP queue 1, item {item}: {topic})")


# -- step cache --------------------------------------------------------------
_STEP_CACHE: dict[tuple, tuple[NavierStokes3D, Any]] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def static_key(config: CFDConfig, n_slots: int) -> tuple:
    """The step signature: everything that selects the batched step.

    Per-simulation physics (nu, dt, lid velocity, forcing) is deliberately
    absent — it rides in the per-slot scalars, so admitting a new parameter
    variant of a seen shape never builds anything.
    """
    return (
        config.case, config.shape, config.extent, config.jacobi_iters,
        config.jacobi_omega, config.fused_sweeps, config.template,
        config.overlap, n_slots,
    )


def compiled_ensemble_step(config: CFDConfig, n_slots: int, device=None):
    """(solver, batched chunk step) for the static signature on ``device``."""
    dev = resolve_device(device)
    key = static_key(config, n_slots) + (str(dev),)
    hit = _STEP_CACHE.get(key)
    if hit is not None:
        _CACHE_STATS["hits"] += 1
        return hit
    _CACHE_STATS["misses"] += 1
    solver = NavierStokes3D(config, dev)
    _STEP_CACHE[key] = (solver, make_ensemble_step(solver))
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
    scenario's initial fields): a dict of tensors.
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


@dataclasses.dataclass
class SimResult:
    sid: int
    tag: str
    steps_done: int
    terminated: str    # "steps" | "steady" | "residual" | "failed"
    state: dict        # CPU tensors: vx, vy, vz, p (+ masks)
    config: CFDConfig
    error: str | None = None   # set iff terminated is "failed"


class _SlotEntry:
    """Host bookkeeping for one resident simulation."""

    __slots__ = ("req", "steps_done", "ke_prev")

    def __init__(self, req: SimRequest):
        self.req = req
        self.steps_done = req.step0
        self.ke_prev: float | None = None


class SimulationFarm:
    """Queue + slots + termination around one batched ensemble step."""

    def __init__(self, base_config: CFDConfig, n_slots: int = 8,
                 check_steady_every: int = 16, device=None, mesh=None,
                 telemetry=None, health=None):
        for what, value in (("mesh", mesh), ("telemetry", telemetry),
                            ("health", health)):
            if value:
                raise not_ported(what)
        self.base_config = base_config
        self.n_slots = n_slots
        self.check_steady_every = check_steady_every
        solver, run_k = compiled_ensemble_step(base_config, n_slots, device)
        self.exec = EnsembleExecutor(base_config, n_slots, solver=solver,
                                     run_k=run_k)
        self.table = SlotTable(n_slots)
        self.results: dict[int, SimResult] = {}
        self.device_steps = 0
        self._next_sid = 0
        self._live: set[int] = set()   # queued or resident sids

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
        return req.sid

    def _admit(self):
        while True:
            admitted = self.table.admit_next()
            if admitted is None:
                break
            slot, req = admitted
            entry = _SlotEntry(req)
            self.table.replace(slot, entry)
            try:
                self.exec.write_slot(slot, host_params(req.config),
                                     state=req.init_state)
            except Exception as e:
                # a request whose admission raises (bad readmission state,
                # mis-shaped fields, ...) fails alone, as a per-sim result
                self._fail(slot, entry, e)
                continue
            if entry.steps_done >= req.steps:
                # already at its target: harvest without stepping, so a
                # steps=0 request never advances the batch
                self._finish(slot, entry, "steps")

    # -- stepping -------------------------------------------------------------
    def _chunk_size(self, max_chunk: int | None) -> int:
        """Steps until the next host decision point: a slot reaching its
        target, the next steady-state check boundary (when a resident sim
        watches one), or the caller's budget.  Chunking is numerics-neutral
        — tested bitwise against single-stepping."""
        chunk = min(e.req.steps - e.steps_done
                    for _, e in self.table.occupied())
        if any(e.req.steady_tol is not None or e.req.residual_tol is not None
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
        try:
            if watch_resid and at_boundary:
                # land the chunk's last step alone: the residual compares
                # consecutive states
                if chunk > 1:
                    self.exec.step_many(chunk - 1)
                prev = self.exec.state
                self.exec.step_many(1)
                resid = self.exec.residuals(prev)
            else:
                self.exec.step_many(chunk)
        except Exception as e:
            # the batched step is shared by every resident sim, so all fail
            for slot, entry in list(self.table.occupied()):
                self._fail(slot, entry, e)
            return 0
        self.device_steps += chunk
        for _, entry in self.table.occupied():
            entry.steps_done += chunk
        for slot, entry in list(self.table.occupied()):
            if entry.steps_done >= entry.req.steps:
                self._finish(slot, entry, "steps")
        self._check_steady(resid)
        return chunk

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

    def _finish(self, slot: int, entry: _SlotEntry, reason: str):
        req = entry.req
        self._release(slot, entry, SimResult(
            sid=req.sid, tag=req.tag, steps_done=entry.steps_done,
            terminated=reason, state=self.exec.read_slot(slot),
            config=req.config))

    def _fail(self, slot: int, entry: _SlotEntry, exc: BaseException):
        """Record a per-sim failure as a harvestable result and free the
        slot — a sim whose admission or step raised surfaces through
        poll/result/drain instead of wedging the farm."""
        req = entry.req
        self._release(slot, entry, SimResult(
            sid=req.sid, tag=req.tag, steps_done=entry.steps_done,
            terminated="failed", state={}, config=req.config,
            error=f"{type(exc).__name__}: {exc}"))

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
    def evict(self, sid: int) -> tuple[SimRequest, dict, int] | None:
        """Pull a *running* simulation off the device mid-flight.

        Returns ``(request, host_state, steps_done)`` and frees the slot;
        None if ``sid`` is not currently resident.  Readmission goes through
        ``submit`` with ``init_state``/``step0`` set (see the service).
        """
        for slot, entry in self.table.occupied():
            if entry.req.sid == sid:
                state = self.exec.read_slot(slot)
                self._live.discard(sid)
                self.table.release(slot)
                self.exec.clear_slot(slot)
                return entry.req, state, entry.steps_done
        return None

    def known(self, sid: int) -> bool:
        """Has this sid ever been issued by the farm?"""
        return 0 <= sid < self._next_sid

    def steps_done(self, sid: int) -> int | None:
        for _, entry in self.table.occupied():
            if entry.req.sid == sid:
                return entry.steps_done
        return None
