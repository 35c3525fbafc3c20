"""Service front-end for the simulation farm: submit / poll / result.

The port of ``repro.sim.service``, the multi-tenant surface: callers hold a
``sid`` ticket, the service drives the farm and answers status queries.
Long-running simulations can be *evicted* — their slot's fields are pulled
to host memory, and spilled to disk through
:class:`repro_torch.ckpt.checkpointer.Checkpointer` when a directory is
configured (or through the job store's snapshots when there is a store) —
so the slot serves other traffic, and later *readmitted* to continue
exactly where they stopped: the saved fields re-enter a slot bit for bit,
so an evicted and readmitted run equals an uninterrupted one.

With telemetry enabled the service also runs the
:mod:`repro_torch.ft.watchdog` machinery: every poll and every farm chunk
is a *heartbeat* (touching the ``heartbeat_path`` liveness file, when
configured); a gap between consecutive beats longer than the configured
deadline counts a ``service.watchdog_stalls`` metric and trace event; and a
:class:`~repro_torch.ft.watchdog.StepWatchdog` EWMA over chunk wall times
flags slow or hung chunks (``service.watchdog_events{kind}``).  On a
health-monitored farm either marks the resident sims ``warning``.

On a mesh every rank runs its own service over the same farm.  Without a
job store an evicted slot's fields are held, or spilled to the checkpoint
directory, by the slot's root rank alone (``EnsembleExecutor.slot_root``).
With one, the store is global rank 0's alone
(:class:`repro_torch.jobs.MeshStore`): an eviction gathers the slot to
rank 0, which writes the ``evict`` snapshot and the ``evicted`` status in
one transaction, and readmission scatters it from there; results (already
gathered to rank 0) and flight records are rank 0's to write; every store
answer reaches every rank, so all take the same branch.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import obs
from repro_torch.cfd.ns3d import CFDConfig
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.ft.watchdog import Heartbeat, StepWatchdog
from repro_torch.sim.farm import (
    SimRequest, SimResult, SimulationFarm, static_key,
)


@dataclasses.dataclass
class _Evicted:
    req: SimRequest
    steps_done: int
    state: dict | None       # CPU tensors; None when spilled to disk or
                             # held by another rank of the mesh
    spilled: bool = False    # this rank wrote the fields to disk


class SimulationService:
    """submit/poll/result over a SimulationFarm, with eviction hooks.

    ``store`` (a :class:`repro_torch.jobs.JobStore` or ``MeshStore``) makes
    the service durable.  On a ``mesh`` of more than one rank every rank
    builds the service at the same point and a JobStore handed in on
    every rank becomes a ``MeshStore``: global rank 0's is written
    through, the other ranks' are closed and ignored."""

    def __init__(self, base_config: CFDConfig, n_slots: int = 8,
                 check_steady_every: int = 16, device=None,
                 ckpt_dir: str | None = None, store=None, mesh=None,
                 slot_axis: str = "data", telemetry=None,
                 farm_id: str | None = None, health=None):
        self.tel = obs.resolve(telemetry)
        self.farm = SimulationFarm(base_config, n_slots,
                                   check_steady_every=check_steady_every,
                                   device=device, mesh=mesh,
                                   slot_axis=slot_axis, telemetry=self.tel,
                                   farm_id=farm_id, health=health)
        self._evicted: dict[int, _Evicted] = {}
        self._requeued_progress: dict[int, int] = {}  # readmitted, waiting
        self._ckpt = Checkpointer(ckpt_dir, keep_last=0) if ckpt_dir else None
        from repro_torch.jobs import on_mesh

        # repro_torch.jobs.JobStore, MeshStore on a mesh of ranks, or None
        self.store = on_mesh(store, mesh)
        self._job_of: dict[int, int] = {}  # farm sid -> durable job_id
        self._last_renew = 0.0
        self._last_beat: float | None = None
        self._hb_file: Heartbeat | None = None
        self.watchdog: StepWatchdog | None = None
        if self.tel.enabled:
            cfg = self.tel.config
            if cfg.heartbeat_path is not None:
                self._hb_file = Heartbeat(cfg.heartbeat_path,
                                          interval_s=cfg.heartbeat_interval_s)
            self.watchdog = StepWatchdog()
        if self.tel.enabled or self.store is not None:
            # the farm beats on every chunk (with the chunk's wall time);
            # poll beats with no observation.  The store's lease renewal
            # rides the same beat: liveness is "the farm is stepping"
            self.farm.heartbeat = self._beat
        if self.store is not None:
            self.farm.on_transition = self._store_transition

    # -- watchdog --------------------------------------------------------------
    def _beat(self, chunk_wall_s: float | None = None):
        """One liveness heartbeat (poll or chunk): renews the store's
        leases (at most every ttl/3), touches the liveness file, feeds the
        chunk time to the step watchdog and records a stall when
        consecutive beats are further apart than ``heartbeat_deadline_s``."""
        if self.store is not None:
            now_w = time.monotonic()
            if now_w - self._last_renew >= self.store.ttl_s / 3:
                self.store.renew()
                self._last_renew = now_w
        if not self.tel.enabled:
            return
        now = time.perf_counter()
        last, self._last_beat = self._last_beat, now
        if self._hb_file is not None:
            self._hb_file.beat()
        deadline = self.tel.config.heartbeat_deadline_s
        if last is not None and now - last > deadline:
            self.tel.metrics.inc("service.watchdog_stalls")
            self.tel.trace.emit("watchdog_stall", gap_s=now - last,
                                deadline_s=deadline)
            self._mark_unhealthy("watchdog_stall", gap_s=now - last)
        if chunk_wall_s is not None and self.watchdog is not None:
            for ev in self.watchdog.observe(self.farm.device_steps,
                                            chunk_wall_s):
                self.tel.metrics.inc("service.watchdog_events", kind=ev.kind)
                self.tel.trace.emit("watchdog_" + ev.kind, step=ev.step,
                                    step_time_s=ev.step_time,
                                    threshold_s=ev.threshold)
                if ev.kind in ("slow_step", "hang"):
                    self._mark_unhealthy("watchdog_" + ev.kind,
                                         step_time_s=ev.step_time)

    def _mark_unhealthy(self, cause: str, **detail):
        """A stall, slow or hung chunk marks every resident sim
        ``warning`` in the health state machine, with the trace schema of
        quarantine; healthy frames at a later drain clear it."""
        monitor = self.farm.monitor
        if monitor is None:
            return
        from repro_torch.obs.health import WARNING

        for _, entry in self.farm.table.occupied():
            monitor.mark(entry.req.sid, WARNING, cause=cause, **detail)

    # -- intake ---------------------------------------------------------------
    def submit(self, req: SimRequest, job_id: int | None = None) -> int:
        """Queue a simulation; returns its sid.

        With a job store the request is made durable FIRST — committed as a
        ``queued`` row leased to this process — and only then queued on
        the farm, so a crash between the two loses nothing.  ``job_id``
        hands in an already-claimed row instead (the Runtime's claim and
        recovery path).  A farm-side submit failure moves the row to
        ``failed`` rather than leaving a leased orphan.
        """
        from repro_torch import jobs

        if self.store is not None and job_id is None:
            job_id = self.store.submit(
                req, signature=str(static_key(req.config, self.farm.n_slots)),
                lease=True)
        try:
            sid = self.farm.submit(req)
        except Exception as e:
            if self.store is not None and job_id is not None:
                self.store.transition(job_id, jobs.FAILED,
                                      error=f"{type(e).__name__}: {e}",
                                      event="result")
            raise
        if self.store is not None and job_id is not None:
            self._job_of[sid] = job_id
            if self.tel.enabled:
                self.tel.trace.emit("job_submit", sid=sid, job_id=job_id,
                                    tag=req.tag)
        return sid

    def job_of(self, sid: int) -> int | None:
        """The durable job_id behind a farm sid (None without a store)."""
        return self._job_of.get(sid)

    # -- durable transitions ---------------------------------------------------
    def _store_transition(self, kind: str, req: SimRequest, result, **info):
        """The farm's ``on_transition`` hook: admission marks the job
        ``running``; a terminal resolution persists the final fields (a
        ``result`` snapshot, done jobs), registers the flight record
        (diverged jobs) and moves the row, releasing its lease."""
        from repro_torch import jobs

        job_id = self._job_of.get(req.sid)
        if job_id is None:
            return
        if kind == "running":
            self.store.transition(job_id, jobs.RUNNING,
                                  steps_done=req.step0, event="admit")
        elif kind == "done":
            if self.store.keep_results:
                with self.tel.span("service.result_snapshot"):
                    self.store.save_snapshot(job_id, result.state,
                                             result.steps_done, kind="result")
            self.store.transition(job_id, jobs.DONE,
                                  steps_done=result.steps_done,
                                  terminated=result.terminated, event="result")
        elif kind in ("failed", "diverged"):
            if kind == "diverged" and info.get("flight_path"):
                # pruned with the job, resolvable from any process
                self.store.record_snapshot(
                    job_id, "flight", self.farm.flight.directory,
                    step_key=req.sid, steps_done=result.steps_done)
            self.store.transition(job_id, getattr(jobs, kind.upper()),
                                  steps_done=result.steps_done,
                                  terminated=result.terminated,
                                  error=result.error, event="result")
        if self.tel.enabled:
            self.tel.trace.emit("job", sid=req.sid, job_id=job_id,
                                transition=kind)
            self.tel.metrics.set("jobs.store_queue_depth",
                                 self.store.queue_depth())

    # -- status ---------------------------------------------------------------
    def poll(self, sid: int) -> dict:
        """{"status": queued|running|evicted|done|failed|diverged,
        "steps_done": int}; a failed or quarantined simulation also
        carries its ``error`` string, and on a health-monitored farm a
        running one its latest drained health frame under ``"health"``."""
        if self.tel.enabled or self.store is not None:
            self._beat()
        if sid in self.farm.results:
            res = self.farm.results[sid]
            if res.terminated in ("failed", "diverged"):
                return {"status": res.terminated,
                        "steps_done": res.steps_done, "error": res.error}
            return {"status": "done", "steps_done": res.steps_done}
        if sid in self._evicted:
            return {"status": "evicted",
                    "steps_done": self._evicted[sid].steps_done}
        running = self.farm.steps_done(sid)
        if running is not None:
            self._requeued_progress.pop(sid, None)
            out = {"status": "running", "steps_done": running}
            if self.farm.monitor is not None:
                frame = self.farm.monitor.frame_of(sid)
                if frame is not None:
                    out["health"] = frame
            return out
        if self.farm.known(sid):
            # a readmitted sim waiting for a slot keeps its saved progress
            return {"status": "queued",
                    "steps_done": self._requeued_progress.get(sid, 0)}
        raise KeyError(f"unknown simulation id {sid}")

    def run(self, device_steps: int) -> int:
        """Advance the farm up to ``device_steps``; returns steps taken."""
        return self.farm.run(device_steps)

    def result(self, sid: int, block: bool = True,
               max_device_steps: int = 100_000) -> SimResult:
        """The finished simulation; drives the farm to completion if needed."""
        if block and sid not in self.farm.results:
            if sid in self._evicted:
                self.readmit(sid)
            self.farm.run(max_device_steps,
                          until=lambda: sid in self.farm.results)
        if sid not in self.farm.results:
            raise KeyError(f"simulation {sid} has not finished "
                           f"(status: {self.poll(sid)['status']})")
        res = self.farm.results[sid]
        if res.terminated == "failed":
            raise RuntimeError(
                f"simulation {sid} ({res.tag or 'untagged'}) failed after "
                f"{res.steps_done} steps: {res.error}")
        return res

    # -- eviction / readmission ------------------------------------------------
    def evict(self, sid: int) -> bool:
        """Move a resident simulation's fields off the device, freeing its
        slot; False if ``sid`` is not resident.

        With a job store the fields spill to the store's ``evict`` snapshot
        and the row turns ``evicted`` in the same transaction, so a
        restarted process resumes it from here (on a mesh the slot is
        gathered to the store's writer, global rank 0, which writes it);
        else, with a checkpoint directory, they spill there (the sid is the
        step key); else they stay in host memory.  A failed write raises.
        """
        from repro_torch.jobs import WRITER

        pulled = self.farm.evict(
            sid, dst=WRITER if self.store is not None else None)
        if pulled is None:
            return False
        req, state, steps_done = pulled
        job_id = self._job_of.get(sid)
        spilled = False
        if self.store is not None and job_id is not None:
            from repro_torch import jobs

            with self.tel.span("service.evict_spill"):
                self.store.save_snapshot(job_id, state, steps_done,
                                         kind="evict", status=jobs.EVICTED)
            state, spilled = None, True
        elif self._ckpt is not None and state is not None:
            with self.tel.span("service.evict_spill"):
                self._ckpt.save(sid, state, blocking=True)
            state, spilled = None, True
        self._evicted[sid] = _Evicted(req=req, steps_done=steps_done,
                                      state=state, spilled=spilled)
        return True

    def readmit(self, sid: int) -> bool:
        """Re-queue an evicted simulation; it resumes at its exact step.
        Its fields (read back from disk when spilled) wait in host memory
        until a slot admits it; on a mesh with a store they are read on
        rank 0 alone, which the request's ``init_rank`` names."""
        ev = self._evicted.get(sid)
        if ev is None:
            return False
        state = ev.state
        job_id = self._job_of.get(sid)
        if ev.spilled and self.store is not None and job_id is not None:
            with self.tel.span("service.readmit_restore"):
                _, state = self.store.load_snapshot(job_id, kind="evict")
        elif ev.spilled:
            with self.tel.span("service.readmit_restore"):
                state = self._ckpt.restore(sid,
                                           self.farm.exec.state_template())
        self.farm.submit(dataclasses.replace(
            ev.req, init_state=state, step0=ev.steps_done, sid=sid))
        # only now is the sim requeued: a failed restore or a refused
        # submit keeps the record for another attempt
        del self._evicted[sid]
        self._requeued_progress[sid] = ev.steps_done
        return True

    def prometheus_text(self, perf: bool = False, chip="auto") -> str:
        """Prometheus text exposition of this service's telemetry registry;
        empty when telemetry is off.  ``perf=True`` first mirrors the
        accounting of the farm's batched step into ``repro_perf_*`` gauges
        (utilization, roofline seconds, predicted FLOPs and HBM bytes per
        invocation) so that a scraper sees prediction and measurement side
        by side; on a card the measurement is the step chunks' device time
        (``Telemetry.device_seconds``), read without a wait."""
        if perf and self.tel.enabled:
            from repro_torch.obs import perf as _perf

            per_step = _perf.measured_seconds(self.tel, "farm.step_chunk",
                                              self.farm.device_steps)
            row = _perf.farm_cost_row(self, measured_s=per_step)
            chip = _perf.resolve_chip(chip, self.farm.exec.device)
            _perf.PerfReport([row], chip=chip).export_gauges(self.tel.metrics)
        return self.tel.metrics.to_prometheus()

    def drain(self, max_device_steps: int = 100_000) -> dict[int, SimResult]:
        """Readmit everything evicted, then run the farm dry.  Every
        submitted sid resolves, failed sims as ``terminated="failed"``."""
        for sid in list(self._evicted):
            self.readmit(sid)
        return self.farm.run_until_drained(max_device_steps)
