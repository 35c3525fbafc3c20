"""Service front-end for the simulation farm: submit / poll / result.

The port of ``repro.sim.service``, the multi-tenant surface: callers hold a
``sid`` ticket, the service drives the farm and answers status queries.
Long-running simulations can be *evicted* — their slot's fields are pulled
to host memory so the slot serves other traffic — and later *readmitted* to
continue exactly where they stopped: the saved fields re-enter a slot
bit-identically, so an evicted and readmitted run equals an uninterrupted
one.

Not ported in this slice: spilling evictions to disk (``ckpt_dir``), the
durable job store, telemetry and the watchdog (ROADMAP queue 1, item 8),
and the farm mesh (item 9); asking for any of them raises.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cfd.ns3d import CFDConfig
from repro_torch.sim.farm import SimRequest, SimResult, SimulationFarm, not_ported


@dataclasses.dataclass
class _Evicted:
    req: SimRequest
    steps_done: int
    state: dict              # CPU tensors


class SimulationService:
    """submit/poll/result over a SimulationFarm, with eviction hooks."""

    def __init__(self, base_config: CFDConfig, n_slots: int = 8,
                 check_steady_every: int = 16, device=None,
                 ckpt_dir: str | None = None, store=None, mesh=None,
                 telemetry=None, health=None):
        for what, value in (("ckpt_dir", ckpt_dir), ("store", store)):
            if value:
                raise not_ported(what)
        self.farm = SimulationFarm(base_config, n_slots,
                                   check_steady_every=check_steady_every,
                                   device=device, mesh=mesh,
                                   telemetry=telemetry, health=health)
        self._evicted: dict[int, _Evicted] = {}
        self._requeued_progress: dict[int, int] = {}  # readmitted, waiting

    def submit(self, req: SimRequest) -> int:
        """Queue a simulation; returns its sid."""
        return self.farm.submit(req)

    def poll(self, sid: int) -> dict:
        """{"status": queued|running|evicted|done|failed, "steps_done": int};
        a failed simulation also carries its ``error`` string."""
        if sid in self.farm.results:
            res = self.farm.results[sid]
            if res.terminated == "failed":
                return {"status": "failed", "steps_done": res.steps_done,
                        "error": res.error}
            return {"status": "done", "steps_done": res.steps_done}
        if sid in self._evicted:
            return {"status": "evicted",
                    "steps_done": self._evicted[sid].steps_done}
        running = self.farm.steps_done(sid)
        if running is not None:
            self._requeued_progress.pop(sid, None)
            return {"status": "running", "steps_done": running}
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

    def evict(self, sid: int) -> bool:
        """Move a resident simulation's fields to host RAM, freeing its
        slot; False if ``sid`` is not resident."""
        pulled = self.farm.evict(sid)
        if pulled is None:
            return False
        req, state, steps_done = pulled
        self._evicted[sid] = _Evicted(req=req, steps_done=steps_done,
                                      state=state)
        return True

    def readmit(self, sid: int) -> bool:
        """Re-queue an evicted simulation; it resumes at its exact step.
        Its fields stay in host RAM until a slot admits it."""
        ev = self._evicted.get(sid)
        if ev is None:
            return False
        self.farm.submit(dataclasses.replace(
            ev.req, init_state=ev.state, step0=ev.steps_done, sid=sid))
        # only now is the sim requeued: a refused submit keeps the record
        del self._evicted[sid]
        self._requeued_progress[sid] = ev.steps_done
        return True

    def drain(self, max_device_steps: int = 100_000) -> dict[int, SimResult]:
        """Readmit everything evicted, then run the farm dry.  Every
        submitted sid resolves, failed sims as ``terminated="failed"``."""
        for sid in list(self._evicted):
            self.readmit(sid)
        return self.farm.run_until_drained(max_device_steps)
