"""Step-time watchdog and liveness heartbeat.

The port of ``repro.ft.watchdog`` (pure stdlib).  ``StepWatchdog`` keeps an
EWMA of step (here: farm chunk) wall times and flags anomalies: a
``slow_step`` above ``slow_factor`` times the mean, a ``hang`` above
``hang_factor`` times it, and a ``checkpoint_requested`` after
``checkpoint_after_slow`` slow steps in a row.  ``Heartbeat`` touches a
liveness file no more often than its interval, for an external
orchestrator that restarts a process whose file went stale.  The
simulation service feeds both (``repro_torch.sim.service``).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class WatchdogEvent:
    kind: str          # "slow_step" | "hang" | "checkpoint_requested"
    step: int
    step_time: float
    threshold: float


class StepWatchdog:
    def __init__(self, *, ewma_alpha: float = 0.1, slow_factor: float = 1.5,
                 hang_factor: float = 5.0, warmup_steps: int = 5,
                 checkpoint_after_slow: int = 3):
        self.alpha = ewma_alpha
        self.slow_factor = slow_factor
        self.hang_factor = hang_factor
        self.warmup = warmup_steps
        self.checkpoint_after_slow = checkpoint_after_slow
        self.ewma: float | None = None
        self.n = 0
        self.consecutive_slow = 0
        self.events: list[WatchdogEvent] = []
        self._t0: float | None = None

    # -- timing interface ------------------------------------------------------
    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> list[WatchdogEvent]:
        assert self._t0 is not None, "end_step without start_step"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, step_time: float) -> list[WatchdogEvent]:
        """Feed one step time; returns any new events."""
        new: list[WatchdogEvent] = []
        self.n += 1
        if self.ewma is None:
            self.ewma = step_time
        if self.n > self.warmup:
            slow_thr = self.slow_factor * self.ewma
            hang_thr = self.hang_factor * self.ewma
            if step_time > hang_thr:
                new.append(WatchdogEvent("hang", step, step_time, hang_thr))
            elif step_time > slow_thr:
                self.consecutive_slow += 1
                new.append(WatchdogEvent("slow_step", step, step_time,
                                         slow_thr))
                if self.consecutive_slow >= self.checkpoint_after_slow:
                    new.append(WatchdogEvent("checkpoint_requested", step,
                                             step_time, slow_thr))
                    self.consecutive_slow = 0
            else:
                self.consecutive_slow = 0
        # EWMA updates on non-hang steps only (hangs would poison the mean)
        if not any(e.kind == "hang" for e in new):
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        self.events.extend(new)
        return new

    @property
    def should_checkpoint(self) -> bool:
        return any(e.kind == "checkpoint_requested" for e in self.events)


class Heartbeat:
    """Deadline-based liveness marker for the orchestrator (file mtime —
    the single-host analogue of the coordination-service heartbeat)."""

    def __init__(self, path: str, interval_s: float = 30.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self):
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as f:
                f.write(str(now))
            self._last = now

    @staticmethod
    def is_alive(path: str, deadline_s: float) -> bool:
        import os

        try:
            return (time.time() - os.path.getmtime(path)) < deadline_s
        except OSError:
            return False
