"""repro_torch.obs — Cactus-style observability: timers, metrics, traces.

The port of ``repro.obs``: three pillars behind one handle.

* :class:`~repro_torch.obs.metrics.Registry` — labeled counters / gauges /
  histograms (``farm.slot_occupancy``, ``farm.queue_depth{priority}``,
  ``farm.compile_cache{result}``, ``sim.steps_total``,
  ``service.submit_to_result_seconds``), snapshottable to a dict.
* :class:`~repro_torch.obs.timers.TimerTree` — hierarchical wall-clock
  timers around every schedule bin and every farm phase, rendered
  Cactus-style by :func:`report`.
* :class:`~repro_torch.obs.trace.TraceLog` — per-simulation lifecycle
  events (submit -> admit -> first_step -> evict/readmit -> steady ->
  result), streamed as JSON lines and exportable to the Chrome trace-event
  format (Perfetto-loadable).

The contract that makes it safe to thread everywhere: **telemetry off is
bitwise-invisible**.  A disabled :class:`Telemetry` (the :data:`NULL`
singleton) makes every hook a no-op — no timers, no
``torch.cuda.synchronize`` fences, no profiler ranges, no events — so the
default path launches exactly what it launched before.  Enable it per
runtime (``repro_torch.api.runtime(..., telemetry=True)``) or standalone::

    tel = repro_torch.obs.telemetry(trace_path="events.jsonl")
    with tel.section("my_phase"):
        ...
    print(repro_torch.obs.report(tel))
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

from repro_torch.obs.bench import (
    SCHEMA as BENCH_SCHEMA, host_info, load_bench, make_bench_doc,
    validate_bench, write_bench,
)
from repro_torch.obs.health import (
    DIAG_COLUMNS, FlightRecorder, HealthConfig, HealthMonitor,
    load_flight_record, render_dashboard, resolve_health,
)
from repro_torch.obs.metrics import Histogram, Registry, series_key
from repro_torch.obs.timers import TimerNode, TimerTree
from repro_torch.obs.trace import TraceLog, validate_chrome_trace

__all__ = [
    "BENCH_SCHEMA", "DIAG_COLUMNS", "FlightRecorder", "HealthConfig",
    "HealthMonitor", "Histogram", "NULL", "Registry", "Telemetry",
    "TelemetryConfig", "TimerNode", "TimerTree", "TraceLog", "host_info",
    "load_bench", "load_flight_record", "make_bench_doc",
    "render_dashboard", "report", "resolve", "resolve_health",
    "series_key", "telemetry", "validate_bench", "validate_chrome_trace",
    "write_bench",
]

_NULL_CM = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """How much to observe, and where the byproducts land.

    ``named_scopes`` additionally wraps instrumented regions in
    ``torch.profiler.record_function`` (and an NVTX range where torch sees
    a card), so schedule bins and farm phases show up in profiler traces.
    The heartbeat fields drive the service watchdog: a liveness file
    touched every ``heartbeat_interval_s`` (for an external orchestrator),
    and a stall recorded whenever consecutive beats are further apart than
    ``heartbeat_deadline_s``.
    """

    enabled: bool = True
    trace_path: str | None = None        # stream events as JSON lines
    named_scopes: bool = True            # annotate profiler traces
    heartbeat_path: str | None = None    # liveness file (ft.watchdog)
    heartbeat_interval_s: float = 5.0
    heartbeat_deadline_s: float = 60.0


def _cuda_devices(x) -> set:
    """The CUDA devices of the tensors in a tree (dicts, lists, tuples)."""
    import torch

    if torch.is_tensor(x):
        return {x.device} if x.device.type == "cuda" else set()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in x))
    return set()


class Telemetry:
    """The live handle: one registry + one timer tree + one trace log."""

    enabled = True

    def __init__(self, config: TelemetryConfig | None = None, **kw):
        self.config = config if config is not None else TelemetryConfig(**kw)
        self.metrics = Registry()
        self.timers = TimerTree()
        self.trace = TraceLog(path=self.config.trace_path)
        global _CURRENT
        _CURRENT = self

    # -- hooks (every one a no-op on NULL) ------------------------------------
    def section(self, name: str):
        """Timer context manager for a nested wall-clock section."""
        return self.timers.section(name)

    def named_scope(self, name: str):
        """Profiler annotation: ``torch.profiler.record_function`` on the
        host timeline, plus an NVTX range where torch sees a card."""
        if not self.config.named_scopes:
            return _NULL_CM
        import torch

        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            ctx.enter_context(torch.cuda.nvtx.range(name))
        return ctx

    def fence(self, x):
        """``torch.cuda.synchronize`` on each card that holds a tensor of
        ``x``, so a section's clock covers the device work it launched; a
        no-op for CPU tensors.  Exists ONLY behind enabled telemetry: the
        off path adds no synchronisation."""
        import torch

        for dev in _cuda_devices(x):
            torch.cuda.synchronize(dev)
        return x

    # -- views ----------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "metrics": self.metrics.snapshot(),
            "timers": self.timers.snapshot(),
            "n_events": len(self.trace.events),
        }

    def dump_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return path

    def report(self) -> str:
        """Human-readable timers + metrics summary (Cactus TimerReport)."""
        parts = ["== repro.obs report ==", self.timers.report()]
        m = self.metrics.report()
        if m:
            parts.append(m)
        if self.trace.events:
            parts.append(f"-- trace: {len(self.trace.events)} events --")
        return "\n".join(parts)

    def reset(self):
        self.metrics.reset()
        self.timers.reset()


class _NullTelemetry(Telemetry):
    """Disabled telemetry: every hook is a no-op; shared singleton."""

    enabled = False

    def __init__(self):
        self.config = TelemetryConfig(enabled=False)
        self.metrics = _NullRegistry()
        self.timers = _NullTimerTree()
        self.trace = _NullTraceLog()

    def section(self, name):
        return _NULL_CM

    def named_scope(self, name):
        return _NULL_CM

    def fence(self, x):
        return x

    def report(self):
        return "== repro.obs report ==\n(telemetry disabled)"


class _NullRegistry(Registry):
    def inc(self, name, value=1, **labels):
        return 0

    def set(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass


class _NullTimerTree(TimerTree):
    def section(self, name):
        return _NULL_CM


class _NullTraceLog(TraceLog):
    def __init__(self):
        super().__init__(path=None)

    def emit(self, kind, sid=None, **data):
        return {}


NULL = _NullTelemetry()
_CURRENT: Telemetry = NULL


def telemetry(**kw) -> Telemetry:
    """Build an enabled :class:`Telemetry` (kwargs per TelemetryConfig)."""
    return Telemetry(TelemetryConfig(**kw))


def resolve(spec) -> Telemetry:
    """Coerce a user-facing telemetry spec to a live handle.

    Accepts: a Telemetry (passes through), None/False (disabled ->
    :data:`NULL`), True (fresh default-config handle), a
    :class:`TelemetryConfig`, or a dict of TelemetryConfig kwargs.
    """
    if isinstance(spec, Telemetry):
        return spec
    if spec is None or spec is False:
        return NULL
    if spec is True:
        return Telemetry()
    if isinstance(spec, TelemetryConfig):
        return Telemetry(spec) if spec.enabled else NULL
    if isinstance(spec, dict):
        cfg = TelemetryConfig(**spec)
        return Telemetry(cfg) if cfg.enabled else NULL
    raise TypeError(
        f"telemetry must be a Telemetry, TelemetryConfig, dict, or bool; "
        f"got {type(spec).__name__}")


def report(tel: Telemetry | None = None) -> str:
    """Render the handle's (default: the most recently enabled
    telemetry's) timer/metrics summary."""
    return (tel if tel is not None else _CURRENT).report()


def __getattr__(name: str):
    # repro_torch.obs.perf pulls in the roofline chips and, at call time,
    # the op-cost trace and the farm stack: lazy, so `import
    # repro_torch.obs` stays light and the farm's own top-level
    # `from repro_torch import obs` cannot cycle through it
    if name == "perf":
        import importlib

        return importlib.import_module("repro_torch.obs.perf")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
