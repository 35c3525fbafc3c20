"""repro_torch.obs — Cactus-style observability: spans, metrics, traces.

The port of ``repro.obs``: three pillars behind one handle, and one hook
that feeds them.

* :func:`span` / :meth:`Telemetry.span` — the one hook around a layer's
  host work (:mod:`repro_torch.obs.spans`): a FUNCTION-scope range on any
  running ``torch.profiler``'s host timeline, and with telemetry on a
  record on the epoch clock that the profiler's host events use, the
  timer tree's node, and NVTX where torch sees a card.  No span
  synchronises with the device.
* :class:`~repro_torch.obs.metrics.Registry` — labeled counters / gauges /
  histograms (``farm.slot_occupancy``, ``farm.queue_depth{priority}``,
  ``farm.compile_cache{result}``, ``sim.steps_total``,
  ``service.submit_to_result_seconds``), snapshottable to a dict.
* :class:`~repro_torch.obs.timers.TimerTree` — hierarchical wall-clock
  timers around every schedule bin and every farm phase, fed by the
  spans, rendered Cactus-style by :func:`report`.
* :class:`~repro_torch.obs.trace.TraceLog` — per-simulation lifecycle
  events (submit -> admit -> first_step -> evict/readmit -> steady ->
  result), streamed as JSON lines and exportable to the Chrome trace-event
  format (Perfetto-loadable); :meth:`Telemetry.save_chrome` writes them
  with the spans.

The contract that makes it safe to thread everywhere: **telemetry off is
bitwise-invisible**.  A disabled :class:`Telemetry` (the :data:`NULL`
singleton) records nothing — no timers, no events — and its spans are
profiler ranges only while a profiler records, so the default path
launches exactly what it launched before.  Enable it per runtime
(``repro_torch.api.runtime(..., telemetry=True)``) or standalone::

    tel = repro_torch.obs.telemetry(trace_path="events.jsonl")
    with tel.span("my_phase"):
        ...
    print(repro_torch.obs.report(tel))
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json

from repro_torch.obs.health import (
    DIAG_COLUMNS, FlightRecorder, HealthConfig, HealthMonitor,
    load_flight_record, render_dashboard, resolve_health,
)
from repro_torch.obs.metrics import Histogram, Registry, series_key
from repro_torch.obs.spans import (
    DeviceClock, SpanRecord, TelemetrySpan, span,
)
from repro_torch.obs.timers import TimerNode, TimerTree
from repro_torch.obs.trace import TraceLog, validate_chrome_trace

__all__ = [
    "DIAG_COLUMNS", "FlightRecorder", "HealthConfig", "HealthMonitor",
    "Histogram", "NULL", "Registry", "SpanRecord", "Telemetry",
    "TelemetryConfig", "TimerNode", "TimerTree", "TraceLog",
    "load_flight_record", "render_dashboard", "report",
    "resolve", "resolve_health", "series_key", "span", "telemetry",
    "validate_chrome_trace",
]

# the spans' process track in a Chrome document (the lifecycle events
# take 1-3, see obs.trace)
_SPANS_PID = 4


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """How much to observe, and where the byproducts land.

    ``named_scopes`` additionally wraps each span in an NVTX range where
    torch sees a card, for nsys; a running ``torch.profiler`` sees every
    span whatever the handle.
    The heartbeat fields drive the service watchdog: a liveness file
    touched every ``heartbeat_interval_s`` (for an external orchestrator),
    and a stall recorded whenever consecutive beats are further apart than
    ``heartbeat_deadline_s``.
    """

    enabled: bool = True
    trace_path: str | None = None        # stream events as JSON lines
    named_scopes: bool = True            # NVTX ranges around spans
    heartbeat_path: str | None = None    # liveness file (ft.watchdog)
    heartbeat_interval_s: float = 5.0
    heartbeat_deadline_s: float = 60.0


class Telemetry:
    """The live handle: one registry + one timer tree + one trace log,
    and the last ``MAX_SPANS`` span records."""

    enabled = True
    MAX_SPANS = 65_536

    def __init__(self, config: TelemetryConfig | None = None, **kw):
        import torch

        self.config = config if config is not None else TelemetryConfig(**kw)
        self.metrics = Registry()
        self.timers = TimerTree()
        self.trace = TraceLog(path=self.config.trace_path)
        self.spans: collections.deque[SpanRecord] = collections.deque(
            maxlen=self.MAX_SPANS)
        self.nvtx = self.config.named_scopes and torch.cuda.is_available()
        self._device: dict[str, DeviceClock] = {}
        global _CURRENT
        _CURRENT = self

    # -- the hook -------------------------------------------------------------
    def span(self, name: str, device=None, **attrs):
        """Context manager around one layer's host work: the profiler range
        of :func:`span`, a :class:`SpanRecord` (``attrs`` kept with it), the
        timer tree's node from the same interval, and NVTX with
        ``named_scopes`` on a card.  With a CUDA ``device`` it also books
        the span's device time, a pair of timing events on the device's
        current stream, to :meth:`device_seconds` (``steps`` in ``attrs``
        counts the steps it covers).  It never synchronises."""
        return TelemetrySpan(self, name, device, attrs)

    def device_clock(self, name: str) -> DeviceClock:
        clock = self._device.get(name)
        if clock is None:
            clock = self._device[name] = DeviceClock()
        return clock

    def device_seconds(self, name: str) -> tuple[float, int] | None:
        """``(seconds, steps)`` of device time booked by the spans named
        ``name`` whose work the device has finished, read without a wait;
        None where no such span ran on a card or none has finished."""
        clock = self._device.get(name)
        if clock is None:
            return None
        clock.fold()
        return (clock.seconds, clock.steps) if clock.steps else None

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

    def to_chrome(self, base_ns: int = 0) -> dict:
        """The lifecycle events and the spans in one Chrome trace-event
        document, microseconds after ``base_ns`` on the epoch clock: give
        a ``torch.profiler`` export's ``baseTimeNanoseconds`` and the two
        documents line up in Perfetto."""
        doc = self.trace.to_chrome()
        shift = (self.trace.t0_ns - base_ns) / 1e3
        for ev in doc["traceEvents"]:
            if ev["ph"] != "M":
                ev["ts"] += shift
        doc["traceEvents"].append(
            {"name": "process_name", "ph": "M", "pid": _SPANS_PID, "ts": 0,
             "args": {"name": "spans"}})
        for rec in list(self.spans):
            doc["traceEvents"].append({
                "name": rec.name, "ph": "X",
                "ts": (rec.start_ns - base_ns) / 1e3,
                "dur": (rec.end_ns - rec.start_ns) / 1e3,
                "pid": _SPANS_PID, "tid": 0,
                "args": dict(rec.attrs, parent=rec.parent)})
        doc["baseTimeNanoseconds"] = base_ns
        return doc

    def save_chrome(self, path: str, base_ns: int = 0) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(base_ns), f)
        return path

    def reset(self):
        self.metrics.reset()
        self.timers.reset()
        self.spans.clear()
        self._device.clear()


class _NullTelemetry(Telemetry):
    """Disabled telemetry: every hook is a no-op; shared singleton."""

    enabled = False

    def __init__(self):
        self.config = TelemetryConfig(enabled=False)
        self.metrics = _NullRegistry()
        self.timers = _NullTimerTree()
        self.trace = _NullTraceLog()
        self.spans = collections.deque(maxlen=0)
        self.nvtx = False
        self._device = {}

    def span(self, name, device=None, **attrs):
        return span(name)

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
        return contextlib.nullcontext()


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
