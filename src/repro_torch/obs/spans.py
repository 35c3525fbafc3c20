"""Spans: named host intervals on the profiler's clock, with no fence.

One hook for every layer of the port: the solver step and its four phases
(``ns3d.*``), the ghost-zone set-up of a launch (``ops.*``), the farm's
phases (``farm.*``, ``ensemble.*``, ``service.*``) and the schedule's bins.

* With a ``torch.profiler`` running, :func:`span` opens a FUNCTION-scope
  range (``torch._C._profiler._RecordFunctionFast``).  It shows on the
  host timeline of the trace like an operator, and gets no device-side
  copy, which a user-scope ``record_function`` range does.
* Otherwise it costs one flag check.

An enabled :class:`~repro_torch.obs.Telemetry` handle's ``span`` adds a
record stamped with ``time.time_ns()``, the clock of the profiler's host
events.  No span synchronises with the device: over asynchronous launches
a span times their enqueue, never the device work.
"""
from __future__ import annotations

import contextlib
import typing
from time import time_ns

import torch
import torch.autograd.profiler as _profiler

_RANGE = torch._C._profiler._RecordFunctionFast
OFF = contextlib.nullcontext()


class SpanRecord(typing.NamedTuple):
    """One closed span of an enabled telemetry handle: epoch nanoseconds,
    the name of the span it nests in (None at the top), its attributes."""

    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    attrs: dict


def span(name: str):
    """A context manager around one layer's host work: a FUNCTION-scope
    profiler range while a profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _RANGE(name)
    return OFF


class DeviceClock:
    """Device time of one span name from pairs of CUDA timing events,
    read without a wait: a pair counts once its end event has completed
    (events of one stream complete in order)."""

    __slots__ = ("pending", "seconds", "steps")

    FOLD_AT = 64      # pending pairs kept before the completed are folded

    def __init__(self):
        self.pending: list[tuple] = []
        self.seconds = 0.0
        self.steps = 0

    def add(self, start, end, steps: int):
        self.pending.append((start, end, steps))
        if len(self.pending) > self.FOLD_AT:
            self.fold()

    def fold(self):
        done = 0
        for start, end, steps in self.pending:
            if not end.query():
                break
            self.seconds += start.elapsed_time(end) / 1e3
            self.steps += steps
            done += 1
        del self.pending[:done]


def _device_start(device):
    """The start of a device clock on ``device``'s current stream, or None
    where ``device`` is not a card."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev, device


class TelemetrySpan:
    """``Telemetry.span``'s context manager: the profiler range, the NVTX
    range (``named_scopes`` on a card), the timer tree's node and the
    record, all from one host interval; with a CUDA ``device``, a pair of
    timing events booked to the name's :class:`DeviceClock`."""

    __slots__ = ("tel", "name", "device", "attrs", "_range", "_node",
                 "_t0", "_ev")

    def __init__(self, tel, name: str, device, attrs: dict):
        self.tel = tel
        self.name = name
        self.device = device
        self.attrs = attrs

    def __enter__(self):
        tel = self.tel
        self._range = span(self.name)
        self._range.__enter__()
        if tel.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._node = tel.timers.enter(self.name)
        self._ev = _device_start(self.device)
        self._t0 = time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time_ns()
        tel = self.tel
        if self._ev is not None:
            start, device = self._ev
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(device))
            tel.device_clock(self.name).add(start, end,
                                            int(self.attrs.get("steps", 1)))
        parent = tel.timers.leave(self._node, (t1 - self._t0) / 1e9)
        tel.spans.append(SpanRecord(self.name, self._t0, t1, parent,
                                    self.attrs))
        if tel.nvtx:
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        return False
