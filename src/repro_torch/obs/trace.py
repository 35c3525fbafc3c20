"""Per-simulation lifecycle traces: JSON-lines log + Chrome trace export.

The port of ``repro.obs.trace`` (pure stdlib): the same events, the same
JSON-lines records and the same Chrome document.

Every simulation moving through the farm leaves a breadcrumb trail —
``submit -> admit -> first_step -> (evict -> readmit)* -> steady? ->
result`` — with its request id, tag, priority, static signature, and (for
failed simulations) the error string.  Events append to an
in-memory list and, when a path is configured, stream to a JSON-lines
file as they happen (one JSON object per line: crash-durable, ``tail
-f``-able, trivially greppable by ``sid``).

``to_chrome()`` converts the log to the Chrome trace-event format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
lifecycle events become instant events on one track per simulation, and
each admit..(result|evict) residency becomes a complete ("X") span on the
slot's track — load the file in Perfetto (ui.perfetto.dev) or
chrome://tracing and the farm's slot occupancy is the picture.
"""
from __future__ import annotations

import json
import threading
import time

# event kinds that end a residency span opened by "admit"
_SPAN_ENDS = ("result", "evict")

# health-vocabulary events (state transitions, watchdog marks,
# quarantines) get their own Chrome-trace process track so the health
# timeline reads separately from the lifecycle instants
_HEALTH_PID = 3


class TraceLog:
    """Append-only event log with monotonic timestamps and sequence ids.

    ``ts`` is seconds since the log was created (monotonic clock — safe
    for ordering and durations); ``t0_ns`` anchors the log's t=0 to the
    epoch in nanoseconds (``time.time_ns()``), the clock of the spans and
    of the profiler's host events, so ``t0_ns + ts * 1e9`` places an
    event beside them.
    """

    def __init__(self, path: str | None = None, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.t0_ns = time.time_ns()
        self.path = path
        self._file = None
        self._lock = threading.Lock()
        self._seq = 0
        self.events: list[dict] = []

    def emit(self, kind: str, sid: int | None = None, **data) -> dict:
        """Record one event; extra keyword data must be JSON-serializable."""
        ev = {"seq": None, "ts": self._clock() - self._t0, "kind": kind}
        if sid is not None:
            ev["sid"] = sid
        ev.update(data)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self.events.append(ev)
            if self.path is not None:
                if self._file is None:
                    self._file = open(self.path, "a")
                self._file.write(json.dumps(ev) + "\n")
                self._file.flush()
        return ev

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- queries --------------------------------------------------------------
    def events_for(self, sid: int) -> list[dict]:
        with self._lock:
            return [e for e in self.events if e.get("sid") == sid]

    def kinds_for(self, sid: int) -> list[str]:
        return [e["kind"] for e in self.events_for(sid)]

    # -- serialization --------------------------------------------------------
    def dumps_jsonl(self) -> str:
        with self._lock:
            return "\n".join(json.dumps(e) for e in self.events)

    def to_chrome(self) -> dict:
        """The log as a Chrome trace-event document (Perfetto-loadable)."""
        with self._lock:
            events = [dict(e) for e in self.events]
        out = []
        open_spans: dict[int, dict] = {}   # sid -> admit event
        for ev in events:
            ts_us = ev["ts"] * 1e6
            sid = ev.get("sid")
            args = {k: v for k, v in ev.items()
                    if k not in ("seq", "ts", "kind")}
            out.append({
                "name": ev["kind"],
                "ph": "i", "s": "p",        # instant, process-scoped
                "ts": ts_us,
                "pid": _HEALTH_PID if ev["kind"] == "health" else 1,
                "tid": sid if sid is not None else 0,
                "args": args,
            })
            if sid is None:
                continue
            if ev["kind"] == "admit":
                open_spans[sid] = ev
            elif ev["kind"] in _SPAN_ENDS and sid in open_spans:
                start = open_spans.pop(sid)
                slot = start.get("slot", 0)
                out.append({
                    "name": start.get("tag") or f"sim {sid}",
                    "ph": "X",
                    "ts": start["ts"] * 1e6,
                    "dur": ts_us - start["ts"] * 1e6,
                    "pid": 2, "tid": slot,
                    "args": {"sid": sid, "until": ev["kind"]},
                })
        meta = [
            {"name": "process_name", "ph": "M", "pid": 1, "ts": 0,
             "args": {"name": "simulations"}},
            {"name": "process_name", "ph": "M", "pid": 2, "ts": 0,
             "args": {"name": "farm slots"}},
            {"name": "process_name", "ph": "M", "pid": _HEALTH_PID, "ts": 0,
             "args": {"name": "health"}},
        ]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def save_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def validate_chrome_trace(doc: dict) -> dict:
    """Schema-check a Chrome trace-event document; returns it or raises.

    Checks the subset Perfetto actually requires: a ``traceEvents`` list
    whose entries carry ``name``/``ph``/``ts``/``pid``/``tid``, known
    phase codes, non-negative microsecond timestamps, and a duration on
    every complete ("X") event.
    """
    problems = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("chrome trace must be a dict with a "
                         "'traceEvents' list")
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field == "tid" and ev.get("ph") == "M":
                continue   # metadata events need no thread
            if field not in ev:
                problems.append(f"{where}: missing {field!r}")
        if ev.get("ph") not in ("i", "I", "X", "B", "E", "M"):
            problems.append(f"{where}: unknown phase {ev.get('ph')!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: ts must be a non-negative number")
        if ev.get("ph") == "X" and not isinstance(
                ev.get("dur"), (int, float)):
            problems.append(f"{where}: complete event missing 'dur'")
    if problems:
        raise ValueError("invalid chrome trace: " + "; ".join(problems))
    return doc
