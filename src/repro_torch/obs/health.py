"""repro_torch.obs.health — in-situ simulation health: NaN quarantine + flight recorder.

The port of ``repro.obs.health``.  The solver computes a small vector of
physics diagnostics — divergence L∞, kinetic energy, max|u| → CFL number,
and a NaN/Inf sentinel — on the slot-stacked state on the device, once a
farm chunk on the chunk's final state (NaN/Inf and divergence persist in
the fields, so a chunk-end sample detects what a per-step sample would),
and shift-appends it into a device-side ``(slots, K, N_DIAG)`` ring
(``repro_torch.sim.ensemble``).  The farm copies that ring to the host
only at its ``check_steady_every`` harvest boundary, one device-to-host
copy, so the steady state pays no extra host sync.

On drain, a per-sim state machine classifies the new frames::

    healthy -> warning -> diverged / nan

with configurable thresholds (:class:`HealthConfig`).  A sim entering a
terminal state is **quarantined**: its slot is released with
``terminated="diverged"``, its last-K frames and final field state are
written through ``ckpt.Checkpointer`` as a *flight record*
(:func:`load_flight_record`), and the other slots keep stepping bitwise as
if the bad sim had never been admitted — slots never interact.

Health is functional, not telemetry: quarantine works with telemetry off,
and with health off (the default) the farm runs the step it ran before.
This module stays light (stdlib + numpy); the checkpointer is imported
where a flight record is written or read.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from collections import deque

import numpy as np

# One health frame = one row of the device ring buffer, in this column
# order.  Column 0 is the device step the frame was sampled at; a step
# of -1 marks a slot-reset sentinel row (no frame recorded yet).  The
# physics columns mirror ``ns3d.HEALTH_DIAGS`` — a test pins the two
# tuples against each other.
DIAG_COLUMNS = ("step", "div_linf", "ke", "umax", "cfl", "finite")
N_DIAG = len(DIAG_COLUMNS)
_COL = {name: i for i, name in enumerate(DIAG_COLUMNS)}

# health state machine, in severity order; DIVERGED/NAN are terminal
HEALTHY = "healthy"
WARNING = "warning"
DIVERGED = "diverged"
NAN = "nan"
STATES = (HEALTHY, WARNING, DIVERGED, NAN)
STATE_CODE = {s: i for i, s in enumerate(STATES)}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Health-monitoring knobs (thresholds in solver units).

    ``window`` is K, the per-slot ring depth: how many most-recent
    frames survive to a flight record and how far back ``poll`` /
    ``Runtime.watch`` can look.  Divergence/CFL cross the *warn*
    threshold -> ``warning`` (recoverable), the *diverged* threshold ->
    quarantine; a non-finite field value -> ``nan`` -> quarantine.
    ``flight_dir=None`` disables flight records (quarantine still
    evicts); the Runtime defaults it to ``<ckpt_dir>/flight`` when a
    checkpoint directory is configured.
    """

    window: int = 8
    div_warn: float = 1e3
    div_diverged: float = 1e7
    cfl_warn: float = 2.0
    cfl_diverged: float = 1e3
    quarantine: bool = True
    flight_dir: str | None = None


def resolve_health(spec) -> HealthConfig | None:
    """Coerce a user-facing health spec: None/False -> off, True ->
    defaults, HealthConfig passes through, dict -> kwargs."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return HealthConfig()
    if isinstance(spec, HealthConfig):
        return spec
    if isinstance(spec, dict):
        return HealthConfig(**spec)
    raise TypeError(
        f"health must be a HealthConfig, dict, or bool; got "
        f"{type(spec).__name__}")


def frame_from_row(row) -> dict:
    """Decode one ring row into a named frame (plain python scalars)."""
    frame = {k: float(v) for k, v in zip(DIAG_COLUMNS, row)}
    frame["step"] = int(frame["step"])
    return frame


def classify_frame(frame: dict, cfg: HealthConfig) -> tuple[str, str]:
    """``(state, cause)`` of one frame under ``cfg``'s thresholds."""
    finite = frame.get("finite", 1.0)
    div, cfl = frame.get("div_linf", 0.0), frame.get("cfl", 0.0)
    if finite < 0.5 or not all(math.isfinite(v) for v in (div, cfl)):
        return NAN, "nonfinite"
    if div >= cfg.div_diverged:
        return DIVERGED, "divergence"
    if cfl >= cfg.cfl_diverged:
        return DIVERGED, "cfl"
    if div >= cfg.div_warn:
        return WARNING, "divergence"
    if cfl >= cfg.cfl_warn:
        return WARNING, "cfl"
    return HEALTHY, ""


def _all_healthy(rows: np.ndarray, cfg: HealthConfig) -> bool:
    """Vectorized ``classify_frame(...) == HEALTHY`` over a row batch —
    the steady-state drain path stays in numpy, no per-frame dicts."""
    div, cfl = rows[:, _COL["div_linf"]], rows[:, _COL["cfl"]]
    finite = rows[:, _COL["finite"]]
    ok = ((finite >= 0.5) & np.isfinite(div) & np.isfinite(cfl)
          & (div < cfg.div_warn) & (cfl < cfg.cfl_warn))
    return bool(ok.all())


class SimHealth:
    """Per-sim health record: current state + the last-K frames seen.

    Frames are stored as raw ring rows (numpy, DIAG_COLUMNS order);
    named-dict views (:attr:`frames`, :attr:`latest`) are built on
    demand, so the steady-state drain path never materializes python
    dicts.
    """

    __slots__ = ("sid", "slot", "tag", "state", "cause", "_rows",
                 "last_step", "resident")

    def __init__(self, sid: int, slot: int, tag: str, window: int):
        self.sid = sid
        self.slot = slot
        self.tag = tag
        self.state = HEALTHY
        self.cause = ""
        self._rows: deque = deque(maxlen=window)
        self.last_step = -1
        self.resident = True

    @property
    def frames(self) -> list[dict]:
        return [frame_from_row(r) for r in self._rows]

    @property
    def latest(self) -> dict | None:
        return frame_from_row(self._rows[-1]) if self._rows else None

    def frames_array(self) -> np.ndarray:
        """The record's frames as a ``(k, N_DIAG)`` float32 array
        (DIAG_COLUMNS order) — what the flight recorder persists."""
        if not self._rows:
            return np.zeros((0, N_DIAG), np.float32)
        return np.stack(list(self._rows)).astype(np.float32)


class HealthMonitor:
    """The host half: per-sim state machines fed by ring drains.

    The farm calls :meth:`admit` when a sim takes a slot, feeds each
    drained ring slice through :meth:`observe`, and :meth:`release`-s on
    eviction/quarantine/finish.  Transitions emit ``kind="health"``
    trace events and ``health.*`` metrics (rendered as
    ``repro_health_*`` by ``prometheus_text``); the watchdog shares the
    same event schema through :meth:`mark` so one timeline explains both
    hangs and divergences.
    """

    def __init__(self, config: HealthConfig, telemetry=None,
                 farm_id: str = "farm"):
        from repro_torch import obs

        self.config = config
        self.tel = obs.resolve(telemetry)
        self.farm_id = farm_id
        self.records: dict[int, SimHealth] = {}

    # -- lifecycle ------------------------------------------------------------
    def admit(self, sid: int, slot: int, tag: str = "",
              last_step: int = -1) -> SimHealth:
        """Start tracking ``sid`` in ``slot``.  ``last_step`` is the
        device step just before admission: ring rows at or below it
        belong to the slot's previous occupant (the step column is the
        executor's monotonic counter) and are never attributed to this
        sim — which is what lets admission skip a device-side ring
        reset."""
        rec = SimHealth(sid, slot, tag, self.config.window)
        rec.last_step = int(last_step)
        self.records[sid] = rec
        return rec

    def release(self, sid: int):
        """Sim left the farm: retire its per-sim gauge but keep the
        record (the dashboard shows the last known state)."""
        rec = self.records.get(sid)
        if rec is None:
            return
        rec.resident = False
        self.tel.metrics.remove("health.sim_state", sid=sid)

    # -- observation ----------------------------------------------------------
    def observe(self, sid: int, rows: np.ndarray) -> SimHealth:
        """Feed one drained ring slice ``(K, N_DIAG)`` for ``sid``.

        Rows with ``step < 0`` are reset sentinels (no frame yet);
        already-seen steps are skipped, the rest run through the state
        machine in step order.  Returns the (possibly transitioned)
        record — the farm quarantines on DIVERGED/NAN.
        """
        rec = self.records.get(sid)
        if rec is None:
            rec = self.admit(sid, -1)
        rows = np.asarray(rows, np.float32)
        fresh = rows[(rows[:, 0] >= 0) & (rows[:, 0] > rec.last_step)]
        if not len(fresh):
            return rec
        fresh = fresh[np.argsort(fresh[:, 0], kind="stable")]
        if rec.state == HEALTHY and _all_healthy(fresh, self.config):
            # steady-state fast path: every frame healthy, no transition
            # possible — batch-append the raw rows, build no dicts
            rec._rows.extend(fresh)
            rec.last_step = int(fresh[-1, 0])
        else:
            for row in fresh:
                frame = frame_from_row(row)
                rec._rows.append(row)
                rec.last_step = frame["step"]
                self._transition(rec, *classify_frame(frame, self.config),
                                 frame=frame)
        self.tel.metrics.inc("health.frames", len(fresh))
        self.tel.metrics.set("health.sim_state", STATE_CODE[rec.state],
                             sid=sid)
        return rec

    def mark(self, sid: int, state: str, cause: str, **detail):
        """External transition (the watchdog's hook): push ``sid``
        toward ``state`` with the same event schema as frame-driven
        transitions — stalls and divergences share one timeline."""
        rec = self.records.get(sid)
        if rec is None:
            return
        self._transition(rec, state, cause, frame=rec.latest, detail=detail)

    def _transition(self, rec: SimHealth, state: str, cause: str,
                    frame: dict | None = None, detail: dict | None = None):
        if STATE_CODE[rec.state] >= STATE_CODE[DIVERGED]:
            return                          # terminal states stick
        if state == rec.state:
            return
        if STATE_CODE[state] < STATE_CODE[rec.state] and state != HEALTHY:
            return                          # only warning->healthy recovers
        prev, rec.state, rec.cause = rec.state, state, cause
        ev = {"farm": self.farm_id, "slot": rec.slot, "tag": rec.tag,
              "state": state, "from": prev, "cause": cause}
        if frame is not None:
            ev["frame"] = frame
        if detail:
            ev.update(detail)
        self.tel.trace.emit("health", sid=rec.sid, **ev)
        self.tel.metrics.inc("health.events", state=state, cause=cause)

    # -- views ----------------------------------------------------------------
    def state_of(self, sid: int) -> str | None:
        rec = self.records.get(sid)
        return rec.state if rec is not None else None

    def frame_of(self, sid: int) -> dict | None:
        """Latest health frame + state for ``sid`` (what ``poll``
        streams as the intermediate analysis), or None before the first
        drain."""
        rec = self.records.get(sid)
        if rec is None:
            return None
        out = {"state": rec.state, "cause": rec.cause}
        if rec.latest is not None:
            out.update(rec.latest)
        return out

    def counts(self) -> dict:
        """Resident sims per health state (the dashboard summary row)."""
        out = {s: 0 for s in STATES}
        for rec in self.records.values():
            if rec.resident:
                out[rec.state] += 1
        return out

    def export_gauges(self):
        """Refresh the per-state residency gauges after a drain."""
        for state, n in self.counts().items():
            self.tel.metrics.set("health.sims", n, state=state)


# -- flight recorder ----------------------------------------------------------

class FlightRecorder:
    """Post-mortem persistence for quarantined sims, via the checkpointer.

    One record per sid: the ring of its last-K health frames plus its
    final (poisoned) field state, written through
    ``ckpt.Checkpointer.save`` (atomic npz + manifest, keyed by sid in
    place of a step), with a ``flight.json`` sidecar naming the columns,
    field order, cause, and thresholds so :func:`load_flight_record`
    needs no solver template to read it back.
    """

    def __init__(self, directory: str):
        from repro_torch.ckpt.checkpointer import Checkpointer

        self.directory = directory
        self._ckpt = Checkpointer(directory, keep_last=0)

    def path_of(self, sid: int) -> str:
        """The directory of ``sid``'s record."""
        return os.path.join(self.directory, f"step_{sid:08d}")

    def record(self, sid: int, *, frames: np.ndarray, state: dict,
               meta: dict | None = None) -> str:
        fields = sorted(state)
        # dict trees flatten with keys sorted, so this tree's leaf order
        # is (frames, *state[fields]) — flight.json records `fields` and
        # load_flight_record rebuilds the structure from it
        from repro_torch.ckpt.checkpointer import to_numpy

        tree = {"frames": np.asarray(frames, np.float32),
                "state": {k: to_numpy(state[k]) for k in fields}}
        self._ckpt.save(sid, tree, blocking=True)
        path = self.path_of(sid)
        doc = {"sid": sid, "columns": list(DIAG_COLUMNS),
               "state_fields": fields}
        doc.update(meta or {})
        with open(os.path.join(path, "flight.json"), "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        return path


def load_flight_record(directory: str, sid: int) -> dict:
    """Read one flight record back: ``{"frames", "state", "meta"}``.

    ``frames`` is the ``(k, N_DIAG)`` array of the sim's last health
    frames (columns per ``meta["columns"]``), ``state`` the final field
    dict.  Template-free: structure is rebuilt from the sidecar + the
    checkpointer's raw leaves.
    """
    from repro_torch.ckpt.checkpointer import Checkpointer

    path = os.path.join(directory, f"step_{sid:08d}", "flight.json")
    with open(path) as f:
        meta = json.load(f)
    _, leaves = Checkpointer(directory).read_arrays(sid)
    fields = meta["state_fields"]
    if len(leaves) != 1 + len(fields):
        raise ValueError(
            f"flight record for sid {sid}: {len(leaves)} leaves, expected "
            f"frames + {len(fields)} fields")
    return {"frames": leaves[0],
            "state": dict(zip(fields, leaves[1:])),
            "meta": meta}


# -- dashboard ----------------------------------------------------------------

_STATE_MARK = {HEALTHY: "ok", WARNING: "WARN", DIVERGED: "DIVG", NAN: "NaN!"}


def render_dashboard(snapshots: list[dict]) -> str:
    """Cactus-HTTPD-style live text dashboard over farm health snapshots.

    Each snapshot is ``SimulationFarm.health_snapshot()``: farm id,
    device step, queue depth, and one row per slot (free or resident,
    with the latest health frame when monitoring is on).
    """
    lines = ["== repro health =="]
    for snap in snapshots:
        states = snap.get("states") or {}
        summary = " ".join(f"{k}={v}" for k, v in states.items() if v)
        lines.append(
            f"farm {snap['farm']}  device_step={snap['device_steps']}  "
            f"queued={snap['queued']}" + (f"  [{summary}]" if summary else ""))
        lines.append(f"  {'slot':>4} {'sid':>5} {'steps':>11} "
                     f"{'state':>5} {'div_linf':>9} {'ke':>9} "
                     f"{'cfl':>7} tag")
        for row in snap["slots"]:
            if row.get("sid") is None:
                lines.append(f"  {row['slot']:>4} {'-':>5} {'':>11} "
                             f"{'free':>5}")
                continue
            hf = row.get("health") or {}
            mark = _STATE_MARK.get(hf.get("state", ""), "-")
            div = hf.get("div_linf")
            ke = hf.get("ke")
            cfl = hf.get("cfl")
            fmt = lambda v, w: f"{v:>{w}.3g}" if v is not None else " " * w
            lines.append(
                f"  {row['slot']:>4} {row['sid']:>5} "
                f"{row['steps_done']:>5}/{row['steps']:<5} {mark:>5} "
                f"{fmt(div, 9)} {fmt(ke, 9)} {fmt(cfl, 7)} "
                f"{row.get('tag', '')}")
    return "\n".join(lines)
