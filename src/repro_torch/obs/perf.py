"""repro_torch.obs.perf — cost-model-grounded performance accounting.

The port's counterpart of ``repro.obs.perf``.  Telemetry answers *where the
wall-clock went*; this layer answers *whether that time was any good*.  It
counts what every step the runtime runs costs — the serial EVOLVE bin of
each prepared scenario and each per-static-signature farm step — with the
op-cost trace of :mod:`repro_torch.launch.op_cost` (the stand-in for the
reference's HLO cost model: the step run once on ``meta`` tensors under a
counting dispatch mode, each hand-written kernel booked at its declared
cost), and joins the predicted FLOPs and HBM bytes against the measured
spans (their device time on a card, their host time on the CPU) to report
achieved-against-roofline utilization and a bottleneck (compute / memory /
collective) per row, with the bytes split by op class.

The analytic ghost-zone model (:func:`halo_bytes_per_step`) is kept equal
to the reference's.  The traced count of a decomposed step's exchanges
comes from the same trace, run with the halo's count transport
(:func:`decomposed_step_hlo`, and ``halo_bytes_predicted`` on a decomposed
farm's row): the two must agree to the byte.

A step the trace cannot follow lands as a ``status="unparsed"`` row: the
accounting never raises into a drive loop.

Surfaces: ``Runtime.report(perf=True)`` / ``Runtime.perf_report()`` and
scrape-able gauges via :meth:`PerfReport.export_gauges` behind
``SimulationService.prometheus_text(perf=True)``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.rooflinemodel import Chip, resolve_chip, \
    terms_from_counts

PERF_SCHEMA = "repro.perf.v1"

# every attributed row carries at least these keys (the regression gate's
# contract with the bench envelope)
ROW_KEYS = ("name", "kind", "signature", "status", "n_devices", "flops",
            "hbm_bytes", "collective_wire_bytes", "invocations",
            "measured_s", "compute_s", "memory_s", "collective_s",
            "roofline_s", "bottleneck", "utilization")


@dataclasses.dataclass
class CostRow:
    """Predicted cost of ONE step invocation, per device, plus the
    measured-time join.  ``flops``/``hbm_bytes`` come from
    :func:`repro_torch.launch.op_cost.safe_count`, ``op_classes`` is their
    split by op class; ``measured_s``/``invocations`` from the spans
    (:func:`measured_seconds`)."""

    name: str
    kind: str                        # "farm-step" | "serial-bin"
    signature: str = "-"             # the farm's static signature
    status: str = "ok"               # "ok" | "unparsed"
    n_devices: int = 1
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    halo_bytes_predicted: float | None = None   # permute bytes (decomposed)
    halo_bytes_analytic: float | None = None    # ghost-zone model
    invocations: int = 0
    measured_s: float | None = None  # wall seconds per invocation
    # health accounting (farm rows with a health monitor): ring-buffer
    # drains performed vs harvest boundaries crossed — equal means the
    # monitor added ZERO host syncs beyond the steady-check cadence
    health_drains: int | None = None
    health_boundaries: int | None = None
    error: str | None = None
    # {op class: {"bytes", "flops", "calls"}}: each kernel by name, and
    # cat / flip / fill / other for the rest
    op_classes: dict = dataclasses.field(default_factory=dict)


# -- cost extraction ----------------------------------------------------------
def cost_row_from_trace(fn, args, *, name: str, kind: str,
                        signature: str = "-") -> CostRow:
    """Count ``fn(*args)`` (``meta`` tensors) with the op-cost trace; a
    trace that fails records ``status="unparsed"`` instead of raising."""
    from repro_torch.launch import op_cost

    counter, status, err = op_cost.safe_count(fn, *args)
    row = CostRow(name=name, kind=kind, signature=signature, status=status,
                  error=err)
    if counter is not None:
        row.flops = float(counter.flops)
        row.hbm_bytes = float(counter.hbm_bytes)
        row.op_classes = {k: dict(v) for k, v in counter.classes.items()}
    return row


# -- analytic halo model ------------------------------------------------------
def _norm_w(w) -> tuple[int, int]:
    if isinstance(w, int):
        return (w, w)
    lo, hi = w
    return (int(lo), int(hi))


def exchange_permute_bytes(local_shape, widths, active_axes,
                           itemsize: int = 4) -> int:
    """Per-device ``collective-permute`` operand bytes of ONE
    ``exchange_pad(u, widths, specs)`` call.

    Mirrors ``repro.core.halo._pad_axis`` exactly: axes pad sequentially
    (later axes exchange strips of the already-padded earlier axes — the
    corner trick), each decomposed axis side ships one strip of width
    ``w`` at the CURRENT padded shape, and non-decomposed axes still grow
    the shape by their BC padding.
    """
    shape = list(local_shape)
    total = 0
    for ax, w in enumerate(widths):
        lo, hi = _norm_w(w)
        if ax in active_axes:
            for side in (lo, hi):
                if side:
                    strip = list(shape)
                    strip[ax] = side
                    total += math.prod(strip) * itemsize
        shape[ax] += lo + hi
    return total


def halo_bytes_per_step(config, active: dict, mesh_extents: dict, *,
                        slots_local: int = 1, itemsize: int = 4) -> int:
    """Analytic per-device ``collective-permute`` operand bytes of ONE
    decomposed ns3d step.

    Mirrors the exchange sequence of ``NavierStokes3D._step_local``:
    three velocity fields at widths (1,1,1); three one-sided divergence
    pads ((1,0),)*3; the Jacobi loop — ``max(jacobi_iters //
    max(fused_sweeps,1), 1)`` iterations padding ``p`` (and, when the
    communication-avoiding smoother is on, also ``rhs``) at the sweep
    width; one one-sided projection pad ((0,1),)*3.  ``active`` maps array
    axis -> mesh axis; ``mesh_extents`` maps mesh axis -> extent;
    ``slots_local`` multiplies for the farm's per-device resident slots.
    The in-situ health diagnostics add nothing here: their divergence
    stencil is interior-only (ghost-free by construction).
    """
    local = list(config.shape)
    for ax, mesh_axis in active.items():
        local[ax] //= mesh_extents[mesh_axis]
    act = set(active)
    k = max(config.fused_sweeps, 1)
    iters = max(config.jacobi_iters // k, 1)
    per_slot = 3 * exchange_permute_bytes(local, (1, 1, 1), act, itemsize)
    per_slot += 3 * exchange_permute_bytes(local, ((1, 0),) * 3, act,
                                           itemsize)
    if k <= 1:
        per_slot += iters * exchange_permute_bytes(local, (1, 1, 1), act,
                                                   itemsize)
    else:  # fused smoother pads p AND rhs at width k each iteration
        per_slot += iters * 2 * exchange_permute_bytes(local, (k, k, k), act,
                                                       itemsize)
    per_slot += exchange_permute_bytes(local, ((0, 1),) * 3, act, itemsize)
    return per_slot * slots_local


def decomposed_step_hlo(config, *, n_slots: int, mesh_axes,
                        slot_axis: str = "slot") -> tuple[dict, dict]:
    """``(counts, active)`` of one step of the slots × shards ensemble,
    per rank — the port's stand-in for the reference's lowering over an
    abstract mesh, which needs no process either.

    The rank's local step (its resident slots, its block) is traced on
    ``meta`` tensors through the CUDA template's glue
    (:mod:`repro_torch.launch.op_cost`), its ghost strips booked by the
    halo's :class:`~repro_torch.core.halo.CountTransport`.  ``counts`` holds
    ``permute_operand_bytes`` (the strips' bytes as the HLO's
    ``collective-permute`` operands hold them, an edge rank's strip
    without a receiver included: equal to :func:`halo_bytes_per_step` by
    construction) and ``permute_ops`` (one per strip, the
    ``collective-permute`` count); ``sent_bytes`` and ``sent_ops`` (only
    the strips with a receiver, for the rank at index 0 of each
    decomposed axis); and the trace's ``flops`` and ``hbm_bytes``.  ``mesh_axes`` is an ordered tuple
    of ``(name, extent)`` pairs, e.g. ``(("slot", 2), ("shard", 2))``;
    ``active`` is ``plan_decomposition``'s."""
    import types

    import torch

    from repro_torch.cfd.ns3d import PARAM_KEYS, NavierStokes3D
    from repro_torch.launch import op_cost
    from repro_torch.sim.ensemble import counted_step, plan_decomposition

    extents = {str(n): int(e) for n, e in mesh_axes}
    shape_of = types.SimpleNamespace(axis_names=tuple(extents), shape=extents)
    solver_cfg, active = plan_decomposition(config, shape_of,
                                            slot_axis=slot_axis)
    virtual = {name: (extents[name], 0) for name in active.values()}
    solver = NavierStokes3D(solver_cfg, "cpu", virtual or None).cost_twin()
    slots = _slots_local(n_slots, extents.get(slot_axis, 1))
    local = solver.driver.local_shape
    fields = (*NavierStokes3D.FIELDS, "mask_vx", "mask_vy", "mask_vz")
    state = {f: torch.empty((slots, *local), device="meta") for f in fields}
    params = {k: torch.empty((slots,), device="meta") for k in PARAM_KEYS}
    step = counted_step(solver)
    counter = op_cost.count(step, state, params, 1)
    transport = step.transport
    booked = ("permute_operand_bytes", "permute_ops", "sent_bytes",
              "sent_ops")
    return {**{k: getattr(transport, k) if transport else 0 for k in booked},
            "flops": float(counter.flops),
            "hbm_bytes": float(counter.hbm_bytes)}, active


# -- runtime extraction -------------------------------------------------------
def _find_sections(timers: dict, name: str) -> tuple[float, int]:
    """Sum (total_s, count) over every node named ``name`` in a nested
    timer snapshot, wherever it nests."""
    tot, cnt = 0.0, 0

    def walk(children: dict):
        nonlocal tot, cnt
        for k, v in children.items():
            if k == name:
                tot += float(v.get("total_s", 0.0))
                cnt += int(v.get("count", 0))
            walk(v.get("children", {}))

    walk(timers or {})
    return tot, cnt


def measured_seconds(telemetry, name: str, invocations: int
                     ) -> float | None:
    """Seconds per invocation of the spans named ``name``: their device
    time where they ran on a card (the timing events that
    ``Telemetry.span`` books, over the steps they cover, read without a
    wait), else their host time in the timer tree over ``invocations``
    (their own count when None)."""
    dev = telemetry.device_seconds(name) if telemetry.enabled else None
    if dev is not None:
        seconds, steps = dev
        return seconds / steps
    tot, cnt = _find_sections(
        telemetry.timers.snapshot() if telemetry.enabled else {}, name)
    n = cnt if invocations is None else invocations
    return tot / n if tot and n else None


def _slots_local(n_slots: int, slot_extent: int) -> int:
    """Resident slots per device: the slot axis divides when it can,
    replicates otherwise."""
    if slot_extent > 1 and n_slots % slot_extent == 0:
        return n_slots // slot_extent
    return n_slots


def farm_cost_row(service, *, signature: str = "-",
                  measured_s: float | None = None) -> CostRow:
    """Cost row of one ``SimulationService``'s batched step (one invocation
    = one device step of the whole slot batch), traced with the executor's
    real signature (``EnsembleExecutor.step_args``: the health ring when it
    is on).  On a health-monitored farm the row also books the drain
    accounting (``health_drains`` performed vs ``health_boundaries``
    crossed)."""
    ex = service.farm.exec
    farm = service.farm
    name = f"farm/{farm.farm_id}"
    try:
        fn, args = ex.cost_step(), ex.step_args(1)
    except Exception as e:     # never raise into a drive loop
        return CostRow(name=name, kind="farm-step", signature=signature,
                       status="unparsed", error=f"{type(e).__name__}: {e}")
    row = cost_row_from_trace(fn, args, name=name, kind="farm-step",
                              signature=signature)
    row.invocations = int(farm.device_steps)
    row.measured_s = measured_s
    decomposed = getattr(ex, "decomposition", None)
    if decomposed and not ex.health_window:
        # the count transport's bytes for the traced step; with health on
        # the trace also holds the diagnostics' one-plane exchanges
        row.halo_bytes_predicted = float(fn.transport.permute_operand_bytes)
    if decomposed:
        from repro_torch.launch.mesh import mesh_extents

        extents = mesh_extents(ex.mesh)
        row.n_devices = math.prod(extents.values())
        row.halo_bytes_analytic = float(halo_bytes_per_step(
            ex.solver.config, dict(ex.decomposition), extents,
            slots_local=len(ex.local_slots)))
    if ex.health_window:
        row.health_drains = int(service.tel.metrics.get("health.drains")
                                or 0)
        row.health_boundaries = int(farm.device_steps
                                    // farm.check_steady_every)
    return row


def health_overhead_model(ex_off, ex_on, check_every: int) -> dict:
    """Deterministic steady-state price of the health monitor.

    Traces both executors' real ``run_k`` for one step: exactly one device
    step for the health-off executor, one step plus one diagnostics pass
    (which samples the chunk's final state) for the health-on one.  The
    steady overhead is therefore ``(bytes_on - bytes_off) / (check_every *
    bytes_off)`` — one diagnostics pass amortized over the
    ``check_steady_every`` steps whose chunk boundary its drain rides.  The
    stencil step carries no matrix product, so HBM traffic is the currency
    (the binding roofline axis for this solver), and the count is the same
    on every call and host, unlike a wall-clock ratio.
    """
    rows = {}
    for tag, ex in (("off", ex_off), ("on", ex_on)):
        try:
            fn, args = ex.cost_step(), ex.step_args(1)
        except Exception as e:
            rows[tag] = CostRow(name=f"health-model/{tag}",
                                kind="health-model", status="unparsed",
                                error=f"{type(e).__name__}: {e}")
            continue
        rows[tag] = cost_row_from_trace(fn, args, name=f"health-model/{tag}",
                                        kind="health-model")
    off, on = rows["off"], rows["on"]
    ok = (off.status == "ok" and on.status == "ok" and off.hbm_bytes > 0)
    doc = {
        "status": "ok" if ok else "unparsed",
        "check_every": int(check_every),
        "hbm_bytes_step": off.hbm_bytes,
        "hbm_bytes_step_health": on.hbm_bytes,
        "hbm_bytes_diag_per_chunk": None,
        "modeled_overhead": None,
    }
    if ok:
        doc["hbm_bytes_diag_per_chunk"] = on.hbm_bytes - off.hbm_bytes
        doc["modeled_overhead"] = ((on.hbm_bytes - off.hbm_bytes)
                                   / (check_every * off.hbm_bytes))
    else:
        doc["error"] = off.error or on.error
    return doc


def serial_cost_row(prepared, *, label: str, telemetry=None) -> CostRow:
    """Cost row of one prepared serial run's EVOLVE bin: an uninstrumented
    twin of the bin on the solver's ``meta`` twin is traced, so telemetry
    wrappers never enter the count.  The measured join is the bin's spans
    in ``telemetry`` (:func:`measured_seconds`)."""
    import torch

    from repro_torch.cfd.ns3d import PARAM_KEYS
    from repro_torch.core.schedule import canonical_bin
    from repro_torch.launch import op_cost

    bname = canonical_bin("EVOLVE")
    name = f"serial/{label}/{bname}"
    try:
        solver = prepared.solver.cost_twin()
        params = {k: torch.empty((), dtype=torch.float32, device="meta")
                  for k in PARAM_KEYS}
        sched = prepared.scenario.schedule(
            solver, step_fn=lambda s: solver._step_local(s, params))
        step = sched.compile_bin(bname)
        state = op_cost.meta_like(prepared.state)
    except Exception as e:     # never raise into a drive loop
        return CostRow(name=name, kind="serial-bin", status="unparsed",
                       error=f"{type(e).__name__}: {e}")
    row = cost_row_from_trace(step, (state,), name=name, kind="serial-bin")
    if telemetry is not None and telemetry.enabled:
        span = f"schedule.{bname}"
        _, cnt = _find_sections(telemetry.timers.snapshot(), span)
        if cnt:
            row.invocations = cnt
            row.measured_s = measured_seconds(telemetry, span, cnt)
    return row


def report_for_runtime(rt, chip: Chip | str = "auto",
                       dtype: str = "f32") -> "PerfReport":
    """The runtime's full perf accounting: one row per farm signature
    (``farm.step_chunk`` seconds / device steps as the measured join: the
    spans' device time on a card, their host time on the CPU) and one per
    prepared serial scenario (``schedule.EVOL`` spans, alike).

    When several farms share one telemetry handle their step-chunk time
    cannot be told apart, so the per-device-step seconds are the
    aggregate across farms — honest for the single-signature common case
    and clearly labeled either way.  ``chip="auto"`` resolves from the
    runtime's device.
    """
    rows: list[CostRow] = []
    services = getattr(rt, "_services", {})
    total_steps = sum(svc.farm.device_steps for svc in services.values())
    per_step = measured_seconds(rt.telemetry, "farm.step_chunk", total_steps)
    for key, svc in services.items():
        rows.append(farm_cost_row(svc, signature=str(key),
                                  measured_s=per_step))
    for label, pr in getattr(rt, "_prepared", {}).items():
        rows.append(serial_cost_row(pr, label=label,
                                    telemetry=rt.telemetry))
    return PerfReport(rows, chip=resolve_chip(chip, rt.device), dtype=dtype)


# -- the report ---------------------------------------------------------------
class PerfReport:
    """Attributed cost rows against one chip's roofline."""

    def __init__(self, rows, *, chip: Chip | str = "auto",
                 dtype: str = "f32"):
        self.costs: list[CostRow] = list(rows)
        self.chip = resolve_chip(chip)
        self.dtype = dtype

    def _attribute(self, c: CostRow) -> dict:
        d = dataclasses.asdict(c)
        terms = terms_from_counts(c.flops, c.hbm_bytes,
                                  c.collective_wire_bytes,
                                  dtype=self.dtype, chip=self.chip)
        d.update(
            compute_s=terms.compute_s, memory_s=terms.memory_s,
            collective_s=terms.collective_s, roofline_s=terms.step_time_s,
            bottleneck=terms.bottleneck if c.status == "ok" else "unknown")
        if c.status == "ok" and c.measured_s and c.measured_s > 0:
            d["achieved_flops_s"] = c.flops / c.measured_s
            # fraction of the roofline-optimistic time actually achieved;
            # left uncapped so a model underestimate stays visible
            d["utilization"] = (terms.step_time_s / c.measured_s
                                if terms.step_time_s else None)
        else:
            d["achieved_flops_s"] = None
            d["utilization"] = None
        ha, hp = c.halo_bytes_analytic, c.halo_bytes_predicted
        d["halo_match"] = (
            None if ha is None or hp is None
            else bool(abs(ha - hp) <= 1e-6 * max(abs(ha), abs(hp), 1.0)))
        return d

    def rows(self) -> list[dict]:
        return [self._attribute(c) for c in self.costs]

    def as_dict(self) -> dict:
        return {
            "schema": PERF_SCHEMA,
            "chip": {"name": self.chip.name,
                     "peak_flops": self.chip.peak_flops(self.dtype),
                     "hbm_bandwidth": self.chip.hbm_bandwidth,
                     "ici_link_bandwidth": self.chip.ici_link_bandwidth},
            "dtype": self.dtype,
            "rows": self.rows(),
        }

    def render(self) -> str:
        lines = [f"-- perf accounting (chip {self.chip.name}, "
                 f"{self.dtype} peak {self.chip.peak_flops(self.dtype):.3g} "
                 f"FLOP/s, HBM {self.chip.hbm_bandwidth:.3g} B/s) --"]
        if not self.costs:
            lines.append("  (no steps accounted — enable telemetry "
                         "and run something first)")
            return "\n".join(lines)
        hdr = (f"  {'row':<34} {'status':<8} {'flops/inv':>10} "
               f"{'HBM B/inv':>10} {'wire B/inv':>10} {'bottleneck':<10} "
               f"{'measured_s':>10} {'util':>6}")
        lines.append(hdr)
        for d in self.rows():
            ms = f"{d['measured_s']:.3g}" if d["measured_s"] else "-"
            ut = f"{d['utilization']:.3g}" if d["utilization"] else "-"
            lines.append(
                f"  {d['name']:<34} {d['status']:<8} {d['flops']:>10.3g} "
                f"{d['hbm_bytes']:>10.3g} "
                f"{d['collective_wire_bytes']:>10.3g} "
                f"{d['bottleneck']:<10} {ms:>10} {ut:>6}")
            if d["op_classes"] and d["hbm_bytes"]:
                split = "  ".join(
                    f"{k} {v['bytes'] / d['hbm_bytes']:.1%}"
                    for k, v in sorted(d["op_classes"].items(),
                                       key=lambda kv: -kv[1]["bytes"]))
                lines.append(f"      HBM bytes by op class: {split}")
            if d["halo_bytes_analytic"] is not None:
                verdict = {True: "MATCH", False: "MISMATCH",
                           None: "?"}[d["halo_match"]]
                lines.append(
                    f"      halo bytes: predicted "
                    f"{d['halo_bytes_predicted'] or 0:.6g} vs analytic "
                    f"{d['halo_bytes_analytic']:.6g} — {verdict}")
            if d.get("health_drains") is not None:
                lines.append(
                    f"      health: {d['health_drains']} ring drains over "
                    f"{d['health_boundaries']} harvest boundaries "
                    f"(extra host syncs: "
                    f"{d['health_drains'] - d['health_boundaries']})")
            if d["error"]:
                lines.append(f"      error: {d['error']}")
        return "\n".join(lines)

    def export_gauges(self, registry, prefix: str = "perf"):
        """Mirror the attributed rows into scrape-able gauges (the
        Prometheus surface behind ``SimulationService.prometheus_text``)."""
        for d in self.rows():
            row = d["name"]
            registry.set(f"{prefix}.flops_per_invocation", d["flops"],
                         row=row)
            registry.set(f"{prefix}.hbm_bytes_per_invocation",
                         d["hbm_bytes"], row=row)
            registry.set(f"{prefix}.collective_wire_bytes_per_invocation",
                         d["collective_wire_bytes"], row=row)
            registry.set(f"{prefix}.roofline_s", d["roofline_s"], row=row)
            registry.set(f"{prefix}.bottleneck", 1.0, row=row,
                         kind=d["bottleneck"])
            if d["utilization"] is not None:
                registry.set(f"{prefix}.utilization", d["utilization"],
                             row=row)
            if d["achieved_flops_s"] is not None:
                registry.set(f"{prefix}.achieved_flops_s",
                             d["achieved_flops_s"], row=row)
        return registry


def validate_perf(doc: dict) -> dict:
    """Schema check for an embedded ``repro.perf.v1`` block; returns the
    doc or raises ``ValueError`` naming every problem at once."""
    problems = []
    if not isinstance(doc, dict):
        raise ValueError(f"perf block must be a dict, got {type(doc)}")
    if doc.get("schema") != PERF_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, "
                        f"expected {PERF_SCHEMA!r}")
    if not isinstance(doc.get("chip"), dict) or "name" not in doc.get(
            "chip", {}):
        problems.append("chip must be a dict with a 'name'")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        problems.append("rows must be a list")
    else:
        for i, r in enumerate(rows):
            missing = [k for k in ROW_KEYS if k not in r]
            if missing:
                problems.append(f"row {i} missing {missing}")
    if problems:
        raise ValueError("invalid perf block: " + "; ".join(problems))
    return doc
