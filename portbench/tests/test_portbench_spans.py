"""The metrics that read the program's own spans: their arithmetic on a
synthetic traced window, nothing to read where the program marks nothing,
and on the card the spans in a traced window of each cell."""
import time

import pytest

import harness
import run
import spanread
import traceread

MS = 1_000_000
KERNEL = "void (anonymous namespace)::jacobi_pressure_kernel<true, true>()"
BENCH = harness.benchmark()


def record(steps=2):
    """A 100 ms window with a pause at 40-50 ms.  The device runs at
    1-30, 31-39 and 61-90 ms.  The host enqueues four solver steps: at
    0.2 ms and 30.5 ms onto an idle device (each after a sync), at 10 ms
    onto a busy one, at 45 ms in the pause; then a farm chunk (55-70 ms)
    with a step onto an idle device and a residual wait, and a harvest."""
    dev = [(KERNEL, 1 * MS, 30 * MS), (KERNEL, 31 * MS, 39 * MS),
           (KERNEL, 61 * MS, 90 * MS)]
    host = [("portbench.step", int(0.1 * MS), 29 * MS),
            ("ns3d.step", int(0.2 * MS), 3 * MS),
            ("ns3d.advect", int(0.3 * MS), int(1.5 * MS)),
            ("ops.ghosted_inputs", int(0.4 * MS), int(0.6 * MS)),
            ("ns3d.step", 10 * MS, 12 * MS),
            ("aten::item", int(29.5 * MS), int(30.2 * MS)),
            ("ns3d.step", int(30.5 * MS), int(33.5 * MS)),
            ("ns3d.step", 45 * MS, 46 * MS),
            ("farm.admit", 52 * MS, 54 * MS),
            ("farm.step_chunk", 55 * MS, 70 * MS),
            ("cudaLaunchKernel", int(55.5 * MS), int(55.6 * MS)),
            ("ns3d.step", 60 * MS, 63 * MS),
            ("farm.residuals", 65 * MS, 69 * MS),
            ("farm.harvest", 92 * MS, 96 * MS)]
    trace = {"window_ns": (0, 100 * MS), "pauses_ns": [(40 * MS, 50 * MS)],
             "device_ops": dev, "host_ops": host}
    return {"trace": trace, "steps": steps, "counters": {}}


def read(name, rec=None):
    return harness.module("metrics", name).read(rec or record())


def test_program_spans_are_told_from_the_harness_and_torch():
    names = [op[0] for op in spanread.program_spans(record()["trace"])]
    assert "portbench.step" not in names and "aten::item" not in names
    assert "cudaLaunchKernel" not in names
    assert names[:3] == ["ns3d.step", "ns3d.advect", "ops.ghosted_inputs"]
    assert all(spanread.is_program_span(n) for n in (
        "ns3d.pressure", "ops.bound_ghosts", "farm.step_chunk",
        "ensemble.write_slot", "service.evict_spill", "schedule.EVOL",
        "run.cavity"))


def test_step_host_ms_is_the_mean_step_enqueued_onto_an_idle_device():
    # 2.8, 3.0 and 3.0 ms; the step at 10 ms waits behind a busy device,
    # the one at 45 ms lies in the pause
    assert read("step.host_ms") == pytest.approx((2.8 + 3.0 + 3.0) / 3)


def test_farm_host_ms_is_the_farms_self_time_a_device_step():
    # admit 2 + chunk 15 + harvest 4 ms, less the step (3) and the
    # residual wait (4) inside the chunk, over two device steps
    assert read("farm.host_ms") == pytest.approx((21 - 7) / 2)


def test_device_idle_program_books_gaps_by_the_span_at_their_midpoint():
    # gaps 0-1 (ns3d.step), 30-31 (ns3d.step from 30.5), 39-40 (none),
    # 50-61 (farm.step_chunk at 55.5), 90-100 (farm.harvest at 95)
    rec = record()
    assert read("device.idle_program", rec) == pytest.approx(
        100 * (1 + 1 + 11 + 10) / 90)
    assert read("device.idle") == pytest.approx(100 * (1 + 1 + 1 + 11 + 10)
                                                / 90)
    # a gap under 10 us is the spacing of a full queue, never booked
    rec["trace"]["device_ops"][0] = (KERNEL, 5000, 30 * MS)
    assert read("device.idle_program", rec) == pytest.approx(
        100 * (1 + 11 + 10) / 90)


def test_a_program_that_marks_nothing_gives_nothing():
    rec = record()
    rec["trace"]["host_ops"] = [op for op in rec["trace"]["host_ops"]
                                if not spanread.is_program_span(op[0])]
    for name in ("step.host_ms", "farm.host_ms", "device.idle_program"):
        assert read(name, rec) is None
        assert read(name, dict(record(), trace=None)) is None
    assert read("farm.host_ms", record(steps=0)) is None
    # steps that all start on a busy device give no sample
    rec = record()
    rec["trace"]["device_ops"] = [(KERNEL, 0, 100 * MS)]
    assert read("step.host_ms", rec) is None


def test_each_cell_reports_the_span_metrics_it_can_read():
    for cell, want in (("cavity512.solve", {"step.host_ms",
                                            "device.idle_program"}),
                       ("sweep256.members", {"step.host_ms", "farm.host_ms",
                                             "device.idle_program"})):
        got = {m["name"] for m in run.metrics_for(cell, True, BENCH)}
        assert want <= got
        assert ("farm.host_ms" in got) == (cell == "sweep256.members")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cavity512.solve", "sweep256.members"])
def test_a_traced_window_on_the_card_holds_the_programs_spans(name):
    """At the cell's own size, a 1 s traced window: no device operation
    carries a program span's name (FUNCTION scope has no device-side
    copy), the first device operation starts after the first solver step
    that enqueued work (the host and device clocks agree), and each new
    metric reads a number."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    wl = harness.workload(name)
    cfg = harness.config(wl["config"])
    device = torch.device("cuda", 0)
    out = run.drive(wl, cfg, 2**31 + 101, 1.0, True, device,
                    time.perf_counter())
    tr = out["trace"]
    assert tr is not None
    assert not [op for op in tr["device_ops"]
                if spanread.is_program_span(op[0])]
    first_dev = traceread.device_in_window(tr)[0][1]
    steps = [op for op in spanread.program_spans(tr, {"ns3d.step"})
             if spanread.in_active(tr, op[1])]
    assert steps and steps[0][1] < first_dev
    phases = {op[0] for op in spanread.program_spans(tr)}
    assert {"ns3d.advect", "ns3d.rhs", "ns3d.pressure", "ns3d.project",
            "ops.ghosted_inputs", "ops.bound_ghosts"} <= phases
    rec = dict(out, jacobi_iters=cfg["jacobi_iters"])
    for m in run.metrics_for(name, True, BENCH):
        if m["name"] in ("step.host_ms", "farm.host_ms",
                         "device.idle_program"):
            value = harness.module("metrics", m["name"]).read(rec)
            assert value is not None and value >= 0, m["name"]
