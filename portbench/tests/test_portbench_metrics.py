"""Each metric's arithmetic on a synthetic traced window."""
import pytest

import harness
import traceread
from cost import stencils

MS = 1_000_000
JP = ("void (anonymous namespace)::jacobi_pressure_kernel<true, false>"
      "(float const*, float const*)")
UV = "void (anonymous namespace)::update_velocity_kernel<true, false>(float*)"
CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, 4>"
       "(float*)")
CELLS = 256 ** 3


def record():
    """A 100 ms window with a 10 ms pause at 40-50 ms: two steps, each one
    UPDATE_VELOCITY launch (2 ms), two JACOBI_PRESSURE launches (1 ms
    each) and a 0.5 ms pad; an 8 ms gap while the host polls, a copy in
    the pause, and a launch before the window that must not count."""
    dev = [(JP, -5 * MS, -4 * MS)]
    t = 0
    for _ in range(2):
        dev += [(UV, t, t + 2 * MS), (JP, t + 2 * MS, t + 3 * MS),
                (JP, t + 3 * MS, t + 4 * MS), (CAT, t + 4 * MS,
                                               int(t + 4.5 * MS))]
        t += 50 * MS
    dev.append(("Memcpy DtoH (Device -> Pageable)", 41 * MS, 49 * MS))
    host = [("portbench.poll_submit", 5 * MS, 39 * MS),
            ("aten::item", 10 * MS, 12 * MS)]
    trace = {"window_ns": (0, 100 * MS), "pauses_ns": [(40 * MS, 50 * MS)],
             "device_ops": dev, "host_ops": host}
    return {"trace": trace, "steps": 2, "cells_per_step": CELLS,
            "jacobi_iters": 2, "window_s": 0.09, "work_cells": 2 * CELLS,
            "setup_s": 12.5, "peak_bytes": 3 * 2**30,
            "counters": {"live_slot_steps": 15, "device_steps": 2,
                         "n_slots": 8}}


def read(name, rec=None):
    return harness.module("metrics", name).read(rec or record())


def test_window_busy_and_idle():
    rec = record()["trace"]
    assert traceread.active(rec) == [(0, 40 * MS), (50 * MS, 100 * MS)]
    assert traceread.window_ns(rec) == 90 * MS
    assert traceread.busy_ns(rec) == 9 * MS
    assert read("device.idle") == pytest.approx(100 * (1 - 9 / 90))


def test_rooflines_are_least_time_over_mean_launch_time():
    assert traceread.launches(record()["trace"],
                              "jacobi_pressure_kernel") == (4, 4 * MS)
    least = stencils.JACOBI_PRESSURE.least_s(CELLS)
    assert read("jacobi_pressure_roofline") == pytest.approx(
        100 * least / 1e-3)
    assert read("update_velocity_roofline") == pytest.approx(
        100 * stencils.UPDATE_VELOCITY.least_s(CELLS) / 2e-3)


def test_step_mfu_and_the_step_glue():
    least = stencils.step_least_s(CELLS, 2)
    assert read("step_mfu") == pytest.approx(100 * least / 0.045)
    # two pads of 0.5 ms over two steps; the copy lies in the pause
    assert read("step.non_kernel_device_ms") == pytest.approx(0.5)


def test_end_to_end_and_counters():
    assert read("mcups") == pytest.approx(2 * CELLS / 0.09 / 1e6)
    assert read("peak_mem_gib") == 3.0
    assert read("setup_s") == 12.5
    assert read("farm.slot_occupancy") == pytest.approx(100 * 15 / 16)


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = dict(record(), trace=None, counters={})
    for name in ("jacobi_pressure_roofline", "update_velocity_roofline",
                 "step_mfu", "step.non_kernel_device_ms", "device.idle",
                 "farm.slot_occupancy"):
        assert read(name, rec) is None
    rec = record()
    rec["trace"]["device_ops"] = [op for op in rec["trace"]["device_ops"]
                                  if op[0] != UV]
    assert read("update_velocity_roofline", rec) is None


def test_breakdown_names_device_ops_and_what_the_host_did_in_each_gap():
    bd = traceread.breakdown(record()["trace"])
    names = [n for n, _ in bd["device_ops"]]
    assert names[0].startswith("update_velocity_kernel<true, false>")
    assert all("(" not in n for n in names)
    gaps = dict(bd["idle_gaps"])
    # 4.5-40 ms: mid-gap at 22.25 ms, inside poll_submit but past aten::item
    assert gaps["portbench.poll_submit"] == pytest.approx(0.0355)
    assert gaps["python"] == pytest.approx(0.0455)
    assert sum(gaps.values()) == pytest.approx(0.081)
