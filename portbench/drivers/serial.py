"""One run stepped for the whole window: ``PreparedRun.step``, the step
``Runtime.run`` calls, with ``Runtime.run``'s residual check (one host sync)
every ``check_every`` steps.

The check's inputs: the run's intake (its prepared state, masks included),
its first step from the seeded fields, and its state after one step of the
window, drawn from the seed; the reference steps from the seeded fields
as often.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import program
import traffic
from window import Window, synchronize


def residual(new: dict, old: dict, dt: torch.Tensor) -> float:
    """``||u_new - u_old||_inf / dt`` over the velocities, as Runtime.run
    reckons it: one host fetch."""
    m = torch.stack([(new[f] - old[f]).abs().max()
                     for f in ("vx", "vy", "vz")]).max()
    return float(m / dt)


def run(cell) -> dict:
    cfg, tr = cell.cfg, cell.wl["traffic"]
    program.register(cfg)
    rt = program.runtime(cfg, cell.device)
    pr = rt.prepare(program.SCENARIO,
                    **program.run_params(cfg, cell.seed, 0, cfg["re"]))
    every = int(cfg["check_every"])
    dt = torch.full((), max(pr.config.dt, 1e-30), dtype=torch.float32,
                    device=cell.device)
    cells = int(np.prod(cfg["grid"]))
    out_of_setup = 0.0       # the check's own copies

    # the start: what the program took in, and its first step from it
    state = pr.state
    t = time.perf_counter()
    intake = program.to_host(state, program.FIELDS + program.MASKS)
    out_of_setup += time.perf_counter() - t
    state = pr.step(state)
    synchronize(cell.device)        # the step's own time stays in set-up
    t = time.perf_counter()
    first = program.to_host(state, program.FIELDS)
    out_of_setup += time.perf_counter() - t
    done = 1
    # warm up, the residual check included
    while done < int(tr["warmup_steps"]):
        prev, state = state, pr.step(state)
        done += 1
    residual(state, prev, dt)
    del prev
    check_at = done + 1 + traffic.checked_step(cell.seed, *tr["check_step"])

    win = Window(cell.seconds, cell.device, cell.trace)
    setup_s = time.perf_counter() - cell.t_start - out_of_setup
    win.open()
    n, checked, resid = 0, None, None
    while True:
        boundary = (done + 1) % every == 0
        keep = state if boundary else None
        with win.span("step"):
            state = pr.step(state)
        done += 1
        n += 1
        if done == check_at:
            with win.pause():
                checked = program.to_host(state, program.FIELDS)
        if boundary:
            with win.span("residual_check"):
                resid = residual(state, keep, dt)
            if done >= check_at and not win.running():
                break
    window_s = win.close()
    record = win.record()
    re = cfg["re"]
    cases = [{"name": "start_gap", "member": 0, "re": re, "steps": 1,
              "output": first}]
    if checked is not None:
        cases.append({"name": "window_gap", "member": 0, "re": re,
                      "steps": check_at, "output": checked})
    return {
        "work_cells": cells * n, "steps": n, "cells_per_step": cells,
        "window_s": window_s, "setup_s": setup_s,
        "peak_bytes": win.peak_bytes,
        "memory_peak_bytes": max(win.peak_bytes, win.setup_peak_bytes),
        "attempted": n, "failed": 0,
        "intake": [{"member": 0, "got": intake}], "cases": cases,
        "counters": {"residual": resid, "check_step": check_at},
        "trace": record,
    }
