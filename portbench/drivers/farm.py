"""A sweep through the farm, as a closed loop with a backlog: the slots full
when the window opens, ``backlog`` members queued behind them, and a new
member submitted (``Runtime.submit``) as each is admitted, so the queue
never runs dry.  Each member runs to the sweep's ``t_end``, as a user
submits it: thousands of steps, so the window times steady batched
stepping.  The farm advances through the service's ``run`` to each check
boundary; ``poll`` follows the members.

Set-up runs the probe first, beside the first resident members: a member
of ``probe_steps`` steps that finishes at a check boundary, whose result
the farm hands out and whose slot it gives to the next queued member.  So
the check reads a result and an admission outside the window.

The check's inputs: every member's intake and first batched step from its
seeded fields, the probe's result, and every slot's state after one
batched step of the window, drawn from the seed.
"""
from __future__ import annotations

import time

import numpy as np

import program
import traffic
from window import Window, synchronize


def slot_members(farm) -> dict[int, tuple[int, int]]:
    """Slot -> (member index, steps done), from the farm's dashboard
    frame."""
    return {row["slot"]: (int(row["tag"][1:]), int(row["steps_done"]))
            for row in farm.health_snapshot()["slots"]
            if row["sid"] is not None}


def run(cell) -> dict:
    cfg, tr = cell.cfg, cell.wl["traffic"]
    n_slots, backlog = int(cfg["n_slots"]), int(tr["backlog"])
    program.register(cfg)
    rt = program.runtime(cfg, cell.device, n_slots=n_slots)
    sweep = traffic.Sweep(tr, cell.seed)
    members: dict[int, traffic.Member] = {}
    sids: dict[int, int] = {}

    def submit(m: traffic.Member):
        members[m.index] = m
        sids[m.index] = rt.submit(
            program.SCENARIO, steps=m.steps, t_end=m.t_end, tag=m.tag,
            residual_tol=tr["residual_tol"],
            **program.run_params(cfg, cell.seed, m.index, m.re))

    submit(sweep.probe())
    for i in range(1, n_slots + backlog + 1):
        submit(sweep.member(i))
    svc = rt.services()[0]
    farm = svc.farm
    cells_a_slot = int(np.prod(cfg["grid"]))
    every = int(cfg["check_every"])
    out_of_setup = 0.0
    intake, cases = [], []

    def first_steps(taken_in, resident_before):
        """The intake and first step of every member admitted by the
        batched step just taken."""
        for slot, (m, _) in slot_members(farm).items():
            if resident_before.get(slot, (None,))[0] == m:
                continue
            intake.append({"member": m, "got": program.to_host(
                taken_in, program.FIELDS + program.MASKS, slot)})
            cases.append({"name": "start_gap", "member": m,
                          "re": members[m].re, "steps": 1,
                          "output": program.to_host(farm.exec.state,
                                                    program.FIELDS, slot)})

    # the start: the probe and the first residents taken in and stepped
    taken_in = dict(farm.exec.state)    # admission writes these in place
    svc.run(1)
    synchronize(cell.device)        # the step's own time stays in set-up
    t = time.perf_counter()
    first_steps(taken_in, {})
    out_of_setup += time.perf_counter() - t
    # the probe finishes at its cap, and its slot goes to the next member
    probe = members[0]
    svc.run(probe.steps - 1)
    t = time.perf_counter()
    done = rt.poll(sids[0])
    if done["status"] == "done":
        cases.append({"name": "result_gap", "member": 0, "re": probe.re,
                      "steps": done["steps_done"],
                      "output": program.to_host(
                          rt.result(sids[0], block=False).state,
                          program.FIELDS)})
    before = slot_members(farm)
    taken_in = dict(farm.exec.state)
    out_of_setup += time.perf_counter() - t
    svc.run(1)
    synchronize(cell.device)
    t = time.perf_counter()
    first_steps(taken_in, before)
    del taken_in
    out_of_setup += time.perf_counter() - t
    next_member = n_slots + backlog + 1

    def poll_submit():
        nonlocal next_member
        queued = sum(rt.poll(sid)["status"] == "queued"
                     for sid in sids.values())
        for _ in range(backlog - queued):
            submit(sweep.member(next_member))
            next_member += 1

    poll_submit()
    check_at = rt.device_steps() + 1 + traffic.checked_step(
        cell.seed, *tr["check_step"])

    def live_steps() -> dict[int, int]:
        out = {}
        for m, sid in sids.items():
            st = rt.poll(sid)
            if st["status"] in ("running", "done", "failed", "diverged"):
                out[m] = st["steps_done"]
        return out

    start_steps, start_device = live_steps(), rt.device_steps()
    win = Window(cell.seconds, cell.device, cell.trace)
    setup_s = time.perf_counter() - cell.t_start - out_of_setup
    win.open()
    checked = False
    while True:
        ds = rt.device_steps()
        n = every - ds % every
        if not checked:
            n = min(n, check_at - ds)
        with win.span("farm_run"):
            svc.run(n)
        if not checked and rt.device_steps() == check_at:
            with win.pause():
                for slot, (m, steps) in slot_members(farm).items():
                    cases.append({"name": "window_gap", "member": m,
                                  "re": members[m].re, "steps": steps,
                                  "output": program.to_host(
                                      farm.exec.state, program.FIELDS,
                                      slot)})
            checked = True
        with win.span("poll_submit"):
            poll_submit()
        if checked and rt.device_steps() % every == 0 \
                and not win.running():
            break
    window_s = win.close()
    record = win.record()
    end_steps = live_steps()
    live = sum(end_steps[m] - start_steps.get(m, 0) for m in end_steps)
    # the probe (member 0) finished in set-up
    resolved = [m for m in end_steps
                if m and rt.poll(sids[m])["status"] != "running"]
    failed = sum(end_steps[m] - start_steps.get(m, 0) for m in resolved
                 if rt.poll(sids[m])["status"] in ("failed", "diverged"))
    device_steps = rt.device_steps() - start_device
    return {
        "work_cells": cells_a_slot * live, "steps": device_steps,
        "cells_per_step": cells_a_slot * n_slots,
        "window_s": window_s, "setup_s": setup_s,
        "peak_bytes": win.peak_bytes,
        "memory_peak_bytes": max(win.peak_bytes, win.setup_peak_bytes),
        "attempted": live, "failed": failed,
        "intake": intake, "cases": cases,
        "counters": {"live_slot_steps": live, "device_steps": device_steps,
                     "n_slots": n_slots,
                     "members_resolved": len(resolved),
                     "members_submitted": len(members) - 1},
        "trace": record,
    }
