#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as JSON lines; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi) and torch's name;
2. build     the CUDA kernels built from ``src/repro_torch/kernels/csrc``,
             one nvcc per source, all started together;
3. kernels   each hand-written kernel against its plain PyTorch version on
             the card, at its main-path shape (256^3; k = 2 sweeps for
             JACOBI_FUSED), an odd shape and a slot-batched call with
             distinct parameter rows (JACOBI_FUSED also for k = 1..4);
             CUDA-event times of kernel and plain version beside the least
             time the card could take (bytes over 3.35 TB/s or float32
             operations over 67 TFLOP/s, H100 SXM data-sheet peaks);
4. main      ``api.runtime(n=256, nz=256).run("cavity", steps=20)`` on the
             ``cuda`` backend with the launch counters reset just before,
             then on the ``torch`` backend; the two must agree, and the
             counts must be 20 x (1, 1, 40, 1); step wall time, the
             profiler's device-time split of one step, and peak memory;
5. farm      the ensemble farm at 256^3 through the front door:
             ``api.runtime(n=256, nz=256, n_slots=4)`` takes five cavity
             requests (Re 50..800, 6..14 steps; the fifth enters a
             reclaimed slot), evicts one mid-run, readmits it and drains;
             counts reset just before and read just after must be
             device_steps x (1, 1, 40, 1), every result must equal a
             serial ``cuda`` run bitwise, and the ``torch`` farm must
             agree; batched step time, sims x steps/s and peak memory;
6. fused     the same farm with ``fused_sweeps=2``: 20 JACOBI_FUSED
             launches a step and no JACOBI_PRESSURE;
7. throughput  n=48 (Ghia's grid), 8 slots, 20 steps: the farm's
             sims x steps/s against eight serial runs;
8. physics   Taylor-Green, cavity divergence and Ghia bounds with the
             kernels, as the reference's tests hold its solver to them.

The line before the last is the ``{"kernels": [...]}`` summary; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 256                      # the main path's grid: N x N x N cells
STEPS = 20
SEED = 0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM data sheet, float32 outside tensor cores
# max|kernel - plain| <= KERNEL_RTOL * max(1, max|plain|): both compute the
# same float32 expression; the kernel may contract a*b+c into one FMA and
# the plain version rounds every operation, a few ulp of the largest term
KERNEL_RTOL = 1e-5
# cuda vs torch backend after STEPS steps: per-step ulp differences stay
# bounded because the Jacobi iteration is contractive
PATH_RTOL = 1e-4

# float32 operations per interior cell, counted from the kernel sources
# (csrc/stencil3d.cu, csrc/jacobi.cu: per cell and sweep), an FMA as two;
# none depends on the data
OPS_PER_CELL = {"UPDATE_VELOCITY": 144, "DIVERGENCE": 6,
                "JACOBI_PRESSURE": 11, "PROJECT_VELOCITY": 10,
                "JACOBI_FUSED": 11}
STENCILS = ("UPDATE_VELOCITY", "DIVERGENCE", "JACOBI_PRESSURE",
            "PROJECT_VELOCITY")
KERNELS = STENCILS + ("JACOBI_FUSED",)
# launches a step: jacobi_iters = 40 sweeps, one by one or k = 2 at a time
PER_STEP = {"UPDATE_VELOCITY": 1, "DIVERGENCE": 1, "JACOBI_PRESSURE": 40,
            "PROJECT_VELOCITY": 1, "JACOBI_FUSED": 0}
PER_STEP_FUSED = dict(PER_STEP, JACOBI_PRESSURE=0, JACOBI_FUSED=20)
FUSED_K = 2
REPLACES = {
    "UPDATE_VELOCITY": "src/repro/core/generator.py:213",
    "DIVERGENCE": "src/repro/core/generator.py:213",
    "JACOBI_PRESSURE": "src/repro/core/generator.py:213",
    "PROJECT_VELOCITY": "src/repro/core/generator.py:213",
    "JACOBI_FUSED": "src/repro/kernels/jacobi.py:79",
}
INSTANCE = {   # the 3DBLOCK template's instances, by body
    "UPDATE_VELOCITY": "src/repro/kernels/stencil3d.py:74",
    "DIVERGENCE": "src/repro/kernels/stencil3d.py:148",
    "JACOBI_PRESSURE": "src/repro/kernels/stencil3d.py:159",
    "PROJECT_VELOCITY": "src/repro/kernels/stencil3d.py:171",
    "JACOBI_FUSED": "src/repro/kernels/jacobi.py:56 (jacobi_fused)",
}
SOURCE = {name: "src/repro_torch/kernels/csrc/stencil3d.cu" for name in STENCILS}
SOURCE["JACOBI_FUSED"] = "src/repro_torch/kernels/csrc/jacobi.cu"

# the farm phases: five requests through four slots, one evicted after
# EVICT_AT steps and readmitted
FARM_SLOTS = 4
FARM_RES = (50.0, 100.0, 200.0, 400.0, 800.0)
FARM_STEPS = (8, 12, 6, 10, 14)
EVICT, EVICT_AT = 1, 4
# the host-bound end: Ghia's n=48 grid, eight slots, twenty steps
TP_N, TP_SLOTS, TP_STEPS = 48, 8, 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_counts() -> None:
    from repro_torch.kernels import jacobi_cuda, stencil3d_cuda

    stencil3d_cuda.reset_launches()
    jacobi_cuda.reset_launches()


def read_counts() -> dict:
    from repro_torch.kernels import jacobi_cuda, stencil3d_cuda

    return {**stencil3d_cuda.LAUNCHES, **jacobi_cuda.LAUNCHES}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    card = {"phase": "card", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(card)
    require(tuple(card["capability"]) == (9, 0),
            f"sm_90a kernels need a Hopper card, got {card['capability']}")
    return smi


def phase_build():
    from repro_torch.kernels import _build, jacobi_cuda, stencil3d_cuda

    t0 = time.perf_counter()
    _build.build_all()          # one nvcc per source, all at once
    stencil3d_cuda._lib()
    jacobi_cuda._lib()
    libs = {}
    for name, info in _build.build_info.items():
        libs[name] = {
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "library": os.path.relpath(info["path"], ROOT),
            "ptxas": [ln.strip() for ln in info["log"].splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln or "smem" in ln]}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs})


# ---------------------------------------------------------------------------
def kernel_inputs(name, S, interior, gen, dev):
    """Random inputs of ``name`` padded as its descriptor declares."""
    import torch
    from repro_torch.kernels import stencil3d

    desc = stencil3d.DESCRIPTORS[name]
    batch = () if S is None else (S,)
    xs = []
    for var in desc.inputs:
        cached = var in desc.cached_inputs
        shape = tuple(n + ((lo + hi) if cached else 0) for n, lo, hi in
                      zip(interior, desc.halo_lo, desc.halo_hi))
        xs.append(torch.rand(batch + shape, generator=gen, device=dev) * 2 - 1)
    return xs


def param_rows(name, cfgs, dev):
    """(S, n_params) table from a list of CFDConfigs (one row each), built
    as the CUDA template builds it, with forcing set so that every
    parameter column is exercised."""
    import torch
    from repro_torch.core.generator import param_table
    from repro_torch.kernels import stencil3d

    desc = stencil3d.DESCRIPTORS[name]
    rows = []
    for s, c in enumerate(cfgs):
        vals = dict(dt=c.dt, h=c.h, nu=c.nu, omega=c.jacobi_omega,
                    fx=0.1 * (s + 1), fy=-0.05 * (s + 1), fz=0.02 * (s + 1))
        rows.append(param_table(desc, vals, None, dev,
                                columns=stencil3d.TABLES[name])[0])
    return torch.stack(rows)


def compare(name, inputs, table):
    import torch
    from repro_torch.kernels import stencil3d_cuda as sc

    got = sc.KERNELS[name](*inputs, table)
    want = sc.PLAIN[name](*inputs, table)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol = KERNEL_RTOL * max(1.0, scale)
    return err, tol, finite, got


def phase_kernels(dev):
    import torch
    from repro_torch.cfd import cavity
    from repro_torch.kernels import stencil3d, stencil3d_cuda as sc

    gen = torch.Generator(device=dev).manual_seed(SEED)
    main_cfg = cavity.config(N, nz=N)
    odd_cfgs = [cavity.config(5, nz=3)]
    batch_cfgs = [cavity.config(24, nz=18, re=re) for re in (50.0, 100.0, 400.0)]
    cases = [("main", None, (N, N, N), [main_cfg]),
             ("odd", None, (5, 7, 3), odd_cfgs),
             ("batched", 3, (24, 20, 18), batch_cfgs)]
    results = {}
    for name in stencil3d.DESCRIPTORS:
        res = {"max_abs_err": 0.0}
        for case, S, interior, cfgs in cases:
            inputs = kernel_inputs(name, S, interior, gen, dev)
            table = param_rows(name, cfgs, dev)
            if S is None:
                table = table[0]
            err, tol, finite, outs = compare(name, inputs, table)
            line = {"phase": "kernel", "kernel": name, "case": case,
                    "slots": S or 1, "interior": list(interior),
                    "max_abs_diff": err, "tolerance": tol, "finite": finite}
            if case == "main":
                nbytes = (sum(t.numel() for t in inputs)
                          + sum(o.numel() for o in outs) + table.numel()) * 4
                ops = OPS_PER_CELL[name] * N ** 3
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops / F32_OPS_PER_S * 1e3
                kern = sc.KERNELS[name]
                plain = sc.PLAIN[name]
                line.update(
                    kernel_ms=cuda_ms(lambda: kern(*inputs, table), reps=50),
                    plain_ms=cuda_ms(lambda: plain(*inputs, table), reps=5,
                                     warmup=1),
                    bytes=nbytes, ops=ops,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=None)
                res.update({k: line[k] for k in
                            ("kernel_ms", "plain_ms", "bound_ms", "bound_by")})
            emit(line)
            require(finite, f"{name} ({case}): non-finite output")
            require(err <= tol, f"{name} ({case}): max|kernel - plain| "
                                f"{err} > {tol}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            del inputs, outs
        results[name] = res
    results["JACOBI_FUSED"] = jacobi_fused_cases(gen, dev)
    torch.cuda.empty_cache()
    return results


def jacobi_fused_cases(gen, dev):
    """JACOBI_FUSED against ``jacobi_fused_ref`` on the card: the 256^3
    main-path call (k = 2, timed), an odd shape, k = 1..4 and a slot batch
    of three."""
    import torch
    from repro_torch.kernels import jacobi_cuda as jc

    h, omega = 1.0 / N, 1.0                   # the solver's h and omega
    cases = [("main", None, (N, N, N), FUSED_K),
             ("odd", None, (5, 7, 3), FUSED_K),
             *((f"k{k}", None, (37, 20, 45), k) for k in (1, 2, 3, 4)),
             ("batched", 3, (24, 20, 18), FUSED_K)]
    res = {"max_abs_err": 0.0}
    for case, S, interior, k in cases:
        batch = () if S is None else (S,)
        shape = batch + tuple(n + 2 * k for n in interior)
        p = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        rhs = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        got = jc.jacobi_fused(p, rhs, h=h, omega=omega, sweeps=k)
        want = jc.jacobi_fused_plain(p, rhs, h=h, omega=omega, sweeps=k)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = KERNEL_RTOL * max(1.0, float(want.abs().max()))
        finite = bool(torch.isfinite(got).all())
        line = {"phase": "kernel", "kernel": "JACOBI_FUSED", "case": case,
                "slots": S or 1, "interior": list(interior), "sweeps": k,
                "max_abs_diff": err, "tolerance": tol, "finite": finite}
        if case == "main":
            nbytes = (p.numel() + rhs.numel() + got.numel()) * 4
            # sweep s updates the interior grown by k - s rings
            ops = OPS_PER_CELL["JACOBI_FUSED"] * sum(
                (N + 2 * (k - s)) ** 3 for s in range(1, k + 1))
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            line.update(
                kernel_ms=cuda_ms(lambda: jc.jacobi_fused(
                    p, rhs, h=h, omega=omega, sweeps=k), reps=50),
                plain_ms=cuda_ms(lambda: jc.jacobi_fused_plain(
                    p, rhs, h=h, omega=omega, sweeps=k), reps=5, warmup=1),
                bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, blocks_per_sm=jc.blocks_per_sm(k))
            res.update({key: line[key] for key in
                        ("kernel_ms", "plain_ms", "bound_ms", "bound_by")})
        emit(line)
        require(finite, f"JACOBI_FUSED ({case}): non-finite output")
        require(tuple(got.shape) == batch + interior,
                f"JACOBI_FUSED ({case}): shape {tuple(got.shape)}")
        require(err <= tol, f"JACOBI_FUSED ({case}): max|kernel - plain| "
                            f"{err} > {tol}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del p, rhs, got, want
    return res


# ---------------------------------------------------------------------------
def phase_main(kernel_results, dev):
    import torch
    from repro_torch import api
    from repro_torch.core.halo import exchange_pad
    from repro_torch.kernels import stencil3d_cuda as sc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res_cuda = api.runtime(n=N, nz=N, backend="cuda", device=dev).run(
        "cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    reset_counts()
    t0 = time.perf_counter()
    res_torch = api.runtime(n=N, nz=N, backend="torch", device=dev).run(
        "cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    torch_launches = read_counts()

    agree = agreement(res_cuda.state, res_torch.state, "cuda vs torch backend")
    del res_torch

    # step wall time and its device-time split, through the front door
    pr = api.runtime(n=N, nz=N, backend="cuda", device=dev).prepare("cavity", re=100.0)
    state = pr.state
    for _ in range(2):
        state = pr.step(state)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        state = pr.step(state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    p_specs = pr.solver._specs("p")
    pad_ms = cuda_ms(lambda: exchange_pad(state["p"], (1, 1, 1), p_specs),
                     reps=20)
    split = profile_step(pr, state)
    kernel_sum = sum(PER_STEP[k] * kernel_results[k]["kernel_ms"]
                     for k in PER_STEP)

    expected = {k: STEPS * v for k, v in PER_STEP.items()}
    emit({"phase": "main", "grid": [N, N, N], "steps": STEPS,
          "launches": launches, "expected": expected,
          "torch_backend_launches": torch_launches,
          "cuda_run_s": cuda_s, "torch_run_s": torch_s,
          "agree": agree, "step_ms": step_ms,
          "kernel_ms_per_step": kernel_sum,
          "jacobi_pad_ms": pad_ms, "device_split_ms_per_step": split,
          "max_memory_allocated": peak,
          "ghia": res_cuda.diagnostics["ghia"]})
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(all(v == 0 for v in torch_launches.values()),
            f"torch backend launched CUDA kernels: {torch_launches}")
    return launches


def agreement(got: dict, want: dict, what: str) -> dict:
    """Hold ``got`` to ``want`` within PATH_RTOL: velocity components to
    the flow's speed (vz stays ~0 in the z-periodic cavity), the pressure
    to its own magnitude.  Both must be finite and 256^3."""
    import torch

    agree = {}
    speed = max(float(want[f].abs().max()) for f in ("vx", "vy", "vz"))
    for f in ("vx", "vy", "vz", "p"):
        a, b = got[f], want[f]
        require(bool(torch.isfinite(a).all()), f"{what}: {f} not finite")
        require(bool(torch.isfinite(b).all()), f"{what}: {f} not finite")
        require(tuple(a.shape) == (N, N, N), f"{f} shape {tuple(a.shape)}")
        diff = float((a - b).abs().max())
        tol = PATH_RTOL * (float(b.abs().max()) if f == "p" else speed)
        agree[f] = {"max_abs_diff": diff, "tolerance": tol}
        require(diff <= tol, f"{what}: {f} differs by {diff} > {tol}")
    return agree


def profile_step(pr, state):
    """Device time of one step by kernel, summed in groups, from the
    profiler ("not measured" where it recorded no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pr.step(state)
        torch.cuda.synchronize()
    groups = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        low = ev.key.lower()
        key = next((tag for tag in ("update_velocity_kernel",
                                    "divergence_kernel",
                                    "jacobi_pressure_kernel",
                                    "project_velocity_kernel",
                                    "jacobi_fused_kernel",
                                    "cat", "flip", "fill")
                    if tag in low), "other")
        groups[key] = groups.get(key, 0.0) + ev.self_device_time_total / 1e3
    return groups or "not measured"


# ---------------------------------------------------------------------------
def drive_farm(dev, backend: str, **solver):
    """The farm's verbs at 256^3 through the front door: submit five
    requests into four slots, run, evict one mid-run, readmit it, drain."""
    from repro_torch import api

    rt = api.runtime(n=N, nz=N, n_slots=FARM_SLOTS, backend=backend,
                     device=dev, **solver)
    sids = [rt.submit("cavity", steps=steps, re=re)
            for re, steps in zip(FARM_RES, FARM_STEPS)]
    require(rt.poll(sids[-1])["status"] == "queued", "fifth request not queued")
    rt.services()[0].run(EVICT_AT)
    poll = rt.poll(sids[EVICT])
    require(poll == {"status": "running", "steps_done": EVICT_AT},
            f"before eviction: {poll}")
    require(rt.evict(sids[EVICT]), "evict refused")
    require(rt.poll(sids[EVICT])["status"] == "evicted", "not evicted")
    require(rt.readmit(sids[EVICT]), "readmit refused")
    out = rt.drain()
    for sid, steps in zip(sids, FARM_STEPS):
        res = out[sid]
        require((res.terminated, res.steps_done) == ("steps", steps),
                f"{backend} farm sid {sid}: {res.terminated} after "
                f"{res.steps_done} steps ({res.error})")
    return rt, sids, out


def batched_step_ms(dev, **solver) -> float:
    """Host-clock time of one batched step with every slot resident."""
    import torch
    from repro_torch import api

    rt = api.runtime(n=N, nz=N, n_slots=FARM_SLOTS, backend="cuda",
                     device=dev, **solver)
    for re in FARM_RES[:FARM_SLOTS]:
        rt.submit("cavity", steps=1000, re=re)
    svc = rt.services()[0]
    svc.run(2)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    svc.run(reps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_farm(dev, label: str, per_step: dict, **solver):
    """The 256^3 farm on the cuda backend, its counts, bitwise equality
    with serial cuda runs, and agreement with the torch backend's farm."""
    import torch
    from repro_torch import api

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rt, sids, out = drive_farm(dev, "cuda", **solver)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    device_steps = rt.device_steps()
    expected = {k: device_steps * v for k, v in per_step.items()}
    require(launches == expected,
            f"{label}: launch counts {launches} != {expected}")
    del rt

    serial_rt = api.runtime(n=N, nz=N, backend="cuda", device=dev, **solver)
    for sid, re, steps in zip(sids, FARM_RES, FARM_STEPS):
        serial = serial_rt.run("cavity", steps=steps, re=re).state
        for f in ("vx", "vy", "vz", "p"):
            require(torch.equal(out[sid].state[f], serial[f]),
                    f"{label}: sid {sid} (Re {re}) field {f} differs from "
                    f"the serial cuda run by "
                    f"{float((out[sid].state[f] - serial[f]).abs().max())}")
        del serial
    reset_counts()
    t0 = time.perf_counter()
    _, _, torch_out = drive_farm(dev, "torch", **solver)
    torch.cuda.synchronize()
    torch_wall = time.perf_counter() - t0
    torch_launches = read_counts()
    require(all(v == 0 for v in torch_launches.values()),
            f"{label}: torch farm launched CUDA kernels: {torch_launches}")
    agree = {sid: agreement(out[sid].state, torch_out[sid].state,
                            f"{label}: cuda vs torch farm, sid {sid}")
             for sid in sids}
    del out, torch_out
    step_ms = batched_step_ms(dev, **solver)
    sim_steps = sum(FARM_STEPS)
    emit({"phase": label, "grid": [N, N, N], "slots": FARM_SLOTS,
          "requests": len(sids), "sim_steps": sim_steps,
          "device_steps": device_steps, "launches": launches,
          "expected": expected, "bitwise_vs_serial": True,
          "wall_s": wall, "sims_steps_per_s": sim_steps / wall,
          "torch_farm_wall_s": torch_wall,
          "batched_step_ms": step_ms,
          "batched_step_ms_per_slot": step_ms / FARM_SLOTS,
          "max_memory_allocated": peak,
          "agree_max_abs_diff": {
              f: max(a[f]["max_abs_diff"] for a in agree.values())
              for f in ("vx", "vy", "vz", "p")}})
    torch.cuda.empty_cache()
    return launches


def phase_throughput(dev):
    """The host-bound end: eight requests of 20 steps at n=48 through an
    eight-slot farm, against eight serial runs of the same requests."""
    import torch
    from repro_torch import api

    res = [40.0 + 20.0 * i for i in range(TP_SLOTS)]

    def farm(steps):
        rt = api.runtime(n=TP_N, n_slots=TP_SLOTS, backend="cuda", device=dev)
        sids = [rt.submit("cavity", steps=steps, re=re) for re in res]
        out = rt.drain()
        torch.cuda.synchronize()
        return rt, [out[sid] for sid in sids]

    def serial(steps):
        rt = api.runtime(n=TP_N, backend="cuda", device=dev)
        outs = [rt.run("cavity", steps=steps, re=re) for re in res]
        torch.cuda.synchronize()
        return outs

    farm(2)                              # warm both paths
    serial(2)
    reset_counts()
    t0 = time.perf_counter()
    rt, farm_out = farm(TP_STEPS)
    farm_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    serial_out = serial(TP_STEPS)
    serial_s = time.perf_counter() - t0
    expected = {k: rt.device_steps() * v for k, v in PER_STEP.items()}
    require(launches == expected,
            f"throughput: launch counts {launches} != {expected}")
    for a, b in zip(farm_out, serial_out):
        for f in ("vx", "vy", "vz", "p"):
            require(torch.equal(a.state[f], b.state[f]),
                    f"throughput: {a.tag} field {f} differs from serial")
    sim_steps = TP_SLOTS * TP_STEPS
    emit({"phase": "throughput", "grid": [TP_N, TP_N, 4], "slots": TP_SLOTS,
          "steps": TP_STEPS, "device_steps": rt.device_steps(),
          "launches": launches, "bitwise_vs_serial": True,
          "farm_s": farm_s, "serial_s": serial_s,
          "farm_sims_steps_per_s": sim_steps / farm_s,
          "serial_sims_steps_per_s": sim_steps / serial_s,
          "farm_over_serial": serial_s / farm_s})
    return launches


# ---------------------------------------------------------------------------
def phase_physics(dev):
    import torch
    from repro_torch import api
    from repro_torch.cfd import cavity, taylor_green
    from repro_torch.kernels import stencil3d_cuda as sc

    sc.reset_launches()
    tg = taylor_green.run(n=32, steps=50, nu=0.1, overlap=False,
                          template="CUDA", device=dev)
    tg_launches = dict(sc.LAUNCHES)
    emit({"phase": "physics", "case": "taylor_green", **tg,
          "launches": tg_launches})
    for k in ("err_vx", "err_vy", "energy_rel_err"):
        require(tg[k] < 5e-3, f"Taylor-Green {k} = {tg[k]} >= 5e-3")
    require(tg["div_max"] < 1e-3, f"Taylor-Green div_max = {tg['div_max']}")
    require(all(v > 0 for v in tg_launches.values()),
            f"Taylor-Green did not run every kernel: {tg_launches}")

    solver, state, _ = cavity.run(n=16, t_end=0.5, jacobi_iters=40,
                                  template="CUDA", overlap=False,
                                  device=dev)
    walls = max(float(state["vx"][-1].abs().max()),
                float(state["vy"][:, -1].abs().max()))
    div = float(solver.divergence_of(state).abs().max())
    emit({"phase": "physics", "case": "cavity_n16", "wall_faces_max": walls,
          "div_max": div})
    require(walls == 0.0, f"cavity wall faces not zero: {walls}")
    require(div < 0.05, f"cavity divergence {div} >= 0.05")

    sc.reset_launches()
    t0 = time.perf_counter()
    res = api.runtime(n=48, device=dev).run("cavity", t_end=12.0, re=100.0)
    ghia = res.diagnostics["ghia"]
    emit({"phase": "physics", "case": "cavity_ghia_n48", "steps":
          res.steps_done, "seconds": time.perf_counter() - t0, **ghia,
          "launches": dict(sc.LAUNCHES)})
    require(ghia["u_rms"] < 0.035 and ghia["v_rms"] < 0.035,
            f"Ghia deviation too large: {ghia}")
    require(sc.LAUNCHES["JACOBI_PRESSURE"] == 40 * res.steps_done,
            "Ghia run did not go through the kernels")


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    smi = phase_card()
    phase_build()
    dev = torch.device("cuda")
    kernel_results = phase_kernels(dev)
    paths = {"serial": phase_main(kernel_results, dev),
             "farm": phase_farm(dev, "farm", PER_STEP),
             "farm_fused": phase_farm(dev, "farm_fused", PER_STEP_FUSED,
                                      fused_sweeps=FUSED_K),
             "throughput": phase_throughput(dev)}
    phase_physics(dev)
    # each kernel's launches on this slice's path that carries it: the
    # farm for the four stencils, the fused-smoother farm for JACOBI_FUSED
    carrier = {name: "farm" for name in STENCILS}
    carrier["JACOBI_FUSED"] = "farm_fused"
    for name in KERNELS:
        require(paths[carrier[name]][name] > 0,
                f"{name} never launched on the {carrier[name]} path")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE[name],
        "replaces": REPLACES[name], "instance": INSTANCE[name],
        "launches": paths[carrier[name]][name],
        "launches_by_path": {k: v[name] for k, v in paths.items()},
        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    } for name, r in kernel_results.items()]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": smi})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
