#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as JSON lines; any failure exits non-zero:

1. card      the card's name and power limit (nvidia-smi) and torch's name;
2. build     the CUDA kernels built from ``src/repro_torch/kernels/csrc``;
3. kernels   each hand-written kernel against its plain PyTorch version on
             the card, at the 256^3 main-path shape, an odd shape and a
             slot-batched call with distinct parameter rows; CUDA-event
             times of kernel and plain version beside the least time the
             card could take (bytes over 3.35 TB/s or float32 operations
             over 67 TFLOP/s, H100 SXM data-sheet peaks);
4. main      ``api.runtime(n=256, nz=256).run("cavity", steps=20)`` on the
             ``cuda`` backend with the launch counters reset just before,
             then on the ``torch`` backend; the two must agree, and the
             counts must be 20 x (1, 1, 40, 1); step wall time, the
             profiler's device-time split of one step, and peak memory;
5. physics   Taylor-Green, cavity divergence and Ghia bounds with the
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

# float32 operations per interior cell, counted from the kernel source
# (csrc/stencil3d.cu), an FMA as two; none depends on the data
OPS_PER_CELL = {"UPDATE_VELOCITY": 148, "DIVERGENCE": 7,
                "JACOBI_PRESSURE": 13, "PROJECT_VELOCITY": 10}
PER_STEP = {"UPDATE_VELOCITY": 1, "DIVERGENCE": 1, "JACOBI_PRESSURE": 40,
            "PROJECT_VELOCITY": 1}
REPLACES = {
    "UPDATE_VELOCITY": "src/repro/kernels/stencil3d.py:74",
    "DIVERGENCE": "src/repro/kernels/stencil3d.py:148",
    "JACOBI_PRESSURE": "src/repro/kernels/stencil3d.py:159",
    "PROJECT_VELOCITY": "src/repro/kernels/stencil3d.py:171",
}
TEMPLATE = "src/repro/core/generator.py:213"
SOURCE = "src/repro_torch/kernels/csrc/stencil3d.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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
    from repro_torch.kernels import _build, stencil3d_cuda

    t0 = time.perf_counter()
    stencil3d_cuda._lib()
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info["seconds"],
          "cached": _build.build_info["cached"],
          "library": os.path.relpath(_build.build_info["path"], ROOT),
          "ptxas": ptxas})


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
    """(S, n_params) table from a list of CFDConfigs (one row each), with
    forcing set so that every parameter column is exercised."""
    import torch
    from repro_torch.kernels import stencil3d

    desc = stencil3d.DESCRIPTORS[name]
    rows = []
    for s, c in enumerate(cfgs):
        vals = dict(dt=c.dt, h=c.h, nu=c.nu, omega=c.jacobi_omega,
                    fx=0.1 * (s + 1), fy=-0.05 * (s + 1), fz=0.02 * (s + 1))
        rows.append([vals[p] for p in desc.parameters])
    return torch.tensor(rows, dtype=torch.float32, device=dev)


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
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
def phase_main(kernel_results, dev):
    import torch
    from repro_torch import api
    from repro_torch.core.halo import exchange_pad
    from repro_torch.kernels import stencil3d_cuda as sc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    t0 = time.perf_counter()
    res_cuda = api.runtime(n=N, nz=N, backend="cuda", device=dev).run(
        "cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    sc.reset_launches()
    t0 = time.perf_counter()
    res_torch = api.runtime(n=N, nz=N, backend="torch", device=dev).run(
        "cavity", steps=STEPS, re=100.0)
    torch.cuda.synchronize()
    torch_s = time.perf_counter() - t0
    torch_launches = dict(sc.LAUNCHES)

    agree = {}
    # velocity components are held to the flow's speed (vz stays ~0 in the
    # z-periodic cavity), the pressure to its own magnitude
    speed = max(float(res_torch.state[f].abs().max()) for f in ("vx", "vy", "vz"))
    for f in ("vx", "vy", "vz", "p"):
        a, b = res_cuda.state[f], res_torch.state[f]
        require(bool(torch.isfinite(a).all()), f"cuda backend: {f} not finite")
        require(bool(torch.isfinite(b).all()), f"torch backend: {f} not finite")
        require(tuple(a.shape) == (N, N, N), f"{f} shape {tuple(a.shape)}")
        diff = float((a - b).abs().max())
        tol = PATH_RTOL * (float(b.abs().max()) if f == "p" else speed)
        agree[f] = {"max_abs_diff": diff, "tolerance": tol}
        require(diff <= tol, f"cuda vs torch backend: {f} differs by {diff} > {tol}")
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
                                    "cat", "flip", "fill")
                    if tag in low), "other")
        groups[key] = groups.get(key, 0.0) + ev.self_device_time_total / 1e3
    return groups or "not measured"


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
    launches = phase_main(kernel_results, dev)
    phase_physics(dev)
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": TEMPLATE, "instance": f"{name} ({REPLACES[name]})",
        "launches": launches[name],
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
