"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its driver (``drivers/<kind>.py``).  The
driver builds the program through its front door from the seed, warms up
every shape the cell uses, and measures for ``--seconds``; then the
program's state is freed and the reference judges what the window
produced (``compare.py``).  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` trace of the window, each by its own reader
(``metrics/<metric>.py``).

Without as many CUDA cards as the cell asks for, or with the JAX stack or
the JAX package loaded, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


@dataclass
class Cell:
    wl: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def metrics_for(name: str, trace: bool, bench: dict) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    reported = {m["name"] for m in bench["end_to_end"]
                if name in m.get("workloads", [name])}
    out = []
    for m in group:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif not trace or m["moves"] in reported:
            out.append(m)
    return out


def drive(wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
          device, t_start: float) -> dict:
    """Run the cell's driver; its output holds host copies alone."""
    import torch

    out = harness.module("drivers", wl["driver"]).run(
        Cell(wl, cfg, seed, seconds, trace, device, t_start))
    # the program's state is gone with the driver's frame; free its blocks
    # before the reference runs
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def execute(wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
            device, t_start: float, bench: dict) -> dict:
    """Drive the cell, judge it, read its metrics: the result's fields."""
    import compare

    out = drive(wl, cfg, seed, seconds, trace, device, t_start)
    t_ref = time.perf_counter()
    vals = compare.readings(out, cfg, seed, device)["program"]
    out["counters"]["reference_s"] = time.perf_counter() - t_ref
    correct, checks = compare.judge(vals, wl["limits"])
    rec = dict(out, jacobi_iters=cfg["jacobi_iters"])
    metrics = {}
    for m in metrics_for(wl["name"], trace, bench):
        value = harness.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]},
              "counters": out["counters"]}
    if trace and out["trace"] is not None:
        import traceread

        result["device"]["busy_s"] = traceread.busy_ns(out["trace"]) / 1e9
        result["device"]["window_s"] = traceread.window_ns(out["trace"]) / 1e9
        result["breakdown"] = traceread.breakdown(out["trace"])
    result["checks"] = checks
    return result


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    harness.use_program()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(wl, cfg, args.seed, args.seconds, bool(args.trace),
                     device, T_START, bench)
    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        "count": int(wl["chips"]), **result["device"]}
    checks = result.pop("checks")
    result["checks"] = {k: {"value": _number(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
