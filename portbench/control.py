"""The readings the limits of ``correct`` are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> ...

For each seed it drives the cell as a run does (a short window at the
cell's own load, long enough to reach the window's checked step), then
reads each number the cell's limits name twice: for the program, and for
the control, the reference one precision below the configuration's
(``compare.CONTROL_BELOW``) in the program's place, and judges both by the
cell's limits as a run does.  One JSON line a seed.  The benchmark's own
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def readings(wl: dict, cfg: dict, seed: int, seconds: float, device) -> dict:
    import compare
    from run import drive

    out = drive(wl, cfg, seed, seconds, False, device, time.perf_counter())
    got = compare.readings(out, cfg, seed, device, control=True)
    return {"seed": seed, "steps": out["steps"],
            **{side: {"readings": vals,
                      "correct": compare.judge(vals, wl["limits"])[0]}
               for side, vals in got.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    harness.use_program()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    for seed in args.seeds:
        print(json.dumps(dict(workload=wl["name"], **readings(
            wl, cfg, seed, args.seconds, torch.device("cuda", 0)))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
