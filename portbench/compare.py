"""The comparison that decides ``correct``.

Each number is held to its limit in the cell's file (``limits``), and a
cell compares the numbers its file names:

* ``intake_diff``: the largest difference between what the program took
  in (the four fields and its three wall masks, as the first step read
  them) and the benchmark's seeded fields and the reference's masks.
  Exact: limit 0.
* ``start_gap``: each run's first step from the seeded fields.
* ``result_gap``: a finished run's result, as the program hands it out,
  after its last step.
* ``window_gap``: a step of the window, drawn from the seed: every run's
  state after it (in a farm, every slot's).

Every gap compares the program's state after some number of steps from a
run's seeded fields with the reference's, stepped from the same seeded
fields as often: the reference never starts from the program's state.  A
gap is the worst, over the fields (and the runs), of
``max |program - reference| / max |reference|``.

The reference is the module the configuration names (``reference``, under
``reference/``), computed in the configuration's ``precision`` with TF32
off.  It runs once the window has closed and the program's state is freed,
one run and one step at a time.  The control is the same reference one
precision lower (:data:`CONTROL_BELOW`), put in the program's place.
"""
from __future__ import annotations

import functools
import math
from collections import defaultdict

import torch

import harness
import traffic

NAMES = ("intake_diff", "start_gap", "result_gap", "window_gap")

# the nearest precision below the one a configuration states
CONTROL_BELOW = {"float64": torch.float32, "float32": torch.bfloat16}


def _worse(a: float, b: float) -> float:
    """The larger of two readings; NaN, a reading that failed, wins."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def gap(got: dict, want: dict, fields) -> float:
    worst = 0.0
    for f in fields:
        w = want[f].to(torch.float32)
        g = got[f].to(w.device, torch.float32)
        scale = float(w.abs().max())
        d = float((g - w).abs().max())
        worst = _worse(worst, d / scale if scale > 0
                       else (0.0 if d == 0 else math.inf))
    return worst


def reference_of(cfg: dict):
    """The reference module the configuration names."""
    return harness.module("reference", cfg["reference"])


class Reference:
    """The reference's inputs for one cell: the seeded fields of any run,
    the masks, each run's parameters, the precision."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.grid = tuple(cfg["grid"])
        self.ns = reference_of(cfg)
        self.dtype = getattr(torch, cfg["precision"])
        self.control_dtype = CONTROL_BELOW[cfg["precision"]]

    def initial(self, member: int) -> dict:
        ic = self.cfg["initial_fields"]
        return traffic.initial_fields(
            self.grid, self.seed, member, modes=ic["modes"],
            amplitude=ic["amplitude"],
            lid_velocity=self.cfg["lid_velocity"], device=self.device)

    def params(self, re: float) -> dict:
        return self.ns.params(re, self.grid,
                              lid_velocity=self.cfg["lid_velocity"],
                              cfl_factor=self.cfg["dt_cfl_factor"],
                              extent=self.cfg["extent"])

    def step(self, state: dict, re: float, dtype) -> dict:
        return self.ns.step(state, self.params(re),
                            jacobi_iters=self.cfg["jacobi_iters"],
                            omega=self.cfg["jacobi_omega"], dtype=dtype)

    def intake_diff(self, entry: dict) -> float:
        want = self.initial(entry["member"])
        m = self.ns.masks(self.grid, self.device)
        want.update({f"mask_{f}": m[f] for f in self.ns.VELOCITY})
        worst = 0.0
        for k, w in want.items():
            worst = _worse(worst, float(
                (entry["got"][k].to(self.device) - w).abs().max()))
        return worst


def readings(out: dict, cfg: dict, seed: int, device,
             control: bool = False) -> dict:
    """The numbers of a driver's output, ``{"program": {name: value}}``;
    with ``control`` also ``"control"``: the reference one precision lower
    in the program's place, stepped beside the reference, its intake the
    seeded fields themselves.  A number with nothing to read is NaN, which
    no limit passes."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(cfg, seed, device)
        fields = ref.ns.FIELDS
        got = defaultdict(list)
        low = defaultdict(list)
        got["intake_diff"] = [ref.intake_diff(e) for e in out["intake"]]
        low["intake_diff"] = [0.0]
        runs = defaultdict(list)
        for case in out["cases"]:
            runs[case["member"]].append(case)
        for member, cases in sorted(runs.items()):
            re = cases[0]["re"]
            due = defaultdict(list)
            for case in cases:
                due[int(case["steps"])].append(case)
            want = ref.initial(member)
            lower = ({f: want[f].to(ref.control_dtype) for f in fields}
                     if control else None)
            want = {f: want[f].to(ref.dtype) for f in fields}
            for n in range(1, max(due) + 1):
                want = ref.step(want, re, ref.dtype)
                if control:
                    lower = ref.step(lower, re, ref.control_dtype)
                for case in due.get(n, ()):
                    got[case["name"]].append(
                        gap(case["output"], want, fields))
                    if control:
                        low[case["name"]].append(gap(lower, want, fields))
            del want, lower
        names = sorted(set(got) | {c["name"] for c in out["cases"]})
        result = {"program": {k: functools.reduce(_worse, got[k])
                              if got[k] else math.nan for k in names}}
        if control:
            result["control"] = {k: functools.reduce(_worse, low[k])
                                 if low[k] else math.nan for k in names}
        return result
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def judge(vals: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """Every number the cell's limits name against its limit; one that is
    missing reads NaN and fails."""
    checks = {name: {"value": vals.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
