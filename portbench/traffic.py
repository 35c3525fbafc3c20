"""The one generator of the benchmark's inputs, driven by the data files.

From ``--seed`` come:

* the initial fields of every run: a smooth velocity field, a few low
  Fourier modes a component (wave numbers, phases and amplitudes drawn
  from the seed and the member's index), scaled so that the amplitudes of
  a component sum to ``amplitude`` times the lid speed, its hi-wall normal
  faces zero, and the pressure zero.  Built on the device from 1-D
  vectors, one outer product a mode;
* a sweep's members: each member's Reynolds number, in blocks of the
  list, each block permuted, and its end time, the same for every member
  (``t_end``, as a user of the farm submits it; the program turns it into
  a step count from the member's dt).  So every seed gets the same
  members in another order, and the work of a window is the same;
* the sweep's probe: a member of ``probe_steps`` steps, its Reynolds
  number drawn from the list, that finishes in set-up, so that the check
  reads a result and an admission outside the measured window;
* the window step whose output a run's check reads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from harness import seed_ints

VELOCITY = ("vx", "vy", "vz")
FIELDS = VELOCITY + ("p",)

# streams of the seed, so that one draw never shifts another
_FIELDS_STREAM, _RE_STREAM = 1, 2
_CHECK_STREAM, _PROBE_STREAM = 5, 6


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed_ints(seed,
                                                                  *stream)))


def initial_fields(grid, seed: int, member: int, *, modes: int,
                   amplitude: float, lid_velocity: float,
                   device) -> dict[str, torch.Tensor]:
    """``vx, vy, vz, p`` of one run, float32 on ``device``."""
    rng = _rng(seed, _FIELDS_STREAM, member)
    nx, ny, nz = grid
    out = {}
    for comp in VELOCITY:
        kx = rng.integers(1, 4, modes)
        ky = rng.integers(1, 4, modes)
        kz = rng.integers(0, 3, modes)
        phase = rng.uniform(0.0, 2.0 * math.pi, modes)
        amp = rng.uniform(-1.0, 1.0, modes)
        amp *= amplitude * lid_velocity / np.abs(amp).sum()
        field = torch.zeros(grid, dtype=torch.float32, device=device)
        for m in range(modes):
            x = _wave(nx, kx[m], 0.0, torch.sin, device) * float(amp[m])
            y = _wave(ny, ky[m], 0.0, torch.sin, device)
            z = _wave(nz, kz[m], float(phase[m]), torch.cos, device, 2.0)
            field += x[:, None, None] * y[None, :, None] * z[None, None, :]
        out[comp] = field
    # the hi walls' normal faces carry no flow (the cavity's wall masks)
    out["vx"][-1, :, :] = 0.0
    out["vy"][:, -1, :] = 0.0
    out["p"] = torch.zeros(grid, dtype=torch.float32, device=device)
    return out


def _wave(n: int, k: int, phase: float, fn, device, period: float = 1.0):
    """``fn(period * pi * k * (i + 1/2) / n + phase)`` for i < n, reckoned in
    float64 and rounded once to float32."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    arg = (i + 0.5) * (period * math.pi * int(k) / n) + phase
    return fn(arg).to(torch.float32)


def checked_step(seed: int, lo: int, hi: int) -> int:
    """The window step a run's check reads, counted from the window's
    first (0), in ``[lo, hi)``."""
    return int(_rng(seed, _CHECK_STREAM).integers(lo, hi))


@dataclasses.dataclass(frozen=True)
class Member:
    index: int
    re: float
    steps: int | None = None       # a step cap, or
    t_end: float | None = None     # an end time the program divides by dt

    @property
    def tag(self) -> str:
        return f"m{self.index}"


class Sweep:
    """The members of a Reynolds sweep, in submission order: the probe
    (index 0) first, then the sweep's members from index 1, the first
    ``n_slots`` of whom are resident when the window opens while the rest
    queue behind them."""

    def __init__(self, traffic: dict, seed: int):
        self.reynolds = [float(r) for r in traffic["reynolds"]]
        self.t_end = float(traffic["t_end"])
        self.probe_steps = int(traffic["probe_steps"])
        self.seed = seed

    def probe(self) -> Member:
        pick = int(_rng(self.seed, _PROBE_STREAM).integers(
            len(self.reynolds)))
        return Member(index=0, re=self.reynolds[pick],
                      steps=self.probe_steps)

    def member(self, i: int) -> Member:
        """The sweep's ``i``-th member, ``i >= 1``."""
        if i < 1:
            raise ValueError("the sweep's members count from 1")
        nre, j = len(self.reynolds), i - 1
        order = _rng(self.seed, _RE_STREAM, j // nre).permutation(nre)
        return Member(index=i, re=self.reynolds[int(order[j % nre])],
                      t_end=self.t_end)
