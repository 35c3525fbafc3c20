"""Bytes and operations of the NS3D projection step's four stencil kernels.

Bytes count each input field read once and each output field written once,
unpadded, 4 bytes a cell (float32), whatever a kernel reads again or pads:
the least traffic the step's arithmetic needs.  Operations count the
additions, subtractions, multiplications and divisions of each kernel's
formula as written (``reference/ns3d.py`` holds the same formulas).

============================  =======  =============  ===================
kernel                        fields   ops a cell     a step
============================  =======  =============  ===================
UPDATE_VELOCITY               3 + 3    3 x 48 = 144   once
DIVERGENCE                    3 + 1    6              once
JACOBI_PRESSURE               2 + 1    11             ``jacobi_iters``
PROJECT_VELOCITY              4 + 3    10             once
============================  =======  =============  ===================

UPDATE_VELOCITY, one component: ten two-point averages (2 each), three flux
differences (4 each), the 7-point Laplacian (8), and the update
``c + dt (-(a + b + d) + nu lap + f)`` (8).  JACOBI_PRESSURE: five adds of
the neighbours, ``h^2 rhs``, the difference, the division by 6, and
``(1 - w) p + w jac`` (3).  PROJECT_VELOCITY: ``dt / h`` and three
``c - s (p' - p)`` (3 each).
"""
from __future__ import annotations

import dataclasses

from cost import peaks

FLOAT_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Kernel:
    name: str          # the descriptor's name
    symbol: str        # the device function's name in the trace
    fields: int        # field passes: inputs read + outputs written
    ops: int           # operations a cell

    def bytes(self, cells: int) -> int:
        return self.fields * cells * FLOAT_BYTES

    def flops(self, cells: int) -> int:
        return self.ops * cells

    def least_s(self, cells: int, chip: str = peaks.DEFAULT) -> float:
        """The least time of one launch over ``cells`` cells: the larger
        of its bytes over the chip's bandwidth and its operations over the
        chip's float32 rate."""
        return peaks.least_s(self.bytes(cells), self.flops(cells), chip)


UPDATE_VELOCITY = Kernel("UPDATE_VELOCITY", "update_velocity_kernel", 6, 144)
DIVERGENCE = Kernel("DIVERGENCE", "divergence_kernel", 4, 6)
JACOBI_PRESSURE = Kernel("JACOBI_PRESSURE", "jacobi_pressure_kernel", 3, 11)
PROJECT_VELOCITY = Kernel("PROJECT_VELOCITY", "project_velocity_kernel", 7, 10)
KERNELS = (UPDATE_VELOCITY, DIVERGENCE, JACOBI_PRESSURE, PROJECT_VELOCITY)
# the fused smoother (``fused_sweeps`` > 1) stands in for JACOBI_PRESSURE
JACOBI_FUSED_SYMBOL = "jacobi_fused_kernel"
STENCIL_SYMBOLS = tuple(k.symbol for k in KERNELS) + (JACOBI_FUSED_SYMBOL,)


def launches(jacobi_iters: int) -> dict[Kernel, int]:
    """Each kernel's launches a step."""
    return {UPDATE_VELOCITY: 1, DIVERGENCE: 1,
            JACOBI_PRESSURE: jacobi_iters, PROJECT_VELOCITY: 1}


def step_field_passes(jacobi_iters: int) -> int:
    """137 at ``jacobi_iters`` 40: 6 + 4 + 40 x 3 + 7."""
    return sum(k.fields * n for k, n in launches(jacobi_iters).items())


def step_bytes(cells: int, jacobi_iters: int) -> int:
    return step_field_passes(jacobi_iters) * cells * FLOAT_BYTES


def step_flops(cells: int, jacobi_iters: int) -> int:
    return sum(k.ops * n for k, n in launches(jacobi_iters).items()) * cells


def step_least_s(cells: int, jacobi_iters: int,
                 chip: str = peaks.DEFAULT) -> float:
    """The least time of one step whichever kernels implement it."""
    return peaks.least_s(step_bytes(cells, jacobi_iters),
                         step_flops(cells, jacobi_iters), chip)
