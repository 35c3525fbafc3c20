"""The driver component: storage and halo specs for one undecomposed grid.

In Cactus the *driver thorn* (PUGH/Carpet) sets up storage, partitions the
grid between processes, and owns inter-process communication.  This slice
of the port runs the grid as one block on one device: the driver allocates
fields on its device and builds the halo AxisSpecs, so application code
(the CFD solver) is written in terms of blocks + ghost zones as in the
paper.  Decomposition over ``torch.distributed`` is ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.halo import AxisSpec, BCRule


@dataclasses.dataclass(frozen=True)
class Domain:
    """Global regular grid: extent, spacing, boundaries."""

    shape: tuple[int, int, int]
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    periodic: tuple[bool, bool, bool] = (False, False, False)


class GridDriver:
    """Owns domain + device; hands out axis specs, storage and the step."""

    def __init__(self, domain: Domain, device: torch.device):
        self.domain = domain
        self.device = torch.device(device)

    # -- geometry ------------------------------------------------------------
    def axis_specs(
        self,
        bc_lo: Sequence[BCRule | None] = (None, None, None),
        bc_hi: Sequence[BCRule | None] = (None, None, None),
    ) -> tuple[AxisSpec, AxisSpec, AxisSpec]:
        """Halo AxisSpecs for the three array axes (for exchange_pad)."""
        return tuple(
            AxisSpec(
                array_axis=a,
                periodic=self.domain.periodic[a],
                bc_lo=bc_lo[a],
                bc_hi=bc_hi[a],
            )
            for a in range(3)
        )

    # -- storage ------------------------------------------------------------
    def coords(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Global cell-center coordinate arrays (f32, on the device).

        The positions are computed in float64 and rounded once to float32,
        as the reference does."""
        axes = [
            self.domain.origin[a] + (np.arange(self.domain.shape[a]) + 0.5) * self.domain.spacing[a]
            for a in range(3)
        ]
        vecs = [torch.tensor(x.astype(np.float32), device=self.device)
                for x in axes]
        return tuple(torch.meshgrid(*vecs, indexing="ij"))

    def allocate(self, names: Sequence[str], init=0.0,
                 dtype=torch.float32) -> dict:
        return {n: torch.full(self.domain.shape, init, dtype=dtype,
                              device=self.device) for n in names}

    # -- execution ----------------------------------------------------------
    def sharded_step_tree(self, step_local: Callable, example_state=None,
                          example_params=None) -> Callable:
        """The step for this driver: undecomposed, the local step itself.

        Kept so the solver reads as the reference does; the decomposed
        form arrives with ROADMAP queue 1, item 9."""
        return step_local
