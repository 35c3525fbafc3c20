"""The driver component: domain decomposition over a mesh of ranks.

In Cactus the *driver thorn* (PUGH/Carpet) sets up storage, partitions the
grid between processes, and owns inter-process communication.  Here the
driver owns the domain, this rank's place on the mesh and the halo links:
it builds the AxisSpecs for stencil kernels, allocates the rank's local
block, maps global fields to blocks and back, and reduces over the
decomposition — so application code (the CFD solver) is written purely in
terms of local blocks + ghost zones, as in the paper.

Without a mesh the grid is one block on one device.  With one, array axis
``a`` of ``Domain.decomposition`` is split over mesh axis ``name``: every
rank of the mesh runs the same local program on its block (the
reference's ``shard_map``), and each decomposed axis's ghost strips travel
by :class:`repro_torch.core.halo.P2PTransport` (or, for a cost trace, the
driver's ``transport``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.halo import (
    AxisLink, AxisSpec, BCRule, CountTransport, P2PTransport,
    tensor_axis,
)
from repro_torch.device import true_divide


@dataclasses.dataclass(frozen=True)
class Domain:
    """Global regular grid: extent, spacing, decomposition, boundaries."""

    shape: tuple[int, int, int]
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # array axis -> mesh axis name (axes absent are not decomposed)
    decomposition: Mapping[int, str] = dataclasses.field(default_factory=dict)
    periodic: tuple[bool, bool, bool] = (False, False, False)


class GridDriver:
    """Owns domain + device + mesh; hands out axis specs, storage, the
    step and the reductions over the decomposition.

    ``mesh`` is a ``DeviceMesh`` (``repro_torch.launch.mesh.make_mesh``)
    or, for a cost trace with no process, a ``{mesh axis: (extent,
    index)}`` mapping that places this block on virtual links.  The
    strips travel point to point over the process group of a
    ``DeviceMesh``; a virtual mesh counts them."""

    def __init__(self, domain: Domain, device: torch.device, mesh=None):
        self.domain = domain
        self.device = torch.device(device)
        self.mesh = mesh
        self.links: dict[int, AxisLink] = {}
        self.transport = None
        if mesh is None:
            if domain.decomposition:
                raise ValueError("decomposed domain requires a mesh")
            return
        if isinstance(mesh, Mapping):
            extents = {n: int(e) for n, (e, _) in mesh.items()}
        else:
            extents = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for a, name in domain.decomposition.items():
            if name not in extents:
                raise ValueError(f"mesh has no axis {name!r} for array axis {a}")
            if domain.shape[a] % extents[name]:
                raise ValueError(
                    f"global extent {domain.shape[a]} on axis {a} not divisible "
                    f"by mesh axis {name!r} (size {extents[name]})"
                )
        # one transport for every axis: its counters are this rank's
        self.transport = (CountTransport() if isinstance(mesh, Mapping)
                          else P2PTransport())
        for a, name in sorted(domain.decomposition.items()):
            if isinstance(mesh, Mapping):
                size, index = mesh[name]
                self.links[a] = AxisLink(name=name, size=int(size),
                                         index=int(index),
                                         transport=self.transport)
            else:
                self.links[a] = AxisLink.from_mesh(mesh, name, self.transport)

    # -- geometry ------------------------------------------------------------
    @property
    def local_shape(self) -> tuple[int, int, int]:
        s = list(self.domain.shape)
        for a, link in self.links.items():
            s[a] //= link.size
        return tuple(s)

    def block_slices(self) -> tuple[slice, slice, slice]:
        """This rank's block of the global grid, one slice per axis."""
        loc = self.local_shape
        starts = [self.links[a].index * loc[a] if a in self.links else 0
                  for a in range(3)]
        return tuple(slice(s, s + n) for s, n in zip(starts, loc))

    def is_last(self, axis: int) -> bool:
        """Does this rank's block end where the grid ends on ``axis``?"""
        link = self.links.get(axis)
        return link is None or link.index == link.size - 1

    def axis_specs(
        self,
        bc_lo: Sequence[BCRule | None] = (None, None, None),
        bc_hi: Sequence[BCRule | None] = (None, None, None),
    ) -> tuple[AxisSpec, AxisSpec, AxisSpec]:
        """Halo AxisSpecs for the three array axes (for exchange_pad)."""
        return tuple(
            AxisSpec(
                array_axis=a,
                mesh_axis=self.domain.decomposition.get(a),
                periodic=self.domain.periodic[a],
                bc_lo=bc_lo[a],
                bc_hi=bc_hi[a],
                link=self.links.get(a),
            )
            for a in range(3)
        )

    # -- storage ------------------------------------------------------------
    def coords(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Cell-center coordinates of this rank's block (f32, on the
        device).

        The positions are computed in float64 over the global grid, cut to
        the block and rounded once to float32, as the reference does."""
        axes = [
            (self.domain.origin[a] + (np.arange(self.domain.shape[a]) + 0.5)
             * self.domain.spacing[a])[sl]
            for a, sl in enumerate(self.block_slices())
        ]
        vecs = [torch.tensor(x.astype(np.float32), device=self.device)
                for x in axes]
        return tuple(torch.meshgrid(*vecs, indexing="ij"))

    def allocate(self, names: Sequence[str], init=0.0,
                 dtype=torch.float32) -> dict:
        return {n: torch.full(self.local_shape, init, dtype=dtype,
                              device=self.device) for n in names}

    def scatter(self, field) -> torch.Tensor:
        """This rank's block of a global field (``(*lead, X, Y, Z)``, a
        tensor or array held by every rank), on the driver's device."""
        field = torch.as_tensor(field)
        sl = (Ellipsis,) + self.block_slices()
        return field[sl].to(self.device, copy=True).contiguous()

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The global field of ``block`` (``(*lead, x, y, z)``), on the host,
        on every rank of the decomposition: the blocks are all-gathered
        over each decomposed axis in turn and joined in rank order."""
        out = block
        for a, link in sorted(self.links.items()):
            parts = link.transport.all_gather(link, out)
            out = torch.cat(list(parts.unbind(0)), dim=tensor_axis(a))
        return out.to("cpu")

    # -- reductions over the decomposition ----------------------------------
    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the decomposition of every block's ``x`` (the
        reference's ``pmean``): per decomposed axis, the blocks' values are
        all-gathered, summed in rank order and divided by the axis's size.
        The order is fixed, so the result is the same bits on every rank
        and for every shape of ``x`` (a farm's per-slot vector included);
        ``all_reduce(SUM)`` would leave the order to the backend."""
        for _, link in sorted(self.links.items()):
            parts = link.transport.all_gather(link, x)
            acc = parts[0]
            for i in range(1, link.size):
                acc = acc + parts[i]
            x = true_divide(acc, float(link.size))
        return x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        for _, link in sorted(self.links.items()):
            x = link.transport.all_reduce(link, x, "max")
        return x

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        for _, link in sorted(self.links.items()):
            x = link.transport.all_reduce(link, x, "min")
        return x

    # -- execution ----------------------------------------------------------
    def sharded_step_tree(self, step_local: Callable, example_state=None,
                          example_params=None) -> Callable:
        """The step for this driver: the local step itself.  Every rank of
        the mesh runs it on its own block (the reference wraps it in
        ``shard_map``); it exchanges ghosts through this driver's specs."""
        return step_local
