"""CaCUDA kernel descriptors — the port's own copy of ``repro.core.descriptor``.

The paper's CaCUDA abstraction declares, per kernel: the grid variables it
touches, their intents, whether they are staged through fast on-chip memory
(CACHED), the stencil radii, and the tile shape.  The descriptor is consumed
by :mod:`repro_torch.core.generator`, which dispatches a ``3DBLOCK``
descriptor to its hand-written CUDA kernel or expands the body eagerly in
PyTorch.  The class is pure Python and kept field-for-field equal to the
reference's (the port's tests pin that); the docstrings below still speak
of the TPU template the fields were first defined for.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence


class Intent(enum.Enum):
    """Variable intents, exactly the CaCUDA set."""

    IN = "IN"
    OUT = "OUT"
    INOUT = "INOUT"
    # Read from one buffer, write to a separate one (double buffering).  The
    # generated kernel reads ``name`` and produces a fresh output array.
    SEPARATEINOUT = "SEPARATEINOUT"

    @property
    def is_read(self) -> bool:
        return self in (Intent.IN, Intent.INOUT, Intent.SEPARATEINOUT)

    @property
    def is_write(self) -> bool:
        return self in (Intent.OUT, Intent.INOUT, Intent.SEPARATEINOUT)


@dataclasses.dataclass(frozen=True)
class VariableGroup:
    """A CCTK_CUDA_KERNEL_VARIABLE block: names sharing intent/caching."""

    names: tuple[str, ...]
    intent: Intent
    cached: bool = True
    group: str = ""

    def __post_init__(self):
        if not self.names:
            raise ValueError("variable group must name at least one variable")


@dataclasses.dataclass(frozen=True)
class StencilDescriptor:
    """The CaCUDA kernel descriptor (Listing 1 of the paper).

    ``stencil`` is the 6-tuple of one-sided radii ``(xl, xh, yl, yh, zl, zh)``
    exactly as in the paper's ``STENCIL="1,1,1,1,1,1"``.  ``tile`` is the
    output tile owned by one kernel instance (the paper's ``TILE="16,16,16"``).
    On TPU the tile maps to the Pallas BlockSpec block shape; cached inputs are
    staged into VMEM as ``tile + stencil`` halo-expanded blocks.

    ``parameters`` declares the kernel's runtime scalars — and, for the
    3DBLOCK template, the *scalar-prefetch contract*: declaration order is
    the column order of the generated kernel's scalar table
    (:meth:`param_index`), the operand that carries array-valued/per-slot
    parameter values (``pltpu.PrefetchScalarGridSpec`` on real TPU, a
    leading row-indexed operand in interpret mode).  Values passed as
    Python scalars are instead baked as trace-time literals.
    """

    name: str
    variables: tuple[VariableGroup, ...]
    stencil: tuple[int, int, int, int, int, int] = (1, 1, 1, 1, 1, 1)
    tile: tuple[int, ...] = (8, 8, 128)
    type: str = "3DBLOCK"
    parameters: tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.stencil) != 6:
            raise ValueError(f"stencil must have 6 radii, got {self.stencil}")
        if any(r < 0 for r in self.stencil):
            raise ValueError(f"stencil radii must be >= 0: {self.stencil}")
        if self.type not in ("3DBLOCK", "JNP"):
            raise ValueError(f"unknown kernel type {self.type!r}")
        if len(self.tile) != 3:
            raise ValueError(f"tile must be rank 3, got {self.tile}")
        seen: set[str] = set()
        for g in self.variables:
            for n in g.names:
                if n in seen:
                    raise ValueError(f"variable {n!r} declared twice")
                seen.add(n)

    # -- derived geometry ---------------------------------------------------
    @property
    def halo_lo(self) -> tuple[int, int, int]:
        return (self.stencil[0], self.stencil[2], self.stencil[4])

    @property
    def halo_hi(self) -> tuple[int, int, int]:
        return (self.stencil[1], self.stencil[3], self.stencil[5])

    @property
    def halo_width(self) -> tuple[int, int, int]:
        """Symmetric ghost width needed per axis (max of lo/hi radius)."""
        return tuple(
            max(self.stencil[2 * a], self.stencil[2 * a + 1]) for a in range(3)
        )

    # -- variable classification --------------------------------------------
    def _names(self, pred) -> tuple[str, ...]:
        out: list[str] = []
        for g in self.variables:
            if pred(g):
                out.extend(g.names)
        return tuple(out)

    @property
    def inputs(self) -> tuple[str, ...]:
        """All variables the kernel reads, in declaration order."""
        return self._names(lambda g: g.intent.is_read)

    @property
    def outputs(self) -> tuple[str, ...]:
        """All variables the kernel writes, in declaration order."""
        return self._names(lambda g: g.intent.is_write)

    @property
    def cached_inputs(self) -> frozenset[str]:
        return frozenset(self._names(lambda g: g.intent.is_read and g.cached))

    def group_of(self, name: str) -> VariableGroup:
        for g in self.variables:
            if name in g.names:
                return g
        raise KeyError(name)

    def param_index(self, name: str) -> int:
        """Scalar-table column of parameter ``name`` (declaration order).

        The generator packs array-valued runtime parameters into the
        3DBLOCK scalar-prefetch table in exactly this order, restricted to
        the parameters that are array-valued at the call site.
        """
        try:
            return self.parameters.index(name)
        except ValueError:
            raise KeyError(
                f"{name!r} is not a declared parameter of kernel "
                f"{self.name} (have {self.parameters})") from None

    def vmem_block_bytes(self, itemsize: int = 4) -> int:
        """VMEM working-set estimate for one kernel instance.

        Mirrors the shared-memory budget check the CaCUDA templates perform:
        each cached input costs a halo-expanded tile, outputs and uncached
        inputs cost a bare tile.
        """
        hx, hy, hz = self.halo_width
        tx, ty, tz = self.tile
        halo_block = (tx + 2 * hx) * (ty + 2 * hy) * (tz + 2 * hz)
        tile_block = tx * ty * tz
        total = 0
        for g in self.variables:
            per_var = halo_block if (g.cached and g.intent.is_read) else tile_block
            if g.intent is Intent.SEPARATEINOUT:
                per_var += tile_block  # separate output buffer
            total += per_var * len(g.names)
        return total * itemsize


def descriptor(
    name: str,
    *,
    stencil: Sequence[int] = (1, 1, 1, 1, 1, 1),
    tile: Sequence[int] = (8, 8, 128),
    type: str = "3DBLOCK",
    parameters: Sequence[str] = (),
    **groups: dict,
) -> StencilDescriptor:
    """Convenience constructor.

    Example::

        update_velocity = descriptor(
            "UPDATE_VELOCITY", stencil=(1, 1, 1, 1, 1, 1), tile=(16, 16, 16),
            velocity=dict(names=("vx", "vy", "vz"), intent="SEPARATEINOUT"),
            pressure=dict(names=("p",), intent="IN"),
            parameters=("density",),
        )
    """
    vgs = []
    for gname, spec in groups.items():
        vgs.append(
            VariableGroup(
                names=tuple(spec["names"]),
                intent=Intent(spec.get("intent", "IN")),
                cached=bool(spec.get("cached", True)),
                group=gname.upper(),
            )
        )
    return StencilDescriptor(
        name=name,
        variables=tuple(vgs),
        stencil=tuple(stencil),
        tile=tuple(tile),
        type=type,
        parameters=tuple(parameters),
    )
