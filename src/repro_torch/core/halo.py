"""Driver-managed ghost-zone (halo) padding, single process.

In Cactus, the driver partitions the grid over MPI ranks and fills each
rank's *ghost region* from its neighbours before stencil kernels run.  This
slice of the port runs undecomposed, so the exchange degenerates to
boundary-condition padding and periodic wrap; the neighbour exchange over
``torch.distributed`` is ROADMAP queue 1, item 9.

Fields are stored **unpadded**; the halo is materialized transiently per
kernel application (``exchange_pad``).  :func:`stencil_step_overlap` keeps
the reference's interior/shell split, so a stencil that needs no ghosts for
its deep interior runs independently of the padding.

Fields are ``(*lead, X, Y, Z)``: any leading axes (the farm's slot axis)
pass through untouched.  ``AxisSpec.array_axis`` names a grid axis (0, 1 or
2) and the padding acts on tensor axis ``array_axis - 3``, counted from the
end (:func:`tensor_axis`, the one place that maps the two), so the same
specs pad one grid and a slot batch of grids.

A BC rule is ``rule(strip, side, axis) -> ghost strip``: the axis is passed
explicitly, as that negative tensor axis (the reference injects it through
a function attribute).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

# A BC rule maps (strip, side, axis) -> ghost strip, where ``strip`` is the
# ``width``-wide slab of interior cells adjacent to the physical boundary
# (ordered as stored, i.e. strip[0] is closest to the domain for side "lo"
# ... strip[-1] closest for side "hi").
BCRule = Callable[[torch.Tensor, str, int], torch.Tensor]

GRID_DIMS = 3


def tensor_axis(array_axis: int) -> int:
    """The tensor axis of grid axis ``array_axis``, counted from the end."""
    if not 0 <= array_axis < GRID_DIMS:
        raise ValueError(f"grid axis {array_axis} not in 0..{GRID_DIMS - 1}")
    return array_axis - GRID_DIMS


def bc_dirichlet(value: float) -> BCRule:
    def rule(strip: torch.Tensor, side: str, axis: int) -> torch.Tensor:
        return torch.full_like(strip, value)

    return rule


def bc_neumann() -> BCRule:
    """Zero-gradient: mirror the adjacent interior cells."""

    def rule(strip: torch.Tensor, side: str, axis: int) -> torch.Tensor:
        return torch.flip(strip, dims=(axis,))

    return rule


def bc_mirror(sign: float = -1.0) -> BCRule:
    """Reflection BC: ghost = sign * mirrored interior (no-slip walls)."""

    def rule(strip: torch.Tensor, side: str, axis: int) -> torch.Tensor:
        return sign * torch.flip(strip, dims=(axis,))

    return rule


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """How one grid axis (``array_axis`` in 0..2) is bounded.

    ``mesh_axis`` names a decomposition axis; this slice runs undecomposed
    and rejects any spec that sets it.
    """

    array_axis: int
    mesh_axis: str | None = None
    periodic: bool = False
    bc_lo: BCRule | None = None
    bc_hi: BCRule | None = None


def _norm_width(w) -> tuple[int, int]:
    """Width spec: int (symmetric) or (lo, hi) one-sided ghost widths."""
    if isinstance(w, int):
        return (w, w)
    lo, hi = w
    return (int(lo), int(hi))


def _pad_axis(u: torch.Tensor, width, spec: AxisSpec) -> torch.Tensor:
    """Fill ghosts along one axis: periodic wrap or physical BCs."""
    if spec.mesh_axis is not None:
        raise NotImplementedError(
            f"axis {spec.array_axis} is decomposed over mesh axis "
            f"{spec.mesh_axis!r}; the port's halo exchange is single-process "
            "(ROADMAP queue 1, item 9: slots x shards over torch.distributed)")
    wlo, whi = _norm_width(width)
    if wlo == 0 and whi == 0:
        return u
    ax = tensor_axis(spec.array_axis)
    size = u.shape[ax]
    if size < max(wlo, whi):
        raise ValueError(
            f"local extent {size} on axis {spec.array_axis} smaller than "
            f"halo width {(wlo, whi)}"
        )

    def apply_bc(rule: BCRule | None, strip: torch.Tensor, side: str):
        if rule is None:
            return torch.zeros_like(strip)
        return rule(strip, side, ax)

    parts = [u]
    if wlo:
        if spec.periodic:
            ghost_lo = u.narrow(ax, size - wlo, wlo)
        else:
            ghost_lo = apply_bc(spec.bc_lo, u.narrow(ax, 0, wlo), "lo")
        parts.insert(0, ghost_lo)
    if whi:
        if spec.periodic:
            ghost_hi = u.narrow(ax, 0, whi)
        else:
            ghost_hi = apply_bc(spec.bc_hi, u.narrow(ax, size - whi, whi), "hi")
        parts.append(ghost_hi)
    return torch.cat(parts, dim=ax)


def exchange_pad(
    u: torch.Tensor, widths: Sequence, specs: Sequence[AxisSpec]
) -> torch.Tensor:
    """Materialize the ghost region: pad ``u`` by ``widths[i]`` along each spec.

    Each width is an int (symmetric) or a ``(lo, hi)`` pair for one-sided
    stencils.  Corner ghosts are produced correctly because later axes pad
    the already-padded earlier axes (the standard two-phase corner trick).
    """
    if len(widths) != len(specs):
        raise ValueError("widths and specs length mismatch")
    for w, spec in zip(widths, specs):
        u = _pad_axis(u, w, spec)
    return u


def stencil_step_overlap(
    u: torch.Tensor,
    widths: Sequence[int],
    specs: Sequence[AxisSpec],
    kernel: Callable[[torch.Tensor], torch.Tensor],
    kernel_deep: Callable[[torch.Tensor], torch.Tensor] | None = None,
    pad_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Apply ``kernel`` (padded -> interior) with the interior/shell split.

    The *deep interior* of the block needs no ghost data, so ``kernel(u)``
    has no dependency on the padding; only thin boundary *shells*
    (width = halo, per face) are computed from the padded array afterwards.

    ``kernel`` must take any shape (maps an array padded by ``widths`` to
    its interior); ``kernel_deep``, if given, is used for the large
    interior block while ``kernel`` handles the thin shells.

    Result equals ``kernel(exchange_pad(u, widths, specs))`` (tested).
    """
    if len(widths) != u.dim():
        raise ValueError("widths must cover every array axis (use 0 to skip)")
    ws = [_norm_width(w) for w in widths]
    # pad_fn lets callers pad packed multi-field arrays with per-field BC
    # rules (must produce ghosts matching `widths`)
    padded = pad_fn(u) if pad_fn is not None else exchange_pad(u, widths, specs)
    deep = (kernel_deep or kernel)(u)  # no ghost dependency

    # Assemble per axis, peeling lo/hi shells computed from the padded array.
    # Output rows [a, b) on an axis with ghosts (lo, hi) need padded rows
    # [a, b + lo + hi).
    def shell(axis: int, side: str, row_lo: list[int], row_hi: list[int]):
        """kernel() over the slab producing the (lo|hi) shell of `axis`."""
        lo, hi = ws[axis]
        sl = []
        for a, ((la, ha), na) in enumerate(zip(ws, u.shape)):
            if a < axis:
                sl.append(slice(row_lo[a], row_hi[a] + la + ha))
            elif a == axis:
                sl.append(slice(0, 2 * lo + hi) if side == "lo"
                          else slice(na - hi, na + lo + hi))
            else:
                sl.append(slice(None))  # full padded extent
        return kernel(padded[tuple(sl)].contiguous())

    # innermost: deep block; wrap outwards in reverse axis order
    out = deep
    row_lo = [lo for lo, _ in ws]
    row_hi = [n - hi for n, (_, hi) in zip(u.shape, ws)]
    for axis in reversed(range(len(ws))):
        lo, hi = ws[axis]
        if lo == 0 and hi == 0:
            continue
        pieces = []
        if lo:
            pieces.append(shell(axis, "lo", row_lo, row_hi))
        pieces.append(out)
        if hi:
            pieces.append(shell(axis, "hi", row_lo, row_hi))
        row_lo[axis] = 0
        row_hi[axis] = u.shape[axis]
        out = torch.cat(pieces, dim=axis) if len(pieces) > 1 else out
    return out
