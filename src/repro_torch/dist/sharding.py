"""Placement rules for slot-stacked grid fields on a mesh of ranks.

The port of the grid and slot rules of ``repro.dist.sharding``.  A
placement is a tuple with one entry per tensor axis: the name of the mesh
axis that axis is split over, or None where every rank holds the whole
extent — the reference's ``PartitionSpec``, entry by entry.  The rules and
their error texts are the reference's:

* a slot axis that does not divide over its mesh axis is *replicated*:
  slots never interact, so every rank of the axis holding every slot is
  correct, only not parallel;
* a grid axis that does not divide *raises*: the halo exchange shifts
  strips over the decomposition's mesh axes as if they held true blocks,
  so a silently replicated grid axis would be mis-sharded, not a layout.

A mesh here is a ``DeviceMesh`` or any object with the reference mesh's
``axis_names`` and ``shape`` mapping (:func:`repro_torch.launch.mesh.mesh_extents`).
The LM spec trees come with the sharded LM (ROADMAP queue 1, item 9b).
"""
from __future__ import annotations

import math

from repro_torch.launch.mesh import mesh_extents


def _axes_prod(mesh, axes) -> int:
    if axes is None:
        return 1
    ext = mesh_extents(mesh)
    if isinstance(axes, str):
        return ext[axes]
    return math.prod(ext[a] for a in axes)


def _guard(mesh, axis, dim: int):
    """``axis`` iff ``dim`` divides evenly over it (else replicated)."""
    if axis is None:
        return None
    if dim % _axes_prod(mesh, axis) != 0:
        return None
    return axis


def slot_spec(mesh, n_slots: int, axis: str = "data") -> tuple:
    """Placement of a leading ensemble *slot* axis over a data-parallel
    mesh axis (each rank of the axis advances ``n_slots / |axis|``
    resident simulations); a slot count that does not divide stays
    replicated."""
    names = tuple(mesh_extents(mesh))
    if axis not in names:
        raise ValueError(f"mesh {names} has no axis {axis!r}")
    return (_guard(mesh, axis, n_slots),)


def validate_decomposition(decomposition, n_axes: int, mesh_axis_names,
                           slot_axis: str | None = None) -> tuple:
    """Normalize + validate a grid decomposition: returns the
    ``((array_axis, mesh_axis), ...)`` pairs, raising on a duplicate array
    axis, an out-of-range array axis, an unknown mesh axis, or a grid axis
    decomposing over the slot axis."""
    pairs = tuple(decomposition.items() if isinstance(decomposition, dict)
                  else decomposition)
    if len({a for a, _ in pairs}) != len(pairs):
        raise ValueError(
            f"decomposition {pairs!r} maps some array axis more than "
            "once; each grid axis decomposes over at most one mesh axis")
    for a, name in pairs:
        if not 0 <= int(a) < n_axes:
            raise ValueError(
                f"decomposition names array axis {a}, but fields have "
                f"only {n_axes} grid axes")
        if name not in mesh_axis_names:
            raise ValueError(
                f"mesh {tuple(mesh_axis_names)} has no axis {name!r} "
                f"(decomposition of array axis {a})")
        if slot_axis is not None and name == slot_axis:
            raise ValueError(
                f"axis {name!r} is the slot axis; a grid axis cannot "
                "decompose over it")
    return pairs


def slot_field_spec(mesh, n_slots: int, shape: tuple, decomposition=(),
                    slot_axis: str = "slot") -> tuple:
    """Placement of a slot-stacked grid field ``(n_slots, *shape)`` on a
    slots × shards mesh: ``(slot_axis or None, <grid axes>)``, the slot
    axis guarded, the grid axes raising when they do not divide."""
    ext = mesh_extents(mesh)
    names = tuple(ext)
    if slot_axis not in names:
        raise ValueError(f"mesh {names} has no slot axis {slot_axis!r}")
    pairs = validate_decomposition(decomposition, len(shape), names,
                                   slot_axis=slot_axis)
    grid: list = [None] * len(shape)
    for a, name in pairs:
        a = int(a)
        if shape[a] % ext[name]:
            raise ValueError(
                f"grid extent {shape[a]} on array axis {a} is not "
                f"divisible by mesh axis {name!r} (size "
                f"{ext[name]}) — refusing to mis-shard")
        grid[a] = name
    return (_guard(mesh, slot_axis, n_slots), *grid)
