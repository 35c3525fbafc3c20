"""Ghost-zone cases of the ghosted stencils (JACOBI_PRESSURE and
UPDATE_VELOCITY), shared by the CPU tests and the card's.

Each case gives a field's three :class:`~repro_torch.core.halo.AxisSpec`
by the field's index (p is field 0; vx, vy, vz are 0, 1, 2) and its lid:
every kind of face (a constant, zeros, a linear and an affine rule, the
periodic wrap, a received strip) appears in some case.  A decomposed axis
sits on a virtual link (no process), with the neighbours its index gives
it; its strips are random, so a case needs no exchange.  This module
imports neither ``jax`` nor the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.cfd.ns3d import bc_moving_wall
from repro_torch.core import halo
from repro_torch.kernels import stencil3d

GHOSTED = ("JACOBI_PRESSURE", "UPDATE_VELOCITY")


def _link(index: int, size: int) -> halo.AxisLink:
    return halo.AxisLink(name="shard", size=size, index=index,
                         transport=halo.CountTransport())


def _spec(axis, lo=None, hi=None, periodic=False, link=None):
    return halo.AxisSpec(array_axis=axis,
                         mesh_axis=None if link is None else "shard",
                         periodic=periodic, bc_lo=lo, bc_hi=hi, link=link)


def _cavity(m, lid):
    """The cavity's rules (``NavierStokes3D._bcs_for``): field m of the
    velocity, the lid on vx's y-hi face; z periodic."""
    zero, noslip = halo.bc_dirichlet(0.0), bc_moving_wall(0.0)
    lo, hi = [((zero, noslip), (zero, bc_moving_wall(lid))),
              ((noslip, zero), (noslip, zero)),
              ((noslip, noslip), (noslip, noslip))][m]
    return (_spec(0, lo[0], hi[0]), _spec(1, lo[1], hi[1]),
            _spec(2, periodic=True))


def _pressure(m, lid):
    neum = halo.bc_neumann()
    return (_spec(0, neum, neum), _spec(1, neum, neum),
            _spec(2, periodic=True))


def _mixed(m, lid):
    """Every rule kind on one field, a different one on each face."""
    rules = [halo.bc_mirror(0.5), halo.bc_dirichlet(2.5), None,
             bc_moving_wall(0.7), halo.bc_neumann(), halo.bc_mirror(-1.0),
             bc_moving_wall(lid)]
    r = rules[m:] + rules[:m]
    return (_spec(0, r[0], r[1]), _spec(1, r[2], r[6]), _spec(2, r[4], r[5]))


def _periodic(m, lid):
    return tuple(_spec(a, periodic=True) for a in range(3))


def _strips_x(m, lid):
    """x decomposed (a middle rank: both faces strips)."""
    return (_spec(0, link=_link(1, 3)),) + _cavity(m, lid)[1:]


def _strips_x_edge(m, lid):
    """x decomposed, the first of two ranks: its x-lo face by rule."""
    cav = _cavity(m, lid)
    return (_spec(0, cav[0].bc_lo, cav[0].bc_hi, link=_link(0, 2)),) + cav[1:]


def _strips_xy(m, lid):
    """x and y decomposed: the y strips carry the x ghost ends; z rules."""
    return (_spec(0, link=_link(1, 3)), _spec(1, link=_link(2, 4), periodic=True),
            _spec(2, halo.bc_neumann(), bc_moving_wall(lid)))


def _strips_yz(m, lid):
    """y and z decomposed after an x axis of rules: the strips carry the
    x rules' ghost ends."""
    return (_spec(0, halo.bc_mirror(-1.0), bc_moving_wall(lid)),
            _spec(1, link=_link(1, 2), periodic=True),
            _spec(2, link=_link(0, 1), periodic=True))


CASES = {"cavity": _cavity, "pressure": _pressure, "mixed": _mixed,
         "periodic": _periodic, "strips_x": _strips_x,
         "strips_x_edge": _strips_x_edge, "strips_xy": _strips_xy,
         "strips_yz": _strips_yz}


def strip_shape(lead, interior, axis: int) -> tuple:
    """The strip of ``axis`` at width 1: padded on the axes before it."""
    return (*lead, *(n + 2 for n in interior[:axis]), 1, *interior[axis + 1:])


def lid_for(slots, dev) -> torch.Tensor:
    """The lid speed as the step passes it: 0-d, or one a slot."""
    if slots is None:
        return torch.tensor(0.8, device=dev)
    return (0.5 + 0.25 * torch.arange(slots, dtype=torch.float32,
                                      device=dev)).reshape(-1, 1, 1, 1)


def case_ghosts(case: str, m: int, slots, interior, dev, rng):
    """(specs, strips, FieldGhosts) of field ``m`` in ``case``: random
    strips on the decomposed faces that have a neighbour."""
    lead = () if slots is None else (slots,)
    specs = CASES[case](m, lid_for(slots, dev))
    strips = []
    for a, spec in enumerate(specs):
        pair = []
        for step in (-1, +1):
            if spec.link is not None and spec.link.peer(step, spec.periodic) \
                    is not None:
                pair.append(torch.from_numpy(rng.randn(
                    *strip_shape(lead, interior, a)).astype(np.float32)
                ).to(dev))
            else:
                pair.append(None)
        strips.append(tuple(pair))
    return specs, tuple(strips), halo.field_ghosts(specs, strips)


def table_for(name: str, slots, dev) -> torch.Tensor:
    rows = [[0.01 * (s + 1), 0.1, 0.05, 0.1 * s, -0.2, 0.3, 0.9]
            [:len(stencil3d.TABLES[name])] for s in range(slots or 1)]
    table = torch.tensor(rows, dtype=torch.float32, device=dev)
    return table if slots else table[0]


def inputs(name: str, case: str, slots, interior, dev, seed: int = 0):
    """(unpadded inputs, table, ghosts, specs, strips) of a GHOSTED
    kernel: its cached fields unpadded and random, the rest (rhs) too."""
    rng = np.random.RandomState(seed)
    lead = () if slots is None else (slots,)
    desc = stencil3d.DESCRIPTORS[name]
    xs = [torch.from_numpy(rng.randn(*lead, *interior).astype(np.float32))
          .to(dev) for _ in desc.inputs]
    n = len(desc.cached_inputs)
    made = [case_ghosts(case, m, slots, interior, dev, rng) for m in range(n)]
    ghosts = [g for _, _, g in made]
    return (xs, table_for(name, slots, dev),
            ghosts[0] if n == 1 else ghosts,
            [sp for sp, _, _ in made], [st for _, st, _ in made])
