"""The ghosted stencils' ghost zone, on the CPU.

JACOBI_PRESSURE and UPDATE_VELOCITY take their fields unpadded on the CUDA
template and make their ghost values themselves from each face's declared form
or the strip its neighbour sent.  Here: every rule's form gives the rule's
bits; the plain versions on unpadded fields equal the port's pad-then-body
bitwise and the reference's pad-then-template within the stencil parity
tolerance of ``tests/test_torch_kernels.py``; a field cut along x (then y)
with strips equals the whole field's result bitwise; the strips
``exchange_strips`` posts equal ``exchange_pad``'s ghost slabs; and the
step on the CUDA template pads nothing for these two kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from tests import torch_ghost_cases as gc
from tests.test_torch_harness import seeded  # installs the shim

import jax.numpy as jnp
from repro.cfd import ns3d as ref_ns3d
from repro.core import generator as ref_generator
from repro.core import halo as ref_halo
from repro.kernels import stencil3d as ref_stencil3d

from repro_torch.cfd import cavity
from repro_torch.cfd.ns3d import PARAM_KEYS, NavierStokes3D, bc_moving_wall
from repro_torch.core import generator, halo
from repro_torch.kernels import ops, stencil3d, stencil3d_cuda
from repro_torch.launch import op_cost

# the stencil parity tolerance of tests/test_torch_kernels.py (about 1 ulp)
RTOL, ATOL = 2e-7, 1e-7
SERIAL_CASES = ("cavity", "pressure", "mixed", "periodic")
SLOTS = (None, 1, 2, 4)
INTERIOR = (5, 7, 6)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _form_value(form: halo.GhostForm, m: np.ndarray) -> np.ndarray:
    """The form evaluated independently in numpy float32, each term
    rounded once."""
    f32 = np.float32
    b = np.asarray(form.b.cpu() if torch.is_tensor(form.b) else form.b, f32)
    if form.kind == "const":
        return np.broadcast_to(b, m.shape).astype(f32)
    if form.kind == "linear":
        return (f32(form.a) * m).astype(f32)
    return ((f32(form.a) * m).astype(f32) + b).astype(f32)


RULES = {
    "dirichlet": lambda: halo.bc_dirichlet(2.5),
    "dirichlet0": lambda: halo.bc_dirichlet(0.0),
    "none": lambda: None,
    "neumann": halo.bc_neumann,
    "mirror": lambda: halo.bc_mirror(-1.0),
    "mirror_half": lambda: halo.bc_mirror(0.5),
    "wall_float": lambda: bc_moving_wall(0.7),
    "wall_still": lambda: bc_moving_wall(0.0),
    "wall_0d": lambda: bc_moving_wall(torch.tensor(0.3)),
    "wall_per_slot": lambda: bc_moving_wall(
        torch.tensor([0.5, -1.25, 3.0]).reshape(-1, 1, 1, 1)),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_declared_forms_give_the_rules_bits(rule):
    """On random strips (signed zeros among them), each face of each axis,
    widths 1 and 2: the rule's call equals its form bit for bit."""
    r = RULES[rule]()
    form = halo.form_of(r)
    assert isinstance(form, halo.GhostForm)
    u = seeded((3, 5, 4, 6), 7)
    u[0, 0, 0, :2] = (0.0, -0.0)
    t = torch.from_numpy(u)
    for axis in (-3, -2, -1):
        for width in (1, 2):
            for side in ("lo", "hi"):
                strip = t.narrow(axis, 0 if side == "lo" else
                                 t.shape[axis] - width, width)
                got = (torch.zeros_like(strip) if r is None
                       else r(strip, side, axis)).numpy()
                want = _form_value(form, np.flip(strip.numpy(), axis))
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got.view(np.uint32),
                                              want.view(np.uint32))


def test_a_closure_declares_no_form_and_takes_the_padded_route():
    """A caller's own rule has no form: the CUDA template's inputs stay
    padded (with the strips in hand), and the choice is counted."""
    def own(strip, side, axis):
        return 3.0 * torch.flip(strip, dims=(axis,))

    specs = (halo.AxisSpec(0, bc_lo=own, bc_hi=halo.bc_neumann()),
             halo.AxisSpec(1, periodic=True), halo.AxisSpec(2, periodic=True))
    assert halo.form_of(own) is None and halo.field_ghosts(specs) is None
    stencil3d_cuda.reset_launches()
    p = torch.from_numpy(seeded((4, 5, 6), 3))
    (pp,), ghosts = ops.ghosted_inputs("JACOBI_PRESSURE", (p,), [specs])
    assert ghosts is None and stencil3d_cuda.PADDED_ROUTE == {
        "UPDATE_VELOCITY": 0, "JACOBI_PRESSURE": 1}
    assert torch.equal(pp, halo.exchange_pad(p, (1, 1, 1), specs))


def _kernel_args(name, case, slots, seed=0, interior=INTERIOR):
    xs, table, ghosts, specs, strips = gc.inputs(name, case, slots, interior,
                                                 "cpu", seed)
    return xs, table, ghosts, specs, strips


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", SERIAL_CASES)
@pytest.mark.parametrize("name", gc.GHOSTED)
def test_plain_on_unpadded_fields_equals_pad_then_body(name, case, slots):
    """The new plain version (and the CUDA template's wrapper, which runs
    it on the CPU) equals exchange_pad plus the padded plain body."""
    xs, table, ghosts, specs, _ = _kernel_args(name, case, slots)
    desc = stencil3d.DESCRIPTORS[name]
    it = iter(specs)
    padded = [halo.exchange_pad(t, (1, 1, 1), next(it))
              if v in desc.cached_inputs else t
              for v, t in zip(desc.inputs, xs)]
    want = _tuple(stencil3d_cuda.PLAIN[name](*padded, table))
    for fn in (stencil3d_cuda.PLAIN[name], stencil3d_cuda.KERNELS[name]):
        got = _tuple(fn(*xs, table, ghosts=ghosts))
        for g, w in zip(got, want):
            assert g.shape == w.shape == (*(() if slots is None else (slots,)),
                                          *INTERIOR)
            assert torch.equal(g, w)


def _ref_specs(case, m, lid):
    """The reference's rules of ``case`` (tests/torch_ghost_cases.py)."""
    S = ref_halo.AxisSpec
    if case == "periodic":
        return [S(array_axis=a, periodic=True) for a in range(3)]
    if case == "pressure":
        n = ref_halo.bc_neumann()
        return [S(0, bc_lo=n, bc_hi=n), S(1, bc_lo=n, bc_hi=n),
                S(2, periodic=True)]
    if case == "cavity":
        zero, noslip = ref_halo.bc_dirichlet(0.0), ref_ns3d.bc_moving_wall(0.0)
        lo, hi = [((zero, noslip), (zero, ref_ns3d.bc_moving_wall(lid))),
                  ((noslip, zero), (noslip, zero)),
                  ((noslip, noslip), (noslip, noslip))][m]
        return [S(0, bc_lo=lo[0], bc_hi=hi[0]), S(1, bc_lo=lo[1], bc_hi=hi[1]),
                S(2, periodic=True)]
    rules = [ref_halo.bc_mirror(0.5), ref_halo.bc_dirichlet(2.5), None,
             ref_ns3d.bc_moving_wall(0.7), ref_halo.bc_neumann(),
             ref_halo.bc_mirror(-1.0), ref_ns3d.bc_moving_wall(lid)]
    r = rules[m:] + rules[:m]
    return [S(0, bc_lo=r[0], bc_hi=r[1]), S(1, bc_lo=r[2], bc_hi=r[6]),
            S(2, bc_lo=r[4], bc_hi=r[5])]


PARAMS = dict(dt=0.01, h=0.1, nu=0.05, fx=0.1, fy=-0.2, fz=0.3, omega=0.8)


@pytest.mark.parametrize("slots", (None, 2))
@pytest.mark.parametrize("case", SERIAL_CASES)
@pytest.mark.parametrize("name", gc.GHOSTED)
def test_plain_on_unpadded_fields_matches_the_reference(name, case, slots):
    """The same seeded numpy inputs through the reference's exchange_pad
    and its JNP template, within RTOL/ATOL."""
    xs, _, ghosts, _, _ = _kernel_args(name, case, slots, seed=4)
    desc = stencil3d.DESCRIPTORS[name]
    params = {k: PARAMS[k] for k in desc.parameters}
    table = generator.param_table(desc, params, slots, "cpu",
                                  columns=stencil3d.TABLES[name])
    table = table if slots else table[0]
    got = _tuple(stencil3d_cuda.PLAIN[name](*xs, table, ghosts=ghosts))

    # the reference pads one grid at a time (its farm vmaps the step)
    lid = gc.lid_for(slots, "cpu").numpy().reshape(-1)
    m = 0
    arrays = {}
    for v, t in zip(desc.inputs, xs):
        a = t.numpy()
        if v in desc.cached_inputs:
            grids = [a] if slots is None else list(a)
            a = np.stack([np.asarray(ref_halo.exchange_pad(
                jnp.asarray(g), (1, 1, 1),
                _ref_specs(case, m, jnp.float32(lid[s]))))
                for s, g in enumerate(grids)])
            a = a[0] if slots is None else a
            m += 1
        arrays[v] = jnp.asarray(a)
    kern = ref_generator.generate(ref_stencil3d.DESCRIPTORS[name],
                                  ref_stencil3d.BODIES[name], template="JNP")
    out = (kern(arrays, **params) if slots is None
           else kern.apply_batched(arrays, **params))
    for g, k in zip(got, desc.outputs):
        np.testing.assert_allclose(g.numpy(), np.asarray(out[k]),
                                   rtol=RTOL, atol=ATOL)


def _cut_specs(whole, cuts):
    """The specs of one block: each cut axis decomposed on a virtual link
    (``cuts[a] = (index, size)``), its edge faces keeping the whole
    field's rules."""
    out = []
    for a, spec in enumerate(whole):
        if a in cuts:
            idx, size = cuts[a]
            spec = dataclasses.replace(
                spec, mesh_axis="shard",
                link=halo.AxisLink(name="shard", size=size, index=idx,
                                   transport=halo.CountTransport()))
        out.append(spec)
    return tuple(out)


def _block_strips(u, whole, bounds):
    """The strips a block receives, sliced from the whole field padded on
    the axes before each cut axis: ``bounds[a] = (start, stop)`` on the
    cut axes; a face on the grid's edge receives none."""
    lead = u.dim() - 3
    strips, padded = [], u
    for a in range(3):
        ax = lead + a
        if a not in bounds:
            strips.append((None, None))
        else:
            lo, hi = bounds[a]
            n = u.shape[ax]
            sl = []
            for b in range(3):
                if b < a:
                    start, stop = bounds.get(b, (0, u.shape[lead + b]))
                    sl.append(slice(start, stop + 2))   # with the ghosts
                elif b == a:
                    sl.append(None)
                else:
                    start, stop = bounds.get(b, (0, u.shape[lead + b]))
                    sl.append(slice(start, stop))

            def take(plane):
                idx = [slice(None)] * lead + [
                    s if s is not None else slice(plane, plane + 1)
                    for s in sl]
                return padded[tuple(idx)].contiguous()

            # the neighbours' edge planes: the cell before the block and
            # the cell after it (axis a is not padded yet)
            strips.append((take(lo - 1) if lo > 0 else None,
                           take(hi) if hi < n else None))
        # later axes' strips come from the field padded on this axis too
        padded = halo.exchange_pad(padded, [1 if b == a else 0
                                            for b in range(3)], whole)
    return tuple(strips)


@pytest.mark.parametrize("slots", (None, 2))
@pytest.mark.parametrize("cut", ("x", "xy"))
@pytest.mark.parametrize("name", gc.GHOSTED)
def test_a_cut_field_with_strips_equals_the_whole_bitwise(name, cut, slots):
    """The whole field cut in two along x (and then in two along y), each
    block given its neighbours' strips (those of y with the x ghost ends):
    every block's result is the whole field's on that block, bitwise."""
    interior = (6, 8, 5)
    xs, table, _, specs, _ = _kernel_args(name, "cavity", slots, seed=9,
                                          interior=interior)
    desc = stencil3d.DESCRIPTORS[name]
    whole_g = [halo.field_ghosts(sp) for sp in specs]
    want = _tuple(stencil3d_cuda.PLAIN[name](
        *xs, table, ghosts=whole_g if len(whole_g) > 1 else whole_g[0]))
    lead = 0 if slots is None else 1
    splits = {0: [(0, 3), (3, 6)]}
    if cut == "xy":
        splits[1] = [(0, 4), (4, 8)]
    blocks = [{}]
    for a, parts in splits.items():
        blocks = [{**b, a: (i, part)} for b in blocks
                  for i, part in enumerate(parts)]
    for block in blocks:
        bounds = {a: part for a, (_, part) in block.items()}
        cuts = {a: (i, len(splits[a])) for a, (i, _) in block.items()}
        sl = tuple([slice(None)] * lead + [
            slice(*bounds.get(a, (0, interior[a]))) for a in range(3)])
        ins, gs = [], []
        it = iter(specs)
        for v, t in zip(desc.inputs, xs):
            ins.append(t[sl].contiguous())
            if v in desc.cached_inputs:
                whole = next(it)
                strips = _block_strips(t, whole, bounds)
                g = halo.field_ghosts(_cut_specs(whole, cuts), strips)
                assert sum(torch.is_tensor(f) for f in g.faces) == \
                    sum(s is not None for pair in strips for s in pair) > 0
                gs.append(g)
        got = _tuple(stencil3d_cuda.PLAIN[name](
            *ins, table, ghosts=gs if len(gs) > 1 else gs[0]))
        for g, w in zip(got, want):
            assert torch.equal(g, w[sl]), block


class EchoTransport(halo.Transport):
    """One rank on a periodic mesh axis of size 1: every strip it sends
    comes back to it from the other side (the exchange of a rank with
    itself), booked as any transport books."""

    def start(self, link, periodic, to_hi, to_lo):
        self._book(link, periodic, to_hi, to_lo)
        got = (None if to_hi is None else to_hi.clone(),
               None if to_lo is None else to_lo.clone())
        return lambda: got

    def all_gather(self, link, t):
        return t[None]

    def all_reduce(self, link, t, op):
        return t


def _echo(spec, transport):
    link = halo.AxisLink(name="shard", size=1, index=0, transport=transport)
    return dataclasses.replace(spec, mesh_axis="shard", periodic=True,
                               link=link)


@pytest.mark.parametrize("decomposed", ((0,), (1,), (0, 1), (1, 2), (0, 2)))
@pytest.mark.parametrize("field", ("p", "vx", "vy", "vz"))
def test_exchange_strips_equal_exchange_pads_ghost_slabs(field, decomposed):
    """For the pressure's and each velocity component's specs, with some
    axes decomposed (a rank that exchanges with itself): the strips
    exchange_strips receives equal exchange_pad's ghost slabs, their ghost
    ends included, and both book the same bytes."""
    solver = NavierStokes3D(cavity.config(6, nz=5), "cpu")
    lid = torch.tensor([0.5, 1.5]).reshape(-1, 1, 1, 1)
    base = solver.driver.axis_specs(*solver._bcs_for(lid)[field])
    u = torch.from_numpy(seeded((2, 6, 7, 5), 13))
    t_pad, t_strips = EchoTransport(), EchoTransport()
    pad_specs = [_echo(s, t_pad) if a in decomposed else s
                 for a, s in enumerate(base)]
    strip_specs = [_echo(s, t_strips) if a in decomposed else s
                   for a, s in enumerate(base)]
    padded = halo.exchange_pad(u, (1, 1, 1), pad_specs)
    strips = halo.exchange_strips(u, (1, 1, 1), strip_specs)
    for a in range(3):
        ax = a - 3
        if a not in decomposed:
            assert strips[a] == (None, None)
            continue
        # the slab of the array padded on axes <= a, as exchange_pad left it
        want = padded
        for b in range(a + 1, 3):
            want = want.narrow(b - 3, 1, want.shape[b - 3] - 2)
        lo, hi = strips[a]
        assert torch.equal(lo, want.narrow(ax, 0, 1))
        assert torch.equal(hi, want.narrow(ax, want.shape[ax] - 1, 1))
    assert (t_strips.permute_operand_bytes, t_strips.sent_bytes) == \
        (t_pad.permute_operand_bytes, t_pad.sent_bytes) != (0, 0)
    # and the plain version on them equals the padded body
    g = halo.field_ghosts(strip_specs, strips)
    assert torch.equal(halo.pad_with_strips(u, (1, 1, 1), strip_specs, strips),
                       padded)
    assert sum(torch.is_tensor(f) for f in g.faces) == 2 * len(decomposed)


def _run(template, n_slots=None, steps=3):
    cfg = dataclasses.replace(cavity.config(8, nz=6, re=100.0),
                              template=template, overlap=False,
                              jacobi_iters=6)
    solver = NavierStokes3D(cfg, "cpu")
    state = solver.init_state()
    step = solver.make_step()
    for _ in range(steps):
        state = step(state)
    return state


def test_cuda_template_step_equals_the_torch_template_bitwise():
    """On the CPU the CUDA template's ghosted route (plain versions on
    unpadded fields) gives the TORCH template's pad-then-body bits."""
    stencil3d_cuda.reset_launches()
    a, b = _run("CUDA"), _run("TORCH")
    for f in ("vx", "vy", "vz", "p"):
        assert torch.equal(a[f], b[f]), f
    assert stencil3d_cuda.PADDED_ROUTE == {"UPDATE_VELOCITY": 0,
                                           "JACOBI_PRESSURE": 0}


def test_a_meta_trace_of_the_step_pads_nothing_for_the_streaming_kernels():
    """The cost trace books the ghosted kernels' unpadded fields and face
    tables, and no pad: the step's only concatenations are the
    divergence's three and the projection's pads (three axes each) and
    the tables stacked from device scalars."""
    n, iters = 8, 6
    cfg = dataclasses.replace(cavity.config(n, nz=n), overlap=False,
                              jacobi_iters=iters)
    solver = NavierStokes3D(cfg, "cpu").cost_twin()
    state = {f: torch.empty((n,) * 3, device="meta")
             for f in (*NavierStokes3D.FIELDS, "mask_vx", "mask_vy",
                       "mask_vz")}
    params = {k: torch.empty((), device="meta") for k in PARAM_KEYS}
    counter = op_cost.count(lambda s: solver._step_local(s, params), state)
    cells = n ** 3
    uv = counter.classes["UPDATE_VELOCITY"]
    assert uv["calls"] == 1
    assert uv["bytes"] == 4 * (6 * cells + 7 + 18)
    jp = counter.classes["JACOBI_PRESSURE"]
    assert jp["calls"] == iters
    assert jp["bytes"] == iters * 4 * (3 * cells + 3 + 6)
    assert counter.classes["cat"]["calls"] == 3 * (3 + 1) + 3


@pytest.mark.parametrize("slots", (None, 2))
@pytest.mark.parametrize("case", ("cavity", "mixed", "strips_xy"))
@pytest.mark.parametrize("name", gc.GHOSTED)
def test_bound_ghosts_give_the_per_launch_faces_bits(name, case, slots):
    """Faces bound once (stencil3d_cuda.bind_ghosts), as the Jacobi sweeps
    of a step share them, give what the same faces give launch by launch,
    however often they are used."""
    xs, table, ghosts, _, _ = _kernel_args(name, case, slots, seed=6)
    want = _tuple(stencil3d_cuda.KERNELS[name](*xs, table, ghosts=ghosts))
    bound = stencil3d_cuda.bind_ghosts(name, ghosts, xs[0])
    assert bound.shape == (slots or 1, *INTERIOR) and bound.struct is None
    for _ in range(2):
        got = _tuple(stencil3d_cuda.KERNELS[name](*xs, table, ghosts=bound))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_bound_ghosts_refuse_another_kernel_or_shape():
    xs, table, ghosts, _, _ = _kernel_args("JACOBI_PRESSURE", "pressure", 2)
    bound = stencil3d_cuda.bind_ghosts("JACOBI_PRESSURE", ghosts, xs[0])
    with pytest.raises(ValueError, match="bound for"):
        stencil3d_cuda.jacobi_pressure(xs[0][:1], xs[1][:1], table[:1],
                                       ghosts=bound)
    vs, vtable, _, _, _ = _kernel_args("UPDATE_VELOCITY", "cavity", 2)
    with pytest.raises(ValueError, match="bound for"):
        stencil3d_cuda.update_velocity(*vs, vtable, ghosts=bound)


def test_faces_are_bound_only_where_no_strip_travels():
    """ops.bound_ghosts binds a field's faces where no axis is decomposed,
    and leaves a decomposed field, or a rule without a form, to each
    launch (ghosted_inputs)."""
    p = torch.from_numpy(seeded((4, 5, 6), 7))
    specs = gc.CASES["pressure"](0, gc.lid_for(None, "cpu"))
    bound = ops.bound_ghosts("JACOBI_PRESSURE", (p,), [specs])
    assert isinstance(bound, stencil3d_cuda.BoundGhosts)
    assert bound.ghosts[0].faces == halo.field_ghosts(specs).faces
    cut = gc.CASES["strips_x"](0, gc.lid_for(None, "cpu"))
    assert any(s.mesh_axis is not None for s in cut)
    assert ops.bound_ghosts("JACOBI_PRESSURE", (p,), [cut]) is None

    def own(strip, side, axis):
        return torch.flip(strip, dims=(axis,))

    formless = (halo.AxisSpec(0, bc_lo=own, bc_hi=halo.bc_neumann()),
                *specs[1:])
    assert ops.bound_ghosts("JACOBI_PRESSURE", (p,), [formless]) is None


def test_the_step_binds_p_faces_once_for_all_its_sweeps(monkeypatch):
    """A serial step on the CUDA template (its meta twin) binds p's faces
    once and hands the same binding to every Jacobi sweep."""
    seen = []
    real = stencil3d_cuda._run

    def spy(name, inputs, table, plain=False, tile=None, ghosts=None):
        if name == "JACOBI_PRESSURE":
            seen.append(ghosts)
        return real(name, inputs, table, plain=plain, tile=tile,
                    ghosts=ghosts)

    monkeypatch.setattr(stencil3d_cuda, "_run", spy)
    n, iters = 8, 5
    cfg = dataclasses.replace(cavity.config(n, nz=n), overlap=False,
                              jacobi_iters=iters)
    solver = NavierStokes3D(cfg, "cpu").cost_twin()
    state = {f: torch.empty((n,) * 3, device="meta")
             for f in (*NavierStokes3D.FIELDS, "mask_vx", "mask_vy",
                       "mask_vz")}
    params = {k: torch.empty((), device="meta") for k in PARAM_KEYS}
    op_cost.count(lambda s: solver._step_local(s, params), state)
    # (the count traces the step more than once: each trace binds anew)
    assert seen and len(seen) % iters == 0
    for step in range(len(seen) // iters):
        sweeps = seen[step * iters:(step + 1) * iters]
        assert isinstance(sweeps[0], stencil3d_cuda.BoundGhosts)
        assert all(g is sweeps[0] for g in sweeps)


# the benchmark's cells: (slots, n), one n^3 run or a slot batch
BENCH_CELLS = {"cavity512.solve": (None, 512), "sweep256.members": (8, 256)}


@pytest.mark.parametrize("cell", list(BENCH_CELLS))
def test_every_jacobi_launch_of_a_benchmark_cell_is_ghosted(monkeypatch, cell):
    """At a benchmark cell's shape every JACOBI_PRESSURE launch of a step
    takes the ghosted load, whose one body (the march beside its face
    blocks) sets its own launch: the step's meta twin hands each of its 40
    sweeps p's bound faces and no tile, asking the autotuner for none, and
    each launch through the wrapper, with the library's entry point
    recorded in place of the card's, passes the faces and counts in
    LAUNCHES and GHOSTED_LAUNCHES."""
    import contextlib
    import types

    from repro_torch.core import autotune

    slots, n = BENCH_CELLS[cell]
    seen = []
    real = stencil3d_cuda._run

    def spy(name, inputs, table, plain=False, tile=None, ghosts=None):
        if name == "JACOBI_PRESSURE":
            seen.append((tile, ghosts))
        return real(name, inputs, table, plain=plain, tile=tile,
                    ghosts=ghosts)

    monkeypatch.setattr(stencil3d_cuda, "_run", spy)
    cfg = dataclasses.replace(cavity.config(n, nz=n), overlap=False)
    solver = NavierStokes3D(cfg, "cpu").cost_twin()
    lead = () if slots is None else (slots,)
    state = {f: torch.empty(lead + (n,) * 3, device="meta")
             for f in (*NavierStokes3D.FIELDS, "mask_vx", "mask_vy",
                       "mask_vz")}
    params = {k: torch.empty(lead, device="meta") for k in PARAM_KEYS}
    autotune.reset_tile_cache()
    op_cost.count(lambda s: solver._step_local(s, params), state)
    assert not any(key[0] == "JACOBI_PRESSURE" for key in autotune._TILE_CACHE)
    sweeps = seen[-cfg.jacobi_iters:]
    assert len(sweeps) == cfg.jacobi_iters == 40

    entry = []

    class Library:
        def stencil3d_jacobi_pressure(self, *args):
            entry.append(args)
            return 0

    monkeypatch.setattr(stencil3d_cuda, "_lib", Library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    stencil3d_cuda.reset_launches()
    for tile, bound in sweeps:
        assert tile is None and isinstance(bound, stencil3d_cuda.BoundGhosts)
        assert bound.shape == ((slots or 1),) + (n,) * 3
        card = dataclasses.replace(
            bound, struct=stencil3d_cuda._ghost_struct(bound.ghosts))
        p = torch.empty(bound.shape, device="meta")
        table = torch.empty((bound.shape[0], 3), device="meta")
        stencil3d_cuda._launch("JACOBI_PRESSURE", [p, p], (p,), table,
                               stencil3d_cuda.block_for(n, n), card)
        assert entry[-1][4] == ctypes.addressof(card.struct)
        assert entry[-1][6:10] == bound.shape
    assert stencil3d_cuda.LAUNCHES["JACOBI_PRESSURE"] == 40
    assert stencil3d_cuda.GHOSTED_LAUNCHES["JACOBI_PRESSURE"] == 40
    assert not any(stencil3d_cuda.PADDED_ROUTE.values())
