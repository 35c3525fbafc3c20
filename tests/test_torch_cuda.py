"""Tests of the hand-written CUDA kernels; they need the card.

Each carries the ``cuda`` marker and skips inside the ``card`` fixture on a
host without a CUDA device, so every worker collects the same tests.  This
file imports neither ``jax`` nor the reference, so it runs on a machine
that has only the port's dependencies:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import autotune
from repro_torch.kernels import (
    attention_cuda, jacobi_cuda, ssd_cuda, stencil3d, stencil3d_cuda,
)
from repro_torch.kernels.ref import MaskSpec

# max|kernel - plain| <= 1e-5 * max(1, max|plain|): the same float32
# expression (the stencils, rounded as written, are also held bitwise)
RTOL = 1e-5
SHAPES = {"cube": (None, (16, 16, 16)), "odd": (None, (5, 7, 3)),
          "batched": (3, (9, 6, 33))}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(name, slots, interior, dev, seed=0):
    desc = stencil3d.DESCRIPTORS[name]
    rng = np.random.RandomState(seed)
    lead = () if slots is None else (slots,)
    xs = []
    for var in desc.inputs:
        cached = var in desc.cached_inputs
        shape = tuple(n + ((lo + hi) if cached else 0) for n, lo, hi in
                      zip(interior, desc.halo_lo, desc.halo_hi))
        xs.append(torch.from_numpy(rng.randn(*lead, *shape).astype(np.float32)).to(dev))
    rows = [[0.01 * (s + 1), 0.1, 0.05, 0.1 * s, -0.2, 0.3, 0.9]
            [:len(stencil3d.TABLES[name])] for s in range(slots or 1)]
    table = torch.tensor(rows, dtype=torch.float32, device=dev)
    return xs, table if slots else table[0]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(stencil3d.DESCRIPTORS))
def test_kernel_matches_plain_version(card, name, shape):
    slots, interior = SHAPES[shape]
    xs, table = _inputs(name, slots, interior, card)
    before = stencil3d_cuda.LAUNCHES[name]
    got = stencil3d_cuda.KERNELS[name](*xs, table)
    want = stencil3d_cuda.PLAIN[name](*xs, table)
    torch.cuda.synchronize()
    assert stencil3d_cuda.LAUNCHES[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        tol = RTOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [None, 4])
@pytest.mark.parametrize("name", list(stencil3d.DESCRIPTORS))
def test_stencils_equal_their_plain_versions_bitwise_at_64(card, name, slots):
    """Every operation of the stencil kernels is rounded as written, in the
    plain body's order, so kernel and plain version agree bit for bit."""
    xs, table = _inputs(name, slots, (64, 64, 64), card, seed=5)
    got = stencil3d_cuda.KERNELS[name](*xs, table)
    want = stencil3d_cuda.PLAIN[name](*xs, table)
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w), float((g - w).abs().max())


def _gradient_kernel():
    """A descriptor with no hand-written kernel (``examples/
    custom_kernel_torch.py``'s GRADIENT_MAG) and its generated kernel."""
    from repro_torch.core import parse_ccl

    desc = parse_ccl("""
    CCTK_CUDA_KERNEL GRADIENT_MAG
      TYPE=3DBLOCK
      STENCIL="1,1,1,1,1,1"
    {
      CCTK_CUDA_KERNEL_VARIABLE CACHED=YES INTENT=IN
      {
        phi
      } "SCALAR_FIELD"
      CCTK_CUDA_KERNEL_VARIABLE INTENT=OUT
      {
        gmag
      } "GRADIENT_MAGNITUDE"
      CCTK_CUDA_KERNEL_PARAMETER
      {
        h
      } "SPACING"
    }
    """)[0]

    def body(ctx):
        phi, h = ctx["phi"], ctx.param("h")
        gx = (phi.at(1, 0, 0) - phi.at(-1, 0, 0)) / (2 * h)
        gy = (phi.at(0, 1, 0) - phi.at(0, -1, 0)) / (2 * h)
        gz = (phi.at(0, 0, 1) - phi.at(0, 0, -1)) / (2 * h)
        return {"gmag": torch.sqrt(gx * gx + gy * gy + gz * gz)}

    return stencil3d_cuda.generated(desc, body)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_generated_kernel_equals_its_plain_version_bitwise(card, shape):
    """A kernel generated from a body rounds every operation as written,
    so it equals the body's plain version on the card bit for bit; the
    launch is counted under the descriptor's name."""
    gen = _gradient_kernel()
    slots, interior = SHAPES[shape]
    rng = np.random.RandomState(3)
    lead = () if slots is None else (slots,)
    phi = torch.from_numpy(rng.randn(*lead, *(n + 2 for n in interior))
                           .astype(np.float32)).to(card)
    table = torch.tensor([[0.1 * (s + 1)] for s in range(slots or 1)],
                         device=card)
    table = table if slots else table[0]
    before = stencil3d_cuda.GENERATED_LAUNCHES.get("GRADIENT_MAG", 0)
    got = gen(phi, table)
    want = gen.plain(phi, table)
    torch.cuda.synchronize()
    assert stencil3d_cuda.GENERATED_LAUNCHES["GRADIENT_MAG"] == before + 1
    assert got.shape == want.shape == (*lead, *interior)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(stencil3d.DESCRIPTORS))
def test_plain_stencils_on_the_card_equal_the_cpu_bitwise(card, name):
    """The plain bodies divide by a 0-dim tensor on the operand's device:
    no reciprocal multiply on the card, so card and CPU agree bit for bit."""
    xs, table = _inputs(name, 2, (64, 64, 64), card, seed=6)
    on_card = stencil3d_cuda.PLAIN[name](*xs, table)
    on_cpu = stencil3d_cuda.PLAIN[name](*(x.cpu() for x in xs), table.cpu())
    for g, w in zip(on_card if isinstance(on_card, tuple) else (on_card,),
                    on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_telemetry_and_health_on_farm_equals_the_off_farm_bitwise(card,
                                                                  tmp_path):
    runs = [dict(steps=3, re=50.0), dict(steps=7, re=200.0),
            dict(steps=2, re=400.0), dict(steps=5, re=100.0),
            dict(steps=6, re=800.0)]

    def drive(**posture):
        rt = api.runtime(n=64, nz=64, n_slots=4, device=card,
                         backend="cuda", jacobi_iters=8, check_every=4,
                         **posture)
        sids = [rt.submit("cavity", **kw) for kw in runs]
        rt.services()[0].run(2)
        assert rt.evict(sids[1]) and rt.readmit(sids[1])
        out = rt.drain()
        return rt, [out[s] for s in sids]

    stencil3d_cuda.reset_launches()
    _, off = drive()
    off_launches = dict(stencil3d_cuda.LAUNCHES)
    stencil3d_cuda.reset_launches()
    rt, on = drive(telemetry=True, health=True, ckpt_dir=str(tmp_path),
                   store=True)
    assert dict(stencil3d_cuda.LAUNCHES) == off_launches
    farm = rt.services()[0].farm
    assert rt.telemetry.metrics.get("health.drains") <= \
        farm.device_steps // farm.check_steady_every
    for a, b in zip(on, off):
        assert (a.terminated, a.steps_done) == (b.terminated, b.steps_done)
        for f in ("vx", "vy", "vz", "p"):
            assert torch.equal(a.state[f], b.state[f]), f


@pytest.mark.cuda
def test_cuda_backend_launches_every_kernel_and_agrees_with_torch(card):
    stencil3d_cuda.reset_launches()
    a = api.runtime(n=16, device=card).run("cavity", steps=3)
    assert stencil3d_cuda.LAUNCHES == {"UPDATE_VELOCITY": 3, "DIVERGENCE": 3,
                                       "JACOBI_PRESSURE": 120,
                                       "PROJECT_VELOCITY": 3}
    assert a.config.template == "CUDA" and a.config.overlap is False
    b = api.runtime(n=16, device=card, backend="torch").run("cavity", steps=3)
    for f in ("vx", "vy", "vz", "p"):
        scale = max(float(b.state[f].abs().max()), 1.0)
        assert float((a.state[f] - b.state[f]).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_cuda_template_with_overlap_runs_the_thin_shells(card):
    from repro_torch.cfd import taylor_green

    stencil3d_cuda.reset_launches()
    res = taylor_green.run(n=16, steps=2, overlap=True, template="CUDA",
                           device=card)
    # deep interior + two shells per decomposed axis, each step
    assert stencil3d_cuda.LAUNCHES["UPDATE_VELOCITY"] == 2 * 7
    assert res["err_vx"] < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_jacobi_fused_matches_plain_version(card, shape, sweeps):
    slots, interior = SHAPES[shape]
    lead = () if slots is None else (slots,)
    rng = np.random.RandomState(sweeps)
    p, rhs = (torch.from_numpy(rng.randn(*lead, *(n + 2 * sweeps for n in interior))
                               .astype(np.float32)).to(card) for _ in range(2))
    before = jacobi_cuda.LAUNCHES["JACOBI_FUSED"]
    got = jacobi_cuda.jacobi_fused(p, rhs, h=1.0 / 48, omega=0.8, sweeps=sweeps)
    want = jacobi_cuda.jacobi_fused_plain(p, rhs, h=1.0 / 48, omega=0.8,
                                          sweeps=sweeps)
    torch.cuda.synchronize()
    assert jacobi_cuda.LAUNCHES["JACOBI_FUSED"] == before + 1
    assert got.shape == want.shape == (*lead, *interior)
    tol = RTOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


def _jacobi_inputs(lead, interior, sweeps, dev, seed):
    rng = np.random.RandomState(seed)
    shape = (*lead, *(n + 2 * sweeps for n in interior))
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
                 for _ in range(2))


# x extents about the kernel's segment length; y and z not multiples of its
# 16 x 32 output tile
SEG = jacobi_cuda.SEGMENT


# (y, z) interiors: z + 2k not a multiple of 4 (4-byte copies) and a
# multiple of 4 at k = 2 and 4 (16-byte copies)
YZ = {"copies4": (17, 33), "copies16": (18, 60)}


@pytest.mark.cuda
@pytest.mark.parametrize("yz", list(YZ))
@pytest.mark.parametrize("sweeps", [2, 4])
@pytest.mark.parametrize("nx", [1, SEG - 1, SEG, SEG + 1, 2 * SEG + 1])
def test_jacobi_fused_x_extents_about_a_segment(card, nx, sweeps, yz):
    p, rhs = _jacobi_inputs((), (nx, *YZ[yz]), sweeps, card, seed=nx)
    got = jacobi_cuda.jacobi_fused(p, rhs, h=1.0 / 48, omega=0.8, sweeps=sweeps)
    want = jacobi_cuda.jacobi_fused_plain(p, rhs, h=1.0 / 48, omega=0.8,
                                          sweeps=sweeps)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (nx, *YZ[yz])
    tol = RTOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("yz", list(YZ))
@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
def test_jacobi_fused_slot_batch_equals_single_slot_calls_bitwise(card, sweeps,
                                                                  yz):
    """The farm's rule: a slot of a batched launch equals the same slot
    launched alone, bit for bit (a slot's halo and segment-start cells are
    recomputed by the one expression every cell uses)."""
    p, rhs = _jacobi_inputs((4,), (SEG + 6, *YZ[yz]), sweeps, card,
                            seed=10 + sweeps)
    batched = jacobi_cuda.jacobi_fused(p, rhs, h=1.0 / 48, omega=0.8,
                                       sweeps=sweeps)
    for s in range(4):
        one = jacobi_cuda.jacobi_fused(p[s].contiguous(), rhs[s].contiguous(),
                                       h=1.0 / 48, omega=0.8, sweeps=sweeps)
        assert torch.equal(batched[s], one), s


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [1, 2, 4])
def test_jacobi_fused_check_rejects_a_zeroed_ghost_face(card, sweeps):
    """A planted fault: the kernel alone is given p with its x-low ghost
    face (k planes) zeroed; the check against the plain version must
    reject it."""
    p, rhs = _jacobi_inputs((), (SEG + 1, 17, 33), sweeps, card, seed=3)
    want = jacobi_cuda.jacobi_fused_plain(p, rhs, h=1.0 / 48, omega=0.8,
                                          sweeps=sweeps)
    bad = p.clone()
    bad[:sweeps] = 0.0
    got = jacobi_cuda.jacobi_fused(bad, rhs, h=1.0 / 48, omega=0.8,
                                   sweeps=sweeps)
    tol = RTOL * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) > tol


# launch tiles (tx, ty, tz) held against block_for, by shape: (slots,
# interior, legal tiles besides the autotuner's choice)
TILE_CASES = {
    "256": (None, (256, 256, 256),
            [(8, 8, 32), (32, 8, 32), (3, 5, 33), (7, 2, 96), (1, 1, 256)]),
    "256x4": (4, (256, 256, 256),
              [(8, 8, 32), (16, 8, 32), (5, 4, 64), (256, 1, 128)]),
    "odd": (None, (5, 7, 3), [(1, 1, 1), (2, 3, 5), (5, 13, 4), (3, 7, 3)]),
    "odd63": (None, (63, 65, 33),
              [(2, 8, 32), (7, 4, 64), (63, 1, 32), (9, 65, 3)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("name", list(stencil3d.DESCRIPTORS))
def test_every_tile_equals_block_for_bitwise(card, name, case):
    """Which thread computes a cell changes nothing in its arithmetic: the
    autotuner's tile and other legal tiles give block_for's bits."""
    slots, interior, tiles = TILE_CASES[case]
    xs, table = _inputs(name, slots, interior, card, seed=7)
    kern = stencil3d_cuda.KERNELS[name]
    want = kern(*xs, table)
    want = want if isinstance(want, tuple) else (want,)
    tuned = autotune.tile_for(stencil3d.DESCRIPTORS[name], interior).tile
    for tile in [tuned, *tiles]:
        before = stencil3d_cuda.LAUNCHES[name]
        got = kern(*xs, table, tile=tile)
        torch.cuda.synchronize()
        assert stencil3d_cuda.LAUNCHES[name] == before + 1
        got = got if isinstance(got, tuple) else (got,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (tile, float((g - w).abs().max()))


# -- the GHOSTED kernels' ghosted load --------------------------------------
# interiors that are no multiple of any tile, and a deep one
GHOST_INTERIORS = {"odd": (5, 7, 3), "ragged": (9, 20, 33),
                   "deep": (70, 12, 40)}


def _ghost_cases():
    """``tests/torch_ghost_cases.py``, loaded from beside this file (on a
    machine where another ``tests`` package comes first on the path)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).with_name("torch_ghost_cases.py")
    spec = importlib.util.spec_from_file_location("torch_ghost_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ghosted(name, case, slots, interior, dev, seed=0):
    gc = _ghost_cases()
    xs, table, ghosts, _, _ = gc.inputs(name, case, slots, interior, dev,
                                        seed)
    return xs, table, ghosts


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("interior", list(GHOST_INTERIORS))
@pytest.mark.parametrize("slots", [None, 1, 2, 4])
@pytest.mark.parametrize("case", ["cavity", "pressure", "mixed", "periodic",
                                  "strips_x", "strips_x_edge", "strips_xy",
                                  "strips_yz"])
@pytest.mark.parametrize("name", stencil3d_cuda.GHOSTED)
def test_ghosted_kernel_equals_its_plain_version_bitwise(card, name, case,
                                                         slots, interior):
    """Unpadded fields, every kind of face (rules as data, the periodic
    wrap, received strips with their ghost ends): the kernel fills its
    ghost zone as the plain version's padding does, bit for bit, under
    block_for's tile and the autotuner's."""
    shape = GHOST_INTERIORS[interior]
    xs, table, ghosts = _ghosted(name, case, slots, shape, card)
    want = _outs(stencil3d_cuda.PLAIN[name](*xs, table, ghosts=ghosts))
    tuned = autotune.tile_for(stencil3d.DESCRIPTORS[name], shape).tile
    for tile in (None, tuned):
        before = dict(stencil3d_cuda.GHOSTED_LAUNCHES)
        got = _outs(stencil3d_cuda.KERNELS[name](*xs, table, tile=tile,
                                                 ghosts=ghosts))
        torch.cuda.synchronize()
        assert stencil3d_cuda.GHOSTED_LAUNCHES[name] == before[name] + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.equal(g, w), (tile, float((g - w).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cavity", "strips_xy"])
@pytest.mark.parametrize("name", stencil3d_cuda.GHOSTED)
def test_ghosted_every_tile_equals_block_for_bitwise(card, name, case):
    """Which block computes a cell, and how many rows it walks, changes
    nothing: every tile gives block_for's bits in the ghosted load."""
    shape = (63, 65, 33)
    xs, table, ghosts = _ghosted(name, case, 2, shape, card, seed=3)
    want = _outs(stencil3d_cuda.KERNELS[name](*xs, table, ghosts=ghosts))
    tuned = autotune.tile_for(stencil3d.DESCRIPTORS[name], shape).tile
    for tile in [tuned, *TILE_CASES["odd63"][2], (63, 8, 32), (5, 2, 3)]:
        got = _outs(stencil3d_cuda.KERNELS[name](*xs, table, tile=tile,
                                                 ghosts=ghosts))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (tile, float((g - w).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walls", "strips_x"])
@pytest.mark.parametrize("name", stencil3d_cuda.GHOSTED)
def test_ghosted_check_rejects_a_zeroed_ghost_face(card, name, case):
    """A planted fault: the kernel alone is given the last field's x-low
    face zeroed (its strip, or its rule made the constant 0: p's Neumann
    wall, vz's no-slip one); the check against the plain version must
    reject it."""
    import dataclasses

    from repro_torch.core import halo

    if case == "walls":
        case = "pressure" if name == "JACOBI_PRESSURE" else "cavity"
    xs, table, ghosts = _ghosted(name, case, 2, (9, 20, 33), card, seed=4)
    many = isinstance(ghosts, list)
    gs = list(ghosts) if many else [ghosts]
    face = gs[-1].faces[0]
    zero = (torch.zeros_like(face) if torch.is_tensor(face)
            else halo.GhostForm("const", b=0.0))
    gs[-1] = dataclasses.replace(gs[-1], faces=(zero, *gs[-1].faces[1:]))
    want = _outs(stencil3d_cuda.PLAIN[name](*xs, table, ghosts=ghosts))
    got = _outs(stencil3d_cuda.KERNELS[name](*xs, table,
                                             ghosts=gs if many else gs[0]))
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tol = RTOL * max(1.0, max(float(w.abs().max()) for w in want))
    assert err > tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cavity", "strips_xy"])
@pytest.mark.parametrize("name", stencil3d_cuda.GHOSTED)
def test_bound_ghosts_launch_as_their_faces_do(card, name, case):
    """Faces bound once (stencil3d_cuda.bind_ghosts), as the Jacobi sweeps
    of a step share them, give the per-launch faces' bits, launch after
    launch; a launch on another shape refuses them."""
    xs, table, ghosts = _ghosted(name, case, 2, (9, 20, 33), card, seed=5)
    want = _outs(stencil3d_cuda.KERNELS[name](*xs, table, ghosts=ghosts))
    bound = stencil3d_cuda.bind_ghosts(name, ghosts, xs[0])
    for _ in range(2):
        got = _outs(stencil3d_cuda.KERNELS[name](*xs, table, ghosts=bound))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="bound for"):
        stencil3d_cuda.KERNELS[name](*(x[:1] for x in xs), table[:1],
                                     ghosts=bound)


# JACOBI_PRESSURE's march: ragged z runs (nz no multiple of 4 or of a
# warp's 128 cells), odd ny, x extents of one and two planes
MARCH_INTERIORS = {"nz5": (6, 9, 5), "nz33": (7, 11, 33), "nz64": (12, 17, 64),
                   "nx1": (1, 9, 40), "nx2": (2, 13, 36)}


@pytest.mark.cuda
@pytest.mark.parametrize("interior", list(MARCH_INTERIORS))
@pytest.mark.parametrize("slots", [1, 3, 8])
@pytest.mark.parametrize("case", ["cavity", "pressure", "mixed", "periodic",
                                  "strips_x", "strips_x_edge", "strips_xy",
                                  "strips_yz"])
def test_jacobi_march_equals_the_plain_version_bitwise(card, case, slots,
                                                       interior):
    """The march and the face blocks of JACOBI_PRESSURE's ghosted load
    give the plain version's bits on every kind of face, strips on a cut
    block included, at any slot count and any interior."""
    shape = MARCH_INTERIORS[interior]
    xs, table, ghosts = _ghosted("JACOBI_PRESSURE", case, slots, shape, card,
                                 seed=11)
    want = stencil3d_cuda.jacobi_pressure_plain(*xs, table, ghosts=ghosts)
    got = stencil3d_cuda.jacobi_pressure(*xs, table, ghosts=ghosts)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


# the benchmark's shapes and a decomposed rank's block (slots, interior,
# x decomposed)
BENCH_SHAPES = {"cavity512": (None, (512, 512, 512), False),
                "sweep256": (8, (256, 256, 256), False),
                "block": (None, (128, 256, 256), True)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BENCH_SHAPES))
def test_jacobi_march_at_the_benchmark_shapes(card, shape):
    """At the benchmark's shapes, with the cavity's faces (and a middle
    rank's received strips), the ghosted JACOBI_PRESSURE is one launch of
    one device function named jacobi_pressure_kernel, bitwise the plain
    version, with no memory beyond its output."""
    import importlib.util
    import pathlib

    from repro_torch.core import halo

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    slots, interior, cut = BENCH_SHAPES[shape]
    gen = torch.Generator(device=card).manual_seed(3)
    link = (halo.AxisLink(name="shard", size=3, index=1,
                          transport=halo.CountTransport()) if cut else None)
    (p, rhs), ghosts = cs.ghosted_inputs("JACOBI_PRESSURE", slots, interior,
                                         gen, card, link)
    rows = torch.tensor([[0.01, 0.9, 0.1]] * (slots or 1), device=card)
    table = rows if slots else rows[0]
    bound = stencil3d_cuda.bind_ghosts("JACOBI_PRESSURE", ghosts, p)
    want = stencil3d_cuda.jacobi_pressure_plain(p, rhs, table, ghosts=bound)
    stencil3d_cuda.jacobi_pressure(p, rhs, table, ghosts=bound)  # built
    torch.cuda.synchronize()
    before = dict(stencil3d_cuda.GHOSTED_LAUNCHES)
    used = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = stencil3d_cuda.jacobi_pressure(p, rhs, table, ghosts=bound)
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) == used + got.numel() * 4
    assert stencil3d_cuda.GHOSTED_LAUNCHES["JACOBI_PRESSURE"] == \
        before["JACOBI_PRESSURE"] + 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("jacobi_pressure_kernel" in n for n in names) == 1, names
    assert torch.equal(got, want), float((got - want).abs().max())


def _slot_ghosts(g, s):
    """FieldGhosts ``g`` of a slot batch cut to slot ``s``: its strips'
    slot, and a b that varies by slot taken at ``s``."""
    import dataclasses

    def cut(f):
        if torch.is_tensor(f):
            return f[s]
        if torch.is_tensor(getattr(f, "b", None)) and f.b.numel() > 1:
            return dataclasses.replace(f, b=f.b.reshape(-1)[s])
        return f

    return dataclasses.replace(
        g, strips=tuple(tuple(cut(t) for t in pair) for pair in g.strips),
        faces=tuple(cut(f) for f in g.faces))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cavity", "pressure", "strips_xy"])
def test_a_slot_of_the_jacobi_march_equals_its_serial_launch(card, case):
    """Each slot of a batched ghosted JACOBI_PRESSURE equals that slot
    launched alone, bit for bit (the farm's slot == serial rule)."""
    (p, rhs), table, ghosts = _ghosted("JACOBI_PRESSURE", case, 5,
                                       (20, 19, 72), card, seed=13)
    got = stencil3d_cuda.jacobi_pressure(p, rhs, table, ghosts=ghosts)
    for s in range(5):
        alone = stencil3d_cuda.jacobi_pressure(p[s], rhs[s], table[s],
                                               ghosts=_slot_ghosts(ghosts, s))
        torch.cuda.synchronize()
        assert torch.equal(got[s], alone), s


@pytest.mark.cuda
def test_cuda_backend_ghosts_every_ghosted_kernel_launch(card):
    """On the cuda backend the step pads nothing for the GHOSTED kernels:
    every launch of theirs takes the ghosted load, on a serial run and on
    a farm."""
    stencil3d_cuda.reset_launches()
    api.runtime(n=16, device=card).run("cavity", steps=2)
    assert stencil3d_cuda.GHOSTED_LAUNCHES == {"UPDATE_VELOCITY": 2,
                                               "JACOBI_PRESSURE": 80}
    stencil3d_cuda.reset_launches()
    rt = api.runtime(n=16, device=card, n_slots=2)
    rt.submit("cavity", re=100.0, steps=3)
    rt.submit("cavity", re=400.0, steps=3)
    rt.drain()
    assert stencil3d_cuda.GHOSTED_LAUNCHES == {
        k: stencil3d_cuda.LAUNCHES[k] for k in stencil3d_cuda.GHOSTED}
    assert stencil3d_cuda.LAUNCHES["JACOBI_PRESSURE"] > 0
    assert not any(stencil3d_cuda.PADDED_ROUTE.values())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(0, 8, 32), (1, 16, 32), (17, 8, 32),
                                  (1, 8, 64), (1, 40, 4), (1.5, 8, 32)])
def test_a_bad_tile_raises_and_launches_nothing(card, tile):
    xs, table = _inputs("JACOBI_PRESSURE", None, (16, 16, 32), card)
    before = dict(stencil3d_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="tile"):
        stencil3d_cuda.jacobi_pressure(*xs, table, tile=tile)
    assert stencil3d_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_serial_and_farm_share_autotuned_tiles(card):
    """The launch tile is resolved per (kernel, local interior, chip) and
    memoized: the farm's batched steps re-read the serial run's choices
    (zero extra misses)."""
    autotune.reset_tile_cache()
    rt = api.runtime(n=24, nz=16, n_slots=2, device=card, backend="cuda",
                     jacobi_iters=4)
    rt.run("cavity", steps=2, re=100.0)
    after_serial = autotune.tile_cache_stats()
    # JACOBI_PRESSURE's ghosted load sets its own launch (OWN_TILE)
    assert after_serial["misses"] == (len(stencil3d.DESCRIPTORS)
                                      - len(stencil3d_cuda.OWN_TILE))
    rt.submit("cavity", steps=3, re=150.0)
    rt.drain()
    after_farm = autotune.tile_cache_stats()
    assert after_farm["misses"] == after_serial["misses"]
    assert after_farm["hits"] > after_serial["hits"]


@pytest.mark.cuda
def test_perf_report_on_the_card_launches_nothing(card):
    rt = api.runtime(n=24, nz=16, n_slots=2, device=card, backend="cuda",
                     telemetry=True, jacobi_iters=4)
    rt.run("cavity", steps=2, re=100.0)
    rt.submit("cavity", steps=3, re=150.0)
    rt.drain()
    torch.cuda.synchronize()
    before = {**stencil3d_cuda.LAUNCHES, **jacobi_cuda.LAUNCHES}
    rep = rt.perf_report()
    assert {**stencil3d_cuda.LAUNCHES, **jacobi_cuda.LAUNCHES} == before
    assert rep.chip.name == "h100-sxm"
    rows = rep.rows()
    assert [r["kind"] for r in rows] == ["farm-step", "serial-bin"]
    for r in rows:
        assert r["status"] == "ok", r["error"]
        assert r["measured_s"] > 0 and r["bottleneck"] == "memory"


@pytest.mark.cuda
@pytest.mark.parametrize("fused_sweeps", [1, 2])
def test_cuda_farm_slots_equal_serial_runs_bitwise(card, fused_sweeps):
    rt = api.runtime(n=16, nz=4, n_slots=4, device=card, backend="cuda",
                     jacobi_iters=8, fused_sweeps=fused_sweeps)
    runs = [dict(steps=3, re=50.0), dict(steps=5, re=200.0),
            dict(steps=2, re=400.0), dict(steps=4, re=100.0),
            dict(steps=6, re=800.0)]
    sids = [rt.submit("cavity", **kw) for kw in runs]
    out = rt.drain()
    for sid, kw in zip(sids, runs):
        serial = rt.run("cavity", **kw)
        for f in ("vx", "vy", "vz", "p"):
            assert torch.equal(out[sid].state[f], serial.state[f]), (sid, f)


# FLASH_ATTENTION cases: (B, Sq, Sk, H, KH, D, dtype, kv dtype, spec, valid)
ATTN_CASES = {
    "prefill_causal": (1, 200, 200, 4, 4, 64, torch.bfloat16, None,
                       MaskSpec(), None),
    "gqa_rep2_d128": (2, 77, 77, 8, 4, 128, torch.bfloat16, None,
                      MaskSpec(), None),
    "gqa_rep4_d32_f32": (1, 65, 65, 8, 2, 32, torch.float32, None,
                         MaskSpec(), None),
    "prefix_offset": (2, 77, 133, 4, 2, 64, torch.bfloat16, None,
                      MaskSpec(causal=True, q_offset=40, prefix_len=9), 120),
    "decode_f32_cache": (4, 1, 300, 4, 4, 64, torch.bfloat16, torch.float32,
                         MaskSpec(causal=False), (37, 300, 1, 150)),
    "blind_rows": (1, 70, 50, 2, 1, 64, torch.float32, None,
                   MaskSpec(causal=True, q_offset=-20), None),
    "no_valid_key": (2, 3, 40, 2, 2, 32, torch.float32, None,
                     MaskSpec(causal=False), (0, 5)),
    # bf16 twins of the two above: the tensor-core prefill and the split-K
    # decode routes
    "blind_rows_bf16": (1, 70, 50, 2, 1, 64, torch.bfloat16, None,
                        MaskSpec(causal=True, q_offset=-20), None),
    "no_valid_key_bf16": (2, 3, 40, 2, 2, 32, torch.bfloat16, None,
                          MaskSpec(causal=False), (0, 5)),
    # llama3-8b's widths at decode: 32 query heads over 8 kv heads, D 128
    "decode_gqa_llama3": (4, 1, 4096, 32, 8, 128, torch.bfloat16,
                          torch.float32, MaskSpec(causal=False),
                          (300, 1500, 2900, 4096)),
    # valid lengths about one 256-key split, and a single key
    "decode_valid_edges": (4, 1, 1024, 8, 8, 64, torch.bfloat16,
                           torch.float32, MaskSpec(causal=False),
                           (255, 256, 257, 1)),
    # split-K blocks of two rows (rep 2, D 128, a batch row with no valid
    # key) and of eight rows in two groups (Sq 3 x rep 4, causal, prefix)
    "decode_two_rows": (3, 1, 520, 4, 2, 128, torch.bfloat16, torch.float32,
                        MaskSpec(causal=False), (0, 257, 520)),
    "decode_row_groups": (2, 3, 700, 8, 2, 64, torch.bfloat16, None,
                          MaskSpec(causal=True, q_offset=500, prefix_len=3),
                          (600, 2)),
    # the CUDA-core route kept for bf16 q with a float32 k/v at Sq > 8
    "prefill_f32_kv": (2, 40, 90, 4, 2, 64, torch.bfloat16, torch.float32,
                       MaskSpec(), None),
    # head dim 112 (kimi-k2) on every route: the tensor-core prefill at GQA
    # 8:1 with a ragged last tile; the split-K decode with float32 rows (28
    # chunks on 32 lanes) in blocks of 8 and 2 rows, and bf16 rows (14 on
    # 16) with a batch row that sees no key; the CUDA-core route for float32
    # q at Sq > 8 and Sq <= 8 (half a warp a row), and bf16 q with a float32
    # k/v
    "prefill_d112_gqa8": (1, 200, 200, 16, 2, 112, torch.bfloat16, None,
                          MaskSpec(), None),
    "decode_d112_f32_cache": (4, 1, 600, 16, 2, 112, torch.bfloat16,
                              torch.float32, MaskSpec(causal=False),
                              (37, 600, 1, 300)),
    "decode_d112_two_rows": (3, 1, 520, 4, 2, 112, torch.bfloat16,
                             torch.float32, MaskSpec(causal=False),
                             (0, 257, 520)),
    "decode_d112_bf16": (2, 1, 300, 8, 8, 112, torch.bfloat16, None,
                         MaskSpec(causal=False), (0, 257)),
    "cuda_core_d112_f32": (1, 65, 65, 8, 2, 112, torch.float32, None,
                           MaskSpec(), None),
    "cuda_core_d112_f32_decode": (2, 3, 90, 4, 2, 112, torch.float32, None,
                                  MaskSpec(causal=True, q_offset=80),
                                  (90, 70)),
    "prefill_f32_kv_d112": (2, 40, 90, 4, 2, 112, torch.bfloat16,
                            torch.float32, MaskSpec(), None),
    # head dim 256 (paligemma-3b: 8 query heads over 1 kv head) on every
    # route: the tensor-core prefill (Q re-read from shared memory) with the
    # 256-key bidirectional prefix and a ragged last tile, and with q_offset,
    # a short prefix and valid lengths; the split-K decode with float32 rows
    # (64 chunks, two a lane) in blocks of 8 rows, of 8 rows in three groups
    # (Sq 3 x rep 8, causal, prefix) and of 2 rows with a batch row that
    # sees no key, and with bf16 rows (32 chunks); the CUDA-core route for
    # float32 q at Sq > 8 (64-row tiles) and Sq <= 8 (8-row tiles), and bf16
    # q with a float32 k/v
    "prefill_d256_mqa8_prefix": (1, 300, 300, 8, 1, 256, torch.bfloat16,
                                 None, MaskSpec(prefix_len=256), None),
    "prefill_d256_offset": (2, 77, 133, 4, 2, 256, torch.bfloat16, None,
                            MaskSpec(causal=True, q_offset=40, prefix_len=9),
                            (133, 100)),
    "decode_d256_f32_cache": (4, 1, 600, 8, 1, 256, torch.bfloat16,
                              torch.float32, MaskSpec(causal=False),
                              (37, 600, 1, 300)),
    "decode_d256_row_groups": (2, 3, 700, 8, 1, 256, torch.bfloat16,
                               torch.float32,
                               MaskSpec(causal=True, q_offset=500,
                                        prefix_len=3), (600, 2)),
    "decode_d256_two_rows": (3, 1, 520, 4, 2, 256, torch.bfloat16,
                             torch.float32, MaskSpec(causal=False),
                             (0, 257, 520)),
    "decode_d256_bf16": (2, 1, 300, 8, 1, 256, torch.bfloat16, None,
                         MaskSpec(causal=False), (0, 257)),
    "cuda_core_d256_f32": (1, 256, 256, 8, 1, 256, torch.float32, None,
                           MaskSpec(), None),
    "cuda_core_d256_f32_decode": (2, 3, 90, 4, 2, 256, torch.float32, None,
                                  MaskSpec(causal=True, q_offset=80),
                                  (90, 70)),
    "prefill_f32_kv_d256": (2, 40, 90, 4, 2, 256, torch.bfloat16,
                            torch.float32, MaskSpec(), None),
}


def _share_of_tolerance(got, want, dtype, roundings: int = 1) -> float:
    """The largest share of the per-row tolerance |kernel - plain|
    <= roundings * rtol * max|plain row| + 1e-5 (a row: one query, one
    head).  bf16 outputs: one bf16 ulp of the row's largest value (2^-7
    relative) a rounding ``got`` took that ``want`` did not (1: kernel and
    plain version may round a float32 result differently; 2: attention
    merged from parts, each part rounded before the merge rounds again);
    float32: 2e-5 relative.  The floor covers the float32 summation error.
    Held per row, since long causal rows are ten times smaller than short
    ones."""
    rtol = roundings * (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5)
    diff = (got.float() - want.float()).abs()
    tol = rtol * want.float().abs().amax(dim=-1, keepdim=True) + 1e-5
    return float((diff / tol).max())


def _attn_inputs(case, dev):
    b, sq, sk, h, kh, d, dt, kvdt, spec, valid = ATTN_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dt)
    k, v = (torch.randn(b, sk, kh, d, generator=gen, device=dev)
            .to(kvdt or dt) for _ in range(2))
    if isinstance(valid, tuple):
        valid = torch.tensor(valid, device=dev)
    return q, k, v, spec, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_matches_plain_version(card, case):
    q, k, v, spec, valid = _attn_inputs(case, card)
    path = attention_cuda.route(q.dtype, k.dtype, q.shape[1])
    before = attention_cuda.LAUNCHES["FLASH_ATTENTION"]
    by_route = attention_cuda.ROUTE_LAUNCHES[path]
    got = attention_cuda.flash_attention(q, k, v, spec, valid)
    want = attention_cuda.flash_attention_plain(q, k, v, spec, valid)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES["FLASH_ATTENTION"] == before + 1
    assert attention_cuda.ROUTE_LAUNCHES[path] == by_route + 1
    assert got.shape == want.shape and got.dtype == q.dtype
    assert bool(torch.isfinite(got).all())
    assert _share_of_tolerance(got, want, q.dtype) <= 1.0


@pytest.mark.cuda
def test_every_route_is_taken(card):
    routes = {attention_cuda.route(a[6], a[7] or a[6], a[1])
              for a in ATTN_CASES.values()}
    assert routes == set(attention_cuda.ROUTES)
    for d in (112, 256):
        routes = {attention_cuda.route(a[6], a[7] or a[6], a[1])
                  for a in ATTN_CASES.values() if a[5] == d}
        assert routes == set(attention_cuda.ROUTES), d


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 96, 192])
def test_a_head_dim_outside_the_set_raises_and_launches_nothing(card, d):
    before = attention_cuda.LAUNCHES["FLASH_ATTENTION"]
    for sq, kvdt in ((40, torch.bfloat16), (1, torch.float32),
                     (40, torch.float32)):
        q = torch.zeros(1, sq, 2, d, dtype=torch.bfloat16, device=card)
        kv = torch.zeros(1, 64, 2, d, dtype=kvdt, device=card)
        with pytest.raises(ValueError, match="head dim"):
            attention_cuda.flash_attention(q, kv, kv, MaskSpec())
    assert attention_cuda.LAUNCHES["FLASH_ATTENTION"] == before


@pytest.mark.cuda
def test_split_k_decode_leaves_its_tickets_at_zero(card):
    """Back-to-back decode launches share the ticket counters: each launch
    must re-arm them, or the next one would merge too early."""
    q, k, v, spec, valid = _attn_inputs("decode_gqa_llama3", card)
    first = attention_cuda.flash_attention(q, k, v, spec, valid)
    for _ in range(3):
        again = attention_cuda.flash_attention(q, k, v, spec, valid)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    assert int(attention_cuda._TICKETS[q.device, stream].abs().sum()) == 0


@pytest.mark.cuda
def test_split_k_decode_d256_leaves_its_tickets_at_zero(card):
    """The same at head dim 256: paligemma's 8 query heads over one kv head
    in blocks of 8 rows, float32 rows of 64 chunks."""
    q, k, v, spec, valid = _attn_inputs("decode_d256_f32_cache", card)
    before = attention_cuda.ROUTE_LAUNCHES["split_k_decode"]
    first = attention_cuda.flash_attention(q, k, v, spec, valid)
    for _ in range(3):
        again = attention_cuda.flash_attention(q, k, v, spec, valid)
    torch.cuda.synchronize()
    assert attention_cuda.ROUTE_LAUNCHES["split_k_decode"] == before + 4
    assert torch.equal(first, again)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    assert int(attention_cuda._TICKETS[q.device, stream].abs().sum()) == 0


@pytest.mark.cuda
def test_d256_prefix_rule_at_prefix_len_256(card):
    """paligemma's prefix-LM mask at its widths: 1,024 rows, 8 heads of 256
    over one kv head, the first 256 positions bidirectional.  The kernel
    matches its plain version; against the plain causal-only mask it
    differs in every prefix row (the check rejects it there) and agrees in
    every row after the prefix, which sees the whole prefix either way."""
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(1, 1024, h, 256, generator=gen, device=card)
               .to(torch.bfloat16) for h in (8, 1, 1))
    before = attention_cuda.ROUTE_LAUNCHES["tensor_core_prefill"]
    got = attention_cuda.flash_attention(q, k, v, MaskSpec(prefix_len=256))
    want = attention_cuda.flash_attention_plain(q, k, v,
                                                MaskSpec(prefix_len=256))
    causal = attention_cuda.flash_attention_plain(q, k, v, MaskSpec())
    torch.cuda.synchronize()
    assert attention_cuda.ROUTE_LAUNCHES["tensor_core_prefill"] == before + 1
    assert _share_of_tolerance(got, want, q.dtype) <= 1.0
    for row in range(255):          # row 255 sees keys 0..255 either way
        assert _share_of_tolerance(got[:, row], causal[:, row],
                                   q.dtype) > 1.0, row
    assert _share_of_tolerance(got[:, 255:], causal[:, 255:], q.dtype) <= 1.0


@pytest.mark.cuda
def test_split_k_decodes_on_two_streams_keep_their_own_tickets(card):
    """Two split-K decodes with different inputs, launched concurrently on
    two streams of the card, several times over: each result equals its
    plain twin (``ref.split_k_decode_reference``) within the per-row
    tolerance, and every ticket counter reads 0 afterwards."""
    from repro_torch.kernels.ref import split_k_decode_reference

    q, k, v, spec, valid = _attn_inputs("decode_gqa_llama3", card)
    gen = torch.Generator(device=card).manual_seed(1)
    q2 = torch.randn(q.shape, generator=gen, device=card).to(q.dtype)
    k2, v2 = (torch.randn(k.shape, generator=gen, device=card).to(k.dtype)
              for _ in range(2))
    cases = ((q, k, v), (q2, k2, v2))
    want = [split_k_decode_reference(a, b, c, spec, valid)
            for a, b, c in cases]
    streams = [torch.cuda.Stream(card) for _ in cases]
    torch.cuda.synchronize()
    for _ in range(8):
        got = []
        for st, (a, b, c) in zip(streams, cases):
            with torch.cuda.stream(st):
                got.append(attention_cuda.flash_attention(a, b, c, spec, valid))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert _share_of_tolerance(g, w, q.dtype) <= 1.0
    for st in streams:
        assert int(attention_cuda._TICKETS[q.device, st.cuda_stream]
                   .abs().sum()) == 0
    assert all(int(t.abs().sum()) == 0
               for t in attention_cuda._TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_check_rejects_a_dropped_key_tile(card, case):
    """A planted fault: the kernel alone is given a valid key length 64
    short (one 64-key tile dropped); the per-row check must reject it."""
    q, k, v, spec, valid = _attn_inputs(case, card)
    if torch.is_tensor(valid):
        short = (valid - 64).clamp(min=1)
    else:
        short = max(1, (k.shape[1] if valid is None else valid) - 64)
    got = attention_cuda.flash_attention(q, k, v, spec, short)
    want = attention_cuda.flash_attention_plain(q, k, v, spec, valid)
    assert _share_of_tolerance(got, want, q.dtype) > 1.0


# the cases whose route writes the log-sum-exp (the split-K decode and the
# CUDA-core route; the tensor-core prefill has no such output)
LSE_CASES = [c for c, a in ATTN_CASES.items()
             if attention_cuda.route(a[6], a[7] or a[6], a[1])
             != "tensor_core_prefill"]


def _lse_share(got, want, dtype) -> float:
    """The largest share of the per-row tolerance of a log-sum-exp:
    |kernel - plain| <= rtol * |plain| + 1e-5, rtol as for the output."""
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
    return float(((got - want).abs() / (rtol * want.abs() + 1e-5)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", LSE_CASES)
def test_lse_launch_gives_the_plain_pair_and_the_same_out_bitwise(card, case):
    """``return_lse``: one launch of the route, its ``out`` bitwise the
    ``out`` of the same launch without it, the log-sum-exp per row against
    the plain version's (-1e30 for a row that sees no key), the split-K
    tickets left at 0."""
    q, k, v, spec, valid = _attn_inputs(case, card)
    path = attention_cuda.route(q.dtype, k.dtype, q.shape[1])
    plain = attention_cuda.flash_attention(q, k, v, spec, valid)
    by_route = attention_cuda.ROUTE_LAUNCHES[path]
    got, lse = attention_cuda.flash_attention(q, k, v, spec, valid,
                                              return_lse=True)
    want, want_lse = attention_cuda.flash_attention_plain(
        q, k, v, spec, valid, return_lse=True)
    torch.cuda.synchronize()
    assert attention_cuda.ROUTE_LAUNCHES[path] == by_route + 1
    assert torch.equal(got, plain)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    assert _share_of_tolerance(got, want, q.dtype) <= 1.0
    assert _lse_share(lse, want_lse, q.dtype) <= 1.0
    if path == "split_k_decode":
        stream = torch.cuda.current_stream(q.device).cuda_stream
        assert int(attention_cuda._TICKETS[q.device, stream].abs().sum()) == 0


@pytest.mark.cuda
def test_the_tensor_core_prefill_has_no_lse_and_launches_nothing(card):
    q, k, v, spec, valid = _attn_inputs("prefill_causal", card)
    before = attention_cuda.LAUNCHES["FLASH_ATTENTION"]
    with pytest.raises(ValueError, match="log-sum-exp"):
        attention_cuda.flash_attention(q, k, v, spec, valid, return_lse=True)
    assert attention_cuda.LAUNCHES["FLASH_ATTENTION"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [112, 128, 256])
def test_rank_slice_decode_merges_to_the_whole_decode(card, d):
    """A 4-slot bf16 decode over each half of a 2,048-row float32 cache, as
    a ``tp`` rank takes it (``models.attention.decode_mha_partial``): each
    half's (out, lse) against the plain pair per row, rows that see no key
    of the second half (lse -1e30) included; the halves merged
    (``kernels.ref.merge_partials``) against the whole cache's decode; a
    log-sum-exp off by log 2 in one half rejected."""
    from repro_torch.kernels.ref import merge_partials
    from repro_torch.models.attention import decode_mha_partial

    b, sk, h, kh = 4, 2048, 16, 2 if d != 256 else 1
    gen = torch.Generator(device=card).manual_seed(d)
    q = torch.randn(b, 1, h, d, generator=gen, device=card).to(
        torch.bfloat16)
    k, v = (torch.randn(b, sk, kh, d, generator=gen, device=card)
            for _ in range(2))
    lens = torch.tensor([1, 700, 1025, 2048], device=card)
    half = sk // 2
    parts = []
    for j in range(2):
        kj, vj = k[:, j * half:(j + 1) * half], v[:, j * half:(j + 1) * half]
        got = decode_mha_partial(q, kj, vj, lens, j * half, template="CUDA")
        want = decode_mha_partial(q, kj, vj, lens, j * half,
                                  template="TORCH")
        assert _share_of_tolerance(got[0], want[0], q.dtype) <= 1.0
        assert _lse_share(got[1], want[1], q.dtype) <= 1.0
        empty = lens <= j * half
        assert bool((got[1][empty] == -1e30).all())
        assert bool(torch.isfinite(got[0]).all())
        parts.append(got)
    outs, lses = (torch.stack(t) for t in zip(*parts))
    whole = attention_cuda.flash_attention_plain(
        q, k, v, MaskSpec(causal=False), lens)
    assert _share_of_tolerance(merge_partials(outs, lses), whole,
                               q.dtype, roundings=2) <= 1.0
    off = lses.clone()
    off[0] += float(np.log(2.0))
    assert _share_of_tolerance(merge_partials(outs, off), whole,
                               q.dtype, roundings=2) > 1.0


# SSD_INTRA cases: (B, nc, L, G, R, P, N)
SSD_CASES = {"zamba2_chunk": (1, 2, 128, 1, 8, 64, 64),
             "odd": (2, 3, 48, 1, 3, 16, 8),
             "groups_long": (1, 2, 200, 2, 2, 24, 20),
             "wide": (1, 1, 256, 1, 2, 128, 128),
             # heads not a multiple of the kernel's heads per block, L 200
             # and 48, and N, P that rule out 16-byte copies
             "heads_not_multiple": (1, 2, 128, 1, 6, 64, 64),
             "l200_heads5": (1, 1, 200, 2, 5, 32, 16),
             "l48_unaligned": (2, 1, 48, 1, 7, 5, 3),
             # the xlstm-125m mLSTM's 512-token prefill (its 4 heads as the
             # groups, N 384, P 385) on mLSTM-like inputs, and shapes across
             # N and P 128 (N slices, column tiles, a last tile of 8)
             "mlstm_prefill": (1, 4, 128, 4, 1, 385, 384),
             "n200_p129_l48": (2, 3, 48, 2, 3, 129, 200),
             "n129_p385": (1, 2, 128, 1, 2, 385, 129),
             "n512_p512_l256": (1, 1, 256, 2, 3, 512, 512)}


def _ssd_inputs(case, dev):
    bsz, nc, l, g, r, p, n = SSD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = rnd(bsz, nc, l, g, r, p)
    if case.startswith("mlstm"):
        # v with the ones column, the forget bias 3, the input gate capped
        # at e^8, k / sqrt(N), and s_in the relay of these inputs (the
        # state term at the output's scale)
        x[..., -1] = 1.0
        ld = torch.nn.functional.logsigmoid(3.0 + rnd(bsz, nc, l, g, r))
        dt = torch.exp(8 * torch.tanh((rnd(bsz, nc, l, g, r) * 6 - 2) / 8))
        b_, c_ = rnd(bsz, nc, l, g, n) / n ** 0.5, rnd(bsz, nc, l, g, n)
        cum = torch.cumsum(ld, dim=2)
        w = torch.exp(cum[:, :, -1:] - cum) * dt
        sc = torch.einsum("bclgn,bclgr,bclgrp->bcgrnp", b_, w, x)
        s_in = torch.zeros_like(sc)
        for c in range(1, nc):
            s_in[:, c] = (s_in[:, c - 1]
                          * torch.exp(cum[:, c - 1, -1])[..., None, None]
                          + sc[:, c - 1])
        return x, ld, dt, b_, c_, s_in
    ld = -torch.nn.functional.softplus(rnd(bsz, nc, l, g, r))
    dt = torch.nn.functional.softplus(rnd(bsz, nc, l, g, r))
    b_, c_ = rnd(bsz, nc, l, g, n), rnd(bsz, nc, l, g, n)
    s_in = rnd(bsz, nc, g, r, n, p) * 0.3
    return x, ld, dt, b_, c_, s_in


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_intra_matches_plain_version(card, case):
    args = _ssd_inputs(case, card)
    before = ssd_cuda.LAUNCHES["SSD_INTRA"]
    got = ssd_cuda.ssd_intra(*args)
    want = ssd_cuda.ssd_intra_plain(*args)
    torch.cuda.synchronize()
    assert ssd_cuda.LAUNCHES["SSD_INTRA"] == before + 1
    # float32 throughout; the decay exponents come from a cumulative sum
    # taken in another order, so allow 1e-4 of the largest output
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_intra_check_rejects_a_zeroed_head_state(card, case):
    """A planted fault: the kernel alone is given s_in with its last head's
    incoming state zeroed; the 1e-4 check must reject it."""
    args = _ssd_inputs(case, card)
    want = ssd_cuda.ssd_intra_plain(*args)
    s_bad = args[5].clone()
    s_bad[:, :, :, -1] = 0.0
    got = ssd_cuda.ssd_intra(*args[:5], s_bad)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 513, 64), (128, 64, 513),
                                   (257, 64, 64)])
def test_ssd_intra_beyond_its_limits_raises_and_launches_nothing(card, shape):
    """L <= 256, N <= 512 and P <= 512 (csrc/ssd.cu's kMax*): a larger
    shape raises in the wrapper, before any launch."""
    l, n, p = shape
    x = torch.zeros(1, 1, l, 1, 1, p, device=card)
    gates = torch.zeros(1, 1, l, 1, 1, device=card)
    bc = torch.zeros(1, 1, l, 1, n, device=card)
    s_in = torch.zeros(1, 1, 1, 1, n, p, device=card)
    before = ssd_cuda.LAUNCHES["SSD_INTRA"]
    with pytest.raises(ValueError, match="the kernel takes"):
        ssd_cuda.ssd_intra(x, gates, gates, bc, bc, s_in)
    assert ssd_cuda.LAUNCHES["SSD_INTRA"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 4, 8, 16, 64])
def test_ssd_heads_per_block_keeps_one_and_a_half_blocks_an_sm(card, nc):
    """SSD_INTRA shares each block's C.B^T among H heads: the most of 8, 4,
    2 whose grid still gives 1.5 blocks an SM (zamba2's 512-, 1024- and
    2048-token prefills: 2, 4, 8 on an H100's 132 SMs)."""
    x = torch.empty(1, nc, 128, 1, 64, 64, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    blocks = lambda h: nc * 2 * -(-64 // h)          # (l tiles, head groups)
    want = next((h for h in (8, 4) if 2 * blocks(h) >= 3 * sms), 2)
    assert ssd_cuda.heads_per_block(x) == want


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3-8b",
                                  "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
                                  "xlstm-125m", "musicgen-large",
                                  "paligemma-3b"])
def test_smoke_model_kernels_agree_with_plain_path(card, arch):
    from repro_torch.configs.registry import get_config, smoke
    from repro_torch.models import model

    cfg = smoke(get_config(arch))
    lm = model.init_params(cfg, 0, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=card,
                         generator=torch.Generator(device=card).manual_seed(2))
    n_attn = (0 if cfg.family == "ssm"
              else cfg.num_layers // (cfg.attn_every or 1))
    # SSD_INTRA a prefill: every Mamba2 layer; xlstm's mLSTM layers
    n_ssd = {"hybrid": cfg.num_layers,
             "ssm": cfg.num_layers - len(cfg.slstm_indices)}.get(
                 cfg.family, 0)
    outs = {}
    for tmpl in ("CUDA", "TORCH"):
        attention_cuda.reset_launches()
        ssd_cuda.reset_launches()
        caches = model.init_caches(cfg, 2, 64, torch.float32, card)
        lp, caches = model.prefill(lm, cfg, {"tokens": toks}, caches,
                                   template=tmpl)
        ld, caches = model.decode_step(
            lm, cfg, toks[:, :1], caches, torch.tensor([40, 23], device=card),
            template=tmpl)
        torch.cuda.synchronize()
        outs[tmpl] = (lp, ld)
        launched = (attention_cuda.LAUNCHES["FLASH_ATTENTION"],
                    ssd_cuda.LAUNCHES["SSD_INTRA"])
        assert launched == ((2 * n_attn, n_ssd) if tmpl == "CUDA" else (0, 0))
    for a, b in zip(outs["CUDA"], outs["TORCH"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_moe_layer_at_qwen3_width_is_bitwise_deterministic(card):
    """One MoE layer at qwen3-moe's published widths (128 experts of 4096
    x 1536, top-8, bf16) on a 2,048-token prefill and a 4-token decode: two
    calls give the same bits (a stable dispatch sort, the combine summed in
    expert order: no atomics decide a value).  The prefill's tokens share a
    direction, as a layer's activations do, so experts overflow and drop;
    the decode's capacity of 8 never drops."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.models.config import LOCAL

    cfg = get_config("qwen3-moe-235b-a22b")
    layer = moe.MoE(torch.Generator(device=card).manual_seed(0), cfg, card)
    gen = torch.Generator(device=card).manual_seed(1)
    base = torch.randn(cfg.d_model, generator=gen, device=card)
    for shape in ((1, 2048), (4, 1)):
        x = (2.0 * base + torch.randn(*shape, cfg.d_model, generator=gen,
                                      device=card)).to(torch.bfloat16)
        a, met_a = moe.moe_apply(layer, cfg, x, LOCAL)
        b, met_b = moe.moe_apply(layer, cfg, x, LOCAL)
        torch.cuda.synchronize()
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert all(torch.equal(u, v) for u, v in zip(met_a, met_b))
        assert bool(torch.isfinite(a).all())
        dropped = float(met_a.dropped_frac)
        assert (0.0 < dropped < 1.0) if shape[1] > 1 else dropped == 0.0


# ---------------------------------------------------------------------------
# training: the kernels under autograd at the train phase's shapes
# ---------------------------------------------------------------------------
def _qkv_views(dev, s=4096, h=32, d=64):
    """q, k, v as the training path may hand them over: strided views into
    one (B, S, 3, H, D) bf16 tensor that requires grad (rows 16-byte
    aligned, last dimension contiguous)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.randn(1, s, 3, h, d, generator=gen, device=dev)
    base = base.to(torch.bfloat16).requires_grad_(True)
    return base, [base[:, :, i] for i in range(3)]


@pytest.mark.cuda
def test_flash_attention_trains_at_4096_tokens(card):
    """The kernel forward at train_4k's 4096 tokens on non-contiguous
    grad-mode views (within the per-row tolerance of the plain forward),
    one launch, and the gradient of the plain chunked version bit for bit
    (the Function's backward recomputes it on the same inputs)."""
    from repro_torch.models.attention import chunked_mha

    base, (q, k, v) = _qkv_views(card)
    assert not q.is_contiguous()
    spec = MaskSpec(causal=True)
    before = attention_cuda.LAUNCHES["FLASH_ATTENTION"]
    out = chunked_mha(q, k, v, spec, q_chunk=1024, kv_chunk=1 << 30,
                      template="CUDA")
    assert attention_cuda.LAUNCHES["FLASH_ATTENTION"] == before + 1
    assert out.grad_fn is not None
    want = chunked_mha(q, k, v, spec, q_chunk=1024, kv_chunk=1 << 30,
                       template="TORCH")
    assert _share_of_tolerance(out.detach(), want.detach(),
                               torch.bfloat16) <= 1.0
    g = torch.randn_like(out)
    (got,) = torch.autograd.grad(out, base, g)
    (ref,) = torch.autograd.grad(want, base, g)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES["FLASH_ATTENTION"] == before + 1
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_ssd_intra_trains_at_32_chunks(card):
    """SSD_INTRA at nc = 32 (train_4k's 4096 tokens in chunks of 128) with
    grad-mode inputs: within 1e-4 of the plain forward, one launch, and the
    plain version's gradient bit for bit."""
    from repro_torch.kernels import ops

    bsz, nc, l, g, r, p, n = 1, 32, 128, 1, 64, 64, 64
    gen = torch.Generator(device=card).manual_seed(9)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=card)
    args = [rnd(bsz, nc, l, g, r, p),
            -torch.nn.functional.softplus(rnd(bsz, nc, l, g, r)),
            torch.nn.functional.softplus(rnd(bsz, nc, l, g, r)),
            rnd(bsz, nc, l, g, n), rnd(bsz, nc, l, g, n),
            rnd(bsz, nc, g, r, n, p) * 0.3]
    args = [a.requires_grad_(True) for a in args]
    before = ssd_cuda.LAUNCHES["SSD_INTRA"]
    y = ops.ssd_intra(*args, template="CUDA")
    want = ops.ssd_intra(*args, template="TORCH")
    assert ssd_cuda.LAUNCHES["SSD_INTRA"] == before + 1
    tol = 1e-4 * max(1.0, float(want.detach().abs().max()))
    assert float((y - want).detach().abs().max()) <= tol
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, args, gy)
    ref = torch.autograd.grad(want, args, gy)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3-8b"])
def test_smoke_model_gradients_on_the_cuda_template(card, arch, remat):
    """A float32 smoke model's loss and gradients on the CUDA template (the
    kernels forward, the plain versions' gradients) against the TORCH
    template: 1e-4 of each leaf's largest gradient, every non-zero leaf
    non-zero, and each kernel launched twice a region (the remat policy's
    recompute reruns the forward)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, smoke
    from repro_torch.models import model

    cfg = dataclasses.replace(smoke(get_config(arch), layers=4),
                              remat=remat)
    lm = model.init_params(cfg, 0, device=card).requires_grad_(True)
    gen = torch.Generator(device=card).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), device=card,
                         generator=gen)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}
    grads, losses = {}, {}
    for tmpl in ("CUDA", "TORCH"):
        attention_cuda.reset_launches()
        ssd_cuda.reset_launches()
        for p in lm.parameters():
            p.grad = None
        loss, _ = model.loss_fn(lm, cfg, batch, template=tmpl)
        loss.backward()
        torch.cuda.synchronize()
        losses[tmpl] = float(loss.detach())
        grads[tmpl] = {n: p.grad.clone() for n, p in lm.named_parameters()}
        n_attn = cfg.num_layers // (cfg.attn_every or 1)
        n_ssd = cfg.num_layers if cfg.family == "hybrid" else 0
        launched = (attention_cuda.LAUNCHES["FLASH_ATTENTION"],
                    ssd_cuda.LAUNCHES["SSD_INTRA"])
        assert launched == ((2 * n_attn, 2 * n_ssd) if tmpl == "CUDA"
                            else (0, 0))
    assert abs(losses["CUDA"] - losses["TORCH"]) <= 1e-5 * losses["TORCH"]
    for name, want in grads["TORCH"].items():
        got = grads["CUDA"][name]
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * max(scale, 1e-30), \
            name
        assert (scale == 0) or float(got.abs().max()) > 0, name
