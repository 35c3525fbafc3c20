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
from repro_torch.kernels import jacobi_cuda, stencil3d, stencil3d_cuda

# max|kernel - plain| <= 1e-5 * max(1, max|plain|): the same float32
# expression, with FMA contraction in the kernel only
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
