"""The port's Navier-Stokes solver against the reference, on the CPU.

Per-step parity: both packages step the same state (carried across with
``repro_torch.convert``) and must agree to max|Δ| ≤ 1e-5·max|field| after
one step and 1e-4·max|field| after ten free-running steps — each step runs
40-60 Jacobi sweeps, and XLA and eager torch round their float32 sums in
different orders.  Then the reference's own physics bounds
(``tests/test_cfd.py``) are run on the port.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_harness import seeded  # installs the shim

import jax.numpy as jnp

from repro.cfd import cavity as ref_cavity
from repro.cfd import ns3d as ref_ns3d
from repro.sim import scenarios as ref_scenarios

from repro_torch import convert
from repro_torch.cfd import cavity, ns3d, taylor_green
from repro_torch.sim import scenarios

STEP_RTOL = 1e-5
RUN_RTOL = 1e-4
CASES = {"cavity": dict(n=12, nz=4),
         "taylor_green": dict(n=12, nz=4, jacobi_iters=40),
         "kelvin_helmholtz": dict(n=12, nz=4, jacobi_iters=40)}


def _close(got: dict, want: dict, rtol: float):
    """max|Δ| ≤ rtol·scale, the scale being max|u| over the three velocity
    components (a component that stays ~0, like the cavity's vz, is held to
    the flow's speed) and max|p| for the pressure."""
    vel = max(float(np.abs(np.asarray(want[f])).max()) for f in ("vx", "vy", "vz"))
    for f in ("vx", "vy", "vz", "p"):
        w = np.asarray(want[f])
        scale = float(np.abs(w).max()) if f == "p" else vel
        err = float(np.abs(got[f] - w).max())
        assert err <= rtol * scale, f"{f}: max|Δ| {err} > {rtol} * {scale}"


def _pair(case, template, **over):
    """Reference solver + its initial state, and the port's solver."""
    kw = dict(CASES[case], **over)
    n = kw.pop("n")
    ref_sc = ref_scenarios.get_scenario(case)
    rsolver = ref_ns3d.NavierStokes3D(ref_sc.config(n, **kw))
    rstate = ref_sc.initial_state(rsolver)
    cfg = scenarios.get_scenario(case).config(n, template=template, **kw)
    solver = ns3d.NavierStokes3D(cfg, device="cpu")
    return rsolver, rstate, solver


def _host(state: dict) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def _reference_path(case: str, **over):
    """The reference's states s0..s3 (one step apart) and s13 (ten more),
    compiled and stepped once per case for every test that reads them."""
    rsolver, rstate, _ = _pair(case, "TORCH", **over)
    rstep = rsolver.make_step()
    path = [_host(rstate)]
    for _ in range(3):
        rstate = rstep(rstate)
        path.append(_host(rstate))
    for _ in range(10):
        rstate = rstep(rstate)
    return rsolver, path, _host(rstate)


@pytest.mark.parametrize("template", ["TORCH", "CUDA"])
@pytest.mark.parametrize("case", list(CASES))
def test_step_parity_with_reference(case, template):
    _, path, end = _reference_path(case)
    step = _pair(case, template)[2].make_step()
    # one step from the same state, three times along the reference path
    for before, after in zip(path, path[1:]):
        got = step(convert.state_from_numpy(before, "cpu"))
        _close(convert.state_to_numpy(got), after, STEP_RTOL)
    # ten free-running steps from there
    state = convert.state_from_numpy(path[-1], "cpu")
    for _ in range(10):
        state = step(state)
    _close(convert.state_to_numpy(state), end, RUN_RTOL)


def test_step_parity_with_overlap_and_fused_sweeps():
    over = dict(overlap=True, fused_sweeps=2)
    _, path, _ = _reference_path("taylor_green", **over)
    step = _pair("taylor_green", "TORCH", **over)[2].make_step()
    got = step(convert.state_from_numpy(path[0], "cpu"))
    _close(convert.state_to_numpy(got), path[1], STEP_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_initial_state_and_params_match_reference(case):
    rsolver, rstate, solver = _pair(case, "TORCH")
    state = scenarios.get_scenario(case).initial_state(solver)
    assert set(state) == set(rstate)
    for k in ("mask_vx", "mask_vy", "mask_vz", "p", "vz"):
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(rstate[k]))
    for k in ("vx", "vy"):    # sin/cos/tanh of float32: ulp-level
        np.testing.assert_allclose(state[k].numpy(), np.asarray(rstate[k]),
                                   rtol=1e-6, atol=1e-6)
    for a, b in zip(solver.driver.coords(), rsolver.driver.coords()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    p = ns3d.params_from_config(solver.config, "cpu")
    rp = ref_ns3d.params_from_config(rsolver.config)
    assert tuple(p) == ns3d.PARAM_KEYS == ref_ns3d.PARAM_KEYS
    for k in p:
        assert p[k].dtype == torch.float32 and p[k].dim() == 0
        assert p[k].item() == float(rp[k])
    assert ns3d.HEALTH_DIAGS == ref_ns3d.HEALTH_DIAGS
    assert ns3d.PERIODIC_CASES == ref_ns3d.PERIODIC_CASES


def test_health_and_analysis_match_reference():
    rsolver, path, _ = _reference_path("taylor_green")
    solver = _pair("taylor_green", "TORCH")[2]
    rstate = {k: jnp.asarray(v) for k, v in path[1].items()}
    state = convert.state_from_numpy(path[1], "cpu")
    want = rsolver.health_report(rstate)
    got = solver.health_report(state)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(solver.kinetic_energy(state),
                               rsolver.kinetic_energy(rstate), rtol=1e-6)
    np.testing.assert_allclose(solver.divergence_of(state).numpy(),
                               np.asarray(rsolver.divergence_of(rstate)),
                               rtol=1e-5, atol=1e-6)


def test_global_mean_uses_sequential_axis_sums():
    solver = ns3d.NavierStokes3D(cavity.config(6, nz=4), device="cpu")
    x = torch.from_numpy(seeded((6, 6, 4), 9))
    want = x.sum(-1).sum(-1).sum(-1) / 144.0
    assert torch.equal(solver._global_mean(x), want)
    batched = torch.stack([x, 2 * x])
    assert torch.equal(solver._global_mean(batched)[0], want)


def test_ghia_errors_match_reference_on_the_same_state():
    rng = np.random.RandomState(3)
    state = {f: rng.randn(16, 16, 4).astype(np.float32) * 0.2
             for f in ("vx", "vy")}
    solver = ns3d.NavierStokes3D(cavity.config(16), device="cpu")
    rsolver = ref_ns3d.NavierStokes3D(ref_cavity.config(16))
    got = cavity.ghia_errors(solver, convert.state_from_numpy(state, "cpu"))
    assert got == ref_cavity.ghia_errors(rsolver, state)


# -- the reference's own bounds (tests/test_cfd.py), on the port ----------
class TestTaylorGreenBounds:
    @pytest.fixture(scope="class")
    def result(self):
        return taylor_green.run(n=32, steps=50, nu=0.1, overlap=False,
                                device="cpu")

    def test_tracks_analytic_solution(self, result):
        assert result["err_vx"] < 5e-3
        assert result["err_vy"] < 5e-3

    def test_energy_decay_rate(self, result):
        assert result["energy_rel_err"] < 5e-3

    def test_divergence_free(self, result):
        assert result["div_max"] < 1e-3

    def test_overlap_equals_plain(self):
        a = taylor_green.run(n=16, steps=10, nu=0.1, overlap=False, device="cpu")
        b = taylor_green.run(n=16, steps=10, nu=0.1, overlap=True, device="cpu")
        assert abs(a["energy"] - b["energy"]) < 1e-7
        assert abs(a["err_vx"] - b["err_vx"]) < 1e-6

    def test_fused_jacobi_matches_plain(self):
        a = taylor_green.run(n=16, steps=10, nu=0.1, fused_sweeps=1,
                             jacobi_iters=40, device="cpu")
        b = taylor_green.run(n=16, steps=10, nu=0.1, fused_sweeps=2,
                             jacobi_iters=40, device="cpu")
        # same sweep count, different padding schedule -> same physics
        assert abs(a["energy"] - b["energy"]) / a["energy"] < 1e-5


class TestCavityBounds:
    @pytest.fixture(scope="class")
    def run(self):
        return cavity.run(n=16, t_end=0.5, jacobi_iters=40, device="cpu")

    def test_wall_faces_stay_zero(self, run):
        _, state, _ = run
        np.testing.assert_array_equal(state["vx"][-1, :, :].numpy(), 0.0)
        np.testing.assert_array_equal(state["vy"][:, -1, :].numpy(), 0.0)

    def test_divergence_stays_small(self, run):
        solver, state, _ = run
        assert float(solver.divergence_of(state).abs().max()) < 0.05

    def test_lid_drags_fluid(self, run):
        solver, state, _ = run
        for f in ("vx", "vy", "vz", "p"):
            assert bool(torch.isfinite(state[f]).all()), f
        _, u = cavity.centerline_u(solver, state)
        assert u[-1] > 0.1
        assert solver.kinetic_energy(state) > 1e-4
