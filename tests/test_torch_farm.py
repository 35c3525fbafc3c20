"""The port's simulation farm, on the CPU with the ``torch`` backend.

Within the port (the reference's own contract, ``tests/test_sim_farm.py``):
a farm slot equals a serial run of the same request bitwise — with
heterogeneous viscosity, time step and lid speed in one batch, with as
many slots as z-cells (a per-slot scalar broadcast onto the wrong axis
could not hide), for ``fused_sweeps`` 1 and 2 — and so do chunked stepping
and an evicted-then-readmitted run.  Against the reference farm (jnp
backend) on the same requests: the same admission order, the same
``steps_done`` and ``terminated``, fields within RUN_RTOL (1e-4, as in
``tests/test_torch_solver.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro.cfd import cavity as ref_cavity
from repro.sim import SimulationFarm as RefFarm

from repro_torch import convert
from repro_torch.cfd import cavity, taylor_green
from repro_torch.cfd.ns3d import NavierStokes3D
from repro_torch.sim import (
    EnsembleExecutor, SimulationFarm, SimulationService,
    compile_cache_stats, reset_compile_cache,
)

N, NZ, SLOTS = 8, 4, 4          # SLOTS == NZ on purpose
KW = dict(nz=NZ, jacobi_iters=10)
FIELDS = ("vx", "vy", "vz", "p")
RUN_RTOL = 1e-4
# (re, lid speed, steps): dt follows re through the CFL bound, so nu, dt and
# the lid differ per slot; six sims through four slots reclaim mid-flight
SIMS = ((50.0, 1.0, 5), (100.0, 0.5, 7), (200.0, 2.0, 4), (400.0, 1.5, 6),
        (800.0, 1.0, 3), (150.0, 0.75, 8))


def _request(re, lid, steps, **kw):
    return cavity.sim_request(N, re=re, lid_velocity=lid, steps=steps,
                              **{**KW, **kw})


@functools.lru_cache(maxsize=None)
def _serial(config, steps):
    """The serial workflow: one solver, its make_step loop."""
    solver = NavierStokes3D(config, "cpu")
    state = solver.init_state()
    step = solver.make_step()
    for _ in range(steps):
        state = step(state)
    return state


def _assert_bitwise(got: dict, want: dict, what=""):
    for f in FIELDS:
        assert torch.equal(got[f], want[f]), f"{what} field {f}"


@pytest.mark.parametrize("fused_sweeps", [1, 2])
def test_farm_slots_equal_serial_runs_bitwise(fused_sweeps):
    kw = dict(fused_sweeps=fused_sweeps)
    farm = SimulationFarm(cavity.config(N, **KW, **kw), n_slots=SLOTS,
                          device="cpu")
    reqs = [_request(*sim, **kw) for sim in SIMS]
    sids = [farm.submit(r) for r in reqs]
    results = farm.run_until_drained()
    total = sum(r.steps for r in reqs)
    assert max(r.steps for r in reqs) <= farm.device_steps < total
    for sid, req in zip(sids, reqs):
        res = results[sid]
        assert (res.steps_done, res.terminated) == (req.steps, "steps")
        assert all(t.device.type == "cpu" for t in res.state.values())
        _assert_bitwise(res.state, _serial(req.config, req.steps), f"sid {sid}")


def test_taylor_green_mixed_viscosity_and_dt_bitwise():
    base = taylor_green.config(N, nz=3, nu=0.1, jacobi_iters=10)
    farm = SimulationFarm(base, n_slots=3, device="cpu")
    reqs = [taylor_green.sim_request(N, nz=3, nu=nu, steps=4, jacobi_iters=10)
            for nu in (0.1, 0.2, 0.4)]
    assert len({r.config.dt for r in reqs}) == 3
    sids = [farm.submit(r) for r in reqs]
    results = farm.run_until_drained()
    for sid, req in zip(sids, reqs):
        _assert_bitwise(results[sid].state, _serial(req.config, req.steps))


def test_chunked_stepping_equals_single_stepping():
    def drive(max_chunk):
        farm = SimulationFarm(cavity.config(N, **KW), n_slots=SLOTS,
                              device="cpu")
        sids = [farm.submit(_request(*sim)) for sim in SIMS]
        while farm.step(max_chunk=max_chunk):
            pass
        return farm, {s: farm.results[s] for s in sids}

    chunked, a = drive(None)
    single, b = drive(1)
    assert chunked.device_steps == single.device_steps
    for sid in a:
        assert a[sid].steps_done == b[sid].steps_done
        _assert_bitwise(a[sid].state, b[sid].state, f"sid {sid}")


def test_evict_readmit_equals_an_uninterrupted_run():
    svc = SimulationService(cavity.config(N, **KW), n_slots=2, device="cpu")
    a = svc.submit(_request(100.0, 1.0, 9))
    b = svc.submit(_request(300.0, 0.5, 9))
    c = svc.submit(_request(200.0, 1.0, 3))
    assert svc.poll(c)["status"] == "queued"
    svc.run(4)
    assert svc.poll(a) == {"status": "running", "steps_done": 4}
    assert svc.evict(a) and not svc.evict(a)
    assert svc.poll(a) == {"status": "evicted", "steps_done": 4}
    svc.run(1)
    assert svc.poll(c)["status"] == "running"
    ra = svc.result(a)
    assert ra.steps_done == 9
    _assert_bitwise(ra.state, _serial(_request(100.0, 1.0, 9).config, 9))
    assert svc.result(b).steps_done == 9
    assert svc.poll(c)["status"] == "done"
    with pytest.raises(KeyError):
        svc.poll(10_000)


def test_one_step_cache_entry_per_static_signature():
    reset_compile_cache()
    base = cavity.config(N, **KW)
    farm = SimulationFarm(base, n_slots=SLOTS, device="cpu")
    solver = farm.exec.solver
    for re in (70.0, 120.0, 180.0, 220.0, 260.0):
        farm.submit(_request(re, 1.0, 2))
    farm.run_until_drained()
    assert compile_cache_stats() == {"hits": 0, "misses": 1, "entries": 1}
    # admitting new physics built nothing: same solver, same step
    assert farm.exec.solver is solver
    again = SimulationFarm(base, n_slots=SLOTS, device="cpu")
    assert again.exec.solver is solver and again.exec._run_k is farm.exec._run_k
    assert compile_cache_stats()["hits"] == 1
    SimulationFarm(base, n_slots=2, device="cpu")      # another slot count
    assert compile_cache_stats()["misses"] == 2
    with pytest.raises(ValueError, match="static config"):
        farm.submit(_request(100.0, 1.0, 2, jacobi_iters=33))


def test_failing_admission_fails_that_sid_alone():
    farm = SimulationFarm(cavity.config(N, **KW), n_slots=2, device="cpu")
    good = farm.submit(_request(100.0, 1.0, 3))
    bad_req = _request(200.0, 1.0, 3)
    fresh = EnsembleExecutor(bad_req.config, 1, device="cpu")._fresh
    bad_req.init_state = {k: v[:-1] for k, v in fresh.items()}   # mis-shaped
    bad = farm.submit(bad_req)
    later = farm.submit(_request(400.0, 1.0, 2))
    results = farm.run_until_drained()
    assert results[bad].terminated == "failed"
    assert "shape" in results[bad].error and results[bad].state == {}
    for sid, (re, steps) in ((good, (100.0, 3)), (later, (400.0, 2))):
        assert results[sid].terminated == "steps"
        _assert_bitwise(results[sid].state,
                        _serial(_request(re, 1.0, steps).config, steps))
    with pytest.raises(ValueError, match="already submitted"):
        farm.submit(bad_req)


def test_write_read_clear_slots():
    ex = EnsembleExecutor(cavity.config(N, **KW), 3, device="cpu")
    params = dict(nu=0.02, dt=1e-3, lid_velocity=0.5, fx=0.0, fy=0.1, fz=0.0)
    state = {k: torch.full_like(v, 2.0) for k, v in ex._fresh.items()}
    ex.write_slot(1, params, state)
    out = ex.read_slot(1)
    assert torch.equal(out["p"], state["p"])
    assert ex.params["lid_velocity"][1] == np.float32(0.5)
    ex.state["p"][1].zero_()                 # the copy shares no memory
    assert torch.equal(out["p"], state["p"])
    ex.clear_slot(1)
    assert ex.params["dt"][1] == np.float32(ex.config.dt)
    assert ex.params["nu"][1] == 0.0


# -- against the reference farm -------------------------------------------------
def _both(reqs_kw, n_slots, check_every=16):
    """The same requests through the reference farm (jnp) and the port's
    (torch backend); returns both farms and the sids (equal in both)."""
    ref = RefFarm(ref_cavity.config(N, **KW), n_slots=n_slots,
                  check_steady_every=check_every)
    port = SimulationFarm(cavity.config(N, **KW), n_slots=n_slots,
                          check_steady_every=check_every, device="cpu")
    sids = []
    for kw in reqs_kw:
        r = ref_cavity.sim_request(N, **KW, **kw)
        sid = ref.submit(r)
        assert port.submit(convert.request_from_numpy(r)) == sid
        sids.append(sid)
    ref.run_until_drained()
    port.run_until_drained()
    return ref, port, sids


def _close(got: dict, want: dict, rtol: float):
    vel = max(float(np.abs(np.asarray(want[f])).max()) for f in ("vx", "vy", "vz"))
    for f in FIELDS:
        w = np.asarray(want[f])
        scale = float(np.abs(w).max()) if f == "p" else vel
        assert float(np.abs(got[f] - w).max()) <= rtol * scale, f


def test_admission_order_matches_reference_under_two_level_priority():
    prios = (0, 1, 0, 2, 1, 0)
    ref, port, sids = _both([dict(re=100.0 + 50 * i, steps=2, priority=p)
                             for i, p in enumerate(prios)], n_slots=1)
    # one slot: results land in admission order
    assert list(port.results) == list(ref.results)
    assert list(port.results) == [3, 1, 4, 0, 2, 5]


def test_termination_and_fields_match_reference():
    reqs = [dict(re=100.0, steps=400, residual_tol=5.0),
            dict(re=400.0, steps=6), dict(re=200.0, steps=11)]
    ref, port, sids = _both(reqs, n_slots=2, check_every=4)
    assert ref.results[0].terminated == "residual"
    for sid in sids:
        a = convert.result_to_numpy(port.results[sid])
        b = ref.results[sid]
        assert (a.steps_done, a.terminated) == (b.steps_done, b.terminated)
        _close(a.state, b.state, RUN_RTOL)
    assert port.device_steps == ref.device_steps


def test_request_from_numpy_carries_the_reference_request():
    r = ref_cavity.sim_request(N, re=250.0, steps=7, priority=2,
                               residual_tol=0.5, lid_velocity=0.3, **KW)
    got = convert.request_from_numpy(r, template="TORCH")
    for f in ("steps", "tag", "steady_tol", "residual_tol", "priority", "step0"):
        assert getattr(got, f) == getattr(r, f), f
    want = dataclasses.replace(cavity.config(N, re=250.0, lid_velocity=0.3,
                                             **KW), template="TORCH")
    assert got.config == want
