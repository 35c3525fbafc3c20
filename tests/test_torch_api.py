"""The port's front door against the reference's, on the CPU.

``repro_torch.api.runtime(n=16, device="cpu").run(...)`` and
``repro.api.runtime(n=16).run(...)`` must report the same diagnostics
within float32 tolerance (max|Δ| ≤ 1e-4·max|field| after the run's steps,
diagnostics to rtol 1e-4), and the port must never fall back to the CPU
when the card is asked for.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro import api as ref_api
from repro.core import schedule as ref_schedule
from repro.sim import scenarios as ref_scenarios

from repro_torch import api, convert
from repro_torch.core import schedule
from repro_torch.device import resolve_device
from repro_torch.sim import scenarios

RTOL = 1e-4
RUNS = {
    "cavity": dict(steps=6, re=100.0),
    "taylor_green": dict(steps=6, nu=0.1, jacobi_iters=40),
    "kelvin_helmholtz": dict(steps=6, jacobi_iters=40),
}


@functools.lru_cache(maxsize=None)
def _runs(name):
    kw = RUNS[name]
    want = ref_api.runtime(n=16).run(name, **kw)
    got = api.runtime(n=16, device="cpu").run(name, **kw)
    return got, want


def _flat(x):
    if isinstance(x, dict):
        return {k: _flat(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [np.asarray(v, np.float64) for v in x]
    return float(x)


@pytest.mark.parametrize("name", list(RUNS))
def test_run_diagnostics_match_reference(name):
    got, want = _runs(name)
    assert got.steps_done == want.steps_done and got.terminated == want.terminated
    assert got.config.template == "TORCH"
    g, w = _flat(got.diagnostics), _flat(want.diagnostics)
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], dict):
            for kk in w[k]:
                np.testing.assert_allclose(g[k][kk], w[k][kk], rtol=RTOL,
                                           atol=1e-7, err_msg=f"{k}.{kk}")
        elif isinstance(w[k], list):
            for a, b in zip(g[k], w[k]):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", list(RUNS))
def test_run_state_matches_reference(name):
    got, want = _runs(name)
    host = convert.state_to_numpy(got.state)
    vel = max(float(np.abs(np.asarray(want.state[f])).max())
              for f in ("vx", "vy", "vz"))
    for f in ("vx", "vy", "vz", "p"):
        w = np.asarray(want.state[f])
        scale = float(np.abs(w).max()) if f == "p" else vel
        assert float(np.abs(host[f] - w).max()) <= RTOL * scale, f
    assert all(t.device.type == "cpu" for t in got.state.values())


def test_residual_termination_matches_reference():
    kw = dict(steps=400, residual_tol=5.0, jacobi_iters=20)
    want = ref_api.runtime(n=8, check_every=4).run("cavity", **kw)
    got = api.runtime(n=8, device="cpu", check_every=4).run("cavity", **kw)
    assert want.terminated == "residual"
    assert (got.terminated, got.steps_done) == (want.terminated, want.steps_done)


def test_analyze_recomputes_the_diagnostics():
    rt = api.runtime(n=16, device="cpu")
    got, _ = _runs("cavity")
    again = rt.analyze(got)
    np.testing.assert_allclose(again["kinetic_energy"],
                               got.diagnostics["kinetic_energy"], rtol=1e-6)
    assert again["ghia"] == got.diagnostics["ghia"]


# -- no fallback ------------------------------------------------------------
def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        api.runtime(n=8)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    from repro_torch.cfd import cavity

    with pytest.raises(RuntimeError, match="cuda"):
        cavity.run(n=8, t_end=0.1)


def test_cuda_backend_on_the_cpu_raises():
    rt = api.runtime(n=8, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        rt.run("cavity", steps=1)
    with pytest.raises(ValueError, match="unknown backend"):
        api.runtime(n=8, backend="pallas", device="cpu")


def test_backend_resolution_mirrors_the_reference():
    assert set(api.BACKENDS) == {"torch", "cuda", "auto"}
    assert api._resolve_backend("auto", torch.device("cpu")) == ("TORCH", None)
    assert api._resolve_backend("auto", torch.device("cuda")) == ("CUDA", False)
    assert api._resolve_backend("cuda", torch.device("cuda", 0)) == \
        (api.BACKENDS["cuda"][0], ref_api.BACKENDS["pallas"][2])
    cfg = api.runtime(n=8, device="cpu", nz=6, jacobi_iters=7).configure(
        "cavity", re=50.0)
    ref_cfg = ref_api.runtime(n=8, nz=6, jacobi_iters=7).configure(
        "cavity", re=50.0)
    for f in ("shape", "extent", "nu", "dt", "case", "lid_velocity",
              "forcing", "jacobi_iters", "jacobi_omega", "fused_sweeps",
              "overlap"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f
    assert cfg.template == "TORCH"


# -- schedule and registry ----------------------------------------------------
def test_schedule_order_matches_reference():
    def build(mod):
        s = mod.Schedule()
        for name, before, after in [("c", (), ("a",)), ("a", (), ()),
                                    ("b", ("c",), ("a",)), ("d", (), ())]:
            s.register("EVOLVE", name, before=before, after=after)(
                lambda st, n=name: st + [n])
        return s

    ours, ref = build(schedule), build(ref_schedule)
    assert ours.names("EVOL") == ref.names("EVOL")
    assert ours.compile_bin("EVOLVE")([]) == ref.compile_bin("EVOLVE")([])
    assert schedule.BIN_ALIASES == ref_schedule.BIN_ALIASES
    with pytest.raises(schedule.ScheduleError):
        schedule.canonical_bin("NOPE")


def test_enabled_telemetry_times_the_schedule_as_the_reference_does():
    """The instrumented bin runs what the plain one runs, and records the
    reference's timer tree: the bin's section over one section a routine,
    each entered once a call."""
    from repro import obs as ref_obs
    from repro_torch import obs

    def build(mod):
        s = mod.Schedule()
        for name in ("a", "b"):
            s.register("EVOLVE", name)(lambda st, n=name: st + [n])
        return s

    ours, ref = build(schedule), build(ref_schedule)
    tel, ref_tel = obs.telemetry(), ref_obs.telemetry()
    assert ours.compile_bin("EVOLVE", telemetry=obs.NULL)([]) == ["a", "b"]
    for _ in range(2):
        assert ours.compile_bin("EVOLVE", telemetry=tel)([]) == \
            ref.compile_bin("EVOLVE", telemetry=ref_tel)([])

    def shape(tree):
        return {k: (v["count"], shape(v["children"])) for k, v in tree.items()}

    assert shape(tel.timers.snapshot()) == shape(ref_tel.timers.snapshot()) \
        == {"schedule.EVOL": (2, {"a": (2, {}), "b": (2, {})})}


def test_scenario_registry_matches_reference():
    assert scenarios.scenario_names() == ref_scenarios.scenario_names()
    for name in scenarios.scenario_names():
        a, b = scenarios.get_scenario(name), ref_scenarios.get_scenario(name)
        assert dict(a.params) == {k: scenarios.ParamSpec(v.default, v.doc)
                                  for k, v in b.params.items()}
        assert list(a.analyses) == list(b.analyses)
        assert a.split_kwargs({"delta": 0.3, "nu": 0.1}) == \
            b.split_kwargs({"delta": 0.3, "nu": 0.1})
    with pytest.raises(scenarios.UnknownScenarioError):
        scenarios.get_scenario("nope")


def test_convert_round_trip_is_bitwise():
    rng = np.random.RandomState(0)
    arrays = {f: rng.randn(4, 5, 3).astype(np.float32) for f in ("vx", "p")}
    state = convert.state_from_numpy(arrays, "cpu")
    back = convert.state_to_numpy(state)
    for f in arrays:
        assert state[f].dtype == torch.float32 and state[f].is_contiguous()
        np.testing.assert_array_equal(back[f], arrays[f])
    params = convert.params_from_numpy({"nu": np.float32(0.1), "dt": 2.5e-3}, "cpu")
    assert params["nu"].dim() == 0 and params["nu"].item() == float(np.float32(0.1))
    assert params["dt"].item() == float(np.float32(2.5e-3))


# -- the farm verbs ---------------------------------------------------------------
FARM = dict(n=8, nz=4, n_slots=2, check_every=4, jacobi_iters=10)
SUBMITS = (dict(steps=9, re=100.0), dict(steps=400, re=150.0, residual_tol=5.0),
           dict(steps=5, re=400.0, priority=1), dict(steps=7, re=250.0))


def _drive(rt):
    """submit / poll / evict / readmit / drain, the same calls on either
    package's runtime; returns the sids, the polls and the drained results."""
    sids = [rt.submit("cavity", **kw) for kw in SUBMITS]
    polls = [rt.poll(sids[0])["status"]]
    rt.services()[0].run(3)
    polls.append(rt.poll(sids[0]))
    assert rt.evict(sids[0]) and not rt.evict(10_000)
    polls.append(rt.poll(sids[0]))
    assert rt.readmit(sids[0]) and not rt.readmit(sids[0])
    return sids, polls, rt.drain()


@functools.lru_cache(maxsize=None)
def _farm_runs():
    want = _drive(ref_api.runtime(**FARM))
    got = _drive(api.runtime(device="cpu", **FARM))
    return got, want


def test_farm_verbs_match_the_reference_runtime():
    (sids, polls, out), (rsids, rpolls, rout) = _farm_runs()
    assert sids == rsids and polls == rpolls
    assert polls[1:] == [{"status": "running", "steps_done": 3},
                         {"status": "evicted", "steps_done": 3}]
    assert set(out) == set(rout) == set(sids)
    for sid in sids:
        a, b = convert.result_to_numpy(out[sid]), rout[sid]
        assert (a.steps_done, a.terminated, a.tag) == \
            (b.steps_done, b.terminated, b.tag)
        vel = max(float(np.abs(np.asarray(b.state[f])).max())
                  for f in ("vx", "vy", "vz"))
        for f in ("vx", "vy", "vz", "p"):
            w = np.asarray(b.state[f])
            scale = float(np.abs(w).max()) if f == "p" else vel
            assert float(np.abs(a.state[f] - w).max()) <= RTOL * scale, (sid, f)
    assert out[sids[1]].terminated == "residual"


def test_farm_results_equal_serial_runs_bitwise():
    (sids, _, out), _ = _farm_runs()
    rt = api.runtime(device="cpu", **FARM)
    for sid, kw in zip(sids, SUBMITS):
        if "residual_tol" in kw:
            continue
        serial = rt.run("cavity", **{k: v for k, v in kw.items()
                                     if k != "priority"})
        for f in ("vx", "vy", "vz", "p"):
            assert torch.equal(out[sid].state[f], serial.state[f]), (sid, f)
    again = rt.analyze(rt.result(rt.submit("cavity", steps=3, re=100.0)))
    assert set(again) == {"ghia", "centerline_u", "kinetic_energy"}


def test_scenario_initial_fields_ride_the_request():
    rt = api.runtime(n=8, nz=2, device="cpu", jacobi_iters=10)
    sid = rt.submit("kelvin_helmholtz", steps=3, eps=0.1)
    serial = rt.run("kelvin_helmholtz", steps=3, eps=0.1)
    res = rt.result(sid)
    assert res.tag == "kelvin_helmholtz-8"
    for f in ("vx", "vy", "vz", "p"):
        assert torch.equal(res.state[f], serial.state[f]), f
    ref = ref_scenarios.get_scenario("kelvin_helmholtz").request(8, steps=3, nz=2)
    got = scenarios.get_scenario("kelvin_helmholtz").request(8, steps=3, nz=2)
    assert set(got.init_state) == set(ref.init_state)
    np.testing.assert_allclose(got.init_state["vx"].numpy(),
                               ref.init_state["vx"], rtol=1e-6, atol=1e-6)


def test_a_failed_signature_resolves_to_failed(monkeypatch):
    real = api.SimulationService

    def picky(cfg, **kw):
        if cfg.shape[2] == 6:
            raise ValueError("this farm cannot be built")
        return real(cfg, **kw)

    monkeypatch.setattr(api, "SimulationService", picky)
    rt = api.runtime(n=8, nz=4, device="cpu", jacobi_iters=10)
    ok = rt.submit("cavity", steps=2)
    bad = rt.submit("cavity", steps=2, nz=6)
    # the reference resolves an unbuildable signature the same way
    ref_rt = ref_api.runtime(n=8, decomposition=((0, "shard"),))
    ref_bad = ref_rt.submit("cavity", steps=2)
    for runtime, sid in ((rt, bad), (ref_rt, ref_bad)):
        poll = runtime.poll(sid)
        assert poll["status"] == "failed" and poll["steps_done"] == 0
        with pytest.raises(RuntimeError, match="failed"):
            runtime.result(sid)
        assert runtime.drain()[sid].terminated == "failed"
    assert "cannot be built" in rt.poll(bad)["error"]
    assert rt.drain()[ok].terminated == "steps"


# a job store on a mesh is global rank 0's (tests/test_torch_durable_mesh.py
# runs it in 4 ranks); here, where no process group is up, a store changes
# nothing about how a mesh posture fails
@pytest.mark.parametrize("posture", [
    pytest.param(dict(mesh_shape=(2,), mesh_axes=("shard",)),
                 id="mesh_shape"),
    pytest.param(dict(mesh_shape=(2,), mesh_axes=("shard",),
                      decomposition=((0, "shard"),)), id="decomposition"),
    pytest.param(dict(mesh=object()), id="stub_mesh")])
def test_a_store_changes_nothing_of_how_a_mesh_posture_fails(posture,
                                                             tmp_path):
    """Without a process group ``mesh_shape`` raises the same error with a
    store as without one; a stub mesh builds, and its farm fails the
    request the same way, the store recording the failed row."""
    def outcome(**kw):
        try:
            rt = api.runtime(n=8, device="cpu", **posture, **kw)
        except Exception as e:
            return type(e).__name__, str(e), None
        sid = rt.submit("cavity", steps=1)
        return "built", rt.poll(sid), rt

    plain = outcome()
    stored = outcome(store=str(tmp_path / "j.sqlite"))
    assert stored[:2] == plain[:2]
    if "mesh" in posture:
        assert plain[1]["status"] == "failed"
        rows = stored[2].jobs()
        assert [(j.status, j.error) for j in rows] == [
            ("failed", plain[1]["error"])]
    else:
        assert plain[0] == "RuntimeError" and "process group" in plain[1]


@pytest.mark.parametrize("posture", ["telemetry", "health", "ckpt_dir",
                                     "store"])
def test_item8_postures_resolve_as_the_reference_resolves_them(posture,
                                                               tmp_path):
    """Each observability/durability posture builds the reference's
    objects: an enabled telemetry handle, the default HealthConfig with
    its flight records under ``<ckpt_dir>/flight``, a per-signature spill
    directory, and ``<ckpt_dir>/jobs.sqlite``."""
    from repro_torch import jobs, obs

    ck = str(tmp_path)
    kw = {"telemetry": dict(telemetry=True), "health": dict(health=True),
          "ckpt_dir": dict(ckpt_dir=ck),
          "store": dict(ckpt_dir=ck, store=True)}[posture]
    rt = api.runtime(n=8, nz=4, device="cpu", jacobi_iters=4, **kw)
    ref = ref_api.runtime(n=8, nz=4, jacobi_iters=4, **kw)
    rt.submit("cavity", steps=1)
    ref.submit("cavity", steps=1)
    if posture == "telemetry":
        assert rt.telemetry.enabled and rt.telemetry is not obs.NULL
    elif posture == "health":
        assert rt.health == obs.HealthConfig() and rt.health.window == \
            ref.health.window
        assert rt.services()[0].farm.exec.health_ring.shape == (4, 8, 6)
    elif posture == "ckpt_dir":
        spill = rt.services()[0]._ckpt.dir
        assert spill == ref.services()[0]._ckpt.dir
        assert os.path.isdir(spill)
    else:
        assert isinstance(rt.store, jobs.JobStore)
        assert rt.store.path == os.path.join(ck, "jobs.sqlite")
        assert [j.status for j in rt.jobs()] == ["queued", "queued"]
    assert rt.drain()[0].terminated == "steps"


def test_durable_verbs_and_a_service_on_a_stub_mesh_with_a_store(tmp_path):
    """The verbs of item 8 work (their own tests are in
    ``tests/test_torch_jobs.py``); a service on a mesh with a store fails
    as it fails without one where no process group is up (the store on a
    mesh of ranks: ``tests/test_torch_durable_mesh.py``)."""
    from repro_torch import jobs
    from repro_torch.cfd import cavity
    from repro_torch.sim import SimulationFarm, SimulationService

    rt = api.runtime(n=8, device="cpu")
    assert rt.claim() == [] and rt.recover() == []
    with pytest.raises(RuntimeError, match="needs a job store"):
        rt.enqueue("cavity", steps=1)
    cfg = cavity.config(8)
    SimulationService(cfg, ckpt_dir=str(tmp_path), device="cpu")
    assert SimulationFarm(cfg, telemetry=True, device="cpu").tel.enabled
    errors = []
    for store in (None, jobs.JobStore(str(tmp_path / "j.sqlite"))):
        with pytest.raises(AttributeError) as e:
            SimulationService(cfg, mesh=object(), device="cpu", store=store)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_enqueue_claim_recover_through_one_store(tmp_path):
    """Enqueued work is claimed by a second runtime on the same store file
    and drained there; the results equal a storeless farm's bitwise."""
    path = str(tmp_path / "jobs.sqlite")
    front = api.runtime(n=8, nz=4, device="cpu", jacobi_iters=4, store=path)
    jids = [front.enqueue("cavity", steps=s, re=re, tag=f"t{i}")
            for i, (re, s) in enumerate(((80.0, 3), (160.0, 5)))]
    assert front.store.queue_depth() == 2
    worker = api.runtime(n=8, nz=4, device="cpu", jacobi_iters=4, store=path)
    assert worker.recover() == []           # nothing was in flight
    sids = worker.claim()
    assert sorted(worker.job_id(s) for s in sids) == sorted(jids)
    out = worker.drain()
    plain = api.runtime(n=8, nz=4, device="cpu", jacobi_iters=4)
    want = [plain.submit("cavity", steps=s, re=re)
            for re, s in ((80.0, 3), (160.0, 5))]
    want = plain.drain()
    for sid, w in zip(sorted(sids, key=worker.job_id), want.values()):
        for f in ("vx", "vy", "vz", "p"):
            assert torch.equal(out[sid].state[f], w.state[f])
            assert torch.equal(front.load_result(worker.job_id(sid))[f],
                               w.state[f])
