"""The comparison that decides ``correct``: the reference against the port's
plain backend, whole runs of both cells at a CPU size, the control, and
runs with the timed path broken underneath."""
import time

import pytest
import torch

import compare
import harness
import program
import run
import traffic
from reference import ns3d

BENCH = harness.benchmark()


def drive(wl, cfg, seed=2**31 + 11, seconds=0.5):
    return run.execute(wl, cfg, seed, seconds, False, "cpu",
                       time.perf_counter(), BENCH)


@pytest.mark.parametrize("re", [50.0, 400.0])
def test_reference_step_matches_the_ports_plain_backend(cell_files, re):
    wl, cfg = cell_files("cavity512.solve", n=12)
    program.register(cfg)
    rt = program.runtime(cfg, "cpu")
    pr = rt.prepare(program.SCENARIO,
                    **program.run_params(cfg, 5, 0, re))
    state = pr.state
    ref = compare.Reference(cfg, 5, "cpu")
    assert ref.ns.__file__.endswith("reference/ns3d.py")
    want = ref.initial(0)
    for f in traffic.FIELDS:
        assert torch.equal(state[f], want[f])
    for _ in range(3):
        got = pr.step(state)
        step = ns3d.step({f: state[f] for f in ns3d.FIELDS}, ref.params(re),
                         jacobi_iters=cfg["jacobi_iters"])
        assert compare.gap(got, step, ns3d.FIELDS) < 1e-6
        assert compare.gap(got, {f: state[f] for f in ns3d.FIELDS},
                           ns3d.FIELDS) > 1e-3
        state = got


@pytest.mark.parametrize("name", ["cavity512.solve", "sweep256.members"])
def test_a_sound_run_is_correct(cell_files, name):
    wl, cfg = cell_files(name)
    res = drive(wl, cfg)
    checks = res["checks"]
    assert res["correct"], checks
    assert checks["intake_diff"]["value"] == 0.0
    assert checks["start_gap"]["value"] < 1e-6
    assert checks["window_gap"]["value"] < 1e-6
    assert res["attempted"] > 0 and res["failed"] == 0
    # every end-to-end metric of the cell but the device's memory, which
    # the CPU has none of
    assert set(res["metrics"]) == {
        m["name"] for m in run.metrics_for(name, False, BENCH)} - {
        "peak_mem_gib"}


def test_the_farm_check_covers_a_finish_and_an_admission(cell_files):
    wl, cfg = cell_files("sweep256.members")
    drv = harness.module("drivers", "farm")
    out = drv.run(run.Cell(wl, cfg, 3, 0.5, False, "cpu", time.perf_counter()))
    names = [c["name"] for c in out["cases"]]
    slots = cfg["n_slots"]
    # the first residents' and the probe's first steps, the probe's result,
    # the admitted member's first step, and every slot in the window
    assert names.count("start_gap") == slots + 1
    assert names.count("result_gap") == 1
    assert names.count("window_gap") == slots
    assert len(out["intake"]) == slots + 1
    probe = [c for c in out["cases"] if c["name"] == "result_gap"][0]
    assert probe["member"] == 0
    assert probe["steps"] == wl["traffic"]["probe_steps"]
    window = [c for c in out["cases"] if c["name"] == "window_gap"]
    assert 0 not in {c["member"] for c in window}
    assert len({c["re"] for c in window}) > 1
    # one member came in at the probe's finish: fewer steps behind it
    assert len({c["steps"] for c in window}) == 2
    # no member finishes in the window: it times steady stepping
    assert out["counters"]["members_resolved"] == 0
    assert out["counters"]["live_slot_steps"] == \
        slots * out["counters"]["device_steps"]


def test_the_control_is_judged_not_correct(cell_files):
    import control

    for name in ("cavity512.solve", "sweep256.members"):
        wl, cfg = cell_files(name)
        got = control.readings(wl, cfg, 17, 0.5, "cpu")
        assert got["program"]["correct"], got
        assert not got["control"]["correct"], got
        for key in ("start_gap", "window_gap"):
            assert got["control"]["readings"][key] > wl["limits"][key], (
                name, key)


def _unchanged(orig):
    def step(self, state, params=None):
        return dict(state)
    return step


def _half_batch(orig):
    def step(self, state, params=None):
        out = orig(self, state, params)
        if out["vx"].dim() != 4:
            return out
        half = out["vx"].shape[0] // 2
        return {k: torch.cat([out[k][:half], state[k][half:]])
                if k in ns3d.FIELDS else v for k, v in out.items()}
    return step


def _altered(orig):
    def step(self, state, params=None):
        out = dict(orig(self, state, params))
        vx = out["vx"].clone()
        at = (0,) * (vx.dim() - 3) + (3, 4, 5)
        vx[at] += 0.01 * float(vx.abs().max())
        out["vx"] = vx
        return out
    return step


# half the batch exists only where slots do
@pytest.mark.parametrize("name, fault", [
    ("cavity512.solve", _unchanged), ("cavity512.solve", _altered),
    ("sweep256.members", _unchanged), ("sweep256.members", _half_batch),
    ("sweep256.members", _altered)])
def test_a_broken_step_is_not_correct(cell_files, monkeypatch, name, fault):
    from repro_torch.cfd.ns3d import NavierStokes3D

    monkeypatch.setattr(NavierStokes3D, "_step_local",
                        fault(NavierStokes3D._step_local))
    wl, cfg = cell_files(name)
    res = drive(wl, cfg)
    assert not res["correct"], res["checks"]
    assert res["checks"]["window_gap"]["value"] > wl["limits"]["window_gap"]


@pytest.mark.cuda
def test_the_control_at_the_cells_own_size():
    """On the card: the program judged correct and the control not, by the
    cells' own limits, at each cell's own size, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control

    for w in BENCH["workloads"]:
        wl = harness.workload(w["name"])
        cfg = harness.config(wl["config"])
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            got = control.readings(wl, cfg, seed, 3.0,
                                   torch.device("cuda", 0))
            assert got["program"]["correct"], got
            assert not got["control"]["correct"], got
