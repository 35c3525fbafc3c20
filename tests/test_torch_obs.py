"""The port's observability layer against the reference's, on the CPU.

``repro_torch.obs`` (metrics, timers, traces, spans, health) and
``repro_torch.ckpt`` / ``repro_torch.ft``: the same call sequence gives the
same snapshot and report text as ``repro.obs``; the port's trace passes the
reference's Chrome-trace validator; ``classify_frame`` and the
``HealthMonitor`` state machine agree with the reference's on a seeded set
of frames with NaN, Inf, warning and diverged values; checkpoints written
by either package read back bitwise in the other.  On the port's farm
(n = 8-12, cavity): the NaN-injection battery of ``tests/test_obs.py``
(the poisoned slot is quarantined with a readable flight record, the
survivors are bitwise those of a farm that never admitted it), and
telemetry plus health on give bitwise the results of both off.  Spans:
the solver step's phases as FUNCTION-scope profiler ranges, telemetry's
records on the profiler's clock, and a farm that never synchronises.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro import obs as ref_obs
from repro.ckpt.checkpointer import Checkpointer as RefCheckpointer
from repro.obs import health as ref_health

from repro_torch import api, obs
from repro_torch.cfd import cavity
from repro_torch.ckpt import Checkpointer
from repro_torch.cfd import ns3d
from repro_torch.ft import StepWatchdog
from repro_torch.obs import health
from repro_torch.sim import SimulationService

N = 8
KW = dict(nz=4, jacobi_iters=6)
FIELDS = ("vx", "vy", "vz", "p")


class _Clock:
    """A fake clock: each call advances by the next step of a fixed list."""

    def __init__(self):
        self.t = 0.0
        self.steps = iter([0.5, 0.25, 1.0, 0.125, 2.0, 0.75] * 20)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


def _drive_metrics(mod):
    reg = mod.Registry()
    reg.inc("farm.compile_cache", result="hit")
    reg.inc("farm.compile_cache", 3, result="miss")
    reg.set("farm.queue_depth", 4, priority=1)
    reg.set("farm.slot_occupancy", 2.5)
    for v in (1e-5, 3e-3, 0.7, 12.0, 2e5):
        reg.observe("service.submit_to_result_seconds", v, priority=0)
    reg.inc("health.frames", 7)
    reg.remove("health.frames")
    return reg


def test_metrics_give_the_reference_snapshot_and_texts():
    ours, ref = _drive_metrics(obs), _drive_metrics(ref_obs)
    assert ours.snapshot() == ref.snapshot()
    assert ours.to_json(indent=1) == ref.to_json(indent=1)
    assert ours.report() == ref.report()
    assert ours.to_prometheus() == ref.to_prometheus()
    assert obs.series_key("x", {"b": 1, "a": 2}) == \
        ref_obs.series_key("x", {"b": 1, "a": 2})


def _drive_timers(mod):
    tree = mod.TimerTree(clock=_Clock())
    for _ in range(3):
        with tree.section("EVOL"):
            with tree.section("step"):
                pass
            with tree.section("pad"):
                with tree.section("cat"):
                    pass
    with tree.section("ANALYSIS"):
        pass
    return tree


def test_timers_give_the_reference_tree_and_report():
    ours, ref = _drive_timers(obs), _drive_timers(ref_obs)
    assert ours.snapshot() == ref.snapshot()
    assert ours.report() == ref.report()


def _drive_trace(mod, path):
    log = mod.TraceLog(path=path, clock=_Clock())
    log.emit("submit", sid=0, tag="a", priority=1)
    log.emit("admit", sid=0, slot=2, tag="a")
    log.emit("first_step", sid=0, device_step=0)
    log.emit("health", sid=0, state="warning", cause="cfl")
    log.emit("evict", sid=0, slot=2)
    log.emit("admit", sid=0, slot=1)
    log.emit("result", sid=0, terminated="steps")
    log.emit("watchdog_stall", gap_s=1.5)
    log.close()
    return log


def test_trace_gives_the_reference_records_and_chrome_document(tmp_path):
    ours = _drive_trace(obs, str(tmp_path / "ours.jsonl"))
    ref = _drive_trace(ref_obs, str(tmp_path / "ref.jsonl"))
    assert ours.events == ref.events
    assert ours.dumps_jsonl() == ref.dumps_jsonl()
    assert ours.to_chrome() == ref.to_chrome()
    lines = (tmp_path / "ours.jsonl").read_text().splitlines()
    assert [json.loads(ln) for ln in lines] == ours.events
    # the port's Chrome document passes the reference's validator
    ref_obs.validate_chrome_trace(ours.to_chrome())
    with pytest.raises(ValueError, match="missing 'ts'"):
        obs.validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "i", "pid": 1, "tid": 0}]})


def test_fence_and_scopes_are_no_ops_on_the_cpu_and_off():
    """The one hook left of the fence, the timer section and the profiler
    scope: with no profiler and telemetry off a span records nothing."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not hasattr(obs.Telemetry, "fence")
    assert not hasattr(obs.Telemetry, "section")
    assert not hasattr(obs.Telemetry, "named_scope")
    with obs.span("ns3d.step"), obs.NULL.span("farm.step_chunk",
                                              device="cpu", steps=4):
        pass
    assert obs.NULL.timers.snapshot() == {} and not obs.NULL.spans
    assert obs.NULL.device_seconds("farm.step_chunk") is None
    assert obs.resolve(False) is obs.NULL and obs.resolve(None) is obs.NULL
    assert obs.resolve({"enabled": False}) is obs.NULL
    tel = obs.telemetry()
    assert obs.resolve(tel) is tel
    with pytest.raises(TypeError):
        obs.resolve(42)


def _kineto_spans(prof, prefix):
    return [ev for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith(prefix)]


def test_a_cpu_solver_step_shows_its_four_phases_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    solver = ns3d.NavierStokes3D(cavity.config(N, **KW), "cpu")
    step = solver.make_step()
    state = solver.init_state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        step(state)
    assert not torch.autograd.profiler._is_profiler_enabled
    evs = _kineto_spans(prof, "ns3d.")
    names = [ev.name() for ev in sorted(evs, key=lambda e: e.start_ns())]
    assert names == ["ns3d.step", "ns3d.advect", "ns3d.rhs",
                     "ns3d.pressure", "ns3d.project"]
    outer = evs[names.index("ns3d.step")]
    t0, t1 = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    for ev in evs:
        assert t0 <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= t1
        # FUNCTION scope: an operator's range, never a user annotation
        assert not ev.is_user_annotation() and ev.scope() == 0
        assert ev.activity_type() == "cpu_op"
        assert ev.device_type() == torch.autograd.DeviceType.CPU


def test_telemetry_spans_lie_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    tel = obs.telemetry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.span("farm.admit", slot=1):
            with tel.span("ensemble.write_slot"):
                torch.ones(64).sum()
        with tel.span("farm.step_chunk", device="cpu", steps=3):
            time.sleep(0.002)
    recs = {r.name: r for r in tel.spans}
    assert recs["ensemble.write_slot"].parent == "farm.admit"
    assert recs["farm.admit"].parent is None
    assert recs["farm.admit"].attrs == {"slot": 1}
    ranges = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name() in recs}
    assert set(ranges) == set(recs)
    for name, rec in recs.items():
        ev = ranges[name]
        assert abs(rec.start_ns - ev.start_ns()) < 200_000, name
        assert abs(rec.end_ns - (ev.start_ns() + ev.duration_ns())) \
            < 200_000, name
    timers = tel.timers.snapshot()
    assert timers["farm.admit"]["children"]["ensemble.write_slot"][
        "count"] == 1
    chunk = recs["farm.step_chunk"]
    assert timers["farm.step_chunk"]["total_s"] == pytest.approx(
        (chunk.end_ns - chunk.start_ns) / 1e9)
    # no card: no device clock, and the perf join takes the host time
    assert tel.device_seconds("farm.step_chunk") is None
    from repro_torch.obs import perf

    assert perf.measured_seconds(tel, "farm.step_chunk", 3) == \
        pytest.approx(timers["farm.step_chunk"]["total_s"] / 3)


def test_span_records_are_bounded_and_the_lifecycle_shares_their_clock(
        tmp_path, monkeypatch):
    monkeypatch.setattr(obs.Telemetry, "MAX_SPANS", 4)
    tel = obs.telemetry()
    before = time.time_ns()
    for i in range(6):
        with tel.span("ops.ghosted_inputs", i=i):
            pass
    assert [r.attrs["i"] for r in tel.spans] == [2, 3, 4, 5]
    assert tel.timers.snapshot()["ops.ghosted_inputs"]["count"] == 6
    ev = tel.trace.emit("submit", sid=0)
    at = tel.trace.t0_ns + ev["ts"] * 1e9
    assert before - 50e6 < tel.trace.t0_ns <= before + 50e6
    assert tel.spans[-1].end_ns - 50e6 < at < time.time_ns() + 50e6
    path = tel.save_chrome(str(tmp_path / "spans.json"),
                           base_ns=tel.trace.t0_ns)
    doc = obs.validate_chrome_trace(json.loads(open(path).read()))
    assert doc["baseTimeNanoseconds"] == tel.trace.t0_ns
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["i"] for e in xs] == [2, 3, 4, 5]
    assert all(e["name"] == "ops.ghosted_inputs" and e["pid"] == 4
               for e in xs)
    inst = [e for e in doc["traceEvents"] if e["name"] == "submit"]
    assert inst[0]["ts"] == pytest.approx(ev["ts"] * 1e6)
    ref_obs.validate_chrome_trace(doc)
    tel.reset()
    assert not tel.spans and tel.timers.snapshot() == {}


class _Event:
    """A stand-in CUDA timing event: a time in ms and whether the device
    has reached it."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "read before the device finished"
        return end.ms - self.ms


def test_device_clock_reads_finished_pairs_without_a_wait():
    from repro_torch.obs import perf
    from repro_torch.obs.spans import DeviceClock

    clock = DeviceClock()
    late = _Event(5.0, done=False)
    clock.add(_Event(0.0), _Event(2.0), 4)
    clock.add(_Event(2.0), late, 4)
    # behind an unfinished pair of the same stream: waits its turn
    clock.add(_Event(5.0), _Event(6.0), 1)
    clock.fold()
    assert (clock.seconds, clock.steps) == (pytest.approx(0.002), 4)
    assert len(clock.pending) == 2
    tel = obs.telemetry()
    tel.device_clock("farm.step_chunk").pending[:] = clock.pending
    assert tel.device_seconds("farm.step_chunk") is None
    late.done = True
    seconds, steps = tel.device_seconds("farm.step_chunk")
    assert (seconds, steps) == (pytest.approx(0.004), 5)
    with tel.span("farm.step_chunk"):
        pass
    # the device time wins over the span's host time in the perf join
    assert perf.measured_seconds(tel, "farm.step_chunk", 100) == \
        pytest.approx(0.004 / 5)


def test_a_farm_drain_with_telemetry_on_never_synchronises(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    rt = api.runtime(n=N, device="cpu", n_slots=2, check_every=4,
                     telemetry=True, **KW)
    sids = [rt.submit("cavity", re=re, steps=6, residual_tol=1e-12)
            for re in (100.0, 200.0, 400.0)]
    rt.run("cavity", steps=2)
    res = rt.drain()
    assert all(res[s].steps_done == 6 for s in sids)
    assert calls == []
    timers = rt.telemetry.timers.snapshot()
    assert {"farm.admit", "farm.step_chunk", "farm.harvest",
            "run.cavity"} <= set(timers)
    assert "farm.residuals" in timers["farm.step_chunk"]["children"]
    assert "ensemble.write_slot" in timers["farm.admit"]["children"]
    names = {r.name for r in rt.telemetry.spans}
    assert {"schedule.EVOL", "farm.residuals", "ensemble.read_slot"} <= names


# -- health: the state machine against the reference's -----------------------
def _seeded_frames(seed: int = 0, n: int = 60) -> np.ndarray:
    """Rows (step, div, ke, umax, cfl, finite) mixing healthy, warning,
    diverged, NaN and Inf values."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((n, health.N_DIAG), np.float32)
    rows[:, 0] = np.arange(n)
    rows[:, 1] = 10.0 ** rng.uniform(-3, 8, n)        # div: healthy..diverged
    rows[:, 2] = rng.uniform(0, 1, n)
    rows[:, 3] = rng.uniform(0, 3, n)
    rows[:, 4] = 10.0 ** rng.uniform(-2, 3.5, n)      # cfl: healthy..diverged
    rows[:, 5] = 1.0
    bad = rng.choice(n, 8, replace=False)
    rows[bad[:2], 1] = np.nan
    rows[bad[2:4], 4] = np.inf
    rows[bad[4:6], 5] = 0.0
    rows[bad[6:], 1] = -np.inf
    return rows


def test_classify_frame_agrees_with_the_reference():
    cfgs = [(health.HealthConfig(), ref_health.HealthConfig()),
            (health.HealthConfig(div_warn=10.0, cfl_warn=0.5),
             ref_health.HealthConfig(div_warn=10.0, cfl_warn=0.5))]
    seen = set()
    for cfg, ref_cfg in cfgs:
        for row in _seeded_frames():
            frame = health.frame_from_row(row)
            got = health.classify_frame(frame, cfg)
            assert got == ref_health.classify_frame(frame, ref_cfg), frame
            seen.add(got[0])
    assert seen == set(health.STATES)
    assert health.DIAG_COLUMNS == ref_health.DIAG_COLUMNS == \
        ("step",) + ns3d.HEALTH_DIAGS


def test_monitor_states_and_causes_agree_with_the_reference():
    """One sim fed the seeded frames a few at a time (stale rows and
    sentinels included), one fed only healthy/warning rows: the same
    transitions, states, causes and kept frames as the reference's."""
    tel, ref_tel = obs.telemetry(), ref_obs.telemetry()
    mon = health.HealthMonitor(health.HealthConfig(window=4), telemetry=tel)
    ref = ref_health.HealthMonitor(ref_health.HealthConfig(window=4),
                                   telemetry=ref_tel)
    rows = _seeded_frames(1)
    calm = rows[(rows[:, 5] > 0.5) & np.isfinite(rows[:, 1])
                & (rows[:, 1] < 1e7) & (rows[:, 4] < 1e3)]
    for m in (mon, ref):
        m.admit(1, slot=0, tag="mixed")
        m.admit(2, slot=1, tag="calm", last_step=3)
    sentinel = np.full((1, health.N_DIAG), -1.0, np.float32)
    for lo in range(0, len(rows), 5):
        chunk = np.concatenate([rows[max(lo - 2, 0):lo + 5], sentinel])
        for sid, feed in ((1, chunk), (2, calm[lo // 5 * 3:lo // 5 * 3 + 3])):
            a, b = mon.observe(sid, feed), ref.observe(sid, feed)
            assert (a.state, a.cause, a.last_step) == \
                (b.state, b.cause, b.last_step)
            np.testing.assert_array_equal(a.frames_array(), b.frames_array())
    mon.mark(2, health.WARNING, cause="watchdog_stall", gap_s=2.0)
    ref.mark(2, ref_health.WARNING, cause="watchdog_stall", gap_s=2.0)
    assert mon.counts() == ref.counts()
    assert [e for e in tel.trace.events if e["kind"] == "health"] == \
        [dict(e, ts=o["ts"]) for e, o in zip(
            [e for e in ref_tel.trace.events if e["kind"] == "health"],
            [e for e in tel.trace.events if e["kind"] == "health"])]
    assert mon.state_of(1) in (health.DIVERGED, health.NAN)


def test_dashboard_renders_the_reference_text():
    snap = {"farm": "cavity/sig000", "device_steps": 16, "queued": 1,
            "states": {"healthy": 1, "warning": 0},
            "slots": [{"slot": 0, "sid": None},
                      {"slot": 1, "sid": 4, "tag": "t", "steps_done": 8,
                       "steps": 20, "health": {"state": "healthy",
                                               "div_linf": 1e-3, "ke": 0.2,
                                               "cfl": 0.3}}]}
    assert health.render_dashboard([snap]) == \
        ref_health.render_dashboard([snap])


def test_flight_records_read_in_either_package(tmp_path):
    frames = np.arange(18, dtype=np.float32).reshape(3, 6)
    state = {"vx": torch.randn(2, 3, 4), "p": torch.zeros(2, 3, 4)}
    health.FlightRecorder(str(tmp_path / "a")).record(
        11, frames=frames, state=state, meta={"cause": "cfl"})
    rec = ref_health.load_flight_record(str(tmp_path / "a"), 11)
    np.testing.assert_array_equal(rec["frames"], frames)
    np.testing.assert_array_equal(rec["state"]["vx"], state["vx"].numpy())
    ref_health.FlightRecorder(str(tmp_path / "b")).record(
        3, frames=frames, state={k: v.numpy() for k, v in state.items()},
        meta={"cause": "nonfinite"})
    rec = health.load_flight_record(str(tmp_path / "b"), 3)
    np.testing.assert_array_equal(rec["state"]["p"], state["p"].numpy())
    assert rec["meta"]["cause"] == "nonfinite"


# -- checkpointer ------------------------------------------------------------
def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"z": rng.randn(3, 4).astype(np.float32),
            "a": {"q": rng.randint(0, 9, (5,)).astype(np.int64),
                  "b": rng.randn(2, 2, 2).astype(np.float64)},
            "m": [rng.randn(4).astype(np.float32),
                  (np.float32(2.5), rng.randn(1).astype(np.float16))]}


def test_checkpoints_read_bitwise_in_either_package(tmp_path):
    tree = _tree(0)
    as_torch = {"z": torch.from_numpy(tree["z"]),
                "a": {"q": torch.from_numpy(tree["a"]["q"]),
                      "b": torch.from_numpy(tree["a"]["b"])},
                "m": [torch.from_numpy(tree["m"][0]),
                      (tree["m"][1][0], torch.from_numpy(tree["m"][1][1]))]}
    Checkpointer(str(tmp_path / "ours"), keep_last=0).save(7, as_torch)
    RefCheckpointer(str(tmp_path / "ref"), keep_last=0).save(7, tree)
    for writer in ("ours", "ref"):
        m1, ours = Checkpointer(str(tmp_path / writer)).read_arrays(7)
        m2, ref = RefCheckpointer(str(tmp_path / writer)).read_arrays(7)
        assert len(ours) == len(ref) == 6
        assert m1["shapes"] == m2["shapes"] and m1["dtypes"] == m2["dtypes"]
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the two writers flatten to the same leaf order
    _, a = Checkpointer(str(tmp_path / "ours")).read_arrays(7)
    _, b = Checkpointer(str(tmp_path / "ref")).read_arrays(7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_checkpointer_restore_async_keep_last_and_cleanup(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    state = {"vx": torch.randn(3, 3), "p": torch.randn(3, 3)}
    for step in (1, 2, 3):
        ck.save_async(step, {k: v + step for k, v in state.items()})
    ck.wait()
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    template = {k: torch.zeros_like(v) for k, v in state.items()}
    step, back = ck.restore_latest(template)
    assert step == 3
    for k in state:
        assert torch.equal(back[k], state[k] + 3)
    (tmp_path / "step_00000009.tmp-dead").mkdir()
    ck.cleanup()
    assert ck.steps() == [2, 3] and ck.remove(2) and not ck.remove(2)
    with pytest.raises(ValueError, match="incompatible trees"):
        ck.restore(3, {"vx": template["vx"]})
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.restore(3, {"vx": torch.zeros(2), "p": template["p"]})


# -- watchdog ----------------------------------------------------------------
def test_watchdog_events_match_the_reference():
    from repro.ft.watchdog import StepWatchdog as RefWatchdog

    times = [1.0] * 6 + [1.6, 1.7, 1.8, 9.0, 1.0, 1.2]
    a, b = StepWatchdog(), RefWatchdog()
    for i, t in enumerate(times):
        assert [(e.kind, e.step) for e in a.observe(i, t)] == \
            [(e.kind, e.step) for e in b.observe(i, t)]
    assert a.ewma == b.ewma and a.should_checkpoint == b.should_checkpoint


# -- the NaN-injection battery on the port's farm ----------------------------
HEALTH_JOBS = ((80.0, "h0"), (150.0, "h1"), (240.0, "h2"))


def _health_runtime(ckpt_dir, telemetry=True, health=True):
    return api.runtime(n=N, device="cpu", n_slots=4, check_every=8,
                       ckpt_dir=ckpt_dir, health=health, telemetry=telemetry,
                       **KW)


def _submit_healthy(rt):
    return [rt.submit("cavity", re=re, steps=24, tag=tag)
            for re, tag in HEALTH_JOBS]


@pytest.fixture(scope="module")
def quarantine_run(tmp_path_factory):
    """A drained health-monitored farm: three healthy cavity sims plus one
    poisoned with a huge dt, far past the CFL-diverged threshold."""
    tmp = str(tmp_path_factory.mktemp("health"))
    rt = _health_runtime(tmp)
    healthy = _submit_healthy(rt)
    bad = rt.submit("cavity", re=100.0, steps=24, dt=50.0, tag="poison")
    return rt, healthy, bad, rt.drain(), tmp


def test_poisoned_slot_is_quarantined(quarantine_run):
    rt, healthy, bad, res, _ = quarantine_run
    r = res[bad]
    assert r.terminated == "diverged" and r.steps_done < 24
    assert "health: " in r.error and "flight record" in r.error
    assert rt.poll(bad)["status"] == "diverged"
    for sid in healthy:
        assert (res[sid].terminated, res[sid].steps_done) == ("steps", 24)


def test_flight_record_is_readable_post_mortem(quarantine_run):
    rt, _, bad, _, tmp = quarantine_run
    rec = health.load_flight_record(f"{tmp}/flight", rt._routes[bad][1])
    frames = rec["frames"]
    assert frames.shape[1] == health.N_DIAG
    assert 1 <= frames.shape[0] <= health.HealthConfig().window
    cfl = frames[:, health.DIAG_COLUMNS.index("cfl")]
    finite = frames[:, health.DIAG_COLUMNS.index("finite")]
    assert (cfl[np.isfinite(cfl)] >= 1e3).any() or (finite < 0.5).any()
    assert set(FIELDS) <= set(rec["state"])
    meta = rec["meta"]
    assert meta["state"] in ("diverged", "nan") and meta["cause"]
    assert meta["tag"] == "poison" and "thresholds" in meta
    # the reference's reader takes the port's record
    assert ref_health.load_flight_record(
        f"{tmp}/flight", rt._routes[bad][1])["meta"]["tag"] == "poison"


def test_survivors_are_bitwise_a_farm_that_never_admitted_it(quarantine_run,
                                                             tmp_path):
    _, healthy, _, res, _ = quarantine_run
    rt2 = _health_runtime(str(tmp_path))
    twins = _submit_healthy(rt2)
    res2 = rt2.drain()
    for a, b in zip(healthy, twins):
        for f in FIELDS:
            assert torch.equal(res[a].state[f], res2[b].state[f])


def test_health_drains_only_at_harvest_boundaries(quarantine_run):
    rt, _, _, _, _ = quarantine_run
    farm = rt.services()[0].farm
    boundaries = farm.device_steps // farm.check_steady_every
    assert farm.device_steps % farm.check_steady_every == 0
    drains = rt.telemetry.metrics.get("health.drains")
    assert drains == boundaries
    timers = rt.telemetry.timers.snapshot()
    assert timers["farm.health_drain"]["count"] == drains


def test_health_events_join_the_trace_and_metrics(quarantine_run):
    rt, _, bad, _, _ = quarantine_run
    inner = rt._routes[bad][1]
    kinds = rt.telemetry.trace.kinds_for(inner)
    assert kinds[:2] == ["submit", "admit"] and kinds[-1] == "result"
    ev = [e for e in rt.telemetry.trace.events_for(inner)
          if e["kind"] == "health"][-1]
    assert ev["state"] in ("diverged", "nan")
    doc = rt.telemetry.trace.to_chrome()
    ref_obs.validate_chrome_trace(doc)
    assert any(e["name"] == "health" and e["pid"] == 3
               for e in doc["traceEvents"])
    assert rt.telemetry.metrics.get("health.quarantines") == 1
    assert "repro_health_sims" in rt.services()[0].prometheus_text()
    text = rt.watch()
    assert "== repro health ==" in text and "free" in text


def test_quarantine_works_with_telemetry_off(quarantine_run, tmp_path):
    _, healthy, _, res_on, _ = quarantine_run
    rt = _health_runtime(str(tmp_path), telemetry=False)
    assert rt.telemetry is obs.NULL
    twins = _submit_healthy(rt)
    bad = rt.submit("cavity", re=100.0, steps=24, dt=50.0, tag="poison")
    res = rt.drain()
    assert res[bad].terminated == "diverged"
    rec = health.load_flight_record(f"{tmp_path}/flight", rt._routes[bad][1])
    assert rec["meta"]["tag"] == "poison"
    for a, b in zip(healthy, twins):
        for f in FIELDS:
            assert torch.equal(res_on[a].state[f], res[b].state[f])


def test_poll_streams_the_latest_frame_while_running():
    svc = SimulationService(cavity.config(N, **KW), n_slots=1,
                            check_steady_every=4, device="cpu",
                            telemetry=True, health=True)
    sid = svc.submit(cavity.sim_request(N, re=100.0, steps=12, **KW))
    svc.run(4)
    out = svc.poll(sid)
    assert out["status"] == "running" and out["steps_done"] == 4
    h = out["health"]
    assert h["state"] == "healthy" and h["step"] == 3
    assert all(np.isfinite(h[c]) for c in ("div_linf", "ke", "cfl"))
    assert "ok" in health.render_dashboard([svc.farm.health_snapshot()])
    svc.drain()


def test_health_ring_rows_are_the_solvers_diagnostics():
    """The ring's newest row is ``health_diagnostics`` of the chunk's final
    state, per slot, stamped with the chunk's last device step."""
    svc = SimulationService(cavity.config(N, **KW), n_slots=2,
                            check_steady_every=4, device="cpu", health=True)
    for re in (100.0, 300.0):
        svc.submit(cavity.sim_request(N, re=re, steps=9, **KW))
    svc.run(4)
    ex = svc.farm.exec
    ring = ex.read_health()
    assert ring.shape == (2, health.HealthConfig().window, health.N_DIAG)
    for slot in range(2):
        one = {f: ex.state[f][slot] for f in ex.state}
        prm = {k: torch.tensor(v[slot]) for k, v in ex.params.items()}
        want = ex.solver.health_diagnostics(one, prm).numpy()
        np.testing.assert_allclose(ring[slot, -1, 1:], want, rtol=1e-6)
        assert ring[slot, -1, 0] == 3 and (ring[slot, :-1, 0] == -1).all()
    svc.drain()


def test_watchdog_stall_marks_resident_sims_warning():
    tel = obs.telemetry(heartbeat_deadline_s=0.0)
    svc = SimulationService(cavity.config(N, **KW), n_slots=2,
                            check_steady_every=2, device="cpu",
                            telemetry=tel, health=True)
    sid = svc.submit(cavity.sim_request(N, re=100.0, steps=6, **KW))
    time.sleep(0.01)
    svc.result(sid)
    evs = [e for e in tel.trace.events if e["kind"] == "health"
           and e["cause"] == "watchdog_stall"]
    assert evs and evs[0]["state"] == "warning" and "gap_s" in evs[0]
    assert [e for e in tel.trace.events if e["kind"] == "health"
            and e["state"] == "healthy" and e["from"] == "warning"]


def test_heartbeat_file_is_touched(tmp_path):
    path = str(tmp_path / "beat")
    svc = SimulationService(cavity.config(N, **KW), n_slots=1, device="cpu",
                            telemetry=obs.telemetry(heartbeat_path=path,
                                                    heartbeat_interval_s=0.0))
    svc.result(svc.submit(cavity.sim_request(N, re=100.0, steps=2, **KW)))
    from repro_torch.ft import Heartbeat

    assert Heartbeat.is_alive(path, deadline_s=60.0)


# -- on against off ----------------------------------------------------------
REQS = ((60.0, 5), (120.0, 11), (250.0, 7), (500.0, 9), (900.0, 4))


def _farm_results(**posture):
    rt = api.runtime(n=N, device="cpu", n_slots=3, check_every=4, **KW,
                     **posture)
    sids = [rt.submit("cavity", re=re, steps=s) for re, s in REQS]
    rt.services()[0].run(3)
    assert rt.evict(sids[1]) and rt.readmit(sids[1])
    out = rt.drain()
    return rt, [out[s] for s in sids]


def test_telemetry_and_health_on_are_bitwise_the_off_farm(tmp_path):
    rt_off, off = _farm_results()
    rt_on, on = _farm_results(telemetry=True, health=True,
                              ckpt_dir=str(tmp_path))
    assert rt_off.telemetry is obs.NULL and rt_off.health is None
    farm_off = rt_off.services()[0].farm
    assert farm_off.exec.health_ring is None and farm_off.heartbeat is None
    assert rt_on.services()[0].farm.exec.health_ring is not None
    for a, b in zip(on, off):
        assert (a.terminated, a.steps_done) == (b.terminated, b.steps_done)
        for f in FIELDS:
            assert torch.equal(a.state[f], b.state[f])
    timers = rt_on.telemetry.timers.snapshot()
    assert {"farm.admit", "farm.step_chunk", "farm.harvest", "farm.evict",
            "service.evict_spill", "service.readmit_restore"} <= set(timers)
    assert rt_on.telemetry.metrics.get("sim.evictions") == 1
    assert "== repro.obs report ==" in rt_on.report()
    assert rt_off.report().endswith("(telemetry disabled)")


def test_serial_run_is_bitwise_with_telemetry_on():
    on = api.runtime(n=N, device="cpu", telemetry=True, **KW)
    a = on.run("cavity", steps=3)
    b = api.runtime(n=N, device="cpu", **KW).run("cavity", steps=3)
    for f in FIELDS:
        assert torch.equal(a.state[f], b.state[f])
    timers = on.telemetry.timers.snapshot()
    assert timers["run.cavity"]["count"] == 1
    assert on.telemetry.metrics.get("sim.steps_total") == 3
