"""The port's durable job engine against the reference's, on the CPU.

``repro_torch.jobs`` restates the battery of ``tests/test_jobs.py`` on the
port: codec round trips (and across the two packages, both ways, bitwise),
the SQLite store (durable submit, priority FIFO claims, live and expired
leases with takeover, no double claim across threads, snapshots, pruning),
one store file read by either package, the store-off farm unchanged, the
durable lifecycle (result snapshots, farm-side failure, evict/readmit
through the store bitwise, flight records resolved from a fresh runtime),
the SIGKILL resume in a subprocess that imports only the port (bitwise
against an uninterrupted run), two workers draining one queue, and the
port's store-backed farm against the reference's at RUN_RTOL (1e-4, as in
``tests/test_torch_farm.py``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro import api as ref_api
from repro import jobs as ref_jobs
from repro.sim.scenarios import get_scenario as ref_scenario

from repro_torch import api, jobs
from repro_torch.jobs import JobStore
from repro_torch.sim.scenarios import get_scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
KW = dict(nz=4, jacobi_iters=8)
FIELDS = ("vx", "vy", "vz", "p")
RUN_RTOL = 1e-4


def _request(re=100.0, steps=8, **kw):
    sc = get_scenario("cavity")
    return sc.request(N, steps=steps, re=re, config=sc.config(N, re=re, **KW),
                      **kw)


def _rt(**kw):
    return api.runtime(n=N, device="cpu", **KW, **kw)


def _bitwise(a: dict, b: dict, what=""):
    for f in FIELDS:
        assert torch.equal(torch.as_tensor(np.asarray(a[f])),
                           torch.as_tensor(np.asarray(b[f]))), (what, f)


# -- codec -------------------------------------------------------------------
def test_config_round_trip_restores_tuples():
    cfg = get_scenario("cavity").config(N, re=123.0, **KW)
    back = jobs.config_from_dict(jobs.config_to_dict(cfg))
    assert back == cfg
    assert isinstance(back.shape, tuple) and isinstance(back.forcing, tuple)
    hash(back)


@pytest.mark.parametrize("decomposition", [
    ((0, "shard"),), ((0, "data"), (1, "model"))])
def test_decomposition_round_trips_in_the_reference_payload(decomposition):
    """A decomposed request's payload is the reference's, key for key (the
    decomposition as ``[[array axis, mesh axis], ...]``), and either
    package decodes the other's to a config with the same tuples."""
    import json

    cfg = get_scenario("cavity").config(N, re=80.0, **KW,
                                        decomposition=decomposition)
    ref_cfg = ref_scenario("cavity").config(N, re=80.0, **KW,
                                            decomposition=decomposition)
    req = dataclasses.replace(_request(re=80.0), config=cfg)
    ref_req = ref_scenario("cavity").request(N, steps=8, re=80.0,
                                             config=ref_cfg)
    ours, theirs = (json.loads(jobs.encode_request(req)[0]),
                    json.loads(ref_jobs.encode_request(ref_req)[0]))
    ref_doc = dict(theirs["config"], template=None)
    assert ours["config"] == ref_doc
    assert ours["config"]["decomposition"] == [list(p) for p in decomposition]
    back = jobs.config_from_dict(jobs.config_to_dict(cfg))
    assert back == cfg and back.decomposition == decomposition
    assert jobs.decode_request(*ref_jobs.encode_request(ref_req)
                               ).config.decomposition == decomposition
    assert ref_jobs.decode_request(*jobs.encode_request(req)
                                   ).config.decomposition == decomposition


def _init_state(seed=0):
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal((N, N, 4)).astype(np.float32)
            for f in FIELDS}


def test_request_round_trip_bitwise():
    init = {k: torch.from_numpy(v) for k, v in _init_state().items()}
    req = _request(re=250.0, steps=17, tag="rt", steady_tol=1e-4,
                   residual_tol=1e-3, priority=2)
    req = dataclasses.replace(req, init_state=init, step0=5, sid=99)
    back = jobs.decode_request(*jobs.encode_request(req))
    assert back.config == req.config
    assert (back.steps, back.tag, back.priority, back.step0) == (17, "rt", 2, 5)
    assert (back.steady_tol, back.residual_tol) == (1e-4, 1e-3)
    assert back.sid is None
    for f in FIELDS:
        assert torch.equal(back.init_state[f], init[f])


def test_no_init_state_encodes_no_blob_and_versions_are_checked():
    payload, blob = jobs.encode_request(_request())
    assert blob is None and jobs.decode_request(payload).init_state is None
    bad = payload.replace(f'"version": {jobs.PAYLOAD_VERSION}',
                          '"version": 999')
    with pytest.raises(ValueError, match="payload version"):
        jobs.decode_request(bad)
    assert jobs.PAYLOAD_VERSION == ref_jobs.PAYLOAD_VERSION


def _config_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_payloads_cross_the_packages_both_ways_bitwise():
    init = _init_state(1)
    ref_req = ref_scenario("cavity").request(
        N, steps=11, re=170.0, tag="x", priority=1, residual_tol=0.5,
        config=ref_scenario("cavity").config(N, re=170.0, **KW))
    ref_req = dataclasses.replace(ref_req, init_state=init, step0=3)
    ours = jobs.decode_request(*ref_jobs.encode_request(ref_req))
    theirs_cfg = _config_fields(ref_req.config)
    for name, value in _config_fields(ours.config).items():
        assert value == theirs_cfg[name], name
    assert (ours.steps, ours.tag, ours.priority, ours.step0,
            ours.residual_tol) == (11, "x", 1, 3, 0.5)
    _bitwise(ours.init_state, init, "reference -> port")

    req = dataclasses.replace(
        _request(re=170.0, steps=11, tag="y"),
        init_state={k: torch.from_numpy(v) for k, v in init.items()})
    back = ref_jobs.decode_request(*jobs.encode_request(req))
    ours_cfg = _config_fields(req.config)
    for name, value in _config_fields(back.config).items():
        if name in ours_cfg:
            assert value == ours_cfg[name], name
    assert (back.config.interpret, back.config.decomposition) == (False, ())
    assert (back.steps, back.tag) == (11, "y")
    _bitwise(back.init_state, init, "port -> reference")


# -- store -------------------------------------------------------------------
def test_submit_is_durable_and_claim_orders_priority_fifo(tmp_path):
    st = JobStore(str(tmp_path / "j.sqlite"))
    ids = [st.submit(_request(tag=t, priority=p))
           for t, p in (("a", 0), ("b", 1), ("c", 0))]
    assert st.queue_depth() == 3 and st.counts()["queued"] == 3
    claimed = st.claim(limit=3)
    assert [j.tag for j in claimed] == ["b", "a", "c"]
    assert [j.job_id for j in claimed] == [ids[1], ids[0], ids[2]]
    assert claimed[0].request().priority == 1
    assert set(st.counts()) == set(jobs.STATUSES) == set(ref_jobs.STATUSES)


def test_live_lease_blocks_peers_expired_lease_takes_over(tmp_path):
    path = str(tmp_path / "j.sqlite")
    a = JobStore(path, ttl_s=0.4, owner="host:1:aaaaaa")
    b = JobStore(path, ttl_s=30.0, owner="host:2:bbbbbb")
    jid = a.submit(_request(tag="x"))
    assert len(a.claim()) == 1
    assert b.claim() == [] and b.lease_of(jid)["owner"] == a.owner
    time.sleep(0.5)
    assert [j.job_id for j in b.claim()] == [jid]
    assert (b.takeovers, a.takeovers) == (1, 0)
    assert [e["event"] for e in b.events(jid)] == ["submit", "claim",
                                                   "takeover"]


def test_renew_release_and_terminal_transitions(tmp_path):
    st = JobStore(str(tmp_path / "j.sqlite"), ttl_s=30.0)
    jid = st.submit(_request(), lease=True)
    before = st.lease_of(jid)["expires_at"]
    time.sleep(0.05)
    assert st.renew() == 1 and st.lease_of(jid)["expires_at"] > before
    st.transition(jid, jobs.RUNNING, steps_done=0, event="admit")
    st.transition(jid, jobs.DONE, steps_done=8, terminated="steps",
                  event="result")
    job = st.get(jid)
    assert (job.status, job.steps_done, job.terminated) == \
        (jobs.DONE, 8, "steps")
    assert st.lease_of(jid) is None
    assert [e["event"] for e in st.events(jid)] == ["submit", "admit",
                                                    "result"]
    assert not st.release(jid)
    with pytest.raises(ValueError, match="unknown job status"):
        st.transition(jid, "bogus")


def test_no_double_claim_across_threads(tmp_path):
    path = str(tmp_path / "j.sqlite")
    seed = JobStore(path)
    for i in range(24):
        seed.submit(_request(tag=f"t{i}"))
    got: dict[str, list[int]] = {}

    def worker(name):
        st = JobStore(path, ttl_s=60.0, owner=f"host:{name}:x")
        mine = []
        while batch := st.claim(limit=2):
            mine.extend(j.job_id for j in batch)
        got[name] = mine

    threads = [threading.Thread(target=worker, args=(str(i),))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    claimed = sorted(j for m in got.values() for j in m)
    assert claimed == sorted(set(claimed)) and len(claimed) == 24


def test_snapshots_round_trip_and_prune(tmp_path):
    st = JobStore(str(tmp_path / "j.sqlite"))
    state = {f: torch.randn(4, 4) for f in FIELDS}
    live = st.submit(_request(tag="live"))
    st.save_snapshot(live, state, steps_done=7, kind="evict",
                     status=jobs.EVICTED)
    steps, back = st.load_snapshot(live, "evict")
    assert steps == 7 and st.get(live).status == jobs.EVICTED
    _bitwise(back, state)
    done = st.submit(_request(tag="done"))
    st.save_snapshot(done, state, 5, kind="result")
    st.transition(done, jobs.DONE, event="result")
    done_dir = os.path.join(st.snapshot_dir("result"), f"step_{done:08d}")
    assert os.path.isdir(done_dir)
    assert st.prune_terminal(max_age_s=0.0) == 1
    assert not os.path.isdir(done_dir) and st.get(done) is None
    assert st.get(live).status == jobs.EVICTED and st.prune_terminal(0.0) == 0
    d2 = st.submit(_request())
    st.transition(d2, jobs.FAILED, error="x", event="result")
    assert st.prune_terminal(max_age_s=3600.0) == 0
    auto = JobStore(str(tmp_path / "k.sqlite"), prune_after_s=0.0)
    a = auto.submit(_request())
    auto.transition(a, jobs.DONE, event="result")
    assert auto.get(a) is None


def test_one_store_file_serves_either_package(tmp_path):
    """Rows and snapshots the port writes, the reference reads, and the
    other way round: one schema, one snapshot layout."""
    path = str(tmp_path / "j.sqlite")
    ours = JobStore(path, owner="host:1:port")
    theirs = ref_jobs.JobStore(path, owner="host:2:ref")
    state = {f: torch.randn(3, 5) for f in FIELDS}
    a = ours.submit(_request(tag="from-port", priority=2))
    ours.save_snapshot(a, state, steps_done=4, kind="evict",
                       status=jobs.EVICTED)
    b = theirs.submit(ref_scenario("cavity").request(
        N, steps=8, re=90.0, tag="from-ref",
        config=ref_scenario("cavity").config(N, re=90.0, **KW)))
    theirs.save_snapshot(b, {k: v.numpy() for k, v in state.items()},
                         steps_done=2, kind="evict", status=jobs.EVICTED)
    assert [j.tag for j in theirs.jobs()] == ["from-port", "from-ref"]
    steps, back = theirs.load_snapshot(a, "evict")
    assert steps == 4
    _bitwise(back, state, "port snapshot read by the reference")
    steps, back = ours.load_snapshot(b, "evict")
    assert steps == 2
    _bitwise(back, state, "reference snapshot read by the port")
    assert ours.get(b).request().tag == "from-ref"
    assert theirs.get(a).request().tag == "from-port"


def test_resolve_store_specs(tmp_path):
    assert jobs.resolve_store(None) is None and jobs.resolve_store(False) is None
    st = JobStore(str(tmp_path / "a.sqlite"))
    assert jobs.resolve_store(st) is st
    assert jobs.resolve_store(str(tmp_path / "b.sqlite")).path == \
        str(tmp_path / "b.sqlite")
    assert jobs.resolve_store({"path": str(tmp_path / "c.sqlite"),
                               "ttl_s": 5.0}).ttl_s == 5.0
    assert jobs.resolve_store(True, ckpt_dir=str(tmp_path)).path == \
        str(tmp_path / "jobs.sqlite")
    with pytest.raises(ValueError, match="needs ckpt_dir"):
        jobs.resolve_store(True)
    with pytest.raises(TypeError):
        jobs.resolve_store(42)


# -- the farm with and without a store ----------------------------------------
RUNS = ((70.0, 9), (150.0, 14), (300.0, 7))


def _store_farm(store, mod=api, **kw):
    rt = (mod.runtime(n=N, device="cpu", n_slots=2, store=store, **KW, **kw)
          if mod is api else
          mod.runtime(n=N, n_slots=2, store=store, **KW, **kw))
    sids = [rt.submit("cavity", re=re, steps=s) for re, s in RUNS]
    out = rt.drain()
    return rt, [out[s] for s in sids]


def test_store_on_is_bitwise_the_store_off_farm(tmp_path):
    _, on = _store_farm(str(tmp_path / "jobs.sqlite"))
    rt_off, off = _store_farm(None)
    for a, b in zip(on, off):
        assert (a.steps_done, a.terminated) == (b.steps_done, b.terminated)
        _bitwise(a.state, b.state)
    svc = rt_off.services()[0]
    assert rt_off.store is None and svc.store is None
    assert svc.farm.on_transition is None and svc.farm.heartbeat is None


def test_store_backed_farm_matches_the_reference(tmp_path):
    _, ours = _store_farm(str(tmp_path / "a.sqlite"))
    _, theirs = _store_farm(str(tmp_path / "b.sqlite"), mod=ref_api)
    for a, b in zip(ours, theirs):
        assert (a.steps_done, a.terminated) == (b.steps_done, b.terminated)
        for f in FIELDS:
            want = np.asarray(b.state[f])
            diff = float(np.abs(a.state[f].numpy() - want).max())
            assert diff <= RUN_RTOL * max(float(np.abs(want).max()), 1e-30)


def test_drain_persists_rows_and_result_snapshots(tmp_path):
    rt = _rt(n_slots=2, telemetry=True, store=str(tmp_path / "jobs.sqlite"))
    sids = [rt.submit("cavity", re=re, steps=6, tag=t)
            for re, t in ((90.0, "a"), (180.0, "b"), (270.0, "c"))]
    res = rt.drain()
    st = rt.store
    assert st.counts()[jobs.DONE] == 3 and st.queue_depth() == 0
    for sid in sids:
        jid = rt.job_id(sid)
        job = st.get(jid)
        assert (job.status, job.steps_done, job.terminated) == \
            (jobs.DONE, 6, "steps")
        assert st.lease_of(jid) is None
        _bitwise(rt.load_result(jid), res[sid].state)
        assert len(st.events(jid, event="result")) == 1
    kinds = [e["kind"] for e in rt.telemetry.trace.events]
    assert "job_submit" in kinds and "job" in kinds
    assert rt.telemetry.metrics.get("jobs.store_queue_depth") == 0
    assert "repro_jobs_store_queue_depth" in rt.services()[0].prometheus_text()


def test_farm_side_failure_lands_in_the_store(tmp_path):
    rt = _rt(n_slots=2, store=str(tmp_path / "jobs.sqlite"))
    good = rt.submit("cavity", re=100.0, steps=4, tag="good")
    bad = rt.submit("cavity", re=100.0, steps=4, tag="bad")
    svc, inner = rt._routes[bad]
    for req in svc.farm.table.queued_items():
        if req.sid == inner:
            req.init_state = {f: torch.zeros(2, 2) for f in FIELDS}
    rt.drain()
    assert rt.poll(bad)["status"] == "failed"
    job = rt.store.get(rt.job_id(bad))
    assert job.status == jobs.FAILED and job.error
    assert rt.store.get(rt.job_id(good)).status == jobs.DONE


@pytest.mark.parametrize("spill", ["store", "ckpt_dir"])
def test_evict_readmit_through_disk_is_bitwise(spill, tmp_path):
    def run(interrupt, **kw):
        rt = _rt(n_slots=1, **kw)
        sid = rt.submit("cavity", re=140.0, steps=10)
        if interrupt:
            rt.services()[0].run(4)
            assert rt.evict(sid)
            svc, inner = rt._routes[sid]
            assert svc._evicted[inner].state is None   # nothing kept in RAM
            if spill == "store":
                snap = rt.store.latest_snapshot(rt.job_id(sid), "evict")
                assert snap["steps_done"] == 4
                assert set(FIELDS) <= set(snap["fields"])
                assert rt.store.get(rt.job_id(sid)).status == jobs.EVICTED
            else:
                assert svc._ckpt.steps() == [inner]
            assert rt.poll(sid) == {"status": "evicted", "steps_done": 4}
        return rt.drain()[sid]

    smooth = run(False)
    kw = ({"store": str(tmp_path / "jobs.sqlite")} if spill == "store"
          else {"ckpt_dir": str(tmp_path)})
    bumpy = run(True, **kw)
    assert bumpy.steps_done == smooth.steps_done == 10
    _bitwise(bumpy.state, smooth.state)


def test_flight_record_resolves_from_a_fresh_runtime(tmp_path):
    store_path = str(tmp_path / "jobs.sqlite")
    rt = _rt(n_slots=2, check_every=8, health=True,
             ckpt_dir=str(tmp_path / "ck"), store=store_path)
    ok = rt.submit("cavity", re=100.0, steps=16, tag="ok")
    bad = rt.submit("cavity", re=100.0, steps=16, dt=50.0, tag="poison")
    rt.drain()
    assert rt.poll(bad)["status"] == "diverged"
    jid = rt.job_id(bad)
    job = rt.store.get(jid)
    assert job.status == jobs.DIVERGED and "flight record" in job.error
    assert rt.store.get(rt.job_id(ok)).status == jobs.DONE
    rt2 = _rt(n_slots=2, store=store_path)
    rec = rt2.flight_record(jid)
    assert rec["meta"]["tag"] == "poison"
    snap = rt2.store.latest_snapshot(jid, "flight")
    flight_dir = os.path.join(snap["dir"], f"step_{snap['step_key']:08d}")
    assert os.path.isdir(flight_dir)
    rt2.store.prune_terminal(0.0)
    assert not os.path.isdir(flight_dir)
    with pytest.raises(KeyError):
        rt2.flight_record(jid)


# -- SIGKILL resume (subprocess, port only) -----------------------------------
_KILL_SCRIPT = textwrap.dedent("""\
    import os, signal, sys
    from repro_torch import api

    rt = api.runtime(n={n}, device="cpu", n_slots=2, nz=4, jacobi_iters=8,
                     store={{"path": {store!r}, "ttl_s": 1.0}})
    sids = [rt.submit("cavity", re=re, steps=12, tag=tag)
            for re, tag in ((80.0, "a"), (160.0, "b"), (240.0, "c"))]
    rt.enqueue("cavity", re=320.0, steps=12, tag="d")
    svc = rt.services()[0]
    svc.run(4)                     # a, b at step 4; c queued; d detached
    assert rt.evict(sids[0])       # a spills its resume snapshot
    svc.run(2)                     # b goes on; c takes a's slot
    bad = sorted(m for m in sys.modules if m == "jax" or m == "repro"
                 or m.startswith(("jax.", "repro.")))
    print("READY", bad, flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
""")


@pytest.fixture(scope="module")
def killed_store(tmp_path_factory):
    """A store orphaned by a SIGKILLed port process: one evicted sim with a
    snapshot, two mid-run, one detached enqueue."""
    store_path = str(tmp_path_factory.mktemp("kill") / "jobs.sqlite")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT.format(n=N, store=store_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert "READY []" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode == -signal.SIGKILL
    return store_path


def test_the_store_shows_the_orphaned_state(killed_store):
    st = JobStore(killed_store)
    by_tag = {j.tag: j for j in st.jobs()}
    assert by_tag["a"].status == jobs.EVICTED
    assert st.latest_snapshot(by_tag["a"].job_id)["steps_done"] == 4
    assert by_tag["b"].status == by_tag["c"].status == jobs.RUNNING
    assert by_tag["d"].status == jobs.QUEUED
    assert st.lease_of(by_tag["d"].job_id) is None


def test_restart_resumes_incomplete_first_and_matches_bitwise(killed_store):
    time.sleep(1.2)            # the dead process's leases expire
    probe = JobStore(killed_store)
    jid_of = {j.tag: j.job_id for j in probe.jobs()}
    seq0 = probe.last_seq()
    rt = _rt(n_slots=2, telemetry=True,
             store={"path": killed_store, "ttl_s": 30.0})
    incomplete = {jid_of[t] for t in ("a", "b", "c")}
    assert incomplete <= rt._jobs_local and jid_of["d"] not in rt._jobs_local
    rt.drain()
    st = rt.store
    assert st.counts()[jobs.DONE] == 4 and st.queue_depth() == 0
    claims = {e["job_id"]: e["seq"] for e in st.events(after_seq=seq0)
              if e["event"] in ("claim", "takeover") and e["owner"] == st.owner}
    assert max(claims[j] for j in incomplete) < claims[jid_of["d"]]
    assert st.takeovers >= len(incomplete)
    assert rt.telemetry.metrics.get("jobs.resumed") == 3
    for tag, jid in jid_of.items():
        assert len(st.events(jid, event="result")) == 1, tag
    ref = _rt(n_slots=2)
    ref_sids = {tag: ref.submit("cavity", re=re, steps=12, tag=tag)
                for re, tag in ((80.0, "a"), (160.0, "b"), (240.0, "c"),
                                (320.0, "d"))}
    ref_res = ref.drain()
    for tag, jid in jid_of.items():
        _bitwise(st.load_result(jid), ref_res[ref_sids[tag]].state, tag)


# -- two workers, one queue ---------------------------------------------------
def test_shared_queue_drains_without_double_execution(tmp_path):
    path = str(tmp_path / "jobs.sqlite")
    rt_a = _rt(n_slots=2, store=JobStore(path, ttl_s=60.0,
                                         owner="host:1:worker-a"))
    rt_b = _rt(n_slots=2, store=JobStore(path, ttl_s=60.0,
                                         owner="host:1:worker-b"))
    jids = [rt_a.enqueue("cavity", re=80.0 + 40 * i, steps=6, tag=f"t{i}")
            for i in range(4)]
    assert len(rt_a.claim(2)) == 2 and len(rt_b.claim(2)) == 2
    rt_a.drain()
    rt_b.drain()
    st = JobStore(path, owner="host:1:auditor")
    assert st.counts()[jobs.DONE] == 4
    for jid in jids:
        evs = st.events(jid)
        assert len([e for e in evs if e["event"] == "result"]) == 1
        assert len({e["owner"] for e in evs
                    if e["event"] in ("claim", "admit", "result")}) == 1
        assert tuple(st.load_result(jid)["vx"].shape[:2]) == (N, N)


def test_ttl_takeover_from_a_dead_claimer(tmp_path):
    path = str(tmp_path / "jobs.sqlite")
    wstore = JobStore(path, ttl_s=60.0, owner="host:1:live")
    rt = _rt(n_slots=2, store=wstore)
    jid = rt.enqueue("cavity", re=110.0, steps=4, tag="stolen")
    dead = JobStore(path, ttl_s=0.4, owner="host:2:dead")
    assert len(dead.claim()) == 1
    assert rt.claim() == []
    time.sleep(0.5)
    assert len(rt.claim()) == 1 and wstore.takeovers == 1
    rt.drain()
    assert wstore.get(jid).status == jobs.DONE
