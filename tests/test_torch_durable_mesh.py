"""The job store on a slots × shards farm, against the reference, on the CPU.

The reference runs one controller over its mesh, so its store is one
process's.  The port runs a process a rank; ``repro_torch.jobs.MeshStore``
keeps the store global rank 0's and broadcasts its answers.  Two gloo
launches of 4 ranks on (slot 2, shard 2), x decomposed, n = 16,
``jacobi_iters=20`` (rank jobs in ``tests/torch_dist_ranks.py``):

* a crash launch: a store-backed farm evicts a job once it has stepped
  (rank 0 writes its snapshot), then global rank 0 SIGKILLs itself;
* one launch for the rest: the crash store recovered and drained, bitwise
  an uninterrupted meshed run, one ``result`` event a job, a recovery that
  ignores the snapshot rejected; five requests, one evicted through the
  store, bitwise the store-less meshed farm, with rows and event sequences
  equal to the reference's single-process store-backed run, fields within
  ``RUN_RTOL`` of it, and the store file read back by ``repro.jobs``;
  a queue enqueued by one process drained by the mesh in one order on
  every rank; a poisoned request quarantined with its flight record
  registered by rank 0; a service built directly with a mesh and a store.

Every rank reports its job ids, rows and polls, and the store files it
holds open: rank 0 alone holds any, and one owner writes each store.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro import api as ref_api
from repro import jobs as ref_jobs

from repro_torch import api, jobs
from repro_torch.jobs import JobStore
from repro_torch.launch.mesh import RankFailed, spawn
from tests import torch_dist_ranks as ranks

N = 16
FIELDS = ("vx", "vy", "vz", "p")
RUN_RTOL = 1e-4             # tests/test_torch_jobs.py's bound
LAUNCH_S = 240.0
DECOMP = ((0, "shard"),)


def _equal(a: dict, b: dict, what: str):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                      err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    root = tmp_path_factory.mktemp("durable_mesh")
    crash_path = str(root / "crash" / "jobs.sqlite")
    marker = str(root / "crash" / "killed.json")
    with pytest.raises(RankFailed):
        spawn(ranks.crash_job, 4, args=(N, crash_path, marker),
              timeout_s=LAUNCH_S)
    with open(marker) as f:
        killed = json.load(f)
    probe = JobStore(crash_path)
    at_crash = {j.tag: (j.status, probe.lease_of(j.job_id))
                for j in probe.jobs()}
    crash_seq = probe.last_seq()
    leases = [lease["expires_at"] for _, lease in at_crash.values() if lease]
    time.sleep(max(max(leases, default=0.0) - time.time(), 0.0) + 0.1)
    probe.close()

    paths = {"farm": str(root / "farm" / "jobs.sqlite"),
             "queue": str(root / "queue" / "jobs.sqlite"),
             "health": str(root / "health"),
             "service": str(root / "service" / "jobs.sqlite")}
    # one process enqueues; the mesh claims and drains
    front = api.runtime(n=N, device="cpu", jacobi_iters=20,
                        decomposition=DECOMP, store=paths["queue"])
    queued = [front.enqueue("cavity", steps=5 + i, re=re, tag=f"q{i}")
              for i, re in enumerate(ranks.QUEUE_RES)]
    front.store.close()
    # a JobStore handed in on every rank opens an existing file: four
    # processes making a new one race for its journal mode
    JobStore(paths["service"]).close()
    out = spawn(ranks.durable_mesh_job, 4, args=(N, crash_path, paths),
                timeout_s=LAUNCH_S)
    return {"out": out, "killed": killed, "at_crash": at_crash,
            "crash_seq": crash_seq, "crash_path": crash_path,
            "paths": paths, "queued": queued}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's single-process store-backed run of the evicting
    drive (undecomposed: the reference mesh is one device here)."""
    path = str(tmp_path_factory.mktemp("ref_store") / "jobs.sqlite")
    rt = ref_api.runtime(n=N, n_slots=4, jacobi_iters=20, store=path)
    sids = [rt.submit("cavity", steps=s, re=re, tag=f"r{i}")
            for i, (re, s) in enumerate(zip(ranks.DURABLE_RES,
                                            ranks.DURABLE_STEPS))]
    rt.services()[0].run(ranks.DURABLE_EVICT_AT)
    assert rt.evict(sids[ranks.DURABLE_EVICT])
    assert rt.readmit(sids[ranks.DURABLE_EVICT])
    res = rt.drain()
    store = ref_jobs.JobStore(path)
    return {"rt": rt, "sids": sids, "res": res, "store": store}


def _port_store(launches) -> JobStore:
    return JobStore(launches["paths"]["farm"])


# -- the store-backed farm ---------------------------------------------------------
def test_store_backed_mesh_farm_is_bitwise_the_storeless_one(launches):
    head = launches["out"][0]
    assert len(head["store_fields"]) == len(ranks.DURABLE_RES)
    for sid, fields in head["store_fields"].items():
        _equal(fields, head["plain_fields"][sid], f"sid {sid}")
        _equal(head["load_result"][sid], fields, f"load_result {sid}")
    for r in launches["out"][1:]:
        assert all(not f for f in r["store_fields"].values())
        assert all(not f for f in r["load_result"].values())


def test_mesh_store_rows_and_events_equal_the_references(launches,
                                                         reference):
    ours, theirs = _port_store(launches), reference["store"]
    mine = [(j.tag, j.status, j.steps_done, j.terminated)
            for j in ours.jobs()]
    ref = [(j.tag, j.status, j.steps_done, j.terminated)
           for j in theirs.jobs()]
    assert mine == ref
    assert [m[1] for m in mine] == ["done"] * len(ranks.DURABLE_RES)
    for a, b in zip(ours.jobs(), theirs.jobs()):
        assert [e["event"] for e in ours.events(a.job_id)] == \
            [e["event"] for e in theirs.events(b.job_id)], a.tag
    snap = ours.latest_snapshot(ours.jobs()[ranks.DURABLE_EVICT].job_id,
                                "evict")
    assert snap["steps_done"] == ranks.DURABLE_EVICT_AT


def test_mesh_store_fields_within_run_rtol_of_the_reference(launches,
                                                            reference):
    head = launches["out"][0]
    for (sid, fields), rsid in zip(sorted(head["store_fields"].items()),
                                   reference["sids"]):
        want_res = reference["res"][rsid]
        assert head["meta"][sid] == (want_res.steps_done,
                                     want_res.terminated)
        for f in FIELDS:
            want = np.asarray(want_res.state[f])
            diff = float(np.abs(fields[f] - want).max())
            assert diff <= RUN_RTOL * max(float(np.abs(want).max()), 1e-30)


def test_every_rank_reports_the_same_job_ids_rows_and_polls(launches):
    out = launches["out"]
    head = out[0]
    assert head["job_ids"] == sorted(head["job_ids"])
    assert head["evicted_poll"] == {"status": "evicted",
                                    "steps_done": ranks.DURABLE_EVICT_AT}
    for r in out:
        for key in ("job_ids", "rows", "polls", "evicted_poll", "meta",
                    "recovered_rows", "crash_rows", "queue_admitted",
                    "queue_meta", "poison", "flight", "service"):
            if key == "flight":
                assert {k: v for k, v in r[key].items() if k != "state"} == \
                    {k: v for k, v in head[key].items() if k != "state"}
            else:
                assert r[key] == head[key], (r["rank"], key)
    assert [p["status"] for p in head["polls"]] == ["done"] * 5


def test_the_reference_reads_the_mesh_store_bitwise(launches):
    head = launches["out"][0]
    theirs = ref_jobs.JobStore(launches["paths"]["farm"])
    for sid, jid in zip(sorted(head["store_fields"]), head["job_ids"]):
        _equal({f: np.asarray(v) for f, v in
                theirs.load_result(jid).items()},
               head["store_fields"][sid], f"job {jid}")


def test_only_rank_0_opens_the_store_and_one_owner_writes_it(launches):
    out = launches["out"]
    assert out[0]["holds_store"] and out[0]["open_store_files"]
    for r in out[1:]:
        assert not r["holds_store"] and r["open_store_files"] == []
        assert not r["handed_open"]        # the JobStore it was handed
    assert out[0]["handed_open"]
    assert len({r["owner"] for r in out}) == 1
    farm = JobStore(launches["paths"]["farm"])
    assert {e["owner"] for e in farm.events()} == {out[0]["owner"]}
    # the queue's rows were submitted by the enqueuing process
    queue = JobStore(launches["paths"]["queue"])
    assert len({e["owner"] for e in queue.events()
                if e["event"] != "submit"}) == 1
    crash, seq = JobStore(launches["crash_path"]), launches["crash_seq"]
    for launch in (lambda e: e["seq"] <= seq, lambda e: e["seq"] > seq):
        assert len({e["owner"] for e in crash.events() if launch(e)}) == 1


# -- a killed mesh -------------------------------------------------------------------
def test_the_killed_mesh_left_orphaned_rows_with_lapsed_leases(launches):
    at = launches["at_crash"]
    assert launches["killed"]["loaded"] == []
    assert at[f"crash{ranks.CRASH_EVICT}"][0] == jobs.EVICTED
    assert {s for s, _ in at.values()} <= {jobs.RUNNING, jobs.EVICTED}
    assert all(lease is not None for _, lease in at.values())
    head = launches["out"][0]
    # recovered in the new launch: every row leased to it again
    assert {row[2] for row in head["recovered_rows"]} <= {
        jobs.RUNNING, jobs.EVICTED}


def test_a_killed_mesh_recovers_bitwise_an_uninterrupted_run(launches):
    head = launches["out"][0]
    assert [row[2] for row in head["crash_rows"]] == ["done"] * 3
    for tag, want in head["uninterrupted"].items():
        _equal(head["crash_results"][tag], want, tag)


def test_recovery_runs_each_job_once_with_one_result_event(launches):
    st = JobStore(launches["crash_path"])
    seq = launches["crash_seq"]
    for job in st.jobs():
        assert len(st.events(job.job_id, event="result")) == 1, job.tag
        after = st.events(job.job_id, after_seq=seq)
        admits = [json.loads(e["detail"]) for e in after
                  if e["event"] == "admit"]
        # one admission in the new launch, at the step it had reached
        assert len(admits) == 1, job.tag
        if job.tag == f"crash{ranks.CRASH_EVICT}":
            assert admits[0]["steps_done"] == launches["out"][0][
                "fault_step0"] == 2
        assert job.steps_done == ranks.CRASH_STEPS


def test_a_recovery_that_ignores_the_snapshot_is_rejected(launches):
    head = launches["out"][0]
    tag = f"crash{ranks.CRASH_EVICT}"
    good = head["uninterrupted"][tag]
    assert any(not np.array_equal(head["fault"][f], good[f])
               for f in FIELDS)
    _equal(head["crash_results"][tag], good, "the real recovery")


# -- a shared queue, quarantine, a service ------------------------------------------
def test_a_shared_queue_drains_in_one_order_on_every_rank(launches):
    head = launches["out"][0]
    queued = launches["queued"]
    assert head["queue_first_claim"] == queued[:2]
    assert [jid for _, jid in head["queue_admitted"]] == queued
    assert head["queue_depth"] == 0 and head["queue_counts"]["done"] == 3
    assert sorted(head["queue_meta"].values()) == [
        (5 + i, "steps") for i in range(3)]


def test_quarantine_on_a_mesh_registers_the_flight_record_on_rank_0(
        launches):
    out = launches["out"]
    jid, bad, ok = out[0]["poison"]
    assert (bad, ok) == ("diverged", "done")
    assert out[0]["flight"]["state"] and all(
        r["flight"]["state"] == [] for r in out[1:])
    path = os.path.join(launches["paths"]["health"], "jobs.sqlite")
    fresh = api.runtime(n=N, device="cpu", jacobi_iters=20, store=path)
    rec = fresh.flight_record(jid)
    assert rec["meta"]["tag"] == "poison"
    assert {"vx", "vy", "vz", "p"} <= set(rec["state"])
    assert tuple(rec["frames"].shape) == out[0]["flight"]["frames"]
    assert "flight record" in fresh.store.get(jid).error


def test_a_service_builds_with_a_mesh_and_a_store(launches):
    for r in launches["out"]:
        kind, jid, poll = r["service"]
        assert kind == "MeshStore" and jid == 1
        assert poll == {"status": "done", "steps_done": 3}
    st = JobStore(launches["paths"]["service"])
    assert [(j.status, j.steps_done) for j in st.jobs()] == [("done", 3)]
    assert tuple(st.load_result(1)["vx"].shape[:2]) == (N, N)
