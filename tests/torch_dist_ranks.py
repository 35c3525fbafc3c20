"""Rank-side jobs of ``tests/test_torch_dist.py``, run by
``repro_torch.launch.mesh.spawn`` in gloo ranks on the CPU.

Each job runs in every rank and returns numpy data (pickled back to the
test process), so the test can hold it against both packages there.  This
module imports the port only: the ranks start fast and never load JAX.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_mesh

FIELDS = ("vx", "vy", "vz", "p")


def _np(state: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in state.items()}


def seeded(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- halo exchange --------------------------------------------------------------
def rules():
    """rule name -> port rule (the names ``test_torch_dist`` maps to the
    reference's rules)."""
    from repro_torch.cfd import ns3d
    from repro_torch.core import halo

    return {
        "dirichlet": halo.bc_dirichlet(2.5), "neumann": halo.bc_neumann(),
        "mirror": halo.bc_mirror(-1.0),
        "moving_wall": ns3d.bc_moving_wall(0.7)}


def exchange_job(cases, shape):
    """Every rank of a (2, 2) mesh over ("a", "b") — array axes 0 and 1 —
    pads its block of each case's seeded global field; returns the padded
    blocks, the blocks' slices, and the permute operand bytes and sent
    bytes its transport booked."""
    from repro_torch.core import halo
    from repro_torch.core.driver import Domain, GridDriver

    mesh = make_mesh((2, 2), ("a", "b"))
    out = []
    for widths, axes, lead, seed in cases:
        field = seeded((*lead, *shape), seed)
        dom = Domain(shape=shape, decomposition={0: "a", 1: "b"},
                     periodic=tuple(p for p, _, _ in axes))
        drv = GridDriver(dom, "cpu", mesh)
        rl = rules()
        pick = (lambda r: None if r is None else rl[r])
        specs = drv.axis_specs(bc_lo=[pick(lo) for _, lo, _ in axes],
                               bc_hi=[pick(hi) for _, _, hi in axes])
        block = drv.scatter(field)
        drv.transport.reset()
        padded = halo.exchange_pad(block, widths, specs)
        out.append({"padded": padded.numpy(), "slices": drv.block_slices(),
                    "bytes": drv.transport.permute_operand_bytes,
                    "sent_bytes": drv.transport.sent_bytes})
    return out


def overlap_job(shape):
    """``stencil_step_overlap`` on a decomposed (2, 2) block against the
    plain ``kernel(exchange_pad(...))`` form, for a seven-point Laplacian:
    returns both (they must be equal bitwise)."""
    from repro_torch.core import halo
    from repro_torch.core.driver import Domain, GridDriver

    mesh = make_mesh((2, 2), ("a", "b"))
    dom = Domain(shape=shape, decomposition={0: "a", 1: "b"},
                 periodic=(False, True, True))
    drv = GridDriver(dom, "cpu", mesh)
    specs = drv.axis_specs(bc_lo=(halo.bc_mirror(-1.0), None, None),
                           bc_hi=(halo.bc_neumann(), None, None))
    u = drv.scatter(seeded(shape, 5))

    def kernel(p):
        c = p[1:-1, 1:-1, 1:-1]
        return (p[2:, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1] + p[1:-1, 2:, 1:-1]
                + p[1:-1, :-2, 1:-1] + p[1:-1, 1:-1, 2:] + p[1:-1, 1:-1, :-2]
                - 6.0 * c)

    got = halo.stencil_step_overlap(u, (1, 1, 1), specs, kernel)
    want = kernel(halo.exchange_pad(u, (1, 1, 1), specs))
    return got.numpy(), want.numpy()


# -- solver ----------------------------------------------------------------------
def solver_job(n: int, steps: int):
    """Taylor-Green at ``n``, ``steps`` steps, decomposed over (2, 2)
    ("data", "model"): the run's report, the gathered final fields, the
    health report of the decomposed state, and one step's booked exchange
    bytes."""
    from repro_torch.cfd import taylor_green
    from repro_torch.cfd.ns3d import NavierStokes3D

    mesh = make_mesh((2, 2), ("data", "model"))
    decomp = ((0, "data"), (1, "model"))
    rep = taylor_green.run(n=n, steps=steps, device="cpu", mesh=mesh,
                           decomposition=decomp)
    solver = NavierStokes3D(taylor_green.config(n, decomposition=decomp),
                            "cpu", mesh)
    state = solver.init_state()
    step = solver.make_step()
    for _ in range(steps):
        state = step(state)
    whole = {f: solver.driver.gather(state[f]).numpy() for f in FIELDS}
    health = solver.health_report(state)
    solver.driver.transport.reset()
    step(state)
    return {"report": rep, "whole": whole, "health": health,
            "step_bytes": solver.driver.transport.permute_operand_bytes,
            "step_sent_bytes": solver.driver.transport.sent_bytes,
            "local_shape": solver.driver.local_shape}


# -- the farm, slots x shards ------------------------------------------------------
def _serial(cfg, mesh, steps: int) -> dict:
    """The serial decomposed run of ``cfg`` on ``mesh``, gathered."""
    from repro_torch.cfd.ns3d import NavierStokes3D

    solver = NavierStokes3D(cfg, "cpu", mesh)
    state = solver.init_state()
    step = solver.make_step()
    for _ in range(steps):
        state = step(state)
    return {f: solver.driver.gather(state[f]).numpy() for f in FIELDS}


def farm_job(n: int, res, steps_list, evict_at: int, tmp: str):
    """Cavity requests through a (2, 2) ("slot", "shard") farm of 4 slots,
    one evicted at ``evict_at`` (spilled to ``tmp``) and readmitted;
    Taylor-Green slots through a 2-slot farm; the serial decomposed run of
    each request on the (2,) "shard" sub-mesh; and a (4, 1) one-shard farm
    (which degrades to the plain slot-parallel step).  Every rank returns
    its metadata; fields come back from global rank 0."""
    from repro_torch.cfd import cavity, taylor_green
    from repro_torch.sim import SimulationFarm, SimulationService

    rank = dist.get_rank()
    kw = dict(jacobi_iters=20, decomposition=((0, "shard"),))
    mesh = make_mesh((2, 2), ("slot", "shard"))
    shard = mesh["shard"]                      # a (2,) mesh: this rank's line
    out = {"rank": rank}

    svc = SimulationService(cavity.config(n, **kw), n_slots=4, mesh=mesh,
                            slot_axis="slot", ckpt_dir=tmp, device="cpu")
    out["decomposition"] = dict(svc.farm.exec.decomposition)
    out["local_slots"] = list(svc.farm.exec.local_slots)
    sids = [svc.submit(cavity.sim_request(n, re=re, steps=s, **kw))
            for re, s in zip(res, steps_list)]
    svc.run(evict_at)
    victim = sids[1]
    out["evicted"] = svc.evict(victim)
    out["spilled"] = svc._evicted[victim].state is None
    out["readmitted"] = svc.readmit(victim)
    results = svc.drain()
    out["meta"] = {sid: (r.steps_done, r.terminated, sorted(r.state))
                   for sid, r in results.items()}
    out["cavity"] = {sid: _np(results[sid].state) for sid in sids
                     if results[sid].state}
    out["cavity_serial"] = [
        _serial(cavity.config(n, re=re, **kw), shard, s)
        for re, s in zip(res, steps_list)]

    tg_kw = dict(decomposition=((0, "shard"),))
    nus, tg_steps = (0.05, 0.1, 0.2), (6, 8, 5)
    farm = SimulationFarm(taylor_green.config(n, nu=0.1, **tg_kw), n_slots=2,
                          mesh=mesh, slot_axis="slot", device="cpu")
    tg_sids = [farm.submit(taylor_green.sim_request(n, nu=nu, steps=s,
                                                    **tg_kw))
               for nu, s in zip(nus, tg_steps)]
    tg = farm.run_until_drained()
    out["tg"] = {sid: _np(tg[sid].state) for sid in tg_sids if tg[sid].state}
    out["tg_serial"] = [
        _serial(taylor_green.config(n, nu=nu, **tg_kw), shard, s)
        for nu, s in zip(nus, tg_steps)]

    # a one-shard mesh: the decomposition degrades to the plain farm
    flat = make_mesh((4, 1), ("slot", "shard"))
    one = SimulationFarm(cavity.config(n, **kw), n_slots=4, mesh=flat,
                         slot_axis="slot", device="cpu")
    out["one_shard_decomposition"] = dict(one.exec.decomposition)
    one_sids = [one.submit(cavity.sim_request(n, re=re, steps=s, **kw))
                for re, s in zip(res[:4], steps_list[:4])]
    one_res = one.run_until_drained()
    out["one_shard"] = {sid: _np(one_res[sid].state) for sid in one_sids
                        if one_res[sid].state}
    errors = {}
    for name, bad in (("unknown", ((0, "nope"),)),
                      ("slot_axis", ((0, "slot"),)),
                      ("duplicate", ((0, "shard"), (0, "shard")))):
        try:
            SimulationFarm(cavity.config(n, jacobi_iters=20,
                                         decomposition=bad),
                           n_slots=4, mesh=flat, slot_axis="slot",
                           device="cpu")
        except ValueError as e:
            errors[name] = str(e)
    out["one_shard_errors"] = errors
    return out


# -- the front door ------------------------------------------------------------------
def front_door_job(n: int, steps: int):
    """``api.runtime`` on a (2, 2) ("slot", "shard") mesh with x decomposed:
    a blocking ``run("cavity")`` and a submit/drain of two requests (the
    first the run's twin)."""
    from repro_torch import api

    rt = api.runtime(n=n, device="cpu", mesh_shape=(2, 2),
                     mesh_axes=("slot", "shard"),
                     decomposition=((0, "shard"),), jacobi_iters=20)
    res = rt.run("cavity", steps=steps, re=150.0)
    sids = [rt.submit("cavity", steps=steps, re=150.0),
            rt.submit("cavity", steps=steps + 3, re=60.0)]
    out = rt.drain()
    return {"rank": dist.get_rank(), "run": _np(res.state),
            "run_diag": res.diagnostics["kinetic_energy"],
            "run_ghia": res.diagnostics["ghia"],
            "decomposition": res.config.decomposition,
            "farm": {s: _np(out[s].state) for s in sids if out[s].state},
            "meta": {s: (out[s].steps_done, out[s].terminated) for s in sids}}


# -- failure -------------------------------------------------------------------------
def failing_job():
    """Rank 1 raises while rank 0 waits on it in a receive that would never
    complete."""
    if dist.get_rank() == 1:
        raise RuntimeError("planted failure on rank 1")
    buf = torch.empty(4)
    dist.recv(buf, 1)
    return os.getpid()


# -- the job store on a mesh ---------------------------------------------------------
DURABLE_RES = (50.0, 100.0, 200.0, 400.0, 80.0)
DURABLE_STEPS = (8, 12, 6, 10, 14)
# the evicted requests sit in a slot of the second slot rank, whose shard
# group's root is global rank 2: a store gathers them to rank 0 instead
DURABLE_EVICT, DURABLE_EVICT_AT = 3, 4
CRASH_RES, CRASH_STEPS, CRASH_EVICT = (80.0, 160.0, 240.0), 6, 1
QUEUE_RES = (70.0, 140.0, 210.0)
POISON_DT = 50.0


def store_files(path: str) -> list:
    """The files of the store at ``path`` (the database, its WAL and
    shared memory) that this process holds open."""
    names = []
    fd_dir = "/proc/self/fd"
    for fd in os.listdir(fd_dir):
        try:
            names.append(os.readlink(os.path.join(fd_dir, fd)))
        except OSError:              # the listing's own descriptor
            pass
    return sorted(n for n in names if n.startswith(path))


def mesh_runtime(n: int, **kw):
    """``api.runtime`` on a (2, 2) ("slot", "shard") mesh, x decomposed."""
    from repro_torch import api

    return api.runtime(n=n, device="cpu", mesh_shape=(2, 2),
                       mesh_axes=("slot", "shard"),
                       decomposition=((0, "shard"),), jacobi_iters=20, **kw)


def evicting_drive(rt) -> tuple:
    """The five requests, one evicted at ``DURABLE_EVICT_AT`` and
    readmitted; returns (sids, its poll when evicted, the results)."""
    sids = [rt.submit("cavity", steps=s, re=re, tag=f"r{i}")
            for i, (re, s) in enumerate(zip(DURABLE_RES, DURABLE_STEPS))]
    rt.services()[0].run(DURABLE_EVICT_AT)
    assert rt.evict(sids[DURABLE_EVICT])
    evicted = rt.poll(sids[DURABLE_EVICT])
    assert rt.readmit(sids[DURABLE_EVICT])
    return sids, evicted, rt.drain()


def _rows(rt) -> list:
    return [(j.job_id, j.tag, j.status, j.steps_done, j.terminated)
            for j in rt.jobs()]


def crash_job(n: int, path: str, marker: str):
    """A store-backed (2, 2) farm of 2 slots takes the crash requests;
    one is evicted once it has stepped (rank 0 writes its snapshot), the
    queued one takes its slot, and global rank 0 then SIGKILLs itself,
    leaving the survivors in a barrier it never reaches."""
    import json
    import signal
    import sys

    rt = mesh_runtime(n, n_slots=2, store={"path": path, "ttl_s": 1.0})
    sids = [rt.submit("cavity", re=re, steps=CRASH_STEPS, tag=f"crash{i}")
            for i, re in enumerate(CRASH_RES)]
    svc = rt.services()[0]
    svc.run(2)
    assert rt.evict(sids[CRASH_EVICT])  # the first snapshot: the eviction's
    svc.run(2)
    if dist.get_rank() == 0:
        loaded = sorted(m for m in sys.modules if m in ("jax", "repro")
                        or m.startswith(("jax.", "repro.")))
        with open(marker, "w") as f:
            json.dump({"jobs": {rt.job_id(s): rt.poll(s) for s in sids},
                       "loaded": loaded}, f)
        os.kill(os.getpid(), signal.SIGKILL)
    dist.barrier()


def durable_mesh_job(n: int, crash_path: str, paths: dict):
    """Every contract of a job store on a mesh, in one launch: recovery of
    the crash store (against an uninterrupted run, and a recovery that
    ignores the snapshot), the evicting drive with and without a store, a
    queue enqueued by one process drained by the mesh (the store handed
    in as a JobStore on every rank), a poisoned request quarantined, and
    a service built directly.  Fields come back from global rank 0."""
    import dataclasses
    import sqlite3

    from repro_torch import jobs
    from repro_torch.cfd import cavity
    from repro_torch.sim import SimulationService

    rank = dist.get_rank()
    out = {"rank": rank}

    # recovery: the crash's orphans are claimed when the Runtime is built
    crt = mesh_runtime(n, n_slots=2, store={"path": crash_path,
                                            "ttl_s": 30.0})
    out["recovered_rows"] = _rows(crt)
    job_of = {j.tag: j.job_id for j in crt.jobs()}
    crt.drain()
    out["crash_rows"] = _rows(crt)
    out["crash_results"] = {tag: _np(crt.load_result(jid))
                            for tag, jid in job_of.items()}
    victim = job_of[f"crash{CRASH_EVICT}"]
    snap = crt.store.latest_snapshot(victim, "evict")
    payload = crt.store.get(victim).request()
    # the uninterrupted run, and the planted fault: the evicted job from
    # its payload, its snapshot ignored but its step0 kept
    ref = mesh_runtime(n, n_slots=2)
    ref_sids = {f"crash{i}": ref.submit("cavity", re=re, steps=CRASH_STEPS)
                for i, re in enumerate(CRASH_RES)}
    svc = ref.services()[0]
    fault = svc.submit(dataclasses.replace(payload,
                                           step0=snap["steps_done"]))
    ref_out = ref.drain()
    out["uninterrupted"] = {tag: _np(ref_out[sid].state)
                            for tag, sid in ref_sids.items()}
    out["fault"] = _np(svc.farm.results[fault].state)
    out["fault_step0"] = snap["steps_done"]

    # the evicting drive through a store-backed farm, then without one
    srt = mesh_runtime(n, n_slots=4, store=paths["farm"])
    sids, out["evicted_poll"], res = evicting_drive(srt)
    out["job_ids"] = [srt.job_id(s) for s in sids]
    out["rows"] = _rows(srt)
    out["polls"] = [srt.poll(s) for s in sids]
    out["meta"] = {s: (r.steps_done, r.terminated) for s, r in res.items()}
    out["store_fields"] = {s: _np(res[s].state) for s in sids}
    out["load_result"] = {s: _np(srt.load_result(srt.job_id(s)))
                          for s in sids}
    out["owner"] = srt.store.owner
    out["holds_store"] = srt.store.local is not None
    prt = mesh_runtime(n, n_slots=4)
    psids, _, pres = evicting_drive(prt)
    out["plain_fields"] = {s: _np(pres[s].state) for s in psids}

    # a queue enqueued by one process, drained by the mesh; the store is
    # handed in on every rank, and only rank 0's is used
    handed = jobs.JobStore(paths["queue"])
    qrt = mesh_runtime(n, n_slots=2, store=handed)
    first = qrt.claim()
    qout = qrt.drain()
    out["queue_first_claim"] = [qrt.job_id(s) for s in first]
    out["queue_admitted"] = [(s, qrt.job_id(s)) for s in qrt._routes]
    out["queue_meta"] = {s: (r.steps_done, r.terminated)
                         for s, r in qout.items()}
    out["queue_depth"] = qrt.store.queue_depth()
    out["queue_counts"] = qrt.store.counts()
    try:
        handed._conn.execute("SELECT 1")
        out["handed_open"] = True
    except sqlite3.ProgrammingError:
        out["handed_open"] = False

    # quarantine: a request poisoned with dt far past the CFL limit
    hrt = mesh_runtime(n, n_slots=2, check_every=8, health=True,
                       ckpt_dir=paths["health"], store=True)
    bad = hrt.submit("cavity", steps=16, re=100.0, dt=POISON_DT,
                     tag="poison")
    ok = hrt.submit("cavity", steps=16, re=100.0, tag="ok")
    hrt.drain()
    out["poison"] = (hrt.job_id(bad), hrt.poll(bad)["status"],
                     hrt.poll(ok)["status"])
    rec = hrt.flight_record(hrt.job_id(bad))
    out["flight"] = {"tag": rec["meta"]["tag"],
                     "frames": tuple(rec["frames"].shape),
                     "state": sorted(rec["state"])}

    # a service built directly on the mesh with a JobStore on every rank
    mesh = srt.mesh
    direct = SimulationService(
        cavity.config(n, jacobi_iters=20, decomposition=((0, "shard"),)),
        n_slots=4, mesh=mesh, slot_axis="slot", device="cpu",
        store=jobs.JobStore(paths["service"]))
    dsid = direct.submit(cavity.sim_request(
        n, re=90.0, steps=3, jacobi_iters=20, decomposition=((0, "shard"),)))
    direct.drain()
    out["service"] = (type(direct.store).__name__, direct.job_of(dsid),
                      direct.poll(dsid))
    out["open_store_files"] = sorted(
        f for p in paths.values() for f in store_files(p)) + store_files(
        crash_path)
    return out
