"""The decomposed CFD path of the port — slots × shards over
``torch.distributed`` — against the reference, on the CPU.

The multi-rank contracts run in gloo ranks started by
``repro_torch.launch.mesh.spawn`` (their jobs are in
``tests/torch_dist_ranks.py``, which imports the port only); each job
returns numpy data and the assertions run here, where the reference is
loaded.  Several contracts share one launch, to keep the file short:

* the placement rules equal the reference's entry by entry, error texts
  included (no ranks: both take a stub mesh);
* the ghost exchange is data movement: every rank's decomposed pad equals
  the same block of the port's and of the reference's undecomposed pad of
  the global field, bitwise, and the overlapped stencil equals the plain
  form;
* the decomposed Taylor-Green solver is within 1e-5 of the port's and the
  reference's serial runs (``tests/test_cfd.py``'s bound), its health
  report of a state equals the serial report of the same state (max, min,
  sentinel exactly, energy to 1e-6), and one step books the analytic halo
  bytes;
* a slots × shards farm slot is bitwise the serial decomposed run, through
  an eviction too (the reference's ``tests/test_sim_farm.py:528-640``);
* one failing rank ends the launch within its deadline;
* the front door runs a decomposed cavity and a farm in 4 ranks.
"""
from __future__ import annotations

import dataclasses
import math
import time
import types

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

import jax.numpy as jnp
from repro.cfd import ns3d as ref_ns3d, taylor_green as ref_tg
from repro.core import halo as ref_halo
from repro.dist import sharding as ref_sharding
from repro.sim import ensemble as ref_ensemble

from repro_torch import api
from repro_torch.cfd import cavity, taylor_green
from repro_torch.cfd.ns3d import NavierStokes3D
from repro_torch.core import halo
from repro_torch.dist import sharding
from repro_torch.launch.mesh import RankFailed, spawn
from repro_torch.obs import perf
from repro_torch.sim import SimulationFarm, ensemble, farm as farm_mod
from tests import torch_dist_ranks as ranks

FIELDS = ("vx", "vy", "vz", "p")
N = 16
RUN_TOL = 1e-5            # tests/test_cfd.py's decomposed-vs-serial bound
KE_TOL = 1e-6
LAUNCH_S = 240.0


def _stub(**extents):
    """The reference mesh's interface: ``shape`` and ``axis_names``."""
    return types.SimpleNamespace(shape=dict(extents),
                                 axis_names=tuple(extents))


def _outcome(fn, *args, **kw):
    try:
        return "ok", tuple(fn(*args, **kw))
    except Exception as e:            # the class and the text are compared
        return type(e).__name__, str(e)


# -- placement rules ------------------------------------------------------------
MESH_2x4 = dict(slot=2, shard=4)
MESH_2x2x2 = dict(slot=2, sx=2, sy=2)

SLOT_SPEC_CASES = [
    (MESH_2x4, 4, "slot"), (MESH_2x4, 3, "slot"), (MESH_2x4, 8, "shard"),
    (MESH_2x4, 4, "nope"), (MESH_2x2x2, 2, "slot")]

DECOMP_CASES = [
    (((0, "shard"),), 3, MESH_2x4, "slot"),
    ({0: "shard"}, 3, MESH_2x4, "slot"),
    (((0, "sx"), (1, "sy")), 3, MESH_2x2x2, "slot"),
    (((0, "shard"), (0, "shard")), 3, MESH_2x4, "slot"),   # duplicated
    (((3, "shard"),), 3, MESH_2x4, "slot"),                # bad array axis
    (((-1, "shard"),), 3, MESH_2x4, "slot"),
    (((0, "nope"),), 3, MESH_2x4, "slot"),                 # unknown axis
    (((0, "slot"),), 3, MESH_2x4, "slot"),                 # the slot axis
    (((0, "slot"),), 3, MESH_2x4, None)]

FIELD_CASES = [
    (MESH_2x4, 4, (16, 16, 4), ((0, "shard"),), "slot"),
    (MESH_2x4, 3, (16, 16, 4), ((0, "shard"),), "slot"),    # slots replicate
    (MESH_2x2x2, 2, (16, 16, 4), ((0, "sx"), (1, "sy")), "slot"),
    (MESH_2x4, 4, (18, 16, 4), ((0, "shard"),), "slot"),    # grid raises
    (MESH_2x4, 4, (16, 16, 4), ((1, "shard"),), "slot"),
    (MESH_2x4, 4, (16, 16, 4), (), "slot"),
    (MESH_2x4, 4, (16, 16, 4), ((0, "nope"),), "slot"),
    (MESH_2x4, 4, (16, 16, 4), ((0, "shard"),), "nope"),   # no slot axis
    (MESH_2x4, 4, (16, 16, 4), ((4, "shard"),), "slot"),
    (MESH_2x4, 4, (16, 16, 4), ((0, "shard"), (0, "slot")), "slot")]


@pytest.mark.parametrize("rule, cases", [
    ("slot_spec", SLOT_SPEC_CASES), ("validate_decomposition", DECOMP_CASES),
    ("slot_field_spec", FIELD_CASES)])
def test_placement_rules_equal_the_reference(rule, cases):
    """Each rule's placement (a tuple of mesh-axis names, the reference's
    PartitionSpec entry by entry) or its exception class and text."""
    for case in cases:
        if rule == "slot_spec":
            mesh, n, axis = case
            args, kw = (_stub(**mesh), n), dict(axis=axis)
        elif rule == "validate_decomposition":
            decomp, n_axes, mesh, slot_axis = case
            args, kw = (decomp, n_axes, tuple(mesh)), dict(slot_axis=slot_axis)
        else:
            mesh, n, shape, decomp, slot_axis = case
            args, kw = (_stub(**mesh), n, shape, decomp), dict(
                slot_axis=slot_axis)
        want = _outcome(getattr(ref_sharding, rule), *args, **kw)
        got = _outcome(getattr(sharding, rule), *args, **kw)
        assert got == want, (rule, case)


def test_plan_decomposition_equals_the_reference_and_needs_a_mesh():
    """The farm's resolution: extent-1 axes dropped after validation, the
    same ValueErrors (a 1-shard mesh included), and no mesh raising with a
    message naming the mesh; the decomposition is part of the static key."""
    cfg = cavity.config(N, jacobi_iters=20, decomposition=((0, "shard"),))
    ref_cfg = ref_ns3d.CFDConfig(**{
        k: v for k, v in dataclasses.asdict(cfg).items()})
    for mesh, slot_axis in ((_stub(slot=2, shard=2), "slot"),
                            (_stub(slot=4, shard=1), "slot"),
                            (_stub(slot=2, shard=2, x=1), "slot")):
        for decomp in (((0, "shard"),), ((0, "shard"), (1, "x")),
                       ((0, "nope"),), ((0, "slot"),), ((0, "shard"),) * 2):
            got = _outcome(lambda: [ensemble.plan_decomposition(
                dataclasses.replace(cfg, decomposition=decomp), mesh,
                slot_axis)[1]])
            want = _outcome(lambda: [ref_ensemble.plan_decomposition(
                dataclasses.replace(ref_cfg, decomposition=decomp), mesh,
                slot_axis)[1]])
            assert got == want, (decomp, mesh.shape)
    with pytest.raises(ValueError, match="mesh"):
        SimulationFarm(cfg, n_slots=2, device="cpu")
    assert farm_mod.static_key(cfg, 2) != farm_mod.static_key(
        dataclasses.replace(cfg, decomposition=()), 2)
    assert ((0, "shard"),) in farm_mod.static_key(cfg, 2)


# -- the ghost exchange ------------------------------------------------------------
SHAPE = (8, 8, 4)
# (periodic, lo rule, hi rule) per axis; axes 0 and 1 are decomposed
AXES = {
    "periodic": [(True, None, None)] * 3,
    "dirichlet": [(False, "dirichlet", "dirichlet"),
                  (False, "dirichlet", None), (True, None, None)],
    "mirror": [(False, "mirror", "moving_wall"), (False, "mirror", "mirror"),
               (False, "neumann", "dirichlet")],
    "neumann": [(False, "neumann", "neumann"), (True, None, None),
                (False, "neumann", "neumann")],
}
WIDTHS = {"1": (1, 1, 1), "lo": ((1, 0),) * 3, "hi": ((0, 1),) * 3,
          "2": (2, 2, 2)}
EXCHANGE_CASES = [(w, a, (), 7 + i) for i, (w, a) in enumerate(
    (w, a) for w in WIDTHS for a in AXES)]
# under a leading slot axis every strip is non-contiguous
EXCHANGE_CASES += [("2", "mirror", (3,), 40), ("lo", "periodic", (2,), 41)]

REF_RULES = {"dirichlet": lambda: ref_halo.bc_dirichlet(2.5),
             "neumann": ref_halo.bc_neumann,
             "mirror": lambda: ref_halo.bc_mirror(-1.0),
             "moving_wall": lambda: ref_ns3d.bc_moving_wall(0.7)}


def _norm(w):
    return (w, w) if isinstance(w, int) else tuple(w)


@pytest.fixture(scope="module")
def exchanged():
    cases = [(WIDTHS[w], AXES[a], lead, seed)
             for w, a, lead, seed in EXCHANGE_CASES]
    t0 = time.perf_counter()
    blocks = spawn(ranks.exchange_job, 4, args=(cases, SHAPE),
                   timeout_s=LAUNCH_S)
    overlap = spawn(ranks.overlap_job, 4, args=(SHAPE,), timeout_s=LAUNCH_S)
    return blocks, overlap, time.perf_counter() - t0


def test_decomposed_exchange_is_bitwise_both_packages(exchanged):
    """Every rank's padded block is the same block of the undecomposed pad
    of the global field — the port's and the reference's (jnp, one
    device) — bit for bit, and its transport booked the reference's
    collective-permute operand bytes (one strip a side, edges included)
    and sent the strips that have a receiver."""
    blocks, _, _ = exchanged
    rl = ranks.rules()
    for i, (w, a, lead, seed) in enumerate(EXCHANGE_CASES):
        widths, axes = WIDTHS[w], AXES[a]
        field = ranks.seeded((*lead, *SHAPE), seed)
        plain = halo.exchange_pad(torch.from_numpy(field), widths, [
            halo.AxisSpec(array_axis=ax, periodic=p,
                          bc_lo=rl.get(lo), bc_hi=rl.get(hi))
            for ax, (p, lo, hi) in enumerate(axes)]).numpy()
        ref = np.asarray(ref_halo.exchange_pad(jnp.asarray(field), [
            *([0] * len(lead)), *widths], [
            *[ref_halo.AxisSpec(array_axis=j) for j in range(len(lead))],
            *[ref_halo.AxisSpec(
                array_axis=len(lead) + ax, periodic=p,
                bc_lo=REF_RULES[lo]() if lo else None,
                bc_hi=REF_RULES[hi]() if hi else None)
              for ax, (p, lo, hi) in enumerate(axes)]]))
        np.testing.assert_array_equal(plain, ref, err_msg=f"case {i}")
        local = (SHAPE[0] // 2, SHAPE[1] // 2, SHAPE[2])
        want_bytes = perf.exchange_permute_bytes(
            local, widths, {0, 1}) * int(np.prod(lead or (1,)))
        for r, got in enumerate(blocks):
            out = got[i]
            cut = [Ellipsis]
            for ax, sl in enumerate(out["slices"]):
                lo, hi = _norm(widths[ax])
                cut.append(slice(sl.start, sl.stop + lo + hi))
            np.testing.assert_array_equal(out["padded"], plain[tuple(cut)],
                                          err_msg=f"case {i} rank {r}")
            assert out["bytes"] == want_bytes, (i, r)
            coords = [sl.start // n for sl, n in zip(out["slices"], local)]
            assert out["sent_bytes"] == _sent_bytes(
                local, widths, coords, [p for p, _, _ in axes],
                int(np.prod(lead or (1,)))), (i, r)


def _sent_bytes(local, widths, coords, periodic, lead):
    """The bytes a rank at ``coords`` of the (2, 2) mesh sends: on each
    decomposed axis its hi strip (width lo) where a hi neighbour exists
    and its lo strip (width hi) where a lo one does, at the shape padded
    so far."""
    shape, total = list(local), 0
    for ax, w in enumerate(widths):
        lo, hi = _norm(w)
        if ax < 2:
            face = math.prod(shape) // shape[ax] * 4 * lead
            if lo and (periodic[ax] or coords[ax] + 1 < 2):
                total += lo * face
            if hi and (periodic[ax] or coords[ax] - 1 >= 0):
                total += hi * face
        shape[ax] += lo + hi
    return total


def test_overlapped_stencil_equals_the_plain_form_on_every_rank(exchanged):
    _, overlap, seconds = exchanged
    for got, want in overlap:
        np.testing.assert_array_equal(got, want)
    assert seconds < LAUNCH_S


# -- the solver ------------------------------------------------------------------------
def test_decomposed_taylor_green_matches_both_serial_runs():
    """Taylor-Green n=16, 8 steps over (2, 2) ("data", "model"): the
    report within 1e-5 of the port's and the reference's serial runs; the
    health report of the decomposed state equal to the serial report of
    the same (gathered) state; one step's booked operand bytes the
    analytic halo model's, and on these periodic axes all of them sent."""
    out = spawn(ranks.solver_job, 4, args=(N, 8), timeout_s=LAUNCH_S)
    serial = taylor_green.run(n=N, steps=8, device="cpu")
    ref = ref_tg.run(n=N, steps=8)
    for r in out:
        rep = r["report"]
        assert rep == out[0]["report"]          # every rank reports alike
        for key in ("err_vx", "energy", "div_max"):
            assert abs(rep[key] - serial[key]) < RUN_TOL, key
            assert abs(rep[key] - float(ref[key])) < RUN_TOL, key
        assert r["local_shape"] == (N // 2, N // 2, 4)
    whole = out[0]["whole"]
    for r in out[1:]:
        for f in FIELDS:
            np.testing.assert_array_equal(r["whole"][f], whole[f])
    solver = NavierStokes3D(taylor_green.config(N), "cpu")
    state = dict(solver.init_state(),
                 **{f: torch.from_numpy(whole[f]) for f in FIELDS})
    want = solver.health_report(state)
    for r in out:
        got = r["health"]
        for key in ("div_linf", "umax", "cfl", "finite"):
            assert got[key] == want[key], key
        assert abs(got["ke"] - want["ke"]) < KE_TOL
    cfg = taylor_green.config(N, decomposition=((0, "data"), (1, "model")))
    bytes_ = perf.halo_bytes_per_step(cfg, {0: "data", 1: "model"},
                                      {"data": 2, "model": 2})
    assert {r["step_bytes"] for r in out} == {bytes_}
    # every axis is periodic: each strip has a receiver and is sent
    assert {r["step_sent_bytes"] for r in out} == {bytes_}


# -- the farm, slots x shards -----------------------------------------------------------
RES = (50.0, 100.0, 200.0, 400.0, 80.0, 300.0)
STEPS = (20, 30, 25, 35, 30, 20)


def _equal(a: dict, b: dict, what: str):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                      err_msg=f"{what} {f}")


def test_slots_x_shards_farm_is_bitwise_the_serial_decomposed_run(tmp_path):
    """On a (2, 2) ("slot", "shard") mesh: every cavity slot — one evicted,
    spilled and readmitted — and every Taylor-Green slot is bitwise the
    serial decomposed run on a (2,) shard mesh; the first is within 1e-5
    of the undecomposed serial run; every rank reports the same metadata
    and rank 0 alone holds the fields; a (4, 1) one-shard mesh degrades to
    the plain farm, bitwise, and still rejects bad decompositions."""
    out = spawn(ranks.farm_job, 4,
                args=(N, RES, STEPS, 10, str(tmp_path)), timeout_s=LAUNCH_S)
    head = out[0]
    assert head["decomposition"] == {0: "shard"}
    assert [r["local_slots"] for r in out] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    for r in out:
        assert (r["evicted"], r["spilled"], r["readmitted"]) == (True,) * 3
        assert {s: m[:2] for s, m in r["meta"].items()} == {
            s: m[:2] for s, m in head["meta"].items()}
    for r in out[1:]:
        assert not r["cavity"] and not r["tg"] and not r["one_shard"]
        assert all(m[2] == [] for m in r["meta"].values())
    sids = sorted(head["cavity"])
    assert len(sids) == len(RES)
    for sid, steps in zip(sids, STEPS):
        assert head["meta"][sid][:2] == (steps, "steps")
        _equal(head["cavity"][sid], head["cavity_serial"][sid],
               f"cavity sid {sid}")
    for i, sid in enumerate(sorted(head["tg"])):
        _equal(head["tg"][sid], head["tg_serial"][i], f"tg sid {sid}")
    # vs the undecomposed serial run: the pmean adds in rank order
    solver = NavierStokes3D(cavity.config(N, re=RES[0], jacobi_iters=20),
                            "cpu")
    state, step = solver.init_state(), solver.make_step()
    for _ in range(STEPS[0]):
        state = step(state)
    for f in FIELDS:
        d = float(np.abs(state[f].numpy() - head["cavity"][sids[0]][f]).max())
        assert d < RUN_TOL, (f, d)
    # the one-shard mesh is the plain slot-parallel farm
    assert head["one_shard_decomposition"] == {}
    plain = SimulationFarm(cavity.config(N, jacobi_iters=20), n_slots=4,
                           device="cpu")
    psids = [plain.submit(cavity.sim_request(N, re=re, steps=s,
                                             jacobi_iters=20))
             for re, s in zip(RES[:4], STEPS[:4])]
    pres = plain.run_until_drained()
    for psid, sid in zip(psids, sorted(head["one_shard"])):
        _equal(pres[psid].state, head["one_shard"][sid], f"one-shard {sid}")
    errors = head["one_shard_errors"]
    assert "has no axis 'nope'" in errors["unknown"]
    assert "is the slot axis" in errors["slot_axis"]
    assert "more than once" in errors["duplicate"]


# -- failure and the front door ----------------------------------------------------------
def test_a_failing_rank_ends_the_launch_within_its_deadline():
    t0 = time.perf_counter()
    with pytest.raises(RankFailed, match="planted failure on rank 1"):
        spawn(ranks.failing_job, 2, timeout_s=60.0)
    assert time.perf_counter() - t0 < 60.0
    with pytest.raises(ValueError, match="gloo"):
        spawn(ranks.failing_job, 2, backend="mpi")
    with pytest.raises(ValueError, match="index"):
        spawn(ranks.failing_job, 2, device="cuda")


def test_front_door_runs_a_decomposed_cavity_and_farm():
    """``api.runtime(mesh_shape=(2, 2), mesh_axes=("slot", "shard"),
    decomposition=((0, "shard"),))`` in 4 ranks: ``run`` gathers the global
    fields on every rank (within 1e-5 of the undecomposed run), the farm's
    twin request equals it bitwise on rank 0; without a process group the
    same config raises."""
    out = spawn(ranks.front_door_job, 4, args=(N, 10), timeout_s=LAUNCH_S)
    head = out[0]
    assert head["decomposition"] == ((0, "shard"),)
    for r in out:
        _equal(r["run"], head["run"], f"rank {r['rank']} run")
        assert r["meta"] == head["meta"] == {0: (10, "steps"), 1: (13, "steps")}
        assert r["run_ghia"] == head["run_ghia"]
    _equal(head["farm"][0], head["run"], "farm twin of the run")
    plain = api.runtime(n=N, device="cpu", jacobi_iters=20).run(
        "cavity", steps=10, re=150.0)
    for f in FIELDS:
        d = float(np.abs(plain.state[f].numpy() - head["run"][f]).max())
        assert d < RUN_TOL, (f, d)
    assert abs(plain.diagnostics["kinetic_energy"] - head["run_diag"]) < KE_TOL
    with pytest.raises(RuntimeError, match="process group"):
        api.runtime(n=N, device="cpu", mesh_shape=(2, 2),
                    mesh_axes=("slot", "shard"),
                    decomposition=((0, "shard"),))
