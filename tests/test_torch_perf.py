"""The port's performance accounting against the reference's, on the CPU.

``repro_torch.core.rooflinemodel``, ``repro_torch.core.autotune``,
``repro_torch.launch.op_cost`` and ``repro_torch.obs.perf``: the roofline
terms, the arithmetic intensity, the analytic halo bytes and the attributed
report rows equal the reference's for the same inputs and chip constants;
the two packages' perf blocks pass each other's schema check; a trace that
fails gives ``status="unparsed"`` without raising; the chip registry's
rules; the autotuner is deterministic and memoized; the op-cost trace of a
step books each kernel at its declared cost and launches nothing; and the
accounting is bitwise invisible on ``runtime(n=16, device="cpu")``.  Every
comparison is exact (``==``, or ``np.array_equal`` for fields): the same
float64 expressions on the same numbers, and results of runs whose
launches are the same.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro.cfd.ns3d import CFDConfig as RefCFDConfig
from repro.core import rooflinemodel as ref_roof
from repro.obs import perf as ref_perf

from repro_torch import api, obs
from repro_torch.cfd import cavity
from repro_torch.cfd.ns3d import PARAM_KEYS, CFDConfig, NavierStokes3D
from repro_torch.core import autotune, rooflinemodel as roof
from repro_torch.kernels import (
    attention_cuda, jacobi_cuda, ssd_cuda, stencil3d, stencil3d_cuda,
)
from repro_torch.kernels.ref import MaskSpec
from repro_torch.launch import op_cost
from repro_torch.obs import perf
from repro_torch.sim import SimulationFarm, SimulationService
from repro_torch.sim.farm import SimRequest

N = 16
KW = dict(jacobi_iters=8)
FIELDS = ("vx", "vy", "vz", "p")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_CHIPS = ("cpu-host", "gpu-generic")


def _launches() -> dict:
    return {**stencil3d_cuda.LAUNCHES, **jacobi_cuda.LAUNCHES,
            **attention_cuda.LAUNCHES, **ssd_cuda.LAUNCHES}


# ---------------------------------------------------------------------------
# roofline terms and intensity: the reference's formulas, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("chip", SHARED_CHIPS)
def test_terms_equal_the_reference(chip, dtype):
    for counts in [(1e9, 1e6, 0.0), (3.5e12, 2.75e10, 1.25e8), (0, 7e5, 1e9),
                   (0.0, 0.0, 0.0)]:
        got = roof.terms_from_counts(*counts, dtype=dtype,
                                     chip=roof.CHIPS[chip])
        want = ref_roof.terms_from_counts(*counts, dtype=dtype,
                                          chip=ref_roof.CHIPS[chip])
        assert got.as_dict() == want.as_dict()
        assert got.step_time_s == want.step_time_s


@pytest.mark.parametrize("chip", SHARED_CHIPS)
def test_shared_chip_constants_are_the_reference_s(chip):
    ref = dataclasses.asdict(ref_roof.CHIPS[chip])
    port = dataclasses.asdict(roof.CHIPS[chip])
    assert {k: port[k] for k in ref} == ref


@pytest.mark.parametrize("tile,halo", [((8, 8, 32), (1, 1, 1)),
                                       ((1, 8, 128), (1, 0, 2)),
                                       ((5, 7, 3), (2, 2, 2))])
def test_arithmetic_intensity_equals_the_reference(tile, halo):
    for flops, nr, nw in [(10.0, 3, 3), (11.0, 2, 1), (144.0, 4, 3)]:
        assert roof.stencil_arithmetic_intensity(tile, halo, flops, nr, nw) \
            == ref_roof.stencil_arithmetic_intensity(tile, halo, flops, nr,
                                                     nw)


# ---------------------------------------------------------------------------
# the analytic halo model: pure math, equal to the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 8, 4), (7, 9, 5)])
@pytest.mark.parametrize("widths", [(1, 1, 1), ((1, 0),) * 3, ((0, 1),) * 3,
                                    (2, 2, 2), ((3, 1), 0, (0, 2))])
@pytest.mark.parametrize("active", [set(), {0}, {1, 2}, {0, 1, 2}])
def test_exchange_permute_bytes_equal_the_reference(shape, widths, active):
    for itemsize in (4, 2):
        assert perf.exchange_permute_bytes(shape, widths, active, itemsize) \
            == ref_perf.exchange_permute_bytes(shape, widths, active,
                                               itemsize)


@pytest.mark.parametrize("fused_sweeps", [1, 2, 3])
@pytest.mark.parametrize("jacobi_iters", [1, 8, 40])
@pytest.mark.parametrize("active,extents", [
    ({}, {}), ({0: "shard"}, {"shard": 2}),
    ({0: "x", 2: "z"}, {"x": 2, "z": 4})])
def test_halo_bytes_per_step_equal_the_reference(fused_sweeps, jacobi_iters,
                                                 active, extents):
    kw = dict(shape=(16, 16, 8), fused_sweeps=fused_sweeps,
              jacobi_iters=jacobi_iters)
    for slots_local in (1, 3):
        got = perf.halo_bytes_per_step(CFDConfig(**kw), active, extents,
                                       slots_local=slots_local)
        want = ref_perf.halo_bytes_per_step(RefCFDConfig(**kw), active,
                                            extents, slots_local=slots_local)
        assert got == want
    assert perf._slots_local(4, 2) == ref_perf._slots_local(4, 2)
    assert perf._slots_local(3, 2) == ref_perf._slots_local(3, 2)


# ---------------------------------------------------------------------------
# the report: rows key for key, schema both ways, garbage never raises
# ---------------------------------------------------------------------------
_ROWS = [
    dict(name="farm/cavity/sig000", kind="farm-step", flops=5.0e8,
         hbm_bytes=1.2e11, invocations=18, measured_s=0.0606,
         health_drains=1, health_boundaries=1),
    dict(name="serial/cavity/EVOL", kind="serial-bin", flops=1.0e10,
         hbm_bytes=3.0e10, invocations=20, measured_s=0.0153),
    dict(name="r", kind="farm-step", flops=1e9, hbm_bytes=1e6,
         measured_s=1e-3, invocations=1, collective_wire_bytes=5e9,
         halo_bytes_analytic=6656.0, halo_bytes_predicted=6656.0),
    dict(name="bad", kind="serial-bin", status="unparsed", error="boom"),
]


@pytest.mark.parametrize("chip", SHARED_CHIPS)
def test_report_rows_equal_the_reference_key_for_key(chip):
    """The port's rows carry the reference's keys with equal values, and
    one key more: ``op_classes``, the split of the bytes by op class."""
    got = perf.PerfReport([perf.CostRow(**r) for r in _ROWS],
                          chip=chip).rows()
    want = ref_perf.PerfReport([ref_perf.CostRow(**r) for r in _ROWS],
                               chip=chip).rows()
    for g, w in zip(got, want):
        assert set(g) - set(w) == {"op_classes"}
        assert {k: g[k] for k in w} == w


def test_perf_blocks_pass_each_other_s_validator():
    rows = [perf.CostRow(**r) for r in _ROWS]
    port = perf.PerfReport(rows, chip="cpu-host").as_dict()
    ref = ref_perf.PerfReport([ref_perf.CostRow(**r) for r in _ROWS],
                              chip="cpu-host").as_dict()
    assert ref_perf.validate_perf(port) is port
    assert perf.validate_perf(ref) is ref
    assert perf.PERF_SCHEMA == ref_perf.PERF_SCHEMA
    assert perf.ROW_KEYS == ref_perf.ROW_KEYS


def test_validate_perf_names_problems():
    with pytest.raises(ValueError, match="schema"):
        perf.validate_perf({"schema": "nope", "chip": {"name": "x"},
                            "rows": []})
    with pytest.raises(ValueError, match="rows"):
        perf.validate_perf({"schema": perf.PERF_SCHEMA,
                            "chip": {"name": "x"}, "rows": None})
    with pytest.raises(ValueError, match=r"row 0 missing"):
        perf.validate_perf({"schema": perf.PERF_SCHEMA,
                            "chip": {"name": "x"}, "rows": [{"name": "r"}]})


def test_a_failing_trace_gives_an_unparsed_row():
    def broken(state):
        raise RuntimeError("not traceable")

    counter, status, err = op_cost.safe_count(broken, {})
    assert counter is None and status == "unparsed"
    assert err == "RuntimeError: not traceable"
    row = perf.cost_row_from_trace(lambda: 1 / 0, (), name="x",
                                   kind="farm-step")
    assert row.status == "unparsed" and "ZeroDivisionError" in row.error
    assert row.flops == 0.0 and row.hbm_bytes == 0.0
    rep = perf.PerfReport([row], chip="cpu-host")
    d = rep.rows()[0]
    assert d["bottleneck"] == "unknown" and d["utilization"] is None
    assert "unparsed" in rep.render()
    perf.validate_perf(rep.as_dict())
    ref_perf.validate_perf(rep.as_dict())


def test_a_service_that_cannot_be_traced_gives_an_unparsed_row():
    class Exec:
        def step_args(self, k):
            raise TypeError("no signature")

        def cost_step(self):
            return None

    class Farm:
        exec, farm_id, device_steps = Exec(), "x", 0

    class Service:
        farm = Farm()

    row = perf.farm_cost_row(Service())
    assert row.status == "unparsed" and "no signature" in row.error


@pytest.mark.parametrize("n, k, mesh_axes, n_slots", [
    (16, 1, (("slot", 2), ("shard", 2)), 4),   # 2 resident slots a rank
    (16, 2, (("slot", 1), ("shard", 2)), 2),   # the fused smoother's k-pads
    (16, 1, (("sx", 2), ("sy", 2), ("slot", 1)), 1),   # two grid axes
])
def test_decomposed_step_counts_the_analytic_halo_bytes(n, k, mesh_axes,
                                                        n_slots):
    """The count transport's permute operand bytes for one traced step of
    the decomposed ensemble equal ``halo_bytes_per_step`` exactly (the
    same accounting, not a measure of traffic), and its operands
    the reference's collective-permute inventory (velocity two-sided,
    divergence and projection one-sided, the Jacobi loop two-sided a
    sweep, each per decomposed axis)."""
    names = [m for m, _ in mesh_axes if m != "slot"]
    decomposition = tuple(enumerate(names))
    cfg = CFDConfig(shape=(n, n, 4), case="cavity", fused_sweeps=k,
                    decomposition=decomposition)
    counts, active = perf.decomposed_step_hlo(cfg, n_slots=n_slots,
                                              mesh_axes=mesh_axes)
    assert active == dict(decomposition)
    extents = dict(mesh_axes)
    analytic = perf.halo_bytes_per_step(
        cfg, active, extents,
        slots_local=perf._slots_local(n_slots, extents["slot"]))
    assert counts["permute_operand_bytes"] == analytic > 0
    iters = max(cfg.jacobi_iters // k, 1)
    per_axis = 2 * 3 + 3 + 2 * iters * (2 if k > 1 else 1) + 1
    assert counts["permute_ops"] == per_axis * len(names)
    # the rank at index 0 of a wall-bounded axis has no lo neighbour: its
    # lo strips are operands that are never sent
    assert 0 < counts["sent_bytes"] < counts["permute_operand_bytes"]
    assert 0 < counts["sent_ops"] < counts["permute_ops"]
    assert counts["hbm_bytes"] > 0 and counts["flops"] > 0
    # the reference's cost model counts the same bytes for its HLO
    assert analytic == ref_perf.halo_bytes_per_step(
        RefCFDConfig(shape=cfg.shape, case="cavity", fused_sweeps=k,
                     decomposition=decomposition),
        active, extents, slots_local=ref_perf._slots_local(
            n_slots, extents["slot"]))


# ---------------------------------------------------------------------------
# the chip registry
# ---------------------------------------------------------------------------
def test_auto_resolves_to_the_host_here():
    assert not torch.cuda.is_available()
    assert roof.resolve_chip("auto") is roof.CHIPS["cpu-host"]
    assert roof.resolve_chip(None) is roof.CHIPS["cpu-host"]
    assert roof.resolve_chip("auto", "cpu") is roof.CHIPS["cpu-host"]
    assert roof.resolve_chip("auto", torch.device("meta")) is \
        roof.CHIPS["cpu-host"]


def test_names_passthrough_and_no_tpu():
    mine = roof.Chip(name="custom")
    assert roof.resolve_chip(mine) is mine
    for name in roof.CHIPS:
        assert roof.resolve_chip(name) is roof.CHIPS[name]
    for name in ("tpu-v5e", "tpu-v9000"):
        with pytest.raises(KeyError, match="unknown chip"):
            roof.resolve_chip(name)


def test_card_names_map_to_the_registry():
    assert roof.chip_for_device_name("NVIDIA H100 80GB HBM3") == "h100-sxm"
    assert roof.chip_for_device_name("NVIDIA H100 SXM5 80GB") == "h100-sxm"
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                  "NVIDIA A100-SXM4-80GB", "NVIDIA L4"):
        assert roof.chip_for_device_name(other) == "gpu-generic"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_h100_constants_are_chip_smoke_s():
    cs, h100 = _chip_smoke(), roof.CHIPS["h100-sxm"]
    assert h100 is roof.H100_SXM and roof.Chip() == h100
    assert h100.hbm_bandwidth == cs.HBM_BYTES_PER_S
    assert h100.peak_flops("f32") == cs.F32_OPS_PER_S
    assert h100.peak_flops("bf16") == cs.BF16_OPS_PER_S
    assert h100.vmem_bytes == 232448        # shared memory a block
    assert (h100.sms, h100.warp, h100.max_threads_block,
            h100.max_threads_sm, h100.regs_sm) == (132, 32, 1024, 2048, 65536)


def test_report_attributes_against_the_resolved_chip():
    row = perf.CostRow(name="r", kind="farm-step", flops=1e9,
                       hbm_bytes=1e6, measured_s=1e-3, invocations=1)
    cpu = perf.PerfReport([row], chip="cpu-host").rows()[0]
    h100 = perf.PerfReport([row], chip="h100-sxm").rows()[0]
    assert cpu["compute_s"] > h100["compute_s"]
    assert cpu["utilization"] > h100["utilization"]


# ---------------------------------------------------------------------------
# the tile autotuner
# ---------------------------------------------------------------------------
SHAPES = [(256, 256, 256), (48, 48, 48), (48, 48, 4), (16, 16, 16),
          (12, 12, 12), (5, 7, 3), (63, 65, 33), (64, 64, 64), (24, 20, 18)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(stencil3d.DESCRIPTORS))
def test_choices_are_legal_deterministic_and_weigh_block_for(name, shape):
    desc, chip = stencil3d.DESCRIPTORS[name], roof.CHIPS["h100-sxm"]
    cands = autotune.candidates(desc, shape, chip)
    assert stencil3d_cuda.block_for(*shape[1:]) in cands
    a = autotune.choose_tile(desc, shape, chip="h100-sxm")
    assert a == autotune.choose_tile(desc, shape, chip=chip)
    assert a.tile in cands
    assert stencil3d_cuda.check_tile(a.tile, shape) == a.tile
    assert a.vmem_bytes <= chip.vmem_bytes * 0.5
    assert a.blocks_per_sm >= 1


def test_the_card_choice_at_256():
    """At the main path's 256^3 the (8, 32) block of block_for walks planes
    along x where the walk saves WALK_GAIN of the staged bytes, as far as
    the occupancy limits let it; PROJECT_VELOCITY, three of whose inputs
    have no halo, and UPDATE_VELOCITY, whose walk MAX_WALK forbids, keep
    block_for.  The model's constants make this the same on any host."""
    got = {name: autotune.choose_tile(d, (256,) * 3, chip="h100-sxm").tile
           for name, d in stencil3d.DESCRIPTORS.items()}
    assert got == {"UPDATE_VELOCITY": stencil3d_cuda.block_for(256, 256),
                   "DIVERGENCE": (4, 8, 32), "JACOBI_PRESSURE": (8, 8, 32),
                   "PROJECT_VELOCITY": stencil3d_cuda.block_for(256, 256)}
    for name, tile in got.items():
        c = autotune.choose_tile(stencil3d.DESCRIPTORS[name], (256,) * 3,
                                 chip="h100-sxm")
        assert c.waves >= autotune.WAVES


def test_tile_for_is_memoized_with_hits_and_misses():
    autotune.reset_tile_cache()
    desc = stencil3d.JACOBI_PRESSURE
    a = autotune.tile_for(desc, (32, 32, 32), chip="h100-sxm")
    b = autotune.tile_for(desc, (32, 32, 32), chip="h100-sxm")
    assert a is b
    assert autotune.tile_cache_stats() == {"hits": 1, "misses": 1,
                                           "entries": 1}
    autotune.tile_for(desc, (32, 32, 32), chip="cpu-host")
    autotune.tile_for(stencil3d.DIVERGENCE, (32, 32, 32), chip="h100-sxm")
    assert autotune.tile_cache_stats()["misses"] == 3
    autotune.reset_tile_cache()
    assert autotune.tile_cache_stats() == {"hits": 0, "misses": 0,
                                           "entries": 0}


@pytest.mark.parametrize("tile", [(0, 8, 32), (1, 16, 32), (17, 8, 32),
                                  (1, 8, 64), (1, 40, 4), (1.5, 8, 32),
                                  (1, 8), "auto"])
def test_a_bad_tile_raises_on_the_cpu_too(tile):
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.randn(18, 18, 34).astype(np.float32))
    rhs = torch.from_numpy(rng.randn(16, 16, 32).astype(np.float32))
    table = torch.tensor([0.01, 1.0, 0.0])
    with pytest.raises(ValueError, match="tile"):
        stencil3d_cuda.jacobi_pressure(p, rhs, table, tile=tile)


def test_serial_and_farm_share_autotuned_tiles():
    """On the CPU the CUDA template runs the kernels' plain versions, and
    resolves the launch tile all the same: the farm's batched steps re-read
    the serial run's choices (zero extra misses)."""
    cfg = dataclasses.replace(cavity.config(N, nz=8, re=100.0, **KW),
                              template="CUDA", overlap=False)
    autotune.reset_tile_cache()
    solver = NavierStokes3D(cfg, "cpu")
    step = solver.make_step()
    state = solver.init_state()
    for _ in range(2):
        state = step(state)
    after_serial = autotune.tile_cache_stats()
    # JACOBI_PRESSURE's ghosted load sets its own launch (OWN_TILE)
    assert after_serial["misses"] == (len(stencil3d.DESCRIPTORS)
                                      - len(stencil3d_cuda.OWN_TILE))
    farm = SimulationFarm(cfg, n_slots=2, device="cpu")
    farm.submit(SimRequest(config=dataclasses.replace(cfg, nu=1.0 / 150.0),
                           steps=2))
    farm.run_until_drained()
    after_farm = autotune.tile_cache_stats()
    assert after_farm["misses"] == after_serial["misses"]
    assert after_farm["hits"] > after_serial["hits"]


# ---------------------------------------------------------------------------
# the op-cost trace
# ---------------------------------------------------------------------------
def _table_floats(name):
    return len(stencil3d.TABLES[name])


def test_step_count_books_each_kernel_at_its_declared_cost():
    """A serial n = 16 step traced on ``meta`` tensors: each stencil books
    exactly the declared formula (each input and output once, the table,
    OPS_PER_CELL per cell; the two GHOSTED kernels their unpadded fields
    and their faces' table of b, 6 floats a field), as many times as the
    step launches it, and nothing is launched."""
    n, iters = N, KW["jacobi_iters"]
    cfg = dataclasses.replace(cavity.config(n, nz=n, **KW), overlap=False)
    solver = NavierStokes3D(cfg, "cpu").cost_twin()
    state = {f: torch.empty((n,) * 3, device="meta")
             for f in (*FIELDS, "mask_vx", "mask_vy", "mask_vz")}
    params = {k: torch.empty((), device="meta") for k in PARAM_KEYS}
    before = _launches()
    counter = op_cost.count(lambda s: solver._step_local(s, params), state)
    assert _launches() == before
    cells, lo = n ** 3, (n + 1) ** 3
    want = {  # (floats moved, calls)
        "UPDATE_VELOCITY": (3 * cells + 3 * cells + 3 * 6, 1),
        "DIVERGENCE": (3 * lo + cells, 1),
        "JACOBI_PRESSURE": (3 * cells + 6, iters),
        "PROJECT_VELOCITY": (3 * cells + lo + 3 * cells, 1),
    }
    for name, (floats, calls) in want.items():
        row = counter.classes[name]
        assert row["calls"] == calls
        assert row["bytes"] == calls * 4 * (floats + _table_floats(name))
        assert row["flops"] == calls * op_cost.OPS_PER_CELL[name] * cells
    assert counter.flops == sum(counter.classes[k]["flops"] for k in want)
    assert set(counter.classes) - set(want) <= {"cat", "flip", "fill",
                                                "other"}
    # the ghost-zone copies (3 divergence pads and the projection pad, each
    # concatenating 3 axes: the GHOSTED kernels make their own), the two
    # parameter tables stacked from device scalars and UPDATE_VELOCITY's
    # face table (the lid's b)
    assert counter.classes["cat"]["calls"] == 3 * (3 + 1) + 3


def test_kernel_wrappers_book_on_meta_and_launch_nothing():
    before = _launches()
    p = torch.empty((2, 20, 21, 22), device="meta")
    with op_cost.OpCounter() as c:
        out = jacobi_cuda.jacobi_fused(p, p, h=0.1, sweeps=2)
    assert out.shape == (2, 16, 17, 18) and out.device.type == "meta"
    assert c.classes["JACOBI_FUSED"]["bytes"] == 4 * (2 * p.numel()
                                                      + out.numel())
    assert c.classes["JACOBI_FUSED"]["flops"] == 11 * 2 * (
        18 * 19 * 20 + 16 * 17 * 18)
    x = torch.empty((1, 2, 16, 1, 3, 8), device="meta")
    lg = torch.empty((1, 2, 16, 1, 3), device="meta")
    bc = torch.empty((1, 2, 16, 1, 4), device="meta")
    s_in = torch.empty((1, 2, 1, 3, 4, 8), device="meta")
    with op_cost.OpCounter() as c:
        y = ssd_cuda.ssd_intra(x, lg, lg, bc, bc, s_in)
    assert y.shape == x.shape
    assert c.classes["SSD_INTRA"]["bytes"] == 4 * (
        2 * x.numel() + 2 * lg.numel() + 2 * bc.numel() + s_in.numel())
    q = torch.empty((2, 24, 4, 32), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 40, 2, 32), dtype=torch.bfloat16, device="meta")
    with op_cost.OpCounter() as c:
        o = attention_cuda.flash_attention(q, kv, kv, MaskSpec(causal=False))
    assert o.shape == q.shape
    assert c.classes["FLASH_ATTENTION"]["flops"] == 4 * 4 * 32 * 2 * 24 * 40
    assert _launches() == before


# ---------------------------------------------------------------------------
# the front door: rows, render, gauges, bitwise invisibility
# ---------------------------------------------------------------------------
def test_runtime_report_carries_the_rows():
    rt = api.runtime(n=N, device="cpu", n_slots=2, telemetry=True, **KW)
    rt.run("cavity", steps=3, re=100.0)
    rt.submit("cavity", re=100.0, steps=4)
    rt.drain()
    before = _launches()
    rows = rt.perf_report().rows()
    assert _launches() == before
    assert [r["kind"] for r in rows] == ["farm-step", "serial-bin"]
    for r in rows:
        assert r["status"] == "ok", r["error"]
        assert r["measured_s"] and r["measured_s"] > 0
        assert r["bottleneck"] == "memory"
        assert r["invocations"] > 0
        assert set(stencil3d.DESCRIPTORS) <= set(r["op_classes"])
    farm, serial = rows
    # a batched step of 2 slots launches each stencil once for both: the
    # same kernel work as two serial steps
    for name in stencil3d.DESCRIPTORS:
        assert farm["op_classes"][name]["calls"] == \
            serial["op_classes"][name]["calls"]
        assert farm["op_classes"][name]["flops"] == \
            2 * serial["op_classes"][name]["flops"]
    text = rt.report(perf=True)
    assert "perf accounting" in text and "farm/cavity" in text
    assert "serial/cavity/EVOL" in text and "HBM bytes by op class" in text


class TestBitwiseInvisible:
    @pytest.mark.parametrize("re,steps", [(80.0, 3), (320.0, 5)])
    def test_perf_accounting_never_perturbs_results(self, re, steps):
        def run(with_perf):
            rt = api.runtime(n=N, device="cpu", n_slots=2,
                             telemetry=bool(with_perf), **KW)
            sid = rt.submit("cavity", re=re, steps=steps)
            rt.drain()
            if with_perf:
                before = _launches()
                rt.report(perf=True)         # traces between two drains
                assert _launches() == before
                sid2 = rt.submit("cavity", re=re, steps=steps)
                rt.drain()
                a, b = rt.result(sid), rt.result(sid2)
                for f in FIELDS:
                    np.testing.assert_array_equal(a.state[f], b.state[f])
            return rt.result(sid)

        on, off = run(True), run(False)
        assert on.steps_done == off.steps_done
        for f in FIELDS:
            np.testing.assert_array_equal(on.state[f], off.state[f])


def test_service_scrape_includes_perf_gauges():
    cfg = cavity.config(N, **KW)
    svc = SimulationService(cfg, n_slots=2, device="cpu",
                            telemetry=obs.telemetry())
    svc.submit(SimRequest(config=cfg, steps=3))
    svc.drain()
    text = svc.prometheus_text(perf=True)
    assert "repro_perf_utilization" in text
    assert "repro_perf_bottleneck" in text
    assert 'kind="memory"' in text
    assert "repro_farm_" in text


def test_disabled_telemetry_scrapes_empty():
    svc = SimulationService(cavity.config(N, **KW), n_slots=2, device="cpu")
    assert svc.prometheus_text() == ""
    assert svc.prometheus_text(perf=True) == ""


def test_health_overhead_model_is_deterministic_and_small():
    def executor(health):
        rt = api.runtime(n=N, device="cpu", n_slots=2, health=health,
                         check_every=8, **KW)
        rt.submit("cavity", re=100.0, steps=4)
        rt.drain()
        return rt.services()[0].farm.exec

    ex_off, ex_on = executor(False), executor(True)
    a = perf.health_overhead_model(ex_off, ex_on, 8)
    b = perf.health_overhead_model(ex_off, ex_on, 8)
    assert a == b
    assert a["status"] == "ok"
    assert 0.0 < a["modeled_overhead"] <= 0.03
    assert a["hbm_bytes_diag_per_chunk"] > 0
    assert a["modeled_overhead"] == (a["hbm_bytes_diag_per_chunk"]
                                     / (8 * a["hbm_bytes_step"]))
