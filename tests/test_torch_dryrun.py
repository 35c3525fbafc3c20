"""The port's one-device dry run (``repro_torch.launch.{dryrun,sweep,
explain}``) against the JAX reference's, on the CPU.

The plan, the input specs and the bytes of what a cell is given (the
parameters, the AdamW state under the plan, the caches, the batch) are
held to the reference's ``jax.eval_shape`` trees exactly: that is data
movement.  The parameter, active-parameter and model-FLOP counts equal the
reference's.  The live-bytes peak of ``op_cost``'s counter is held to a
hand-counted function, its recorded results and the train cell's
microbatch extrapolation to a full trace, exactly.  Every arch × shape
runs at smoke width (the shapes cut to tens of positions), and the
published widths of the moe family's training cells are reckoned in full
(they allocate nothing).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; the fixture initialises jax's backend first and restores the
variable after, so that no later test or subprocess sees 512 devices.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs import shapes as rshapes  # noqa: E402
from repro.dist.sharding import _path_str  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, explain, op_cost, sweep  # noqa: E402

ARCHS = tuple(registry.ARCHS)
# the smoke cells' shapes: each kind at tens of positions
SMOKE_SHAPES = {"train_4k": dict(seq_len=64, global_batch=8),
                "prefill_32k": dict(seq_len=64, global_batch=2),
                "decode_32k": dict(seq_len=64, global_batch=2),
                "long_500k": dict(seq_len=128, global_batch=1)}


@pytest.fixture(scope="module")
def rdry():
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.fixture
def smoke_shapes(monkeypatch):
    for name, kw in SMOKE_SHAPES.items():
        monkeypatch.setitem(dryrun.SHAPES, name,
                            dataclasses.replace(SHAPES[name], **kw))


def _smoke_overrides(arch) -> dict:
    cfg = registry.smoke(registry.get_config(arch))
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


def _dtype_name(dt) -> str:
    return (str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)


def _ref_bytes(tree) -> dict:
    """Reference leaf path -> bytes."""
    return {_path_str(path): math.prod(x.shape) * np.dtype(x.dtype).itemsize
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_bytes(named: dict, stacked: bool) -> dict:
    """Reference leaf path -> bytes of the port's named tensors (a stacked
    leaf's layers summed)."""
    out: dict = {}
    for name, t in named.items():
        key = convert.reference_path(name, stacked)
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


# ---------------------------------------------------------------------------
# the plan, the input specs and the bytes a cell is given
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_plan_equals_the_reference(rdry, arch):
    got = dryrun.train_plan(registry.get_config(arch))
    want = rdry.train_plan(rreg.get_config(arch))
    assert got["grad_accum"] == want["grad_accum"]
    for k in ("m_dtype", "v_dtype"):
        assert _dtype_name(got[k]) == _dtype_name(want[k]), k
    # one device; fsdp_tp is the meshed cells' plan (train_plan(..., meshed=True))
    assert got["shard_mode"] == "local" and want["shard_mode"] == "fsdp_tp"


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(rdry, arch, shape):
    got = dryrun.input_specs(registry.get_config(arch), SHAPES[shape])
    want = rdry.input_specs(rreg.get_config(arch), rshapes.SHAPES[shape])
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert _dtype_name(t.dtype) == _dtype_name(want[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_trees_leaf_for_leaf(rdry, arch):
    """Parameters and the AdamW state under the plan (train_4k), the caches
    (decode_32k) and each batch: the port's meta tensors hold exactly the
    bytes of the reference's ``jax.eval_shape`` leaves."""
    rcfg = rreg.get_config(arch)
    params = jax.eval_shape(
        lambda: rmodel.init_params(rcfg, jax.random.PRNGKey(0)))
    plan = rdry.train_plan(rcfg)
    opt = jax.eval_shape(radamw.AdamW(m_dtype=plan["m_dtype"],
                                      v_dtype=plan["v_dtype"]).init, params)
    cell = dryrun.build_cell(arch, "train_4k")
    lm, state, batch = cell.args
    stacked = lm.stack.stacked
    assert _port_bytes(dict(lm.named_parameters()), stacked) == \
        _ref_bytes(params)
    assert _port_bytes(state.m, stacked) == _ref_bytes(opt.m)
    assert _port_bytes(state.v, stacked) == _ref_bytes(opt.v)
    want_batch = sum(_ref_bytes(rdry.input_specs(
        rcfg, rshapes.SHAPES["train_4k"])).values())
    assert cell.memory == {
        "params": sum(_ref_bytes(params).values()),
        "optimizer": sum(_ref_bytes(opt).values()),
        "batch": want_batch}
    shp = rshapes.SHAPES["decode_32k"]
    caches = jax.eval_shape(lambda: rmodel.init_caches(
        rcfg, shp.global_batch, shp.seq_len, jnp.bfloat16))
    dec = dryrun.build_cell(arch, "decode_32k")
    got = sorted(t.numel() * t.element_size()
                 for t in torch.utils._pytree.tree_leaves(dec.args[2]))
    assert got == sorted(_ref_bytes(caches).values())
    assert dec.memory["caches"] == sum(got)


# ---------------------------------------------------------------------------
# the counter's live bytes, its recorded results, the extrapolation
# ---------------------------------------------------------------------------
def test_live_bytes_peak_of_a_hand_counted_function():
    """Three allocations, one freed, one view; an argument's storage, its
    view and an in-place update count nothing."""
    arg = torch.empty(10 ** 6, device="meta")
    with op_cost.OpCounter() as c:
        a = torch.empty(1000, device="meta")          # 4,000 B
        b = torch.zeros(500, device="meta")           # 2,000 B
        v = a.view(10, 100)                           # a view: nothing
        d = a + 1                                     # 4,000 B: the peak
        assert c.live_bytes == 10_000
        del d                                         # freed
        b.mul_(2)                                     # in place: nothing
        arg.view(-1).add_(1)                          # the argument's
        assert c.live_bytes == 6_000
        del v
    assert c.peak_bytes == 10_000 and c.live_bytes == 6_000
    del a
    assert c.live_bytes == 2_000                      # released at death


def test_attention_counts_equal_the_mask_they_stand_for():
    for sq, sk, causal, off, pre in [(77, 133, True, 56, 9),
                                     (70, 50, True, -20, 0),
                                     (64, 64, True, 0, 0),
                                     (32, 40, True, 0, 36),
                                     (3, 40, False, 0, 0)]:
        mask = op_cost.attention_mask(2, sq, sk, causal, off, pre)
        q = torch.empty(2, sq, 4, 8, device="meta", dtype=torch.bfloat16)
        k = torch.empty(2, sk, 2, 8, device="meta", dtype=torch.bfloat16)
        assert op_cost.flash_attention_spec_cost(q, k, causal, off, pre) \
            == op_cost.flash_attention_cost(q, k, mask)


def _trace(arch="qwen3-moe-235b-a22b", accum=4, **kw):
    return dryrun.trace_cell(
        arch, "train_4k", cfg_overrides=dict(_smoke_overrides(arch),
                                             remat="block"),
        plan_overrides={"grad_accum": accum},
        shape_overrides={"seq_len": 32, "global_batch": accum}, **kw)[1]


def test_recorded_results_change_no_count(monkeypatch):
    """A train cell's counts with the fresh ops' results recorded equal
    those with every op run (after a warm-up trace: a first trace fills
    ``device.true_divide``'s cached divisors)."""
    _trace()
    got = _trace()
    monkeypatch.setattr(op_cost, "_fresh", lambda func: False)
    want = _trace()
    assert got.classes == want.classes and got.ops == want.ops
    assert got.peak_bytes == want.peak_bytes


def test_microbatch_extrapolation_equals_the_full_trace(monkeypatch):
    _trace(accum=8)
    monkeypatch.setattr(dryrun, "FULL_TRACE_MAX", 8)
    full = _trace(accum=8)
    monkeypatch.setattr(dryrun, "FULL_TRACE_MAX", 5)
    part = _trace(accum=8)
    assert full.traced_microbatches == [8]
    assert part.traced_microbatches == [2, 3]
    assert part.classes == full.classes and part.ops == full.ops
    assert part.peak_bytes == full.peak_bytes


# ---------------------------------------------------------------------------
# every cell at smoke width; the counts against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_every_cell_at_smoke_width_is_ok_or_skipped(smoke_shapes, arch):
    over = _smoke_overrides(arch)
    rcfg = rreg.smoke(rreg.get_config(arch))
    for shape in SHAPES:
        art = dryrun.run_cell(arch, shape, cfg_overrides=over,
                              verbose=False)
        if not rshapes.applicable(rcfg, rshapes.SHAPES[shape]):
            assert art["status"] == "skipped"
            assert "full-attention" in art["reason"]
            continue
        assert art["status"] == "ok", art.get("traceback")
        spec = dryrun.SHAPES[shape]
        tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                      else 1)
        mult = 6 if spec.kind == "train" else 2
        assert art["n_params"] == rcfg.param_count()
        assert art["n_active_params"] == rcfg.active_param_count()
        assert art["model_flops_global"] == \
            mult * rcfg.active_param_count() * tokens
        assert art["flops_per_device"] > 0 and art["hbm_bytes_per_device"] > 0
        assert art["collective_wire_bytes_per_device"] == 0
        mem = art["memory"]
        assert mem["argument_bytes"] == sum(
            mem["argument_bytes_by_part"].values())
        assert mem["peak_bytes"] > 0 and art["fits_hbm"] is True
        assert art["roofline"]["bottleneck"] in ("compute", "memory")
    subq = rcfg.subquadratic
    assert subq == (arch in ("zamba2-1.2b", "xlstm-125m"))


def test_the_moe_drives_at_published_widths_are_reckoned():
    """One qwen3-moe layer at the card's drive (global batch 2 in 2
    microbatches of 4,096 tokens) fits the H100; two do not; one kimi-k2
    layer at train_4k does not."""
    drive = dict(plan_overrides={"grad_accum": 2},
                 shape_overrides={"global_batch": 2})
    arts = [dryrun.run_cell("qwen3-moe-235b-a22b", "train_4k",
                            cfg_overrides={"num_layers": n}, verbose=False,
                            **drive) for n in (1, 2)]
    kimi = dryrun.run_cell("kimi-k2-1t-a32b", "train_4k",
                           cfg_overrides={"num_layers": 1}, verbose=False)
    assert [a["status"] for a in arts + [kimi]] == ["ok"] * 3
    assert [a["fits_hbm"] for a in arts + [kimi]] == [True, False, False]
    one = arts[0]
    assert one["plan"]["m_dtype"] == "torch.bfloat16"
    assert one["n_params"] == 3_732_418_560
    # bf16 weights but the float32 router and norms (ln1, ln2, final);
    # bf16 moments for every leaf and AdamW's int32 step counter
    parts = one["memory"]["argument_bytes_by_part"]
    f32 = 4096 * 128 + 3 * 4096
    assert parts["params"] == 2 * one["n_params"] + 2 * f32
    assert parts["optimizer"] == 4 * one["n_params"] + 4
    assert kimi["traced_microbatches"] == [2, 3]


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------
def test_mesh_multi_and_a2a_raise_naming_item_9():
    """``--mesh multi|both``, ``--moe-mode a2a`` and ``--ssm-sp`` run now
    (the meshed tests below); what raises is a mesh kind or an MoE mode
    the dry run does not know, and a live mesh, whose collectives would
    run on ``meta`` tensors (``ValueError``); the command lines refuse
    them by their choices."""
    for kw, match in ((dict(mesh_kind="pods"), "unknown mesh"),
                      (dict(moe_mode="ep"), "unknown moe mode"),
                      (dict(mesh=object()), "CountingMesh"),
                      (dict(moe_mode="a2a"), "'a2a'.*needs a mesh"),
                      (dict(ssm_sp=True), "ssm_sp.*needs a mesh")):
        with pytest.raises(ValueError, match=match):
            dryrun.run_cell("llama3-8b", "train_4k", **kw)
    with pytest.raises(ValueError, match="needs a mesh"):
        dryrun.build_cell("zamba2-1.2b", "train_4k", ssm_sp=True)
    for argv in (["--mesh", "pods"], ["--moe-mode", "ep"],
                 ["--moe-mode", "a2a"], ["--mesh", "both", "--moe-mode",
                                         "a2a"]):
        with pytest.raises(SystemExit) as bad:
            dryrun.main(argv)
        assert bad.value.code == 2
        with pytest.raises(SystemExit) as bad:
            sweep.main(argv)
        assert bad.value.code == 2
    # one device splits no sequence: --ssm-sp needs --mesh multi, and the
    # sweep has no such flag
    for main, argv in ((dryrun.main, ["--mesh", "both", "--ssm-sp"]),
                       (explain.main, ["--arch", "zamba2-1.2b", "--shape",
                                       "train_4k", "--ssm-sp"]),
                       (sweep.main, ["--mesh", "multi", "--ssm-sp"])):
        with pytest.raises(SystemExit) as bad:
            main(argv)
        assert bad.value.code == 2


# (arch, posture, config fields replaced): qwen3-moe with 32 experts, so
# that they split over model 16
MESHED = {"llama3-8b": ("tp", False, {}),
          "qwen3-moe-235b-a22b": ("a2a", False, {"num_experts": 32}),
          "zamba2-1.2b": ("tp", True, {})}
MESHED_SHAPES = {"train_4k": dict(seq_len=64, global_batch=64),
                 "prefill_32k": dict(seq_len=64, global_batch=32),
                 "decode_32k": dict(seq_len=64, global_batch=32)}


@pytest.mark.parametrize("arch", list(MESHED))
def test_meshed_cells_at_smoke_width(arch):
    """One rank of (pod 2, data 16, model 16) at smoke width: train,
    prefill and decode ``ok`` with the rank's collectives counted, but
    the cells the posture cannot run, which end ``error`` with the
    reason: ``a2a`` at decode (one token over model 16), ``ssm_sp`` at
    prefill (no Mamba2 state to cache)."""
    moe_mode, ssm_sp, over = MESHED[arch]
    over = dict(_smoke_overrides(arch), **over)
    for shape, so in MESHED_SHAPES.items():
        art = dryrun.run_cell(arch, shape, "multi", moe_mode=moe_mode,
                              ssm_sp=ssm_sp, cfg_overrides=over,
                              shape_overrides=so, verbose=False)
        assert art["mesh"] == "multi" and art["devices"] == 512
        assert art["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
        if (moe_mode, shape) == ("a2a", "decode_32k"):
            assert art["status"] == "error"
            assert "one token cannot split" in art["error"]
            continue
        if ssm_sp and shape == "prefill_32k":
            assert art["status"] == "error"
            assert "returns no state" in art["error"]
            continue
        assert art["status"] == "ok", art.get("traceback")
        assert art["collective_wire_bytes_per_device"] > 0
        assert art["roofline"]["collective_s"] > 0
        assert art["fits_hbm"] is True
        kinds = art["collectives"]
        assert set(art["collective_counts"]) == set(kinds)
        if moe_mode == "a2a":
            assert kinds["all_to_all"]["calls"] == 2 * over["num_layers"] \
                * (2 if shape == "train_4k" else 1) * int(
                    art["plan"].get("grad_accum", 1))
        if shape == "train_4k":
            # 64 rows over data 32: two a rank, in two microbatches of the
            # plan's four
            assert art["plan"]["grad_accum"] == "2"
            assert art["plan"]["grad_accum_plan"] == "4"


def _block_bytes(shapes, specs, extents: dict, itemsize=None) -> int:
    """Bytes of one rank's blocks of the reference's leaves ``shapes``
    under its ``PartitionSpec`` tree ``specs``."""
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = 1
        for i, dim in enumerate(x.shape):
            axes = spec[i] if i < len(spec) else None
            axes = () if axes is None else (
                (axes,) if isinstance(axes, str) else axes)
            n *= dim // math.prod(extents[a] for a in axes)
        total += n * (itemsize or np.dtype(x.dtype).itemsize)
    return total


@pytest.mark.parametrize("arch", list(MESHED))
def test_meshed_argument_bytes_equal_the_reference_spec_blocks(rdry, arch):
    """At published widths (two layers), a rank of (2, 16, 16) is given
    exactly the bytes of its blocks of the reference's spec trees: the
    parameters (``param_spec_tree``), the AdamW moments under the plan
    (``state_spec_tree``) and its rows of the batch (``batch_spec_tree``)."""
    from repro.dist import sharding as rshd
    from repro.optim.adamw import AdamW as RAdamW

    moe_mode, ssm_sp, _ = MESHED[arch]
    extents = {"pod": 2, "data": 16, "model": 16}
    rcfg = dataclasses.replace(rreg.get_config(arch), num_layers=2)
    stub = types.SimpleNamespace(shape=extents, axis_names=tuple(extents))
    shape = rshapes.SHAPES["train_4k"]
    rshard = rshd.make_shard_cfg(stub, rcfg, shape.global_batch,
                                 moe_mode=moe_mode, ssm_sp=ssm_sp)
    params = jax.eval_shape(
        lambda: rmodel.init_params(rcfg, jax.random.PRNGKey(0)))
    pspecs = rshd.param_spec_tree(params, rcfg, stub, rshard)
    plan = rdry.train_plan(rcfg)
    mom = _block_bytes(params, pspecs, extents,
                       np.dtype(plan["m_dtype"]).itemsize)
    batch = rdry.input_specs(rcfg, shape)
    cell = dryrun.build_cell(arch, "train_4k", mesh="multi",
                             moe_mode=moe_mode, ssm_sp=ssm_sp,
                             cfg_overrides={"num_layers": 2})
    assert cell.memory == {
        "params": _block_bytes(params, pspecs, extents),
        "optimizer": 2 * mom + 4,                 # m, v and the step
        "batch": _block_bytes(batch, rshd.batch_spec_tree(batch, stub,
                                                          rshard), extents)}
    assert cell.shard.moe_mode == (moe_mode if rcfg.num_experts else
                                   "local")
    assert cell.shard.ssm_sp == ssm_sp


def test_sweep_reuses_a_cached_artifact_and_fails_on_an_error(
        tmp_path, monkeypatch, capsys):
    cached = {"arch": "llama3-8b", "shape": "train_4k", "mesh": "single",
              "status": "ok"}
    os.makedirs(tmp_path / "single")
    with open(tmp_path / "single" / "llama3-8b__train_4k.json", "w") as f:
        json.dump(cached, f)
    ran = []

    def fake_run_cell(arch, shape, mesh_kind, **kw):
        ran.append((arch, shape))
        status = "error" if shape == "decode_32k" else "ok"
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "moe_mode": kw["moe_mode"], "status": status,
                "error": "planted"}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    argv = ["--archs", "llama3-8b", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as ok:
        sweep.main(argv + ["--shapes", "train_4k,prefill_32k"])
    assert ok.value.code == 0
    assert ran == [("llama3-8b", "prefill_32k")]
    assert "cached single llama3-8b train_4k: ok" in capsys.readouterr().out
    with open(tmp_path / "single" / "llama3-8b__prefill_32k.json") as f:
        assert json.load(f)["status"] == "ok"
    with pytest.raises(SystemExit) as bad:
        sweep.main(argv + ["--shapes", "train_4k,decode_32k", "--force"])
    assert bad.value.code == 1
    assert ran[1:] == [("llama3-8b", "train_4k"), ("llama3-8b", "decode_32k")]
    # a posture's cells are not the tp cells': an a2a sweep after a tp
    # sweep of the same mesh runs its cells, beside the tp artifacts
    del ran[:]
    argv += ["--mesh", "multi", "--shapes", "train_4k"]
    for extra in ([], ["--moe-mode", "a2a"], ["--moe-mode", "a2a"]):
        with pytest.raises(SystemExit) as ok:
            sweep.main(argv + extra)
        assert ok.value.code == 0
    assert ran == [("llama3-8b", "train_4k")] * 2
    assert "cached multi llama3-8b train_4k" in capsys.readouterr().out
    for d, mode in (("multi", "tp"), ("multi-a2a", "a2a")):
        with open(tmp_path / d / "llama3-8b__train_4k.json") as f:
            assert json.load(f)["moe_mode"] == mode


def test_explain_prints_its_sections(smoke_shapes, capsys):
    over = _smoke_overrides("qwen3-moe-235b-a22b")
    terms, tr = explain.explain("qwen3-moe-235b-a22b", "train_4k",
                                cfg_overrides=over,
                                plan_overrides=explain.parse_kv(
                                    ["grad_accum=2", "m_dtype=bfloat16"]))
    out = capsys.readouterr().out
    for text in ("compute_s=", "memory_s=", "bottleneck=", "memory: argument",
                 "bytes by op class:", "FLASH_ATTENTION", "top ops",
                 "aten.bmm.default"):
        assert text in out, text
    assert terms.memory_s > 0 and tr.peak_bytes > 0
    assert explain.parse_kv(["a=1", "b=0.5", "c=true", "d=x"]) == \
        {"a": 1, "b": 0.5, "c": True, "d": "x"}
    with pytest.raises(ValueError, match="HLO computation"):
        explain.explain("llama3-8b", "train_4k", drill="fusion")
    # one rank of the multi-pod mesh under ssm_sp: its collectives by kind
    explain.explain("zamba2-1.2b", "train_4k", "multi", ssm_sp=True,
                    cfg_overrides=_smoke_overrides("zamba2-1.2b"),
                    plan_overrides={"grad_accum": 1})
    out = capsys.readouterr().out
    assert "(multi; moe=local, ssm_sp=True" in out
    assert "collectives: {'all_gather': " in out and "reduce_scatter" in out
    with pytest.raises(ValueError, match="unknown moe mode"):
        explain.explain("llama3-8b", "train_4k", moe_mode="ep")
