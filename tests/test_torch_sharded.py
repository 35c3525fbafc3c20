"""The LM trained over a mesh of ranks — the ``fsdp_tp`` and ``dp`` train
steps, int8 error-feedback compression, GPipe and ``moe_mode="tp"`` —
against the reference, on the CPU.

The multi-rank contracts run in one launch of 4 gloo ranks
(``repro_torch.launch.mesh.spawn``; the jobs are in
``tests/torch_shard_ranks.py``, which imports the port only); each job
returns numpy data and the comparisons run here, where the reference is
loaded:

* the spec trees (``param_spec_tree``, ``cache_spec_tree``,
  ``batch_spec_tree``, ``make_shard_cfg``, ``state_spec_tree``) equal the
  reference's ``PartitionSpec``s entry for entry, for every leaf of every
  registry arch, at smoke widths and at published widths (``meta`` tensors
  against ``eval_shape``), on stub meshes (no ranks);
* the ``fsdp_tp`` step on (data 2, model 2) for llama3-8b, zamba2-1.2b and
  qwen3-moe (capacity factor 8: no drops) is within the reference's
  bounds of its ``make_train_step(cfg, LOCAL, ...)`` (loss 1e-3, params
  5e-3: ``tests/test_dist_equivalence.py``), its gathered gradients
  within 1e-4 of the reference's leaf by leaf (``tests/test_torch_train.py``'s
  bound), and within 1e-5 of the port's
  single-process step (loss, and every gathered gradient's relative
  norm error); each rank stores exactly its placement's blocks; a ``wo``
  without its reduce over ``tp`` and a data-axis gradient not divided by
  |dp| are each rejected by that check;
* ``moe_mode="tp"`` is within 2e-3 of the reference's ``LOCAL``
  ``moe_apply``;
* the ``dp`` step on (pod 2, data 2) is within the reference's bounds of
  its ``LOCAL`` step (its gradient within 1e-4 of the reference's mean
  of row gradients), and the compressed step within the reference's
  bounds of the exact one (loss 1e-4, params 5e-3), its gradient mean
  within 5e-2 of the exact one, its residual non-zero and carried, and
  error feedback's identity at the second step within 1e-5;
* a tensor-parallel split product is the float32 product of operands
  rounded to bf16, forward and backward;
* int8 quantization and the error-feedback mean are bitwise the
  reference's; GPipe over ``pod`` 4 is the sequential stack at the
  reference's 2e-4 / 2e-5;
* a checkpoint saved at (2, 2) restores at (4, 1) bitwise;
* the launcher trains over ``--mesh 2x2`` and resumes a killed run
  bitwise;
* ``a2a`` and ``ssm_sp`` build, and a posture with no ``model`` axis for
  them raises; a meshed ``ServingEngine`` builds on a stub mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.dist import compression as rcomp  # noqa: E402
from repro.dist import sharding as rshd  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.config import LOCAL as RLOCAL  # noqa: E402
from repro.optim.adamw import AdamW as RAdamW  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, PackedLMDataset  # noqa: E402
from repro_torch.dist import compression, sharding  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.config import LOCAL, ModelConfig, ShardCfg  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from tests import torch_shard_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSDP_ARCHS = {"llama3-8b": 2, "zamba2-1.2b": 4, "qwen3-moe-235b-a22b": 2}
SEQ, BATCH = 64, 4
OPT = dict(lr=1e-3)
REF_LOSS, REF_PARAMS = 1e-3, 5e-3          # tests/test_dist_equivalence.py
# the gradients against the reference's, per leaf: max|port - ref| <=
# REF_GRAD * max|ref| (tests/test_torch_train.py's GRAD_TOL)
REF_GRAD = 1e-4
PORT_REL = 1e-5                             # vs the port's own single step
MOE_TOL = 2e-3
EF_LOSS, EF_PARAMS = 1e-4, 5e-3
# the compressed step's gradient mean against the exact one (relative norm
# over the model): int8 rounds each element within half of max|g| / 127,
# about 1% of a gradient's norm; a missing scale or a sum for the mean is
# off by 50% or more
EF_GRAD_REL = 5e-2
# error feedback's identity, a step given the residual e against the same
# step given none (e'): mean(c) + mean(e_new) = mean(g) + mean(e) and
# mean(c') + mean(e'_new) = mean(g), to float32 rounding; a residual not
# added, or not returned, breaks it by about the quantization error
EF_IDENTITY = 1e-5
GPIPE_RTOL, GPIPE_ATOL = 2e-4, 2e-5
LAUNCH_S = 300.0


def _stub(**extents):
    """The reference mesh's interface: ``shape`` and ``axis_names``."""
    return types.SimpleNamespace(shape=dict(extents),
                                 axis_names=tuple(extents))


MESHES = {"2x4": dict(data=2, model=4), "2x16": dict(data=2, model=16),
          "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "4x1": dict(data=4, model=1)}


# -- spec trees (no ranks) -------------------------------------------------------
def _ref_leaves(tree) -> dict:
    """{path: spec} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {rshd._path_str(p): tuple(s) for p, s in flat}


@functools.lru_cache(maxsize=None)
def _models(arch: str, smoke: bool):
    cfg, rcfg = registry.get_config(arch), rreg.get_config(arch)
    if smoke:
        cfg, rcfg = registry.smoke(cfg), rreg.smoke(rcfg)
    shapes = jax.eval_shape(lambda: rmodel.init_params(
        rcfg, jax.random.PRNGKey(0)))
    return cfg, rcfg, model.init_params(cfg, device="meta"), shapes


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_trees_equal_the_reference_leaf_for_leaf(mesh, smoke):
    stub = _stub(**MESHES[mesh])
    n_leaves = 0
    for arch in registry.list_archs():
        cfg, rcfg, lm, shapes = _models(arch, smoke)
        stacked = lm.stack.stacked
        for mode in ("fsdp_tp", "dp"):
            for gb in (3, 512, 8):
                shard = sharding.make_shard_cfg(stub, cfg, gb, mode=mode)
                ref = rshd.make_shard_cfg(stub, rcfg, gb, mode=mode)
                for f in ("dp", "tp", "moe_mode", "ssm_sp", "batch_sharded",
                          "replicate_params", "dp_axes"):
                    assert getattr(shard, f) == getattr(ref, f), (arch, f)
                batch = {"tokens": torch.empty((gb, 64), device="meta")}
                rbatch = {"tokens": jax.ShapeDtypeStruct((gb, 64),
                                                         jnp.int32)}
                assert sharding.batch_spec_tree(batch, stub, shard) == \
                    {k: tuple(v) for k, v in rshd.batch_spec_tree(
                        rbatch, stub, ref).items()}
            want = _ref_leaves(rshd.param_spec_tree(shapes, rcfg, stub, ref))
            got = sharding.param_spec_tree(lm, cfg, stub, shard)
            assert {convert.reference_path(n, stacked) for n in got} == \
                set(want), arch
            for name, spec in got.items():
                assert spec == want[convert.reference_path(name, stacked)], \
                    (arch, mode, name, spec)
            opt = AdamW().state_spec_tree(got)
            ropt = RAdamW().state_spec_tree(
                rshd.param_spec_tree(shapes, rcfg, stub, ref))
            assert opt.step == tuple(ropt.step)
            assert opt.m == opt.v == got and _ref_leaves(ropt.m) == want
            n_leaves += len(got)
            # the cache rule, leaf by leaf in the reference's order
            caches = model.init_caches(cfg, 8, 1024, device="meta")
            rcaches = jax.eval_shape(lambda: rmodel.init_caches(
                rcfg, 8, 1024, jnp.bfloat16))
            from repro_torch.ckpt.checkpointer import flatten

            rspecs = jax.tree.leaves(
                rshd.cache_spec_tree(rcaches, rcfg, stub, ref),
                is_leaf=lambda x: isinstance(x, P))
            tensors = flatten(caches)[0]
            assert len(tensors) == len(rspecs), arch
            for t, rs in zip(tensors, rspecs):
                assert sharding.cache_spec_tree(t, cfg, stub, shard) == \
                    tuple(rs), (arch, mode, tuple(t.shape))
    assert n_leaves > 100


def test_guard_cases_of_the_reference():
    """``tests/test_dist_fast.py``'s cases on the port's rules."""
    cfg = registry.get_config("llama3-8b")
    lm = model.init_params(cfg, device="meta")
    for extents, wk, wq in (
            (dict(data=2, model=4), (None, "data", "model", None),
             (None, "data", "model", None)),
            (dict(data=2, model=16), (None, "data", None, None),
             (None, "data", "model", None))):
        stub = _stub(**extents)
        shard = sharding.make_shard_cfg(stub, cfg, global_batch=8)
        specs = sharding.param_spec_tree(lm, cfg, stub, shard)
        assert specs["stack.layers.0.attn.wk"] == wk
        assert specs["stack.layers.0.attn.wq"] == wq
    specs = sharding.param_spec_tree(
        lm, cfg, _stub(data=2, model=4),
        sharding.make_shard_cfg(_stub(data=2, model=4), cfg, 8))
    assert specs["stack.layers.0.attn.wo"] == (None, "model", None, "data")
    assert specs["stack.layers.0.ffn.down.w"] == (None, "model", "data")
    assert specs["embed.table"] == ("model", "data")
    assert specs["unembed.w"] == ("data", "model")
    assert specs["final_norm.scale"] == ()
    # the port's per-layer tensors drop the layer entry
    pl = sharding.param_placements(
        lm, cfg, _stub(data=2, model=4),
        sharding.make_shard_cfg(_stub(data=2, model=4), cfg, 8))
    assert pl["stack.layers.3.attn.wq"] == ("data", "model", None)
    assert pl["final_norm.scale"] == (None,)


def test_path_str_agrees_with_reference_path_and_the_decay_filter():
    """The placement rules' key, ``convert.reference_path``, is the
    reference's ``_path_str`` of every leaf."""
    assert convert.reference_path("stack.layers.3.ffn.down.w") == \
        "stack/layers/ffn/down/w"
    assert convert.reference_path("stack.layers.3.up.w", stacked=False) == \
        "stack/layers/3/up/w"
    for arch in ("zamba2-1.2b", "xlstm-125m"):
        _, _, lm, shapes = _models(arch, True)
        assert {convert.reference_path(n, lm.stack.stacked)
                for n, _ in lm.named_parameters()} == \
            {rshd._path_str(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]}
    opt = AdamW()
    assert not opt.decays("stack.layers.0.mamba.A_log")
    assert opt.decays("stack.layers.0.mamba.conv_b")


# -- the split product (no ranks) -------------------------------------------------
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_split_product_is_the_float32_product_of_rounded_operands(x_dtype):
    """Forward: the float32 product of the operands rounded to bf16;
    backward: the float32 products with the incoming gradient, returned in
    each operand's dtype; the TF32 setting is the same after as before."""
    from repro_torch.models.layers import split_product

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 8), generator=gen).to(x_dtype).requires_grad_()
    w = torch.randn((8, 6), generator=gen).requires_grad_()
    g = torch.randn((2, 3, 6), generator=gen).bfloat16().float()
    before = torch.backends.cuda.matmul.allow_tf32
    y = split_product(x, w, torch.bfloat16)
    y.backward(g)
    x16, w16 = x.detach().bfloat16().float(), w.detach().bfloat16().float()
    assert y.dtype == torch.float32 and torch.equal(y, x16 @ w16)
    assert x.grad.dtype == x_dtype and w.grad.dtype == torch.float32
    assert torch.equal(x.grad, (g @ w16.t()).to(x_dtype))
    assert torch.equal(w.grad, x16.reshape(-1, 8).t() @ g.reshape(-1, 6))
    assert torch.backends.cuda.matmul.allow_tf32 == before


# -- compression (no ranks) ---------------------------------------------------------
def _seeded(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape, scale", [((64, 33), 1.0), ((7,), 1e-3),
                                          ((5, 5), 0.0)])
def test_int8_quantization_is_bitwise_the_reference(shape, scale):
    g = _seeded(shape, 11, scale)
    q, s, e = compression.quantize_int8(torch.from_numpy(g))
    rq, rs, re = rcomp.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re))
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s, shape).numpy(),
        np.asarray(rcomp.dequantize_int8(rq, rs, shape)))
    n = int(np.prod(shape))
    for c in (True, False):
        assert compression.wire_bytes(n, compressed=c) == \
            rcomp.wire_bytes(n, compressed=c)


# -- the one launch ---------------------------------------------------------------------
def _cfgs(arch: str):
    layers = FSDP_ARCHS[arch]
    cfg = registry.smoke(registry.get_config(arch), layers=layers)
    rcfg = rreg.smoke(rreg.get_config(arch), layers=layers)
    if cfg.num_experts:                 # no drops: an exact match
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        rcfg = dataclasses.replace(rcfg, capacity_factor=8.0)
    return cfg, rcfg


def _batch(cfg, global_batch=BATCH, seq=SEQ):
    ds = PackedLMDataset(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                    seq_len=seq, global_batch=global_batch),
                         cfg)
    return ds.batch(0)


# attention over tp = 2 where the heads do not split evenly: kv heads
# whole, each rank its q heads' groups (one kv head for all; one a q
# head, with biases); and no split at all (every rank the whole attention)
HEAD_SPLITS = {"mqa_one_group": dict(num_heads=4, num_kv_heads=1),
               "kv_a_q_head": dict(num_heads=6, num_kv_heads=3,
                                   qkv_bias=True),
               "heads_whole": dict(num_heads=3, num_kv_heads=1)}


def _head_split_cfg(name):
    cfg = registry.smoke(registry.get_config("llama3-8b"))
    return dataclasses.replace(cfg, head_dim=32, **HEAD_SPLITS[name])


EF_CASES = [(_seeded((2, 300), 1), _seeded((2, 300), 2, 1e-2)),
            (_seeded((2, 4, 5), 3), np.zeros((2, 4, 5), np.float32)),
            (np.zeros((2, 6), np.float32), np.zeros((2, 6), np.float32))]
GPIPE = dict(L=8, B=8, S=16, D=32, microbatches=4)


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """Inputs, the reference's results, and the ranks' results of one
    4-rank launch."""
    jobs, inputs = {}, {}
    for arch in FSDP_ARCHS:
        cfg, rcfg = _cfgs(arch)
        rp = rmodel.init_params(rcfg, jax.random.PRNGKey(0))
        pnp = jax.tree.map(np.asarray, rp)
        b = _batch(cfg)
        inputs[arch] = (cfg, rcfg, rp, pnp, b)
        base = dict(cfg=cfg, params=pnp, batch=b, opt=OPT)
        jobs[arch] = dict(kind="fsdp", case=dict(
            base, ckpt=str(tmp_path_factory.mktemp("ckpt"))
            if arch == "llama3-8b" else None))
    cfg, _, _, pnp, b = inputs["llama3-8b"]
    jobs["llama3-8b/accum2"] = dict(kind="fsdp", case=dict(
        cfg=cfg, params=pnp, batch=b, opt=OPT, grad_accum=2))
    jobs["fault/grad_not_divided"] = dict(kind="fsdp", case=dict(
        cfg=cfg, params=pnp, batch=b, opt=OPT, fault="grad_not_divided"))
    xcfg = registry.smoke(registry.get_config("xlstm-125m"))
    xp = convert.lm_params_to_numpy(model.init_params(xcfg, 0, device="cpu"))
    inputs["xlstm-125m"] = (xcfg, None, None, xp, _batch(xcfg))
    jobs["xlstm-125m"] = dict(kind="fsdp", case=dict(
        cfg=xcfg, params=xp, batch=inputs["xlstm-125m"][4], opt=OPT))
    for name in HEAD_SPLITS:
        hcfg = _head_split_cfg(name)
        hp = convert.lm_params_to_numpy(model.init_params(hcfg, 0,
                                                          device="cpu"))
        inputs[name] = (hcfg, None, None, hp, b)
        jobs[name] = dict(kind="fsdp", case=dict(cfg=hcfg, params=hp,
                                                 batch=b, opt=OPT))
    cfg, _, _, pnp, b = inputs["zamba2-1.2b"]
    jobs["fault/wo_without_reduce"] = dict(kind="fsdp", case=dict(
        cfg=cfg, params=pnp, batch=b, opt=OPT, fault="wo_without_reduce"))
    cfg, _, _, pnp, _ = inputs["qwen3-moe-235b-a22b"]
    x = _seeded((4, 32, cfg.d_model), 7)
    jobs["moe_tp"] = dict(kind="moe_tp", case=dict(cfg=cfg, params=pnp, x=x))
    cfg, _, _, pnp, b = inputs["llama3-8b"]
    jobs["dp"] = dict(kind="dp", case=dict(cfg=cfg, params=pnp, batch=b,
                                           opt=OPT, steps=2))
    jobs["ef"] = dict(kind="ef", case=EF_CASES)
    g = GPIPE
    gcfg = ModelConfig(name="t", family="dense", num_layers=g["L"],
                       d_model=g["D"], num_heads=4, num_kv_heads=4, d_ff=64,
                       vocab_size=128)
    gin = dict(cfg=gcfg, ws=_seeded((g["L"], g["D"], g["D"]), 5,
                                    1 / np.sqrt(g["D"])),
               x=_seeded((g["B"], g["S"], g["D"]), 6),
               microbatches=g["microbatches"])
    jobs["gpipe"] = dict(kind="gpipe", case=gin)
    jobs["bf16"] = dict(kind="bf16", case=3)
    jobs["gather_many"] = dict(kind="gather_many", case=4)
    jobs["launcher"] = dict(kind="launcher", case=LAUNCHER + [
        "--ckpt-dir", str(tmp_path_factory.mktemp("whole"))])
    out = spawn(ranks.all_jobs, 4, args=(jobs,), timeout_s=LAUNCH_S)
    return inputs, jobs, out


def _ref_step(rcfg, rp, b, grad_accum=1):
    opt = RAdamW(lr=OPT["lr"])
    step = jax.jit(rstep.make_train_step(rcfg, RLOCAL, opt, grad_accum))
    p, _, met = step(rp, opt.init(rp), {k: jnp.asarray(v)
                                        for k, v in b.items()})
    return float(met["loss"]), jax.tree.map(np.asarray, p)


def ref_grads(rcfg, rp, b, per_row: bool = False) -> dict:
    """The reference's gradient of its ``LOCAL`` loss, as a numpy tree: on
    the whole batch, or (``per_row``) the mean over the rows of each row's
    own, as the ``dp`` step takes it (a rank's mean loss on its row)."""
    vg = jax.jit(jax.grad(lambda p, x: rmodel.loss_fn(p, rcfg, x, RLOCAL)[0]))
    parts = [{k: v[i:i + 1] for k, v in b.items()}
             for i in range(len(b["targets"]))] if per_row else [b]
    gs = [vg(rp, {k: jnp.asarray(v) for k, v in x.items()}) for x in parts]
    return jax.tree.map(lambda *g: np.mean(np.stack(
        [np.asarray(x, np.float64) for x in g]), 0), *gs)


def ref_grad_errors(got: dict, ref_g, cfg) -> dict:
    """{leaf: max|port - ref| / max|ref|} above :data:`REF_GRAD`, for every
    parameter of the port."""
    bad = {}
    for n, g in got.items():
        w = _ref_param(ref_g, n, cfg)
        assert g.shape == w.shape, n
        e = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        if not e <= REF_GRAD:
            bad[n] = float(e)
    return bad


def _port_step(cfg, pnp, b, grad_accum=1):
    lm = convert.lm_params_from_numpy(cfg, pnp, device="cpu")
    opt = AdamW(**OPT)
    step = step_lib.make_train_step(cfg, LOCAL, opt, grad_accum)
    lm, state, met = step(lm, opt.init(lm), {k: torch.from_numpy(v)
                                             for k, v in b.items()})
    grads = {n: p.grad.detach().numpy() for n, p in lm.named_parameters()}
    if grad_accum > 1:      # .grad holds the last microbatch's: take m
        grads = {n: m.numpy() for n, m in state.m.items()}
    return float(met["loss"]), grads, {
        n: p.detach().numpy() for n, p in lm.named_parameters()}


def _ref_param(ref_np: dict, name: str, cfg) -> np.ndarray:
    """The reference's leaf for the port's parameter ``name``."""
    stacked = cfg.family != "ssm"
    parts = name.split(".")
    node = ref_np
    i = None
    for j, k in enumerate(parts):
        if stacked and parts[:2] == ["stack", "layers"] and j == 2:
            i = int(k)
            continue
        node = node[int(k)] if isinstance(node, (list, tuple)) else node[k]
    return node[i] if i is not None else node


def grad_errors(got: dict, want: dict, zero=()) -> dict:
    """{leaf: relative norm error} above :data:`PORT_REL`.  A leaf in
    ``zero`` (its gradient is zero in exact arithmetic: float32 noise on
    both sides, an sLSTM's ``bi``) is held at PORT_REL of the largest
    leaf's norm instead."""
    top = max(np.linalg.norm(w) for w in want.values())
    bad = {}
    for n, w in want.items():
        scale = top if n in zero else max(np.linalg.norm(w), 1e-30)
        e = np.linalg.norm(got[n] - w) / scale
        if not e <= PORT_REL:
            bad[n] = float(e)
    return bad


@pytest.mark.parametrize("arch", list(FSDP_ARCHS))
def test_fsdp_tp_step_matches_the_reference_and_the_port(launch, arch):
    inputs, _, out = launch
    cfg, rcfg, rp, pnp, b = inputs[arch]
    res = out[0][arch]
    ref_loss, ref_p = _ref_step(rcfg, rp, b)
    loss = res["metrics"][0]["loss"]
    assert abs(loss - ref_loss) < REF_LOSS, (loss, ref_loss)
    worst = max(np.abs(p - _ref_param(ref_p, n, cfg)).max()
                for n, p in res["params"].items())
    assert worst < REF_PARAMS, worst
    assert ref_grad_errors(res["grads"], ref_grads(rcfg, rp, b), cfg) == {}
    port_loss, port_g, port_p = _port_step(cfg, pnp, b)
    assert abs(loss - port_loss) <= PORT_REL * abs(port_loss)
    assert grad_errors(res["grads"], port_g) == {}
    for r in out:                       # the same metrics on every rank
        assert r[arch]["metrics"] == res["metrics"]
        assert r[arch]["params"].keys() == port_p.keys()


def test_fsdp_tp_step_of_the_ssm_family_matches_the_port(launch):
    """xlstm-125m's per-layer stack: every mLSTM and sLSTM leaf gathered
    whole for its use, the vocabulary split over ``model``."""
    inputs, _, out = launch
    cfg, _, _, pnp, b = inputs["xlstm-125m"]
    res = out[0]["xlstm-125m"]
    port_loss, port_g, _ = _port_step(cfg, pnp, b)
    assert abs(res["metrics"][0]["loss"] - port_loss) <= \
        PORT_REL * abs(port_loss)
    zero = [f"stack.layers.{i}.bi" for i in cfg.slstm_indices]
    assert grad_errors(res["grads"], port_g, zero) == {}
    got, want = res["shapes"]
    assert got == want and got["embed.table"][0] == cfg.vocab_size // 2


@pytest.mark.parametrize("name", list(HEAD_SPLITS))
def test_attention_head_splits_match_the_port(launch, name):
    inputs, _, out = launch
    cfg, _, _, pnp, b = inputs[name]
    res = out[0][name]
    port_loss, port_g, _ = _port_step(cfg, pnp, b)
    assert abs(res["metrics"][0]["loss"] - port_loss) <= \
        PORT_REL * abs(port_loss)
    assert grad_errors(res["grads"], port_g) == {}
    stub = _stub(data=2, model=2)
    specs = sharding.param_spec_tree(
        model.init_params(cfg, device="meta"), cfg, stub,
        sharding.make_shard_cfg(stub, cfg, BATCH))
    wq, wk = specs["stack.layers.0.attn.wq"], specs["stack.layers.0.attn.wk"]
    assert wk[2] is None                        # kv heads whole on tp
    assert wq[2] == (None if name == "heads_whole" else "model")


def test_each_rank_stores_only_its_blocks(launch):
    inputs, _, out = launch
    for arch in [*FSDP_ARCHS, *HEAD_SPLITS]:
        cfg = inputs[arch][0]
        whole = sum(p.numel() * 4 for p in model.init_params(
            cfg, device="meta").parameters())
        for r in out:
            got, want = r[arch]["shapes"]
            assert got == want, arch
            assert r[arch]["local_bytes"] < 0.5 * whole, (arch, whole)


def test_fsdp_tp_grad_accum_matches_the_port(launch):
    """Two microbatches: the loss, and the accumulated gradient as the
    first moment holds it after one step (m = (1 - b1) · clip · g)."""
    inputs, _, out = launch
    cfg, _, _, pnp, b = inputs["llama3-8b"]
    res = out[0]["llama3-8b/accum2"]
    port_loss, port_m, _ = _port_step(cfg, pnp, b, grad_accum=2)
    assert abs(res["metrics"][0]["loss"] - port_loss) <= \
        PORT_REL * abs(port_loss)
    assert grad_errors(res["m"], port_m) == {}


@pytest.mark.parametrize("fault, arch", [
    ("wo_without_reduce", "zamba2-1.2b"), ("grad_not_divided", "llama3-8b")])
def test_planted_faults_are_rejected(launch, fault, arch):
    inputs, _, out = launch
    cfg, _, _, pnp, b = inputs[arch]
    _, port_g, _ = _port_step(cfg, pnp, b)
    bad = grad_errors(out[0][f"fault/{fault}"]["grads"], port_g)
    assert bad and max(bad.values()) > 1e-2, bad


def test_moe_tp_matches_the_reference_local_moe(launch):
    inputs, jobs, out = launch
    cfg, rcfg, rp, _, _ = inputs["qwen3-moe-235b-a22b"]
    x = jobs["moe_tp"]["case"]["x"]
    layer0 = jax.tree.map(lambda a: a[0], rp["stack"]["layers"]["ffn"])
    ref, rmet = rmoe.moe_apply(layer0, rcfg, jnp.asarray(x), RLOCAL)
    err = np.abs(out[0]["moe_tp"]["out"] - np.asarray(ref)).max()
    assert err < MOE_TOL, err
    assert out[0]["moe_tp"]["dropped"] == float(rmet.dropped_frac) == 0.0


def test_dp_and_compressed_dp_steps(launch):
    inputs, _, out = launch
    cfg, rcfg, rp, _, b = inputs["llama3-8b"]
    res = out[0]["dp"]
    ref_loss, ref_p = _ref_step(rcfg, rp, b)
    exact, comp = res["exact"], res["compressed"]
    assert abs(exact["metrics"][0]["loss"] - ref_loss) < REF_LOSS
    worst = max(np.abs(p - _ref_param(ref_p, n, cfg)).max()
                for n, p in exact["params"][0].items())
    assert worst < REF_PARAMS, worst
    assert ref_grad_errors(exact["grads"][0],
                           ref_grads(rcfg, rp, b, per_row=True), cfg) == {}
    # the reference's check: one step from the same state
    assert abs(comp["metrics"][0]["loss"] - exact["metrics"][0]["loss"]) \
        < EF_LOSS
    worst = max(np.abs(comp["params"][0][n] - p).max()
                for n, p in exact["params"][0].items())
    assert worst < EF_PARAMS, worst
    # the compressed gradient mean against the exact one, as the steps
    # took them
    assert rel_norm_error(comp["took"][0], exact["took"][0]) < EF_GRAD_REL
    # the residual is non-zero after each step, and carried: the second
    # step given it differs from the second step given zeros
    norms = [sum(np.linalg.norm(e) for e in ef.values()) for ef in comp["ef"]]
    assert all(n > 0 for n in norms) and norms[0] != norms[1]
    un = res["uncarried"]
    assert any(not np.array_equal(comp["params"][1][n], p)
               for n, p in un["params"].items())
    # error feedback's identity at the second step; a residual averaged
    # over the pods (ranks 0, 1 are pod 0, ranks 2, 3 pod 1)
    pods = lambda ef: {n: (ef(0)[n] + ef(2)[n]) / 2 for n in un["ef"]}
    e1 = pods(lambda r: out[r]["dp"]["compressed"]["ef"][0])
    e2 = pods(lambda r: out[r]["dp"]["compressed"]["ef"][1])
    e2_fresh = pods(lambda r: out[r]["dp"]["uncarried"]["ef"])
    carried = {n: comp["took"][1][n] - e1[n] + e2[n] for n in e1}
    fresh = {n: un["took"][n] + e2_fresh[n] for n in e1}
    assert rel_norm_error(carried, fresh) < EF_IDENTITY
    pod = lambda r: 0 if r < 2 else 1
    for r in range(4):
        other = out[r ^ 1]["dp"]["compressed"]["ef"][1]
        mine = out[r]["dp"]["compressed"]["ef"][1]
        assert pod(r) == pod(r ^ 1)
        for n in mine:
            np.testing.assert_array_equal(mine[n], other[n])
        for n, p in exact["params"][1].items():     # replicated updates
            np.testing.assert_array_equal(out[r]["dp"]["exact"]["params"][1][n],
                                          p)


def rel_norm_error(got: dict, want: dict) -> float:
    """|got - want| / |want| over every leaf together."""
    num = sum(np.sum((got[n].astype(np.float64) - w) ** 2)
              for n, w in want.items())
    den = sum(np.sum(w.astype(np.float64) ** 2) for w in want.values())
    return float(np.sqrt(num / den))


def test_ef_allreduce_mean_is_bitwise_the_reference(launch):
    _, _, out = launch
    by_pod = {r["ef"]["pod"]: r["ef"]["results"] for r in out}
    fn = jax.vmap(lambda g, e: rcomp.ef_allreduce_mean(g, e, "pod"),
                  axis_name="pod")
    for i, (g, e) in enumerate(EF_CASES):
        gm, ne = fn(jnp.asarray(g), jnp.asarray(e))
        for pod in (0, 1):
            np.testing.assert_array_equal(by_pod[pod][i][0],
                                          np.asarray(gm[pod]))
            np.testing.assert_array_equal(by_pod[pod][i][1],
                                          np.asarray(ne[pod]))


def test_gpipe_matches_the_sequential_stack(launch):
    _, jobs, out = launch
    case = jobs["gpipe"]["case"]
    ws, x = jnp.asarray(case["ws"]), jnp.asarray(case["x"])
    ref = x
    for i in range(ws.shape[0]):
        ref = jnp.tanh(ref @ ws[i])
    for r in out:
        np.testing.assert_allclose(r["gpipe"], np.asarray(ref),
                                   rtol=GPIPE_RTOL, atol=GPIPE_ATOL)


def test_bfloat16_blocks_gather_and_reduce_scatter(launch):
    """Gloo moves no 16-bit integers: bfloat16 travels as its bytes
    (bitwise), and the backward's sum runs in float32, rounded once."""
    _, _, out = launch
    gen = torch.Generator().manual_seed(3)
    blocks = torch.randn((2, 3, 5), generator=gen).to(torch.bfloat16)
    grad = torch.randn((3, 10), generator=gen).to(torch.bfloat16)
    whole = torch.cat([blocks[0], blocks[1]], 1).float().numpy()
    total = (grad.float() * 1 + grad.float() * 2).to(torch.bfloat16)
    for r in out:
        res = r["bf16"]
        assert res["dtypes"] == ("torch.bfloat16", "torch.bfloat16")
        np.testing.assert_array_equal(res["gathered"], whole)
        me = res["data"]
        np.testing.assert_array_equal(
            res["grad"], total[:, 5 * me:5 * me + 5].float().numpy())


def test_gather_many_gathers_and_reduces_each_block_as_its_own(launch):
    """Blocks along different dims in one collective: each gathered as a
    lone gather would; the backward sums each gradient over ``data`` and
    keeps this rank's block, or keeps the block only."""
    _, _, out = launch
    gen = torch.Generator().manual_seed(4)
    a, b = (torch.randn(s, generator=gen).numpy()
            for s in ((2, 2, 3), (2, 3, 4)))
    ga, gb = (torch.randn(s, generator=gen).numpy()
              for s in ((4, 3), (3, 8)))
    for r in out:
        res, me = r["gather_many"], r["gather_many"]["data"]
        for back in (True, False):
            got = res[back]
            np.testing.assert_array_equal(got["x"], np.concatenate(a, 0))
            np.testing.assert_array_equal(got["y"], np.concatenate(b, 1))
            sx, sy = ((g * 1 + g * 2) if back else g * (me + 1)
                      for g in (ga, gb))
            np.testing.assert_array_equal(got["gx"], sx[2 * me:2 * me + 2])
            np.testing.assert_array_equal(got["gy"], sy[:, 4 * me:4 * me + 4])


def test_checkpoint_saved_at_2x2_restores_at_4x1_bitwise(launch):
    from repro_torch.ckpt.checkpointer import Checkpointer

    _, jobs, out = launch
    directory = jobs["llama3-8b"]["case"]["ckpt"]
    cfg = jobs["llama3-8b"]["case"]["cfg"]
    _, arrays = Checkpointer(directory).read_arrays(1)
    saved = out[0]["llama3-8b"]
    lm = model.init_params(cfg, device="meta")
    names = sorted(n for n, _ in lm.named_parameters())
    # the tree {"opt": AdamWState(step, m, v), "params": ...} flattened
    n = len(names)
    m_saved = dict(zip(names, arrays[1:1 + n]))
    p_saved = dict(zip(names, arrays[1 + 2 * n:1 + 3 * n]))
    for name in names:
        np.testing.assert_array_equal(p_saved[name], saved["params"][name])
        np.testing.assert_array_equal(m_saved[name], saved["m"][name])
    mesh = _stub(data=4, model=1)
    for r in out:
        el = r["llama3-8b"]["elastic"]
        cut = lambda a, name: sharding.block(
            torch.from_numpy(a), el["placement"][name], mesh,
            el["coord"]).numpy()
        for name in names:
            np.testing.assert_array_equal(el["blocks"][name],
                                          cut(p_saved[name], name))
            np.testing.assert_array_equal(el["m_blocks"][name],
                                          cut(m_saved[name], name))
            np.testing.assert_array_equal(el["full"][name], p_saved[name])


# -- the launcher -------------------------------------------------------------------------
LAUNCHER = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--mesh",
            "2x2", "--batch", "4", "--seq", "32", "--steps", "6",
            "--ckpt-every", "2", "--log-every", "1"]


def _launcher(args):
    return [sys.executable, "-m", "repro_torch.launch.train", *LAUNCHER,
            *args]


def test_launcher_trains_over_a_mesh_and_resumes_a_killed_run(launch,
                                                              tmp_path):
    """The launch's ranks ran ``--mesh 2x2`` to its end (its checkpoints in
    ``whole``); the command line, killed in every rank once step 3 is
    logged and started again, resumes and ends bitwise at the same
    state."""
    _, jobs, out = launch
    whole = jobs["launcher"]["case"][-1]
    losses = out[0]["launcher"]
    assert len(losses) == 6 and all(r["launcher"] == losses for r in out)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cut = str(tmp_path / "cut")
    proc = subprocess.Popen(_launcher(["--ckpt-dir", cut]), env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            start_new_session=True)
    try:
        for line in proc.stdout:
            if line.startswith("[train] step     3 "):
                os.killpg(proc.pid, signal.SIGKILL)
                break
    finally:
        proc.wait(timeout=LAUNCH_S)
    assert proc.returncode == -signal.SIGKILL
    p = subprocess.run(_launcher(["--ckpt-dir", cut]), env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=LAUNCH_S)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "[train] resumed from step " in p.stdout, p.stdout
    assert "[train] done: " in p.stdout
    from repro_torch.ckpt.checkpointer import Checkpointer

    _, a = Checkpointer(whole).read_arrays(6)
    _, b = Checkpointer(cut).read_arrays(6)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- what stays unported ------------------------------------------------------------------
def test_a2a_ssm_sp_and_meshed_serving_still_raise():
    """``a2a`` and ``ssm_sp`` build now (``tests/test_torch_sharded_sp.py``
    trains with them); what still raises is a posture with no tensor-
    parallel axis to split over and an unknown MoE mode (``ValueError``,
    never a quiet fall back to ``local``).  A meshed ``ServingEngine``
    builds (``tests/test_torch_sharded_serve.py`` serves with it): on a
    stub mesh at coordinate (data 1, model 1) it holds that rank's blocks
    of the caches and the parameters' use."""
    cfg = registry.smoke(registry.get_config("llama3-8b"))
    stub = _stub(data=2, model=2)
    for kw in (dict(moe_mode="a2a"), dict(ssm_sp=True)):
        shard = sharding.make_shard_cfg(stub, cfg, 4, **kw)
        assert (shard.moe_mode, shard.ssm_sp, shard.tp) == (
            kw.get("moe_mode", "local"), kw.get("ssm_sp", False), "model")
        with pytest.raises(ValueError, match="tensor-parallel axis"):
            sharding.make_shard_cfg(stub, cfg, 4, mode="dp", **kw)
    with pytest.raises(ValueError, match="unknown moe_mode"):
        ShardCfg(moe_mode="ep")
    at = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                               shape=(2, 2), get_coordinate=lambda: [1, 1])
    eng = ServingEngine(cfg, model.init_params(cfg, 0, device="cpu"),
                        shard=sharding.make_shard_cfg(at, cfg, 4),
                        max_seq=32, device="cpu")
    assert (eng.rows.start, eng.rows.stop) == (2, 4)
    assert tuple(eng.kv_block) == (16, True)
    assert tuple(eng.caches.k.shape) == (cfg.num_layers, 2, 16,
                                         cfg.num_kv_heads, cfg.head_dim)
    assert tuple(eng.params.stack.layers[0].attn.wq.shape) == (
        cfg.d_model, cfg.num_heads // 2, cfg.head_dim)
    assert tuple(eng.params.final_norm.scale.shape) == (cfg.d_model,)
