"""The sharded LM's sequence-parallel postures — ``moe_mode="a2a"`` and
sequence-parallel Mamba2 (``ssm_sp``) — against the reference, on the CPU.

The reference's own checks of these postures
(``tests/test_dist_equivalence.py``) run meshes in subprocesses that fail
on jax 0.9 in this container, so each meshed result here is held against
the reference's ``LOCAL`` result in-process, at that test's bound.  One
launch of 4 gloo ranks over (data 2, model 2) runs every rank job
(``tests/torch_shard_ranks.py``); the reference runs in this process while
the ranks do.

* ``a2a``, qwen3-moe smoke, B 4, S 32: at capacity factor 8 within 2e-3
  of the reference's ``LOCAL`` ``moe_apply`` with ``dropped`` 0 on both;
  at the default 1.25 within 2e-3 of the reference's per-block semantics
  (its ``_route`` and ``_local_moe`` on each (data, model) block, the
  capacity of the block's tokens), ``dropped`` equal; ``moe_aux`` and
  ``moe_z`` the mean of the blocks' ``_route`` values.
* ``ssm_sp``, zamba2 smoke, B 4: ``mamba2_seq`` within 1e-4 of the
  reference's ``LOCAL`` one at S 64 and at S 40 (a rank's block of 20
  tokens, not a multiple of the 16-token chunk); the ``ValueError``s for a
  sequence that does not divide over ``model``, a block shorter than the
  conv halo, a prefill that wants the state, and ``a2a`` at decode.
* The ``fsdp_tp`` steps (zamba2 smoke under ``ssm_sp``; qwen3-moe smoke
  under ``a2a`` at ``router_aux_coef`` 0, capacity factor 8): the loss
  within 1e-3 of the reference's, and every gathered gradient leaf within
  1e-4 of the reference's ``jax.grad`` of its ``LOCAL`` loss (of the
  leaf's largest value, ``tests/test_torch_train.py``'s bound).  Five
  planted faults are each rejected by that bound: ``no_halo``,
  ``no_relay``, ``tp_grad_kept``, ``router_grad_kept``, ``return_order``
  (``torch_shard_ranks.planted``).
* Counting equals live: the same step of one rank on a (2, 2)
  ``CountingMesh`` on ``meta`` books exactly the calls and operand bytes
  by kind that ``collectives.STATS`` booked in the live ranks.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import mamba2 as rmamba  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.config import LOCAL as RLOCAL  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, PackedLMDataset  # noqa: E402
from repro_torch.dist import collectives, sharding  # noqa: E402
from repro_torch.launch.mesh import CountingMesh, spawn  # noqa: E402
from repro_torch.models import mamba2, model, moe  # noqa: E402
from repro_torch.models.config import ShardCfg  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from tests import torch_shard_ranks as ranks  # noqa: E402

MOE_TOL = 2e-3                     # tests/test_dist_equivalence.py:43
SSM_TOL = 1e-4                     # tests/test_dist_equivalence.py:16
REF_LOSS = 1e-3
REF_GRAD = 1e-4                    # of each leaf's max|ref|
B, MOE_S, STEP_S = 4, 32, 64
SSM_SEQS = (64, 40)
CAPACITY = (8.0, 1.25)
LAUNCH_S = 300.0
POSTURES = {"ssm_sp": ("zamba2-1.2b", 4, dict(ssm_sp=True)),
            "a2a": ("qwen3-moe-235b-a22b", 2, dict(moe_mode="a2a"))}
FAULTS = {"no_halo": "ssm_sp", "no_relay": "ssm_sp",
          "tp_grad_kept": "ssm_sp", "router_grad_kept": "a2a",
          "return_order": "a2a"}
OPT = dict(lr=1e-3)


def _seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _cfgs(posture: str):
    arch, layers, _ = POSTURES[posture]
    cfg = registry.smoke(registry.get_config(arch), layers=layers)
    rcfg = rreg.smoke(rreg.get_config(arch), layers=layers)
    if posture == "a2a":          # no drops, no load-balance term
        kw = dict(capacity_factor=8.0, router_aux_coef=0.0)
        cfg, rcfg = (dataclasses.replace(c, **kw) for c in (cfg, rcfg))
    return cfg, rcfg


def _batch(cfg):
    ds = PackedLMDataset(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                    seq_len=STEP_S, global_batch=B), cfg)
    return ds.batch(0)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _reference(inputs: dict, xs: dict) -> dict:
    """The reference's results, computed while the ranks run."""
    out = {"grads": {}}
    for posture, (cfg, rcfg, rp, _, b) in inputs.items():
        vg = jax.jit(jax.value_and_grad(
            lambda p, x: rmodel.loss_fn(p, rcfg, x, RLOCAL)[0]))
        loss, g = vg(rp, {k: jnp.asarray(v) for k, v in b.items()})
        out["grads"][posture] = (float(loss), jax.tree.map(np.asarray, g))
    _, rcfg, rp, _, _ = inputs["ssm_sp"]
    mamba = _layer0(rp["stack"]["layers"]["mamba"])
    seq = jax.jit(lambda p, x: rmamba.mamba2_seq(p, rcfg, x, RLOCAL)[0])
    out["ssm"] = {s: np.asarray(seq(mamba, jnp.asarray(x)))
                  for s, x in xs["ssm"].items()}
    _, rcfg, rp, _, _ = inputs["a2a"]
    ffn = _layer0(rp["stack"]["layers"]["ffn"])
    out["moe"] = {}
    for cf, x in xs["moe"].items():
        c = dataclasses.replace(rcfg, capacity_factor=cf,
                                router_aux_coef=rreg.smoke(rreg.get_config(
                                    "qwen3-moe-235b-a22b")).router_aux_coef)
        local, met = jax.jit(lambda p, x: rmoe.moe_apply(p, c, x, RLOCAL))(
            ffn, jnp.asarray(x))
        out["moe"][cf] = {"local": np.asarray(local),
                          "local_dropped": float(met.dropped_frac),
                          "blocks": _per_block(ffn, c, x)}
    return out


def _per_block(ffn, rcfg, x) -> dict:
    """The reference's semantics of ``a2a``: ``_route`` and ``_local_moe``
    on each (data, model) block of x, the capacity of the block's
    tokens."""

    @jax.jit
    def block(p, blk):
        x2d = blk.reshape(-1, blk.shape[-1])
        ids, gates, aux, z = rmoe._route(p, rcfg, x2d)
        cap = rmoe._capacity(x2d.shape[0], rcfg)
        y, dropped = rmoe._local_moe(p, rcfg, x2d, ids, gates, 0,
                                     rcfg.num_experts, cap,
                                     rcfg.compute_dtype)
        if "shared" in p:
            y = y + rlayers.mlp(p["shared"], x2d)
        return y.reshape(blk.shape), jnp.stack([aux, z, dropped])

    out = np.zeros_like(x)
    mets = {}
    bl, sl = B // 2, x.shape[1] // 2
    for di in range(2):
        for ti in range(2):
            at = (slice(di * bl, (di + 1) * bl), slice(ti * sl, (ti + 1) * sl))
            y, met = block(ffn, jnp.asarray(x[at]))
            out[at] = np.asarray(y)
            mets[(di, ti)] = tuple(float(v) for v in np.asarray(met))
    return {"out": out, "mets": mets}


@pytest.fixture(scope="module")
def launch():
    """Inputs, the reference's results and the ranks' results of one
    4-rank launch."""
    inputs, jobs = {}, {}
    for posture in POSTURES:
        cfg, rcfg = _cfgs(posture)
        rp = rmodel.init_params(rcfg, jax.random.PRNGKey(0))
        pnp = jax.tree.map(np.asarray, rp)
        b = _batch(cfg)
        inputs[posture] = (cfg, rcfg, rp, pnp, b)
        base = dict(cfg=cfg, params=pnp, batch=b, opt=OPT,
                    posture=POSTURES[posture][2])
        jobs[posture] = dict(kind="fsdp", case=base)
    for fault, posture in FAULTS.items():
        jobs[f"fault/{fault}"] = dict(kind="fsdp", case=dict(
            jobs[posture]["case"], fault=fault))
    zcfg, _, _, zp, _ = inputs["ssm_sp"]
    qcfg, _, _, qp, _ = inputs["a2a"]
    # the forwards at the config's own load-balance coefficient
    qcfg = dataclasses.replace(qcfg, router_aux_coef=registry.smoke(
        registry.get_config("qwen3-moe-235b-a22b")).router_aux_coef)
    xs = {"ssm": {s: _seeded((B, s, zcfg.d_model), 10 + s)
                  for s in SSM_SEQS},
          "moe": {cf: _seeded((B, MOE_S, qcfg.d_model), 7)
                  for cf in CAPACITY}}
    jobs["forward"] = dict(kind="sp_forward", case=dict(
        ssm_cfg=zcfg, ssm_params=zp, moe_cfg=qcfg, moe_params=qp, **xs))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.all_jobs, 4, args=(jobs,),
                           timeout_s=LAUNCH_S)
        ref = _reference(inputs, xs)
        out = done.result()
    return inputs, ref, out


# -- the forwards --------------------------------------------------------------------
def test_a2a_matches_the_reference_local_moe_at_capacity_8(launch):
    _, ref, out = launch
    want = ref["moe"][8.0]
    for r in out:
        got = r["forward"]["moe"][8.0]
        err = np.abs(got["out"] - want["local"]).max()
        assert err < MOE_TOL, err
        assert got["dropped_frac"] == want["local_dropped"] == 0.0


def test_a2a_matches_the_per_block_reference_at_the_default_capacity(
        launch):
    """At 1.25 each block's capacity follows its own tokens, and the port
    drops the fraction the reference's blocks do."""
    _, ref, out = launch
    want = ref["moe"][1.25]
    for r in out:
        got = r["forward"]["moe"][1.25]
        err = np.abs(got["out"] - want["blocks"]["out"]).max()
        assert err < MOE_TOL, err
        di = r["forward"]["coord"]["data"]
        blocks = [want["blocks"]["mets"][(di, t)] for t in range(2)]
        assert got["dropped_frac"] == pytest.approx(
            np.mean([m[2] for m in blocks]), abs=1e-7)


def test_a2a_moe_aux_is_the_mean_of_the_blocks_route_aux(launch):
    _, ref, out = launch
    for cf in CAPACITY:
        mets = ref["moe"][cf]["blocks"]["mets"]
        assert all(m[0] > 0 for m in mets.values())
        for r in out:
            got = r["forward"]["moe"][cf]
            di = r["forward"]["coord"]["data"]
            for i, key in ((0, "aux_loss"), (1, "z_loss")):
                want = np.mean([mets[(di, t)][i] for t in range(2)])
                assert got[key] == pytest.approx(want, rel=1e-5), key
        # the data mean the step takes: the mean over every block
        mean = np.mean([r["forward"]["moe"][cf]["aux_loss"] for r in out])
        assert mean == pytest.approx(np.mean([m[0] for m in mets.values()]),
                                     rel=1e-5)


@pytest.mark.parametrize("seq", SSM_SEQS)
def test_ssm_sp_mamba2_seq_matches_the_reference_local(launch, seq):
    _, ref, out = launch
    for r in out:
        err = np.abs(r["forward"]["ssm"][seq] - ref["ssm"][seq]).max()
        assert err < SSM_TOL, err


# -- what the postures refuse (no ranks: a counting mesh) ----------------------------
def _counting_shard(cfg, **posture):
    return sharding.make_shard_cfg(CountingMesh((2, 2), ("data", "model")),
                                   cfg, 2, **posture)


@pytest.mark.parametrize("case", ["seq_not_divisible", "block_below_halo",
                                  "return_state", "a2a_decode"])
def test_the_sequence_limits_raise(case):
    if case == "a2a_decode":
        cfg = registry.smoke(registry.get_config("qwen3-moe-235b-a22b"))
        lm = model.init_params(cfg, 0, device="cpu")
        shard = _counting_shard(cfg, moe_mode="a2a")
        x = torch.zeros((2, 1, cfg.d_model))
        with pytest.raises(ValueError, match="does not divide"):
            moe.moe_apply(lm.stack.layers[0].ffn, cfg, x, shard)
        return
    cfg = registry.smoke(registry.get_config("zamba2-1.2b"))
    p = model.init_params(cfg, 0, device="cpu").stack.layers[0].mamba
    shard = _counting_shard(cfg, ssm_sp=True)
    seq, kw, match = {"seq_not_divisible": (33, {}, "does not divide"),
                      "block_below_halo": (4, {}, "shorter than the conv"),
                      "return_state": (32, dict(return_state=True),
                                       "returns no state")}[case]
    with pytest.raises(ValueError, match=match):
        mamba2.mamba2_seq(p, cfg, torch.zeros((2, seq, cfg.d_model)), shard,
                          **kw)


# -- the fsdp_tp steps -------------------------------------------------------------
def _ref_param(tree, name: str):
    parts = name.split(".")
    node, i = tree, None
    for j, k in enumerate(parts):
        if parts[:2] == ["stack", "layers"] and j == 2:
            i = int(k)
            continue
        node = node[k]
    return node[i] if i is not None else node


def grad_errors(got: dict, ref_g) -> dict:
    """{leaf: max|port - ref| / max|ref|} above :data:`REF_GRAD`."""
    bad = {}
    for n, g in got.items():
        w = _ref_param(ref_g, n)
        assert g.shape == w.shape, n
        e = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        if not e <= REF_GRAD:
            bad[n] = float(e)
    return bad


@pytest.mark.parametrize("posture", list(POSTURES))
def test_fsdp_tp_step_matches_the_reference(launch, posture):
    _, ref, out = launch
    loss, ref_g = ref["grads"][posture]
    res = out[0][posture]
    assert abs(res["metrics"][0]["loss"] - loss) < REF_LOSS
    assert grad_errors(res["grads"], ref_g) == {}
    for r in out:                       # the same metrics on every rank
        assert r[posture]["metrics"] == res["metrics"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_are_rejected(launch, fault):
    _, ref, out = launch
    _, ref_g = ref["grads"][FAULTS[fault]]
    bad = grad_errors(out[0][f"fault/{fault}"]["grads"], ref_g)
    assert bad, fault


# -- counting equals live --------------------------------------------------------------
@pytest.mark.parametrize("posture", list(POSTURES))
def test_counted_collectives_equal_the_live_ones(launch, posture):
    """Rank 0's step on a counting mesh on ``meta``: the calls and operand
    bytes of each kind the live rank booked, exactly."""
    inputs, _, out = launch
    cfg, _, _, _, b = inputs[posture]
    mesh = CountingMesh((2, 2), ("data", "model"))
    shard = sharding.make_shard_cfg(mesh, cfg, B, **POSTURES[posture][2])
    lm = sharding.shard_params(model.init_params(cfg, device="meta"), cfg,
                               shard)
    opt = AdamW(**OPT)
    batch = sharding.local_batch({k: torch.from_numpy(v).to("meta")
                                  for k, v in b.items()}, mesh, shard)
    collectives.reset_stats()
    step_lib.make_train_step(cfg, shard, opt)(lm, opt.init(lm), batch)
    counted = {k: (r["calls"], r["bytes"])
               for k, r in collectives.STATS["by_kind"].items()}
    collectives.reset_stats()
    live = {k: (r["calls"], r["bytes"])
            for k, r in out[0][posture]["collectives"].items()}
    assert counted == live
    kinds = {"ssm_sp": {"all_gather", "all_reduce", "reduce_scatter"},
             "a2a": {"all_gather", "all_reduce", "reduce_scatter",
                     "all_to_all"}}[posture]
    assert set(counted) == kinds
    assert ShardCfg(mesh=mesh, **POSTURES[posture][2]).tp_size() == 2
