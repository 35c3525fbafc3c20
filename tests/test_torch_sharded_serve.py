"""The LM served over a mesh of ranks — prefill and decode with the KV
cache's sequence split over ``tp``, FLASH_ATTENTION's decode with its
log-sum-exp, and ``ServingEngine(shard=...)`` — against the reference, on
the CPU.

* The plain decode partial with its log-sum-exp
  (``models.attention.decode_mha_partial`` on the ``TORCH`` template),
  taken over 2 and 4 blocks of the sequence and merged
  (``kernels.ref.merge_partials``), equals the reference's
  ``decode_mha`` on the whole cache within 1e-6 of the output's scale in
  float32, at every head
  dim the kernel takes, GQA 1:1, 4:1 and MQA 8:1, with per-row lengths
  that leave some blocks no valid key (their lse is -1e30, their weight
  0).
* ``dist.sharding.local_caches`` gives every rank of a stub mesh the
  blocks of the reference's ``cache_spec_tree``, for every served family,
  including the guard's cases (a batch or a length that does not divide).
* One launch of 4 gloo ranks (jobs in ``tests/torch_shard_ranks.py``):
  meshed ``prefill`` and 2 ``decode_step``s over (data 2, model 2), B 8,
  S 24, max_seq 32, per-row lengths, for llama3-8b, zamba2-1.2b,
  qwen3-moe (capacity factor 8, ``moe_mode="tp"``), paligemma-3b (KH 1,
  an 8-row prefix) and xlstm-125m smoke, and llama3-8b where the
  sequence (30 positions) or the heads (3 over 1) do not divide over
  ``model``: the logits within 2e-3 of the
  reference's ``LOCAL`` (``tests/test_dist_equivalence.py``'s bound for
  its meshed decode, held here in-process: that test's subprocess fails
  on jax 0.9) and within 1e-5 of the port's ``LOCAL``, each rank's cache
  blocks within 1e-6 (relative norm) of the matching blocks of the port's
  ``LOCAL`` caches; a meshed ``ServingEngine`` serving 8 requests through
  4 slots gives the reference engine's tokens on every rank (llama3-8b,
  zamba2-1.2b); and the check rejects each planted fault: the partials
  averaged without their log-sum-exp weights, the new token written on
  every ``tp`` rank, an empty block's NaN partial.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.dist import sharding as rshd  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models.config import LOCAL as RLOCAL  # noqa: E402
from repro.serve import engine as rengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.attention import decode_mha_partial  # noqa: E402
from tests import torch_shard_ranks as ranks  # noqa: E402

# float32: the merged blocks against the reference's whole decode, of the
# output's scale max(1, max|out|), as tests/test_torch_attention.py holds
# the plain attention (the two packages sum in other orders)
MERGE_TOL = 1e-6
REF_TOL = 2e-3                    # tests/test_dist_equivalence.py:128
PORT_TOL = 1e-5                   # logits, of max(1, max|logit|)
CACHE_TOL = 1e-6                  # each cache leaf's relative norm error
B, S, MAX_SEQ, PREFIX = 8, 24, 32, 8
# per-row lengths of the first decode step: rows at or below 15 see no key
# of model rank 1's half (positions 16..31); 16 writes the first position
# of that half; 23 the last prompt position
LENS = np.array([3, 15, 16, 17, 23, 5, 20, 10], np.int64)
DECODE_STEPS = 2
# (arch, config fields replaced, max_seq): the five families at the
# reference test's shapes; then llama3 at 30 positions, which do not divide
# over ``model`` (cache_spec_tree's guard: every model rank holds the whole
# sequence), and with 3 q heads over 1 kv head, neither of which divides
# (every model rank computes the whole attention)
SERVE_CASES = {arch: (arch, {}, MAX_SEQ) for arch in (
    "llama3-8b", "zamba2-1.2b", "qwen3-moe-235b-a22b", "paligemma-3b",
    "xlstm-125m")}
SERVE_CASES["llama3-8b/seq_whole"] = ("llama3-8b", {}, 30)
SERVE_CASES["llama3-8b/heads_whole"] = (
    "llama3-8b", dict(num_heads=3, num_kv_heads=1), MAX_SEQ)
ENGINE_ARCHS = ("llama3-8b", "zamba2-1.2b")
ENGINE_SLOTS, ENGINE_NEW = 4, 8
FAULTS = ("unweighted", "every_rank", "nan_empty")
MESH = dict(data=2, model=2)
LAUNCH_S = 300.0


def _stub(**extents):
    """The reference mesh's interface: ``shape`` and ``axis_names``."""
    return types.SimpleNamespace(shape=dict(extents),
                                 axis_names=tuple(extents))


def _coords(extents: dict):
    names = list(extents)
    for idx in np.ndindex(*extents.values()):
        yield dict(zip(names, (int(i) for i in idx)))


# -- (a) the plain partials merged over blocks (no ranks) ------------------------
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("heads", [(8, 8), (8, 2), (8, 1)],
                         ids=["gqa1to1", "gqa4to1", "mqa8to1"])
@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
def test_merged_partials_equal_the_reference_decode(d, heads, parts):
    h, kh = heads
    sk = 64
    rng = np.random.default_rng(d * 100 + kh * 10 + parts)
    q = rng.standard_normal((4, 1, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((4, sk, kh, d)).astype(np.float32)
            for _ in range(2))
    # valid lengths: one key; inside the first block; across blocks; all
    lens = np.array([1, 13, 40, 64], np.int64)
    want = np.asarray(rattn.decode_mha(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens)))
    size = sk // parts
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    outs, lses = zip(*(decode_mha_partial(
        tq, tk[:, j * size:(j + 1) * size], tv[:, j * size:(j + 1) * size],
        torch.from_numpy(lens), j * size, template="TORCH")
        for j in range(parts)))
    got = ref.merge_partials(torch.stack(outs), torch.stack(lses)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= MERGE_TOL * scale
    # a block that holds no valid key of a row: finite, lse -1e30
    for j, lse in enumerate(lses):
        empty = lens <= j * size
        assert bool(torch.isfinite(outs[j]).all())
        assert bool((lse[torch.from_numpy(empty)] == -1e30).all())
        assert bool((lse[torch.from_numpy(~empty)] > -1e29).all())
    # the log-sum-exp is that of the masked logits
    whole, lse = decode_mha_partial(tq, tk, tv, torch.from_numpy(lens), 0,
                                    template="TORCH")
    logits = torch.einsum("bqhd,bkhd->bqhk", tq,
                          tk.repeat_interleave(h // kh, 2)) / d ** 0.5
    logits = torch.where(torch.arange(sk)[None, None, None]
                         < torch.from_numpy(lens)[:, None, None, None],
                         logits, -1e30)
    assert torch.allclose(lse, torch.logsumexp(logits, -1), rtol=1e-6,
                          atol=1e-6)
    assert np.abs(whole.numpy() - want).max() <= MERGE_TOL * scale


# -- (b) the cache blocks on stub meshes (no ranks) --------------------------------
def _block_shape(shape, spec, extents: dict):
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            out[i] //= extents[a]
    return tuple(out)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_cache_blocks_follow_cache_spec_tree(arch):
    """Every rank's ``local_caches`` are the blocks of the reference's
    ``cache_spec_tree``, leaf by leaf, and its ``KVBlock`` starts where its
    block of the sequence does; a length that does not divide over
    ``model`` leaves the sequence whole (``split`` False), a batch that
    does not divide over ``data`` leaves the rows whole."""
    cfg = registry.smoke(registry.get_config(arch))
    rcfg = rreg.smoke(rreg.get_config(arch))
    for extents, batch, max_seq in ((MESH, 8, 32), (MESH, 3, 32),
                                    (dict(data=2, model=4), 8, 30),
                                    (dict(data=1, model=4), 4, 64),
                                    (dict(data=4, model=1), 8, 32)):
        stub = _stub(**extents)
        shard = sharding.make_shard_cfg(stub, cfg, batch)
        rshard = rshd.make_shard_cfg(stub, rcfg, batch)
        rcaches = jax.eval_shape(lambda: rmodel.init_caches(
            rcfg, batch, max_seq, jnp.float32))
        leaves = jax.tree.leaves(rcaches)
        specs = jax.tree.leaves(
            rshd.cache_spec_tree(rcaches, rcfg, stub, rshard),
            is_leaf=lambda x: isinstance(x, P))
        want = [_block_shape(t.shape, tuple(s), extents)
                for t, s in zip(leaves, specs)]
        seq_split = any(len(s) > 2 and s[2] is not None for s in specs)
        for coord in _coords(extents):
            caches, kvb = sharding.local_caches(
                cfg, batch, max_seq, shard, torch.float32, "meta",
                coord=coord)
            got = [tuple(t.shape) for t in sharding.tree_leaves(caches)]
            assert got == want, (arch, extents, batch, max_seq)
            if cfg.family == "ssm" or extents["model"] == 1:
                assert kvb is None
            else:
                assert kvb.split == seq_split
                size = max_seq // extents["model"] if seq_split else 0
                assert kvb.start == coord["model"] * size
            rows = sharding.local_rows(batch, shard, coord)
            n = rows.stop - rows.start
            assert n == (batch // extents["data"] if batch % extents["data"]
                         == 0 else batch)


# -- the one launch ------------------------------------------------------------------
def _cfgs(case: str):
    arch, fields, _ = SERVE_CASES[case]
    cfg = registry.smoke(registry.get_config(arch))
    rcfg = rreg.smoke(rreg.get_config(arch))
    if cfg.num_experts:                 # no drops: an exact match
        fields = dict(fields, capacity_factor=8.0)
    return (dataclasses.replace(cfg, **fields),
            dataclasses.replace(rcfg, **fields))


def _inputs(cfg, seed: int = 0) -> tuple[dict, list]:
    """(the prefill batch: tokens, and an 8-row prefix for the vlm
    family; each decode step's tokens)."""
    rng = np.random.default_rng(seed)
    pre = PREFIX if cfg.family == "vlm" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - pre))}
    if pre:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, pre, cfg.d_model)).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab_size, (B, 1))
             for _ in range(DECODE_STEPS)]
    return batch, steps


def _prompts(cfg) -> list:
    """8 prompts of 3..20 tokens: some inside model rank 0's half of the
    32 positions, some across both halves once decoded."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, int(n))
            for n in (3, 20, 9, 17, 14, 5, 19, 12)]


@pytest.fixture(scope="module")
def launch():
    """The inputs, the reference's numpy trees and one 4-rank launch's
    results."""
    inputs, jobs = {}, {}
    for arch, (_, _, max_seq) in SERVE_CASES.items():
        cfg, rcfg = _cfgs(arch)
        rp = rmodel.init_params(rcfg, jax.random.PRNGKey(0))
        pnp = jax.tree.map(np.asarray, rp)
        batch, steps = _inputs(cfg)
        inputs[arch] = (cfg, rcfg, rp, pnp, batch, steps)
        case = dict(cfg=cfg, params=pnp, batch=batch, tokens=steps,
                    lens=LENS, max_seq=max_seq)
        jobs[arch] = dict(kind="serve", case=case)
        if arch == "llama3-8b":
            for fault in FAULTS:
                jobs[f"fault/{fault}"] = dict(kind="serve",
                                              case=dict(case, fault=fault))
        if arch in ENGINE_ARCHS:
            jobs[f"engine/{arch}"] = dict(kind="engine", case=dict(
                cfg=cfg, params=pnp, prompts=_prompts(cfg),
                slots=ENGINE_SLOTS, max_seq=MAX_SEQ, new=ENGINE_NEW))
    jobs["a2a"] = dict(kind="a2a", case=5)
    # the references (JAX and the port's LOCAL) computed while the ranks
    # run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(spawn, ranks.all_jobs, 4, args=(jobs,),
                                 timeout_s=LAUNCH_S)
        for case in SERVE_CASES:
            _expected(case)
        out = ranks_done.result()
    return inputs, out


def _ref_logits(rcfg, rp, batch, steps, max_seq: int) -> list:
    caches = rmodel.init_caches(rcfg, B, max_seq, jnp.float32)
    lg, caches = rmodel.prefill(rp, rcfg, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, caches, RLOCAL)
    out = [np.asarray(lg)]
    for i, tok in enumerate(steps):
        lg, caches = rmodel.decode_step(rp, rcfg, jnp.asarray(tok, jnp.int32),
                                        caches, jnp.asarray(LENS + i),
                                        RLOCAL)
        out.append(np.asarray(lg))
    return out


def _port_local(cfg, pnp, batch, steps, max_seq: int) -> tuple[list, list]:
    """The port's ``LOCAL`` logits and caches (numpy leaves in order)."""
    lm = convert.lm_params_from_numpy(cfg, pnp, device="cpu")
    caches = model.init_caches(cfg, B, max_seq, torch.float32, "cpu")
    lg, caches = model.prefill(lm, cfg, {k: torch.from_numpy(v) for k, v in
                                         batch.items()}, caches)
    out = [lg.numpy()]
    for i, tok in enumerate(steps):
        lg, caches = model.decode_step(lm, cfg, torch.from_numpy(tok), caches,
                                       torch.from_numpy(LENS + i))
        out.append(lg.numpy())
    return out, sharding.tree_leaves(caches)


def failures(cfg, got: list, ref_logits: list, port_logits: list,
             port_caches: list) -> dict:
    """What the meshed run ``got`` (every rank's result) misses: the
    logits against the reference's and the port's ``LOCAL`` (every rank),
    each rank's cache blocks against the matching blocks of the port's
    ``LOCAL`` caches.  NaN counts as a miss."""
    bad = {}
    stub = _stub(**MESH)
    shard = sharding.make_shard_cfg(stub, cfg, B)
    for r, res in enumerate(got):
        for i, (a, w, p) in enumerate(zip(res["logits"], ref_logits,
                                          port_logits)):
            err_ref = float(np.abs(a - w).max())
            err_port = float(np.abs(a - p).max())
            if not err_ref <= REF_TOL:
                bad[f"rank {r} logits {i} vs reference"] = err_ref
            if not err_port <= PORT_TOL * max(1.0, float(np.abs(p).max())):
                bad[f"rank {r} logits {i} vs port"] = err_port
        for j, (mine, whole) in enumerate(zip(res["caches"], port_caches)):
            want = sharding.block(whole, sharding.cache_spec_tree(
                whole, cfg, stub, shard), stub, res["coord"]).numpy()
            assert mine.shape == want.shape, (r, j)
            err = float(np.linalg.norm(mine - want)
                        / max(np.linalg.norm(want), 1e-30))
            if not err <= CACHE_TOL:
                bad[f"rank {r} cache leaf {j}"] = err
    return bad


@functools.lru_cache(maxsize=None)
def _expected(case: str) -> tuple:
    """(the reference's LOCAL logits, the port's LOCAL logits and
    caches) of ``case``'s inputs."""
    cfg, rcfg = _cfgs(case)
    max_seq = SERVE_CASES[case][2]
    rp = rmodel.init_params(rcfg, jax.random.PRNGKey(0))
    batch, steps = _inputs(cfg)
    return (_ref_logits(rcfg, rp, batch, steps, max_seq),
            *_port_local(cfg, jax.tree.map(np.asarray, rp), batch, steps,
                         max_seq))


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_meshed_prefill_and_decode_match_the_reference_and_the_port(launch,
                                                                    case):
    inputs, out = launch
    cfg = inputs[case][0]
    max_seq = SERVE_CASES[case][2]
    got = [r[case] for r in out]
    assert failures(cfg, got, *_expected(case)) == {}
    kvb = [r["kv_block"] for r in got]
    if cfg.family == "ssm":
        assert kvb == [None] * 4
    elif max_seq % 2:
        assert kvb == [(0, False)] * 4
    else:
        assert [(b.start, b.split) for b in kvb] == \
            [(r["coord"]["model"] * max_seq // 2, True) for r in got]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_are_rejected(launch, fault):
    inputs, out = launch
    bad = failures(inputs["llama3-8b"][0], [r[f"fault/{fault}"] for r in out],
                   *_expected("llama3-8b"))
    assert any("logits" in k for k in bad), (fault, bad)
    if fault == "every_rank":          # the stray write shows in the cache
        assert any("cache" in k for k in bad), bad


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_meshed_engine_serves_the_reference_tokens(launch, arch):
    inputs, out = launch
    cfg, rcfg, rp, _, _, _ = inputs[arch]
    eng = rengine.ServingEngine(rcfg, rp, slots=ENGINE_SLOTS,
                                max_seq=MAX_SEQ)
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(rengine.Request(i, p.astype(np.int32),
                                   max_new_tokens=ENGINE_NEW))
    want = {r.rid: r.output for r in eng.run_until_drained()}
    assert len(want) == 8
    stub = _stub(**MESH)
    shard = sharding.make_shard_cfg(stub, cfg, ENGINE_SLOTS)
    want_shapes = [_block_shape(t.shape, sharding.cache_spec_tree(
        t, cfg, stub, shard), MESH) for t in sharding.tree_leaves(
            model.init_caches(cfg, ENGINE_SLOTS, MAX_SEQ, torch.float32,
                              "meta"))]
    for r, res in enumerate(out):
        got = res[f"engine/{arch}"]
        assert got["tokens"] == want, r
        assert got["steps"] == eng.steps and got["idle"]
        d = r // 2                       # rank r = (data r // 2, model r % 2)
        assert got["rows"] == (2 * d, 2 * d + 2)
        assert got["kv_block"] == (r % 2 * MAX_SEQ // 2, True)
        assert got["cache_shapes"] == want_shapes, r


def test_all_to_all_moves_bf16_blocks_between_the_model_ranks(launch):
    """Rank (d, m) receives, from each model rank j of its data index,
    block m of j's dim 1, concatenated along dim 2 in rank order."""
    _, out = launch
    res = [r["a2a"] for r in out]
    for r in res:
        d, m = r["coord"]["data"], r["coord"]["model"]
        line = [x["x"] for x in res if x["coord"]["data"] == d]
        want = np.concatenate([x[:, 2 * m:2 * m + 2] for x in line], axis=2)
        assert r["dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(r["y"], want)


def test_the_wrapper_gives_the_plain_pair_and_books_the_lse():
    """``attention_cuda.flash_attention(..., return_lse=True)``: on the CPU
    the plain pair, its ``out`` bitwise the call without it; on ``meta``
    the declared cost plus the (B, Sq, H) float32 output; the
    tensor-core prefill's shapes raise."""
    from repro_torch.kernels import attention_cuda
    from repro_torch.launch import op_cost

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 64)).astype(
        np.float32)) for _ in range(2))
    valid = torch.tensor([0, 17])
    spec = ref.MaskSpec(causal=False)
    out, lse = attention_cuda.flash_attention(q, k, v, spec, valid,
                                              return_lse=True)
    want = ref.attention_lse_reference(q, k, v, spec, valid)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert torch.equal(out, attention_cuda.flash_attention(q, k, v, spec,
                                                           valid))
    assert lse.dtype == torch.float32 and bool((lse[0] == -1e30).all())
    meta = [t.to("meta") for t in (q, k, v)]
    booked = []
    for with_lse in (False, True):
        with op_cost.OpCounter() as c:
            attention_cuda.flash_attention(*meta, spec, valid.to("meta"),
                                           return_lse=with_lse)
        booked.append(c.classes["FLASH_ATTENTION"]["bytes"])
    assert booked[1] - booked[0] == 2 * 1 * 4 * 4
    pre = torch.zeros((1, 16, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="log-sum-exp"):
        attention_cuda.flash_attention(pre, pre, pre, ref.MaskSpec(),
                                       return_lse=True)
