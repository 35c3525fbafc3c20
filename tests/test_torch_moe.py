"""The port's ``moe`` family against the JAX reference, on the CPU: the
router, the sort-based capacity dispatch, the deterministic combine, the
MoE layer, the loss and its gradients, AdamW steps, the decay mask, the
parameter and optimizer-state conversion, and the parameter and FLOP
counts; and FLASH_ATTENTION's plain version at kimi-k2's head dim 112
against the Pallas kernel in interpret mode.

Both packages get the same weights (``convert.lm_params_from_numpy``) and
the same seeded numpy inputs, at the float32 smoke configs of
``qwen3-moe-235b-a22b`` (no shared expert) and ``kimi-k2-1t-a32b`` (one
shared expert): 8 experts, top-2, d_model 128.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.dist.sharding import _path_str  # noqa: E402
from repro.kernels.attention import flash_attention as r_flash  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.config import LOCAL as RLOCAL  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import schedules as rsched  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import attention as pflash  # noqa: E402
from repro_torch.models import layers, model, moe  # noqa: E402
from repro_torch.models.config import LOCAL  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ARCHS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
SEQ, BATCH = 64, 2
# float32 smoke models: the packages sum the same terms in another order.
# The router's outputs (gates, the aux and z losses) at 1e-6; the MoE
# layer's output at 1e-5 of its scale; the loss at 1e-5 relative and each
# gradient leaf at 1e-4 of its largest entry, as tests/test_torch_train.py
# holds the dense and hybrid families; after AdamW steps, each leaf's
# relative L2 error at 1e-3 (Adam divides each gradient by its own running
# magnitude, which amplifies the summation-order noise of near-zero ones).
ROUTE_TOL = 1e-6
LAYER_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STATE_RTOL = 1e-3


@pytest.fixture(scope="module")
def pairs():
    """Per arch: reference config, port config, reference params (jax)."""
    out = {}
    for arch in ARCHS:
        rcfg = rreg.smoke(rreg.get_config(arch))
        cfg = registry.smoke(registry.get_config(arch))
        init = jax.jit(functools.partial(rmodel.init_params, rcfg))
        out[arch] = (rcfg, cfg, init(jax.random.PRNGKey(0)))
    return out


def _port_model(cfg, rp):
    return convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp),
                                        device="cpu")


def _layer0(rp):
    """The reference's MoE parameters of layer 0 (numpy leaves)."""
    return jax.tree.map(lambda t: np.asarray(t[0]),
                        rp["stack"]["layers"]["ffn"])


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _batch(step):
    ds = rpipe.PackedLMDataset(rpipe.DataConfig(
        seed=0, vocab_size=512, seq_len=SEQ, global_batch=BATCH,
        doc_len_mean=32))
    return ds.batch(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# capacity, dispatch, router, combine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_capacity_equals_the_reference(arch, reduced):
    rcfg, cfg = rreg.get_config(arch), registry.get_config(arch)
    if reduced:
        rcfg, cfg = rreg.smoke(rcfg), registry.smoke(cfg)
    for t in (1, 4, 40, 1024, 2048):
        assert moe._capacity(t, cfg) == rmoe._capacity(t, rcfg), t
    # decode at 4 slots never drops: a token's k experts are distinct, so
    # no expert is asked for more than 4 assignments
    assert moe._capacity(4, cfg) >= 4


def _dispatch_cases():
    rng = np.random.RandomState(0)
    uniform = rng.randint(0, 8, size=40 * 2)
    masked = uniform.copy()
    masked[rng.rand(masked.size) < 0.3] = 8          # == E: masked out
    skewed = np.where(rng.rand(80) < 0.7, 3, rng.randint(0, 8, size=80))
    return {"uniform": (uniform, 8, 24), "masked": (masked, 8, 24),
            "skewed_overflow": (skewed, 8, 24),
            "wide": (rng.randint(0, 128, size=1024 * 8), 128, 80)}


@pytest.mark.parametrize("case", list(_dispatch_cases()))
def test_dispatch_indices_are_the_reference_bitwise(case):
    ids, e, cap = _dispatch_cases()[case]
    ra, rv, rd = rmoe._dispatch_indices(jnp.asarray(ids, jnp.int32), e, cap)
    pa, pv, pd = moe._dispatch_indices(torch.from_numpy(ids), e, cap)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    assert pd.dtype == torch.float32
    assert pd.numpy().tobytes() == np.asarray(rd, np.float32).tobytes()
    if case == "skewed_overflow":
        assert float(pd) > 0.3      # expert 3 takes ~60 of 80 into 24 slots
    if case == "masked":
        assert float(pd) == 0.0     # masked ids are not counted as dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_the_reference(pairs, arch):
    rcfg, cfg, rp = pairs[arch]
    lm = _port_model(cfg, rp)
    x = _x((96, cfg.d_model), 1)
    rids, rgates, raux, rz = rmoe._route(_layer0(rp), rcfg, jnp.asarray(x))
    ids, gates, aux, z = moe._route(lm.stack.layers[0].ffn, cfg,
                                    torch.from_numpy(x))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates),
                               rtol=0, atol=ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=ROUTE_TOL)
    np.testing.assert_allclose(float(z), float(rz), rtol=ROUTE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [(2, 40), (4, 1)])
def test_moe_apply_matches_the_reference(pairs, arch, tokens):
    """A prefill-shaped call (80 tokens, capacity 32) and a decode-shaped
    one (4 tokens, capacity 8: no drops).  The tokens share a direction, as
    a layer's activations do, so the router favours a few experts and the
    prefill-shaped call overflows them."""
    rcfg, cfg, rp = pairs[arch]
    lm = _port_model(cfg, rp)
    x = 2.0 * _x((1, 1, cfg.d_model), 9) + _x((*tokens, cfg.d_model), 2)
    rout, rmet = rmoe.moe_apply(_layer0(rp), rcfg, jnp.asarray(x), RLOCAL)
    out, met = moe.moe_apply(lm.stack.layers[0].ffn, cfg,
                             torch.from_numpy(x), LOCAL)
    want = np.asarray(rout)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(out.numpy() - want).max()) <= LAYER_TOL * scale
    for got, ref in zip(met, rmet):
        np.testing.assert_allclose(float(got), float(ref), rtol=ROUTE_TOL,
                                   atol=1e-9)
    assert (float(met.dropped_frac) > 0) == (tokens == (2, 40))
    assert hasattr(lm.stack.layers[0].ffn, "shared") == \
        (arch == "kimi-k2-1t-a32b")


def test_combine_is_deterministic_and_a_sequential_sum_by_expert():
    """The combine twice on the same inputs gives the same bits, and equals
    a plain loop that adds each token's kept contributions in ascending
    expert order from zero, in bfloat16 (the card's compute dtype)."""
    rng = np.random.RandomState(3)
    t, k, e, d = 50, 4, 16, 24
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    ids[:20, 0] = 5                                   # expert 5 overflows
    ids = torch.from_numpy(ids)
    cap = 16
    assign, valid, _ = moe._dispatch_indices(ids.reshape(-1), e, cap)
    assert not bool(valid.all()) and float(_) > 0
    contrib = torch.from_numpy(rng.randn(e * cap, d).astype(np.float32))
    contrib = contrib.to(torch.bfloat16) * valid[:, None]
    a = moe._combine(contrib, assign, valid, ids)
    b = moe._combine(contrib, assign, valid, ids)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    want = torch.zeros(t, d, dtype=torch.bfloat16)
    slot_of = {int(assign[s]): s for s in range(e * cap) if bool(valid[s])}
    for tok in range(t):
        for j in sorted(range(k), key=lambda j: int(ids[tok, j])):
            s = slot_of.get(tok * k + j)
            if s is not None:
                want[tok] = want[tok] + contrib[s]
    assert torch.equal(a, want)


# ---------------------------------------------------------------------------
# the loss, its gradients and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(pairs, arch):
    rcfg, cfg, rp = pairs[arch]
    batch = _batch(0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss_fn(p, rcfg, b, RLOCAL), has_aux=True))
    (rloss, rmet), rgrads = vg(rp, jax.tree.map(jnp.asarray, batch))
    lm = _port_model(cfg, rp)
    lm.requires_grad_(True)
    loss, met = model.loss_fn(lm, cfg, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=LOSS_RTOL)
    assert float(rmet["moe_aux"]) > 0 and float(rmet["moe_dropped"]) > 0
    for k in ("ce", "acc", "moe_aux", "moe_z", "moe_dropped"):
        np.testing.assert_allclose(float(met[k].detach()), float(rmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    got = convert.grads_to_numpy(lm)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    names = []
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        names.append(_path_str(path))
        assert g.shape == w.shape, _path_str(path)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (_path_str(path),
                                                          err)
    assert {"stack/layers/ffn/router", "stack/layers/ffn/experts/gate",
            "stack/layers/ffn/experts/down"} <= set(names)


def _leaf_rel(got: dict, want) -> float:
    worst = 0.0
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w, np.float64)
        worst = max(worst, float(np.linalg.norm(g - w))
                    / max(float(np.linalg.norm(w)), 1e-30))
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_the_reference(pairs, arch):
    """One reference step makes a non-trivial AdamW state; both packages
    carry it through two more steps."""
    rcfg, cfg, rp = pairs[arch]
    sched = (3e-3, 2, 10)
    ropt = radamw.AdamW(lr=rsched.warmup_cosine(*sched))
    rts = jax.jit(rstep.make_train_step(rcfg, RLOCAL, ropt))
    rp, rst, _ = rts(rp, ropt.init(rp), jax.tree.map(jnp.asarray, _batch(0)))
    lm = _port_model(cfg, rp)
    st = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, rst), "cpu")
    ts = step_lib.make_train_step(cfg, LOCAL,
                                  AdamW(lr=schedules.warmup_cosine(*sched)))
    for step in (1, 2):
        b = _batch(step)
        rp, rst, rmet = rts(rp, rst, jax.tree.map(jnp.asarray, b))
        lm, st, met = ts(lm, st, _torch_batch(b))
        for k in ("loss", "ce", "moe_aux", "moe_z", "moe_dropped",
                  "grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert int(st.step) == int(rst.step) == 3
    assert _leaf_rel(convert.lm_params_to_numpy(lm), rp) <= STATE_RTOL
    got = convert.adamw_state_to_numpy(st)
    assert _leaf_rel(got.m, rst.m) <= STATE_RTOL
    assert _leaf_rel(got.v, rst.v) <= STATE_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_the_reference_leaf_for_leaf(pairs, arch):
    rcfg, cfg, rp = pairs[arch]
    ropt = radamw.AdamW()
    want = {_path_str(path): ropt.decay_filter(_path_str(path))
            for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]}
    opt = AdamW()
    got = {}
    for name, _ in model.init_params(cfg, device="meta").named_parameters():
        got.setdefault(convert.reference_path(name), set()).add(
            opt.decays(name))
    assert {k: v.pop() for k, v in got.items() if len(v) == 1} == want
    assert want["stack/layers/ffn/router"] is True
    assert want["stack/layers/ffn/experts/gate"] is True


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_adamw_state_round_trip_through_numpy(pairs, arch):
    rcfg, cfg, rp = pairs[arch]
    rp = jax.tree.map(np.asarray, rp)
    rst = radamw.AdamW().init(rp)
    rst = rst._replace(step=np.int32(5),
                       m=jax.tree.map(lambda x: x - 0.5, rp),
                       v=jax.tree.map(lambda x: x * x, rp))
    lm = _port_model(cfg, rp)
    st = convert.adamw_state_from_numpy(rst, "cpu")
    assert set(st.m) == {n for n, _ in lm.named_parameters()}
    back = convert.adamw_state_to_numpy(st)
    assert int(back.step) == 5
    for a, b in ((back.m, rst.m), (back.v, rst.v),
                 (convert.lm_params_to_numpy(lm), rp)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_the_smoke_model_on_the_cpu(arch, capsys):
    from repro_torch.launch import train as launch_train

    losses = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--steps", "2", "--batch", "2", "--seq", "32",
                                "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "[train] done: 2 steps" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# forced routing (the card's gradient-parity check), the plan's bf16
# moments, the sliced AdamW update
# ---------------------------------------------------------------------------
def _chip_smoke():
    """``chip_smoke.py`` as a module (importing it defines its functions
    and runs nothing)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(test_torch_harness.ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _loss_and_grads(lm, cfg, batch):
    for p in lm.parameters():
        p.grad = None
    loss, _ = model.loss_fn(lm, cfg, batch, template="TORCH")
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in lm.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_route_at_its_own_top_k_ids_is_the_unforced_route_bitwise(pairs,
                                                                   arch):
    _, cfg, rp = pairs[arch]
    lm = _port_model(cfg, rp)
    x = torch.from_numpy(_x((SEQ, cfg.d_model), 5))
    params = lm.stack.layers[0].ffn
    free = moe._route(params, cfg, x)
    forced = moe._route(params, cfg, x, ids=free[0])
    for a, b in zip(free, forced):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forced_routing_holds_two_plain_runs_to_one_routing(pairs, arch,
                                                            remat):
    """Two TORCH runs whose attentions differ (kv_chunk 64: one chunk;
    16: the online softmax over four) agree in the loss and every gradient
    leaf once the second takes the first's top-k ids call by call
    (``chip_smoke.forced_routing``), remat ``block``'s recompute included;
    the same run given other ids (each token's from its neighbour) moves
    the experts' gradients, so the ids are taken."""
    cs = _chip_smoke()
    _, cfg, rp = pairs[arch]
    cfg = dataclasses.replace(cfg, remat=remat)
    other = dataclasses.replace(cfg, kv_chunk=16)
    lm = _port_model(cfg, rp).requires_grad_(True)
    batch = _torch_batch(_batch(0))
    with cs.recording(moe, "_route", lambda out: out[0]) as chosen:
        want_loss, want = _loss_and_grads(lm, cfg, batch)
    calls = cfg.num_layers * (2 if remat == "block" else 1)
    assert len(chosen) == calls
    with cs.forced_routing(chosen) as taken:
        got_loss, got = _loss_and_grads(lm, other, batch)
    assert len(taken) == calls and all(a is b for a, b in zip(taken, chosen))
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= GRAD_TOL * float(w.abs().max()), (name, err)
    with cs.forced_routing([torch.roll(c, 1, 0) for c in chosen]):
        _, moved = _loss_and_grads(lm, other, batch)
    leaf = "stack.layers.0.ffn.experts.gate"
    assert float((moved[leaf] - want[leaf]).norm()) > \
        0.1 * float(want[leaf].norm())
    assert cs.topk_agreement(chosen, chosen) == 1.0
    assert cs.topk_agreement([torch.roll(c, 1, 0) for c in chosen],
                             chosen) < 1.0


def _plan_moments(arch):
    from repro_torch.launch.dryrun import train_plan

    plan = train_plan(registry.get_config(arch))
    return plan["m_dtype"], plan["v_dtype"]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_with_the_plans_bf16_moments_match_the_reference(pairs,
                                                                   arch):
    """The published config's plan gives bf16 moments (>= 128 experts, or
    d_model >= 4096); the smoke model trains two steps with them in both
    packages from the same weights and fresh states."""
    rcfg, cfg, rp = pairs[arch]
    m_dt, v_dt = _plan_moments(arch)
    assert m_dt == v_dt == torch.bfloat16
    sched = (3e-3, 2, 10)
    ropt = radamw.AdamW(lr=rsched.warmup_cosine(*sched),
                        m_dtype=jnp.bfloat16, v_dtype=jnp.bfloat16)
    rts = jax.jit(rstep.make_train_step(rcfg, RLOCAL, ropt))
    lm = _port_model(cfg, rp)
    opt = AdamW(lr=schedules.warmup_cosine(*sched), m_dtype=m_dt,
                v_dtype=v_dt)
    ts = step_lib.make_train_step(cfg, LOCAL, opt)
    rst, st = ropt.init(rp), opt.init(lm)
    for step in (0, 1):
        b = _batch(step)
        rp, rst, rmet = rts(rp, rst, jax.tree.map(jnp.asarray, b))
        lm, st, met = ts(lm, st, _torch_batch(b))
        for k in ("loss", "ce", "moe_aux", "moe_z", "grad_norm",
                  "clip_scale"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert all(t.dtype == torch.bfloat16
               for t in (*st.m.values(), *st.v.values()))
    assert _leaf_rel(convert.lm_params_to_numpy(lm), rp) <= STATE_RTOL
    got = convert.adamw_state_to_numpy(st)
    # one bf16 rounding of float32 values that may differ in their last
    # bits: a few elements a bf16 ulp (at most 2^-7 relative) apart
    assert _leaf_rel(got.m, rst.m) <= 2.0 ** -7
    assert _leaf_rel(got.v, rst.v) <= 2.0 ** -7


@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_adamw_update_equals_the_whole_bitwise(pairs, arch,
                                                      monkeypatch):
    """AdamW updates a leaf UPDATE_SLICE elements at a time along its first
    axis; every operation is elementwise, so 100-element slices give the
    parameters and bf16 moments of the whole-leaf update bit for bit."""
    from repro_torch.optim import adamw

    _, cfg, rp = pairs[arch]
    m_dt, v_dt = _plan_moments(arch)
    opt = AdamW(lr=1e-2, m_dtype=m_dt, v_dtype=v_dt)
    runs = []
    for whole in (True, False):
        if not whole:
            monkeypatch.setattr(adamw, "UPDATE_SLICE", 100)
        lm = _port_model(cfg, rp)
        st = opt.init(lm)
        for seed in (1, 2):
            grads = {n: torch.from_numpy(_x(tuple(p.shape), seed + i))
                     for i, (n, p) in enumerate(lm.named_parameters())}
            lm, st, _ = opt.update(grads, st, lm)
        runs.append((dict(lm.named_parameters()), st))
        sliced = [len(list(adamw._slices(p))) for p in lm.parameters()]
        assert max(sliced) == (1 if whole else cfg.vocab_size)
    (pa, sa), (pb, sb) = runs
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(sa.m[n], sb.m[n]) and torch.equal(sa.v[n],
                                                             sb.v[n]), n


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layers_", [None, 1, 4])
def test_counts_match_the_reference(arch, layers_):
    """The published config and the depth cuts the card runs (the port on
    ``meta``, the reference through ``eval_shape``: nothing allocated)."""
    rcfg, cfg = rreg.get_config(arch), registry.get_config(arch)
    if layers_:
        rcfg = dataclasses.replace(rcfg, num_layers=layers_)
        cfg = dataclasses.replace(cfg, num_layers=layers_)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
    for training in (True, False):
        assert model.model_flops_per_step(cfg, 4, 4096, training) == \
            rmodel.model_flops_per_step(rcfg, 4, 4096, training)
    assert moe.moe_flops_per_token(cfg) == rmoe.moe_flops_per_token(rcfg)


# ---------------------------------------------------------------------------
# FLASH_ATTENTION at kimi-k2's head dim
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,hkv,sq,sk,causal,q_offset", [
    (8, 1, 128, 128, True, 0),
    (4, 2, 64, 128, True, 64),
])
def test_plain_flash_at_head_dim_112_matches_pallas_interpret(
        h, hkv, sq, sk, causal, q_offset):
    """The Pallas kernel tiles (block, D) with the full D, so it takes 112;
    the plain version, which the card's kernel is held against, agrees with
    it at 2e-6 of the output's scale (float32, another summation order)."""
    d = 112
    q, k, v = (_x(s, i) for i, s in
               enumerate([(h, sq, d), (hkv, sk, d), (hkv, sk, d)]))
    want = np.asarray(r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=q_offset, block_q=64,
                              block_k=64, interpret=True))
    got = pflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, q_offset=q_offset,
                                 block_q=64, block_k=64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 2e-6 * scale


# ---------------------------------------------------------------------------
# the in-place truncated normal
# ---------------------------------------------------------------------------
def _scaled_copy(gen, shape, stddev, dtype, device):
    """The draw as it was before the scaling went in place: ``t * stddev``
    into a second float32 tensor, then the cast."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type == "meta":
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3-8b",
                                  "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_truncated_normal_in_place_gives_the_same_draws_bitwise(
        arch, dtype, monkeypatch):
    cfg = dataclasses.replace(registry.smoke(registry.get_config(arch)),
                              param_dtype=dtype)
    now = model.init_params(cfg, 7, device="cpu").state_dict()
    monkeypatch.setattr(layers, "truncated_normal", _scaled_copy)
    before = model.init_params(cfg, 7, device="cpu").state_dict()
    assert list(now) == list(before)
    for name in now:
        assert now[name].dtype == before[name].dtype
        assert torch.equal(now[name], before[name]), name
