"""The port's training slice against the JAX reference, on the CPU: the
loss and its gradients, AdamW steps (with and without gradient
accumulation) from a carried-across optimizer state, rematerialisation,
the kernels' autograd Functions, the decay mask, the schedules, the
chunked cross-entropy and the checkpointed optimizer state.

Both packages get the same weights (``convert.lm_params_from_numpy``) and
the same batches (the reference's ``PackedLMDataset``) at the smoke
configs of ``llama3-8b`` and ``zamba2-1.2b``, in float32.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs import shapes as rshapes  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.dist.sharding import _path_str  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models.config import LOCAL as RLOCAL  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import schedules as rsched  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry, shapes  # noqa: E402
from repro_torch.kernels import autograd  # noqa: E402
from repro_torch.kernels.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.ref import MaskSpec, full_mha_reference  # noqa: E402
from repro_torch.kernels.ssd import ssd_intra_reference  # noqa: E402
from repro_torch.models import model, transformer  # noqa: E402
from repro_torch.models.config import LOCAL, ShardCfg  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ARCHS = ("zamba2-1.2b", "llama3-8b")
LAYERS = {"zamba2-1.2b": 4, "llama3-8b": 2}
SEQ, BATCH = 64, 2
# float32 smoke models: the packages differ in summation order only
LOSS_RTOL = 1e-5          # the loss, grad_norm, lr and clip_scale
GRAD_TOL = 1e-4           # per leaf: max|port - ref| <= GRAD_TOL * max|ref|
# after 3 AdamW steps, per leaf: |port - ref|_2 <= STATE_RTOL * |ref|_2.
# Adam divides each gradient by its own running magnitude, so an element
# whose gradient is near zero amplifies the packages' summation-order
# noise; a norm over the leaf bounds what that does to the whole leaf.
STATE_RTOL = 1e-3


@pytest.fixture(scope="module")
def pairs():
    """Per arch: reference config, port config, reference params (jax).
    zamba2 keeps 4 Mamba layers, so its shared attention block is applied
    twice and its gradient sums two applications."""
    out = {}
    for arch in ARCHS:
        layers = LAYERS[arch]
        rcfg = rreg.smoke(rreg.get_config(arch), layers=layers)
        cfg = registry.smoke(registry.get_config(arch), layers=layers)
        init = jax.jit(functools.partial(rmodel.init_params, rcfg))
        out[arch] = (rcfg, cfg, init(jax.random.PRNGKey(0)))
    return out


def _port_model(cfg, rp):
    return convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp),
                                        device="cpu")


def _batch(step, global_batch=BATCH):
    """Documents of ~32 tokens, so a sequence holds boundaries (masked
    targets)."""
    ds = rpipe.PackedLMDataset(rpipe.DataConfig(
        seed=0, vocab_size=512, seq_len=SEQ, global_batch=global_batch,
        doc_len_mean=32))
    return ds.batch(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_grads(lm, cfg, batch, template=None):
    lm.requires_grad_(True)
    for p in lm.parameters():
        p.grad = None
    loss, met = model.loss_fn(lm, cfg, _torch_batch(batch), template=template)
    loss.backward()
    return loss, met, {n: p.grad.clone() for n, p in lm.named_parameters()}


def grad_problems(got: dict, want: dict, *, rel: float, cos: float) -> list:
    """What the gradient-parity check finds wrong, leaf by leaf: a relative
    norm error above ``rel``, a cosine below ``cos``, or a leaf that is zero
    where ``want``'s is not (``chip_smoke.py``'s train-phase check)."""
    out = []
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        wn, gn = float(w.norm()), float(g.norm())
        if wn > 0 and gn == 0:
            out.append(f"{name}: zero gradient")
            continue
        if wn == 0:
            continue
        if float((g - w).norm()) / wn > rel:
            out.append(f"{name}: relative error {float((g - w).norm()) / wn}")
        if float((g * w).sum()) / (gn * wn) < cos:
            out.append(f"{name}: cosine {float((g * w).sum()) / (gn * wn)}")
    return out


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(pairs, arch):
    rcfg, cfg, rp = pairs[arch]
    batch = _batch(0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss_fn(p, rcfg, b, RLOCAL), has_aux=True))
    (rloss, rmet), rgrads = vg(rp, jax.tree.map(jnp.asarray, batch))
    assert (batch["targets"] < 0).any()      # document boundaries masked
    assert transformer.n_attn_layers(cfg) == (2 if arch == "zamba2-1.2b"
                                              else 0)
    lm = _port_model(cfg, rp)
    loss, met, _ = _port_grads(lm, cfg, batch)
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=LOSS_RTOL)
    for k in ("ce", "acc", "moe_aux", "moe_z", "moe_dropped"):
        np.testing.assert_allclose(float(met[k].detach()), float(rmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    got = convert.grads_to_numpy(lm)
    want = jax.tree.map(np.asarray, rgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert g.shape == w.shape, _path_str(path)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (_path_str(path), err)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_gives_the_gradients_of_none_bitwise(pairs, arch, remat):
    """Rematerialisation recomputes the same operations on the same inputs
    in the backward, and the graph is the same, so the gradients are those
    of ``remat="none"`` bit for bit."""
    rcfg, cfg, rp = pairs[arch]
    batch = _batch(0)
    outs = {}
    for policy in ("none", remat):
        c = dataclasses.replace(cfg, remat=policy)
        outs[policy] = _port_grads(_port_model(c, rp), c, batch)
    assert torch.equal(outs["none"][0], outs[remat][0])
    for name, g in outs["none"][2].items():
        assert torch.equal(g, outs[remat][2][name]), name


def test_unknown_remat_policy_and_mode_raise(pairs):
    _, cfg, rp = pairs["llama3-8b"]
    c = dataclasses.replace(cfg, remat="everything")
    with pytest.raises(ValueError, match="remat policy"):
        model.loss_fn(_port_model(c, rp), c, _torch_batch(_batch(0)))
    lm = _port_model(cfg, rp)
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(ValueError, match="mode"):
        transformer.stack_seq(lm.stack, cfg, x, LOCAL,
                              positions=torch.arange(4), mask=MaskSpec(),
                              mode="decode")


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------
_FlashFn = autograd.FlashAttentionFn     # the Function the checks may swap


class _ZeroDq(_FlashFn):
    """The planted fault: a backward that drops q's gradient."""

    @staticmethod
    def backward(ctx, grad_out):
        dq, *rest = _FlashFn.backward(ctx, grad_out)
        return (torch.zeros_like(dq), *rest)


def _no_grad(fn):
    def stand_in(*args):
        with torch.no_grad():
            return fn(*args)

    return stand_in


def _attn_case(seed=3):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    q, k, v = t(2, 24, 4, 16), t(2, 24, 2, 16), t(2, 24, 2, 16)
    return [x.requires_grad_(True) for x in (q, k, v)], t(2, 24, 4, 16)


def _chunked(q, k, v, spec, valid, scale):
    return chunked_attention(q, k, v, spec, q_chunk=8, kv_chunk=16,
                             kv_valid_len=valid, scale=scale)


@pytest.mark.parametrize("plain", ["full_mha_reference", "chunked"])
@pytest.mark.parametrize("spec,valid", [(MaskSpec(), None),
                                        (MaskSpec(prefix_len=5), 20)])
def test_flash_attention_fn_gives_the_plain_gradient(plain, spec, valid):
    """With a forward autograd cannot see through (the plain version under
    ``no_grad``, as opaque as a kernel launch), the Function's gradients
    are the plain version's own, bit for bit, and the planted zero-dq
    backward is caught by the gradient check."""
    fn = full_mha_reference if plain == "full_mha_reference" else _chunked
    (q, k, v), w = _attn_case()
    stand_in = _no_grad(fn)
    assert stand_in(q, k, v, spec, valid, None).grad_fn is None   # the trap
    out = autograd.flash_attention(q, k, v, spec, valid, None, plain=fn,
                                   forward=stand_in)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((fn(q, k, v, spec, valid, None) * w).sum(),
                               (q, k, v))
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    bad = _ZeroDq.apply(q, k, v, spec, valid, None, fn, stand_in)
    faulty = torch.autograd.grad((bad * w).sum(), (q, k, v))
    names = ("q", "k", "v")
    assert grad_problems(dict(zip(names, got)), dict(zip(names, want)),
                         rel=1e-6, cos=0.999) == []
    assert grad_problems(dict(zip(names, faulty)), dict(zip(names, want)),
                         rel=1e-6, cos=0.999) == ["q: zero gradient"]


def test_ssd_intra_fn_gives_the_plain_gradient():
    rng = np.random.RandomState(4)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    bsz, nc, l, g, r, p, n = 1, 3, 16, 1, 4, 8, 6
    args = [t(bsz, nc, l, g, r, p),
            -torch.nn.functional.softplus(t(bsz, nc, l, g, r)),
            torch.nn.functional.softplus(t(bsz, nc, l, g, r)),
            t(bsz, nc, l, g, n), t(bsz, nc, l, g, n),
            0.3 * t(bsz, nc, g, r, n, p)]
    args = [a.requires_grad_(True) for a in args]
    w = t(bsz, nc, l, g, r, p)
    out = autograd.ssd_intra(*args, forward=_no_grad(ssd_intra_reference))
    got = torch.autograd.grad((out * w).sum(), args)
    want = torch.autograd.grad((ssd_intra_reference(*args) * w).sum(), args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # an input that needs no gradient gets none
    args[5] = args[5].detach()
    out = autograd.ssd_intra(*args, forward=_no_grad(ssd_intra_reference))
    assert len(torch.autograd.grad((out * w).sum(), args[:5])) == 5


def test_plain_ssd_gradient_stays_finite_where_a_masked_decay_overflows():
    """Decays of -6 a step over a 32-step chunk: above the diagonal
    cum_i - cum_j reaches 186, where exp overflows.  The plain SSD masks
    before the exponential: its output is the exp-first formulation's (the
    reference's jnp body) bit for bit and matches the reference's, and its
    gradient, the backward of ``SSDIntraFn``, stays finite."""
    from repro.kernels.ssd import ssd_intra_reference as ref_ssd

    rng = np.random.RandomState(6)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    bsz, nc, l, g, r, p, n = 1, 2, 32, 1, 3, 4, 5
    args = [t(bsz, nc, l, g, r, p), torch.full((bsz, nc, l, g, r), -6.0),
            torch.nn.functional.softplus(t(bsz, nc, l, g, r)),
            t(bsz, nc, l, g, n), t(bsz, nc, l, g, n),
            0.3 * t(bsz, nc, g, r, n, p)]
    x, log_decay, in_scale, b_, c_, s_in = args
    cum = torch.cumsum(log_decay, dim=2)
    diff = cum[:, :, :, None] - cum[:, :, None]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool))
    assert float(diff.max()) > 88.0
    lmat = torch.where(mask[None, None, :, :, None, None], torch.exp(diff),
                       0.0)
    attw = (torch.einsum("bclgn,bcmgn->bclmg", c_, b_)[..., None] * lmat
            * in_scale[:, :, None])
    exp_first = (torch.einsum("bclmgr,bcmgrp->bclgrp", attw, x)
                 + torch.einsum("bclgn,bcgrnp->bclgrp", c_, s_in)
                 * torch.exp(cum)[..., None])
    out = ssd_intra_reference(*args)
    assert torch.equal(out, exp_first)
    want = np.asarray(ref_ssd(*(jnp.asarray(a.numpy()) for a in args)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    args = [a.requires_grad_(True) for a in args]
    y = autograd.ssd_intra(*args, forward=_no_grad(ssd_intra_reference))
    grads = torch.autograd.grad(y.sum(), args)
    assert all(bool(torch.isfinite(gr).all()) for gr in grads)


class _Counting(_FlashFn):
    calls = 0

    @staticmethod
    def forward(ctx, *args):
        _Counting.calls += 1
        return _FlashFn.forward(ctx, *args)


class _CountingSSD(autograd.SSDIntraFn):
    calls = 0

    @staticmethod
    def forward(ctx, *args):
        _CountingSSD.calls += 1
        return _SSDFn.forward(ctx, *args)


_SSDFn = autograd.SSDIntraFn


@pytest.mark.parametrize("arch,remat", [("zamba2-1.2b", "none"),
                                        ("llama3-8b", "none"),
                                        ("zamba2-1.2b", "dots")])
def test_cuda_template_trains_through_the_functions(pairs, arch, remat,
                                                    monkeypatch):
    """On the CPU the ``CUDA`` template's wrappers run their plain versions
    inside the Functions' forwards, where autograd records nothing: so a
    ``CUDA`` loss on the CPU takes every gradient from the Functions'
    backwards.  They equal the ``TORCH`` template's (forward by
    ``full_mha_reference`` against the chunked online softmax: a
    summation-order difference), every attention and SSD region goes
    through a Function (twice under ``dots``, whose recompute reruns the
    forward), and the planted zero-dq fault is caught."""
    rcfg, cfg, rp = pairs[arch]
    cfg = dataclasses.replace(cfg, remat=remat)
    batch = _batch(1)
    _, _, want = _port_grads(_port_model(cfg, rp), cfg, batch, "TORCH")
    monkeypatch.setattr(autograd, "FlashAttentionFn", _Counting)
    monkeypatch.setattr(autograd, "SSDIntraFn", _CountingSSD)
    _Counting.calls = _CountingSSD.calls = 0
    _, _, got = _port_grads(_port_model(cfg, rp), cfg, batch, "CUDA")
    runs = 1 if remat == "none" else 2
    assert _Counting.calls == runs * cfg.num_layers // (cfg.attn_every or 1)
    assert _CountingSSD.calls == runs * (cfg.num_layers
                                         if cfg.family == "hybrid" else 0)
    assert grad_problems(got, want, rel=1e-5, cos=0.9999) == []
    monkeypatch.setattr(autograd, "FlashAttentionFn", _ZeroDq)
    _, _, faulty = _port_grads(_port_model(cfg, rp), cfg, batch, "CUDA")
    found = grad_problems(faulty, want, rel=1e-5, cos=0.9999)
    assert any(".attn.wq: zero gradient" in f for f in found), found


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------
def _leaf_rel(got: dict, want) -> float:
    worst = 0.0
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float64)
        worst = max(worst, float(np.linalg.norm(g - w))
                    / max(float(np.linalg.norm(w)), 1e-30))
    return worst


@pytest.mark.parametrize("arch,grad_accum", [("zamba2-1.2b", 1),
                                             ("llama3-8b", 1),
                                             ("llama3-8b", 2)])
def test_train_steps_match_the_reference(pairs, arch, grad_accum):
    """One reference step makes a non-trivial AdamW state; both packages
    carry it (``adamw_state_from_numpy``) through three more steps."""
    rcfg, cfg, rp = pairs[arch]
    sched = (3e-3, 2, 10)
    ropt = radamw.AdamW(lr=rsched.warmup_cosine(*sched))
    rts = jax.jit(rstep.make_train_step(rcfg, RLOCAL, ropt, grad_accum))
    rp, rst, _ = rts(rp, ropt.init(rp), jax.tree.map(jnp.asarray, _batch(0)))
    lm = _port_model(cfg, rp)
    st = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, rst), "cpu")
    opt = AdamW(lr=schedules.warmup_cosine(*sched))
    ts = step_lib.make_train_step(cfg, LOCAL, opt, grad_accum)
    for step in (1, 2, 3):
        b = _batch(step)
        rp, rst, rmet = rts(rp, rst, jax.tree.map(jnp.asarray, b))
        lm, st, met = ts(lm, st, _torch_batch(b))
        for k in ("loss", "ce", "grad_norm", "lr", "clip_scale"):
            np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    assert int(st.step) == int(rst.step) == 4
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
    if cfg.family == "hybrid":   # the reference's quirk, kept on purpose
        assert want["stack/layers/mamba/conv_b"] is True
        assert want["stack/layers/mamba/dt_bias"] is False
    assert AdamW(weight_decay=0.0).decays("embed.table") is False


def test_schedules_match_the_reference():
    steps = np.arange(0, 26, dtype=np.int32)
    for args in ((3e-3, 5, 20), (1e-2, 0, 10), (3e-3, 21, 20, 0.2)):
        want = np.array([float(rsched.warmup_cosine(*args)(jnp.int32(s)))
                         for s in steps])
        got = schedules.warmup_cosine(*args)(torch.from_numpy(steps))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
        for s in (0, 7):      # a plain int step
            np.testing.assert_allclose(
                float(schedules.warmup_cosine(*args)(s)),
                float(rsched.warmup_cosine(*args)(s)), rtol=1e-6)
    assert float(schedules.constant(5e-4)(torch.tensor(3))) == \
        float(rsched.constant(5e-4)(jnp.int32(3)))


def test_adamw_bf16_moments_and_clip_match_the_reference():
    rng = np.random.RandomState(7)
    w0 = rng.randn(6, 5).astype(np.float32)
    s0 = (1 + 0.1 * rng.randn(5)).astype(np.float32)
    grads = [(3 * rng.randn(6, 5).astype(np.float32),
              rng.randn(5).astype(np.float32)) for _ in range(3)]
    kw = dict(lr=1e-2, clip_norm=0.5)
    ropt = radamw.AdamW(m_dtype=jnp.bfloat16, v_dtype=jnp.bfloat16, **kw)
    rparams = {"norm": {"scale": jnp.asarray(s0)}, "w": jnp.asarray(w0)}
    rst = ropt.init(rparams)

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
            self.norm = torch.nn.Module()
            self.norm.scale = torch.nn.Parameter(torch.from_numpy(s0.copy()))

    tiny = Tiny()
    opt = AdamW(m_dtype=torch.bfloat16, v_dtype=torch.bfloat16, **kw)
    st = opt.init(tiny)
    for gw, gs in grads:
        rparams, rst, rstats = ropt.update(
            {"norm": {"scale": jnp.asarray(gs)}, "w": jnp.asarray(gw)},
            rst, rparams)
        tiny, st, stats = opt.update(
            {"w": torch.from_numpy(gw), "norm.scale": torch.from_numpy(gs)},
            st, tiny)
        assert float(stats["clip_scale"]) < 1.0
        for k in ("grad_norm", "clip_scale", "lr"):
            np.testing.assert_allclose(float(stats[k]), float(rstats[k]),
                                       rtol=1e-6)
    assert all(t.dtype == torch.bfloat16 for t in (*st.m.values(),
                                                   *st.v.values()))
    # moments: one bf16 rounding of float32 values that may differ in
    # their last float32 bits, so at most one bf16 ulp (2^-8 relative)
    for got, want in ((st.m["w"], rst.m["w"]), (st.v["w"], rst.v["w"]),
                      (st.m["norm.scale"], rst.m["norm"]["scale"])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=2 ** -8)
    np.testing.assert_allclose(tiny.w.detach().numpy(),
                               np.asarray(rparams["w"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tiny.norm.scale.detach().numpy(),
                               np.asarray(rparams["norm"]["scale"]),
                               rtol=1e-5)


def test_chunked_xent_matches_a_dense_cross_entropy(pairs):
    """Chunks of 16 over 40 positions (the last one padded), negative
    targets masked: the loss, the accuracy and the gradient of the hidden
    states equal a dense cross-entropy over the full logits."""
    _, cfg, rp = pairs["llama3-8b"]
    lm = _port_model(cfg, rp)
    rng = np.random.RandomState(5)
    hidden = torch.from_numpy(rng.randn(2, 40, cfg.d_model).astype(np.float32))
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 40)))
    tgt[0, :3] = -1
    tgt[1, 17] = -1
    h1 = hidden.clone().requires_grad_(True)
    loss, acc = model.chunked_xent(lm, cfg, h1, tgt, chunk=16)
    (g1,) = torch.autograd.grad(loss, h1)
    h2 = hidden.clone().requires_grad_(True)
    logits = h2 @ lm.unembed.w
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), tgt.reshape(-1), ignore_index=-1)
    (g2,) = torch.autograd.grad(want, h2)
    valid = tgt >= 0
    want_acc = ((logits.argmax(-1) == tgt) & valid).sum() / valid.sum()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert float(acc) == float(want_acc)
    torch.testing.assert_close(g1, g2, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_match_the_reference(pairs, arch):
    """``make_prefill_step`` then two greedy ``make_serve_step`` calls: the
    same next tokens as the reference's, logits at 2e-5 of their scale
    (the model functions behind them are held per arch and per slot in
    ``tests/test_torch_lm.py``)."""
    from repro_torch.models.config import LOCAL as PORT_LOCAL

    rcfg, cfg, rp = pairs[arch]
    toks = _batch(0)["tokens"][:, :24]
    rcaches = rmodel.init_caches(rcfg, BATCH, 32, jnp.float32)
    rl, rcaches = jax.jit(rstep.make_prefill_step(rcfg, RLOCAL))(
        rp, {"tokens": jnp.asarray(toks)}, rcaches)
    lm = _port_model(cfg, rp)
    caches = model.init_caches(cfg, BATCH, 32, torch.float32, "cpu")
    with torch.no_grad():
        pl, caches = step_lib.make_prefill_step(cfg, PORT_LOCAL)(
            lm, {"tokens": torch.from_numpy(toks)}, caches)
    rserve = jax.jit(rstep.make_serve_step(rcfg, RLOCAL))
    serve = step_lib.make_serve_step(cfg, PORT_LOCAL)
    scale = max(1.0, float(np.abs(np.asarray(rl)).max()))
    assert float(np.abs(pl.numpy() - np.asarray(rl)).max()) <= 2e-5 * scale
    rtok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    tok = torch.from_numpy(np.array(rtok))
    for t in (24, 25):
        rtok, rlog, rcaches = rserve(rp, rtok, rcaches, jnp.int32(t))
        with torch.no_grad():
            tok, log, caches = serve(lm, tok, caches, t)
        assert tok.dtype == torch.int32 and tok.shape == (BATCH, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        scale = max(1.0, float(np.abs(np.asarray(rlog)).max()))
        assert float(np.abs(log.numpy() - np.asarray(rlog)).max()) <= \
            2e-5 * scale


# ---------------------------------------------------------------------------
# state across packages and through checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_adamw_state_round_trip_through_numpy(pairs, arch):
    rcfg, cfg, rp = pairs[arch]
    rp = jax.tree.map(np.asarray, rp)
    rst = radamw.AdamW().init(rp)
    rst = rst._replace(step=np.int32(7),
                       m=jax.tree.map(lambda x: x + 1.5, rp),
                       v=jax.tree.map(lambda x: x * x, rp))
    st = convert.adamw_state_from_numpy(rst, "cpu")
    assert isinstance(st, AdamWState) and st.step.dtype == torch.int32
    assert set(st.m) == {n for n, _ in _port_model(cfg, rp).named_parameters()}
    back = convert.adamw_state_to_numpy(st)
    assert int(back.step) == 7
    for a, b in ((back.m, rst.m), (back.v, rst.v),
                 (convert.lm_params_to_numpy(_port_model(cfg, rp)), rp)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_checkpointer_round_trips_an_adamw_state_bitwise(tmp_path):
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    params = {"w": t(3, 4), "norm.scale": t(4).to(torch.bfloat16)}
    tree = {"params": params,
            "opt": AdamWState(step=torch.tensor(12, dtype=torch.int32),
                              m={k: t(*v.shape) for k, v in params.items()},
                              v={k: t(*v.shape).to(torch.bfloat16)
                                 for k, v in params.items()})}
    ck = Checkpointer(str(tmp_path))
    ck.save(12, tree)
    target = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
              "opt": AdamWState(step=torch.zeros((), dtype=torch.int32),
                                m={k: torch.zeros_like(v) for k, v in
                                   tree["opt"].m.items()},
                                v={k: torch.zeros_like(v) for k, v in
                                   tree["opt"].v.items()})}
    got = ck.restore(12, target)
    assert isinstance(got["opt"], AdamWState)
    want_leaves = jax.tree.leaves(tree)
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(want_leaves) == 7
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# accounting, shapes and what is not ported
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_shapes_match_the_reference(arch):
    rcfg, cfg = rreg.get_config(arch), registry.get_config(arch)
    assert cfg.active_param_count() == rcfg.active_param_count()
    for training in (True, False):
        assert model.model_flops_per_step(cfg, 8, 4096, training) == \
            rmodel.model_flops_per_step(rcfg, 8, 4096, training)
    assert model.LOSS_CHUNK == rmodel.LOSS_CHUNK
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rshapes.SHAPES.items()}
    for shape in shapes.SHAPES.values():
        assert shapes.applicable(cfg, shape) == \
            rshapes.applicable(rcfg, rshapes.SHAPES[shape.name])


def test_what_is_not_ported_raises(pairs):
    """The mesh postures raise (item 9); the modality inputs, once item 11,
    now run: ``embeds`` that are the tokens' own embeddings give the
    tokens' loss bitwise, and an ``audio`` config counts the FLOPs of its
    dense stack."""
    _, cfg, rp = pairs["llama3-8b"]

    class Meshed:
        mesh = object()

    with pytest.raises(NotImplementedError, match="item 9"):
        step_lib.make_train_step(cfg, Meshed(), AdamW())
    with pytest.raises(NotImplementedError, match="item 9"):
        ShardCfg(mesh=object())
    lm = _port_model(cfg, rp)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(1, 12)))
    targets = torch.roll(toks, -1, dims=1)
    with torch.no_grad():
        embeds = lm.embed.table[toks]
        want, _ = model.loss_fn(lm, cfg, {"tokens": toks, "targets": targets})
        got, _ = model.loss_fn(lm, cfg, {"embeds": embeds,
                                         "targets": targets})
    assert torch.equal(got, want)
    assert model.model_flops_per_step(
        dataclasses.replace(cfg, family="audio"), 1, 64) == \
        model.model_flops_per_step(cfg, 1, 64)
