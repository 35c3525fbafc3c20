"""The port's xLSTM blocks (the ``ssm`` family, xlstm-125m) against the JAX
reference, on the CPU.

Seeded numpy inputs and states go through ``repro.models.xlstm``'s
``mlstm_seq``, ``mlstm_step``, ``slstm_seq`` and ``slstm_step`` and through
the port's, at the smoke width (d_model 64, 2 heads, chunk 16), in float32
and with bf16 weights and compute; the mLSTM's SSD core with the heads as
its groups, and the plain SSD_INTRA at the published mLSTM shape (G 4,
R 1, N 384, P 385) against the reference's oracle.  The serving engine's
slot reuse and the cache conversions for the family are here too; the
rest of the family's serving tests are ``tests/test_torch_lm.py``'s,
parametrised over its ``ARCHS``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.kernels import ssd as rssd  # noqa: E402
from repro.models import mamba2 as rmamba  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import xlstm as rx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ssd, ssd_cuda  # noqa: E402
from repro_torch.models import mamba2, model, xlstm  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

ARCH = "xlstm-125m"
# float32: the packages differ in summation order only (the chunked SSD's
# cumulative sums, the recurrent einsums); 1e-5 of the output's scale
TOL = {"float32": 1e-5,
       # bf16 weights and compute: each package rounds its bf16 matmul
       # outputs to the nearest bf16 after float32 sums taken in another
       # order, so an element may land one bf16 ulp (2^-8 relative) apart
       # and pass that on through the block; 2e-2 of the output's scale
       "bfloat16": 2e-2}
# the cells' states are float32 in both packages whatever the compute dtype,
# made from q, k, v and gates that agree bitwise (bf16 matmul outputs) or to
# float32 rounding: held at the float32 tolerance, which is what catches a
# conv tail rounded the other way (prefill casts it to the compute dtype,
# the step keeps it in float32: ~1e-4 of the state's scale at bf16)
STATE_TOL = TOL["float32"]
# float32 gradients, per leaf: max|port - ref| <= GRAD_TOL * max|ref| (the
# training tests' tolerance, tests/test_torch_train.py)
GRAD_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32"):
    rcfg = rreg.smoke(rreg.get_config(ARCH))
    cfg = registry.smoke(registry.get_config(ARCH))
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(rcfg, param_dtype=jdt, compute_dtype=jdt),
            dataclasses.replace(cfg, param_dtype=tdt, compute_dtype=tdt))


def _block_pair(kind, dtype="float32", seed=0):
    """The reference's block parameters and the port's block holding them
    bitwise."""
    rcfg, cfg = _cfgs(dtype)
    init = rx.init_mlstm if kind == "mlstm" else rx.init_slstm
    rp = init(jax.random.PRNGKey(seed), rcfg)
    block = (xlstm.MLSTMBlock if kind == "mlstm" else xlstm.SLSTMBlock)(
        None, cfg, "meta")
    block.load_state_dict(
        {".".join(k): convert._tensor(np.asarray(v)) for k, v in
         convert._flatten(jax.tree.map(np.asarray, rp))},
        strict=True, assign=True)
    return rcfg, cfg, rp, block


def _x(shape, seed, dtype):
    """A seeded float32 array and the same values in ``dtype`` for both
    packages (bf16: each rounds the float32 to nearest even, the same
    bits)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)
    return err / scale


def _mlstm_state(cfg, seed):
    """A seeded float32 state (no value of it bf16-representable by
    chance) for both packages."""
    h, di, p = xlstm._dims(cfg)
    rs = np.random.RandomState(seed)
    c = rs.randn(2, h, p, p + 1).astype(np.float32)
    conv = rs.randn(2, cfg.conv_width - 1, di).astype(np.float32)
    n = c[..., p].copy()
    ref = rx.MLSTMState(*map(jnp.asarray, (c, n, conv)))
    return ref, xlstm.MLSTMState(*map(torch.from_numpy, (c, n, conv)))


def _slstm_state(cfg, seed):
    h = cfg.num_heads
    p = cfg.d_model // h
    rs = np.random.RandomState(seed)
    c, n, m, hh = (rs.randn(2, h, p).astype(np.float32) for _ in range(4))
    n = np.abs(n) + 1.0
    ref = rx.SLSTMState(*map(jnp.asarray, (c, n, m, hh)))
    return ref, xlstm.SLSTMState(*map(torch.from_numpy, (c, n, m, hh)))


def _states_close(got, want, tol, what):
    for field, a, b in zip(want._fields, got, want):
        _close(a, b, tol, f"{what} {field}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_seq_matches_reference(dtype, with_state):
    """37 tokens through the chunked SSD (chunks of 16, the last padded),
    from no state or a float32 one (prefill casts its conv tail to the
    compute dtype)."""
    rcfg, cfg, rp, block = _block_pair("mlstm", dtype)
    jx, tx = _x((2, 37, cfg.d_model), 1, dtype)
    rstate, pstate = _mlstm_state(cfg, 2) if with_state else (None, None)
    ry, rst = rx.mlstm_seq(rp, rcfg, jx, state=rstate, return_state=True)
    py, pst = xlstm.mlstm_seq(block, cfg, tx, state=pstate, return_state=True)
    assert py.dtype == DTYPES[dtype][1]
    _close(py, ry, TOL[dtype], "out")
    _states_close(pst, rst, STATE_TOL, "state")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_step_matches_reference(dtype):
    """Three decode steps from a float32 state (the step keeps its conv
    tail in float32 and divides k by sqrt(p))."""
    rcfg, cfg, rp, block = _block_pair("mlstm", dtype)
    rst, pst = _mlstm_state(cfg, 3)
    for t in range(3):
        jx, tx = _x((2, cfg.d_model), 10 + t, dtype)
        ry, rst = rx.mlstm_step(rp, rcfg, jx, rst)
        py, pst = xlstm.mlstm_step(block, cfg, tx, pst)
        _close(py, ry, TOL[dtype], f"step {t}")
        _states_close(pst, rst, STATE_TOL, f"step {t}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_seq_matches_reference(dtype, with_state):
    rcfg, cfg, rp, block = _block_pair("slstm", dtype)
    jx, tx = _x((2, 21, cfg.d_model), 4, dtype)
    rstate, pstate = _slstm_state(cfg, 5) if with_state else (None, None)
    ry, rst = rx.slstm_seq(rp, rcfg, jx, state=rstate, return_state=True)
    py, pst = xlstm.slstm_seq(block, cfg, tx, state=pstate, return_state=True)
    _close(py, ry, TOL[dtype], "out")
    _states_close(pst, rst, STATE_TOL, "state")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slstm_step_matches_reference(dtype):
    rcfg, cfg, rp, block = _block_pair("slstm", dtype)
    rst, pst = _slstm_state(cfg, 6)
    for t in range(3):
        jx, tx = _x((2, cfg.d_model), 20 + t, dtype)
        ry, rst = rx.slstm_step(rp, rcfg, jx, rst)
        py, pst = xlstm.slstm_step(block, cfg, tx, pst)
        _close(py, ry, TOL[dtype], f"step {t}")
        _states_close(pst, rst, STATE_TOL, f"step {t}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_then_steps_equal_one_longer_seq(kind):
    """A 29-token prefill and then 4 steps give the outputs and the state
    of one 33-token sequence, in the port and against the reference's
    longer sequence (float32)."""
    rcfg, cfg, rp, block = _block_pair(kind)
    seq = xlstm.mlstm_seq if kind == "mlstm" else xlstm.slstm_seq
    step = xlstm.mlstm_step if kind == "mlstm" else xlstm.slstm_step
    rseq = rx.mlstm_seq if kind == "mlstm" else rx.slstm_seq
    jx, tx = _x((2, 33, cfg.d_model), 7, "float32")
    want, wst = rseq(rp, rcfg, jx, return_state=True)
    y, st = seq(block, cfg, tx[:, :29], return_state=True)
    outs = [y]
    for t in range(29, 33):
        yt, st = step(block, cfg, tx[:, t], st)
        outs.append(yt[:, None])
    _close(torch.cat(outs, dim=1), want, TOL["float32"], "outputs")
    _states_close(st, wst, TOL["float32"], "state")


def test_slstm_mlp_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's sLSTM
    MLP uses it, and the erf GeLU would differ by more than the float32
    tolerance."""
    rcfg, cfg, rp, block = _block_pair("slstm")
    jy, ty = _x((2, 5, cfg.d_model), 8, "float32")
    jx, tx = _x((2, 5, cfg.d_model), 9, "float32")
    want = rx._slstm_mlp(rp, rcfg, jy, jx)
    _close(xlstm._slstm_mlp(block, cfg, ty, tx), want, TOL["float32"], "tanh")
    gelu = F.gelu
    try:
        xlstm.F.gelu = lambda t, approximate="none": gelu(t)
        with pytest.raises(AssertionError):
            _close(xlstm._slstm_mlp(block, cfg, ty, tx), want, TOL["float32"])
    finally:
        xlstm.F.gelu = gelu
    t = torch.linspace(-3, 3, 13)
    assert not torch.equal(F.gelu(t, approximate="tanh"), F.gelu(t))


def test_slstm_max_state_starts_at_minus_1e30():
    """The sLSTM max-state starts at -1e30, as the reference's: a sequence
    from no state equals one from ``slstm_init_state``, and one from a
    zero max-state differs."""
    rcfg, cfg, rp, block = _block_pair("slstm")
    init = xlstm.slstm_init_state(cfg, 2)
    ref = rx.slstm_init_state(rcfg, 2)
    for a, b in zip(init, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(init.m, torch.full_like(init.m, -1e30))
    assert len({t.data_ptr() for t in init}) == 4     # no shared storage
    _, tx = _x((2, 6, cfg.d_model), 11, "float32")
    y0, _ = xlstm.slstm_seq(block, cfg, tx)
    y1, _ = xlstm.slstm_seq(block, cfg, tx, state=init)
    assert torch.equal(y0, y1)
    zero_m = init._replace(m=torch.zeros_like(init.m))
    y2, _ = xlstm.slstm_seq(block, cfg, tx, state=zero_m)
    assert not torch.allclose(y0, y2, rtol=0, atol=1e-3)


def _mlstm_kernel_inputs(seed, bsz, nc, l, g, n, p):
    """SSD_INTRA's inputs as an mLSTM layer makes them: v with the ones
    column, log_decay = log_sigmoid(3 + noise) (the forget bias), in_scale
    = exp(8 tanh(i / 8)) with i spread over the cap (up to e^8), k / sqrt
    of the head dim, and s_in the inter-chunk relay of the same inputs."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    x = f(bsz, nc, l, g, 1, p)
    x[..., -1] = 1.0
    ld = -np.logaddexp(0.0, -(3.0 + f(bsz, nc, l, g, 1))).astype(np.float32)
    i_logit = f(bsz, nc, l, g, 1) * 6.0 - 2.0
    dt = np.exp(8.0 * np.tanh(i_logit / 8.0)).astype(np.float32)
    b_ = (f(bsz, nc, l, g, n) / np.sqrt(p - 1)).astype(np.float32)
    c_ = f(bsz, nc, l, g, n)
    cum = np.cumsum(ld, axis=2)
    w = np.exp(cum[:, :, -1:] - cum) * dt                     # (B,nc,L,G,1)
    sc = np.einsum("bclgn,bclgr,bclgrp->bcgrnp", b_, w, x)
    s_in = np.zeros_like(sc)
    for c in range(1, nc):
        s_in[:, c] = (s_in[:, c - 1] * np.exp(cum[:, c - 1, -1])[..., None,
                                                                  None]
                      + sc[:, c - 1])
    return x, ld, dt, b_, c_, s_in.astype(np.float32)


# SSD_INTRA's card tolerance (chip_smoke.SSD_RTOL): 1e-4 of max|y|
SSD_RTOL = 1e-4


def test_plain_ssd_intra_at_the_mlstm_shape_matches_the_reference():
    """The plain SSD_INTRA at xlstm-125m's prefill shape (L 128, G 4 heads,
    R 1, N 384, P 385) against the reference's oracle, on mLSTM-like
    inputs; the CUDA wrapper's CPU route is the same function, and its
    checks take the shape (the kernel's limits are N, P <= 512)."""
    args = _mlstm_kernel_inputs(0, 1, 2, 128, 4, 384, 385)
    got = ssd.ssd_intra_reference(*map(torch.from_numpy, args))
    want = rssd.ssd_intra_reference(*map(jnp.asarray, args))
    _close(got, want, 1e-5, "plain")
    assert torch.equal(ssd_cuda.ssd_intra(*map(torch.from_numpy, args)), got)
    assert (ssd_cuda.MAX_N, ssd_cuda.MAX_P) == (512, 512)
    # the state term is of the output's scale: zeroing s_in moves y by far
    # more than the card's tolerance (the planted fault of chip_smoke.py)
    bad = list(map(torch.from_numpy, args))
    bad[5] = torch.zeros_like(bad[5])
    scale = float(got.abs().max())
    assert float((ssd.ssd_intra_reference(*bad) - got).abs().max()) > \
        100 * SSD_RTOL * scale


@pytest.mark.parametrize("init", [False, True])
def test_ssd_core_with_heads_as_groups_matches_reference(init):
    """The mLSTM's call of the chunked core: (G, R) = (H, 1), P = head dim
    + 1, 40 tokens in chunks of 16, from no state or a carried one."""
    bsz, s, h, n = 2, 40, 2, 64
    rs = np.random.RandomState(12)
    f = lambda *sh: rs.randn(*sh).astype(np.float32)
    x = f(bsz, s, h, 1, n + 1)
    x[..., -1] = 1.0
    ld = -np.logaddexp(0.0, -(3.0 + f(bsz, s, h, 1))).astype(np.float32)
    sc = np.exp(8.0 * np.tanh((f(bsz, s, h, 1) * 4 - 2) / 8)).astype(np.float32)
    b_, c_ = f(bsz, s, h, n) / 8.0, f(bsz, s, h, n)
    st = f(bsz, h, 1, n, n + 1) if init else None
    args = (x, ld, sc, b_, c_)
    ry, rfin = rmamba.ssd_core(*map(jnp.asarray, args), 16,
                               None if st is None else jnp.asarray(st))
    py, pfin = mamba2.ssd_core(*map(torch.from_numpy, args), 16,
                               None if st is None else torch.from_numpy(st))
    _close(py, ry, 2e-5, "y")
    _close(pfin, rfin, 2e-5, "final state")


def _engine_pair(seed=0):
    rcfg, cfg = rreg.smoke(rreg.get_config(ARCH)), \
        registry.smoke(registry.get_config(ARCH))
    rp = rmodel.init_params(rcfg, jax.random.PRNGKey(seed))
    lm = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp),
                                      device="cpu")
    return rcfg, cfg, rp, lm


def test_readmitting_into_a_used_slot_gives_a_fresh_engines_tokens():
    """A request served in a slot that an earlier request left holding its
    sLSTM and mLSTM states gives the tokens a fresh engine gives it: the
    slot is reset to a fresh cache's values (the sLSTM max-state -1e30),
    not to zeros."""
    _, cfg, _, lm = _engine_pair()
    rng = np.random.default_rng(3)
    first, second = (rng.integers(0, cfg.vocab_size, size=n) for n in (20, 9))
    used = engine.ServingEngine(cfg, lm, slots=1, max_seq=64, device="cpu")
    used.submit(engine.Request(0, first, max_new_tokens=5))
    used.submit(engine.Request(1, second, max_new_tokens=5))
    got = {r.rid: r.output for r in used.run_until_drained()}
    fresh = engine.ServingEngine(cfg, lm, slots=1, max_seq=64, device="cpu")
    fresh.submit(engine.Request(1, second, max_new_tokens=5))
    assert got[1] == fresh.run_until_drained()[0].output
    # the slot's sLSTM max-state was set back to -1e30 before the prefill
    one = model.init_caches(cfg, 1, 64, torch.float32, "cpu")
    used_one = engine._slot_view(used.caches, used._batch_axes, 0)
    model.reset_caches(cfg, used_one)
    for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(used_one)),
                    jax.tree.leaves(convert.caches_to_numpy(one))):
        assert np.array_equal(a, b)


def test_engine_finds_each_cache_leafs_slot_axis():
    """The slot axis of each cache leaf, as the reference's engine finds
    it: 0 for the ssm family's per-layer states, 1 under the stacked layer
    axis of the other families."""
    _, cfg, _, _ = _engine_pair()
    axes = engine._batch_axes(cfg, 3, 64)
    assert isinstance(axes, tuple) and len(axes) == cfg.num_layers
    assert all(set(st) == {0} for st in axes)
    kinds = [type(st).__name__ for st in axes]
    assert kinds == ["MLSTMState", "SLSTMState"]
    dense = registry.smoke(registry.get_config("llama3-8b"))
    assert set(engine._batch_axes(dense, 3, 64)) == {1}
    hybrid = engine._batch_axes(
        registry.smoke(registry.get_config("zamba2-1.2b")), 3, 64)
    assert {a for leaf in hybrid.values() for a in leaf} == {1}


def test_ssm_caches_and_params_round_trip_bitwise():
    """The reference's ssm caches (a tuple of MLSTMState / SLSTMState) and
    parameters (a tuple of per-layer dicts under stack/layers) go to the
    port and back bitwise, with the same tree structure."""
    rcfg, cfg, rp, lm = _engine_pair()
    rc = rmodel.init_caches(rcfg, 2, 32, jnp.float32)
    rs = np.random.RandomState(13)
    rc = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32), rc)
    pc = convert.caches_from_numpy(rc, "cpu")
    assert [type(s).__name__ for s in pc] == ["MLSTMState", "SLSTMState"]
    back = convert.caches_to_numpy(pc)
    shape = lambda tree: [(type(st).__name__, st._fields) for st in tree]
    assert isinstance(back, tuple) and shape(back) == shape(rc)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rc)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tree = jax.tree.map(np.asarray, rp)
    assert isinstance(tree["stack"]["layers"], tuple)
    again = convert.lm_params_to_numpy(lm)
    assert jax.tree.structure(again) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    assert convert.reference_path("stack.layers.1.rz", stacked=False) == \
        "stack/layers/1/rz"
    assert convert.reference_path("stack.layers.1.attn.wq") == \
        "stack/layers/attn/wq"


def _block_grads(kind, rp, block, jx, tx, state=None, rstate=None):
    """d sum(w * out) / d (x, every parameter) of one block call, ``w`` a
    seeded weight: ``jax.grad`` of the reference's function and
    ``torch.autograd.grad`` of the port's, as (port name -> (port, ref))
    numpy pairs.  ``kind``: mlstm_seq, mlstm_step or slstm_seq."""
    rcfg, cfg = _cfgs()
    rfn, pfn = getattr(rx, kind), getattr(xlstm, kind)
    run_r = ((lambda p, x: rfn(p, rcfg, x, rstate)[0]) if state is not None
             else (lambda p, x: rfn(p, rcfg, x)[0]))
    out_shape = jax.eval_shape(run_r, rp, jx).shape
    w = np.random.RandomState(9).randn(*out_shape).astype(np.float32)
    rg, rgx = jax.grad(lambda p, x: jnp.sum(run_r(p, x) * w),
                       argnums=(0, 1))(rp, jx)
    block.requires_grad_(True)
    tx = tx.clone().requires_grad_(True)
    out = (pfn(block, cfg, tx, state) if state is not None
           else pfn(block, cfg, tx))[0]
    names = [n for n, _ in block.named_parameters()]
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              [tx, *block.parameters()])
    want = {".".join(k): np.asarray(v) for k, v in
            convert._flatten(jax.tree.map(np.asarray, rg))}
    pairs = {"x": (got[0].numpy(), np.asarray(rgx))}
    pairs.update((n, (g.numpy(), want[n])) for n, g in zip(names, got[1:]))
    return pairs


# leaves whose gradient is zero in exact arithmetic, so float32 noise in
# both packages: the sLSTM's ``bi`` from a fresh state (a shift of every
# input-gate logit is absorbed by the stabilizer m), and on the tie inputs
# the mLSTM's conv (every token's output is one scale of its v rows, which
# the RMSNorm removes); held at GRAD_TOL of the block's largest gradient
ZERO_GRAD = {"slstm_seq": {"bi"}, "mlstm_seq": {"conv_w", "conv_b"},
             "mlstm_step": {"conv_w", "conv_b"}}


def _grad_errors(pairs, zero=()) -> dict:
    """Per leaf: max|port - ref| over max|ref|, or over the largest leaf's
    for the leaves in ``zero`` and those whose reference gradient is 0."""
    top = max(float(np.abs(w).max()) for _, w in pairs.values())
    own = lambda n, w: (top if n in zero else float(np.abs(w).max())) or top
    return {n: float(np.abs(g - w).max()) / own(n, w)
            for n, (g, w) in pairs.items()}


def _normalizer_tie(rp):
    """The mLSTM block's parameters set so that each head's normalizer
    |n·q| is 1.0 exactly at the first token and t + 1 after it: the conv
    gives silu(64) = 64 in every channel, q and k are 8 and 1 in one
    component of each head (0 elsewhere), k·q / sqrt(64) = 1, the input
    gate exp(8 tanh(0)) = 1 and the forget gate exp(log_sigmoid(100)) = 1
    — every value exact in float32 in both packages."""
    rcfg, cfg = _cfgs()
    h, di, hd = xlstm._dims(cfg)
    assert hd == 64
    rp = jax.tree.map(np.array, rp)
    rp["conv_w"][:] = 0.0
    rp["conv_b"][:] = 64.0
    for name, val in (("wq", 2.0 ** -3), ("wk", 2.0 ** -6)):
        rp[name]["w"][:] = 0.0
        rp[name]["w"][0, ::hd] = val
    rp["wi"]["w"][:] = 0.0
    rp["wf"]["w"][:] = 0.0
    rp["bi"][:] = 0.0
    rp["bf"][:] = 100.0
    block = xlstm.MLSTMBlock(None, cfg, "meta")
    block.load_state_dict(
        {".".join(k): convert._tensor(v) for k, v in convert._flatten(rp)},
        strict=True, assign=True)
    return jax.tree.map(jnp.asarray, rp), block


@pytest.mark.parametrize("kind", ["mlstm_seq", "mlstm_step", "slstm_seq"])
def test_gradients_at_the_normalizer_tie_match_the_reference(kind):
    """Where the normalizer the output divides by meets its floor of 1.0
    exactly, ``jnp.maximum``'s gradient goes half to each side: the mLSTM's
    |n·q| on inputs built to reach 1.0 (``_normalizer_tie``: the first
    token of a 20-token sequence over two chunks, and one decode step from
    a zero state), where a floor that passes the whole gradient
    (``torch.clamp``) is off by the whole of wk's gradient; and the sLSTM's
    n at the first step from a fresh state (exp(i - m) = exp(0)), a
    constant, where either floor gives the reference's gradient.  The
    port's gradient of x and of every parameter matches ``jax.grad`` of the
    reference's block (float32, GRAD_TOL of each leaf's scale, as
    ``tests/test_torch_train.py``)."""
    rcfg, cfg, rp, block = _block_pair(kind[:5])
    state = rstate = None
    if kind == "mlstm_step":
        rp, block = _normalizer_tie(rp)
        jx, tx = _x((2, cfg.d_model), 11, "float32")
        rstate = rx.mlstm_init_state(rcfg, 2)
        state = xlstm.mlstm_init_state(cfg, 2)
    else:
        if kind == "mlstm_seq":
            rp, block = _normalizer_tie(rp)
        jx, tx = _x((2, 20, cfg.d_model), 12, "float32")
    errs = _grad_errors(_block_grads(kind, rp, block, jx, tx, state, rstate),
                        ZERO_GRAD[kind])
    assert max(errs.values()) <= GRAD_TOL, sorted(errs.items(),
                                                  key=lambda e: -e[1])[:4]


def test_flops_and_parameter_counts_match_the_reference():
    """xlstm-125m at published widths: parameters (12 mixed layers, d_ff
    0, tied embeddings), active parameters, the forward FLOPs of a step
    and of one mLSTM block."""
    rcfg, cfg = rreg.get_config(ARCH), registry.get_config(ARCH)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    for training in (False, True):
        assert model.model_flops_per_step(cfg, 4, 2048, training) == \
            rmodel.model_flops_per_step(rcfg, 4, 2048, training)
    assert xlstm.xlstm_flops_per_token(cfg) == rx.xlstm_flops_per_token(rcfg)


@pytest.mark.parametrize("tokens", [512, 1024, 2048])
def test_ssd_intra_cost_at_the_mlstm_prefill(tokens):
    """``op_cost.ssd_intra_cost`` at xlstm-125m's prefill (B 1, nc chunks
    of 128, G 4, R 1, N 384, P 385), on meta tensors: each input and the
    output once (22.1 MB at 512 tokens, linear in nc: 0.0066 ms at 3.35
    TB/s) and the causal scores, weights, W·x and C·s_in (0.81 G
    operations at 512)."""
    from repro_torch.launch import op_cost

    nc, l, g, n, p = tokens // 128, 128, 4, 384, 385
    meta = lambda *s: torch.empty(*s, device="meta")
    args = (meta(1, nc, l, g, 1, p), meta(1, nc, l, g, 1),
            meta(1, nc, l, g, 1), meta(1, nc, l, g, n), meta(1, nc, l, g, n),
            meta(1, nc, g, 1, n, p))
    nbytes, ops = op_cost.ssd_intra_cost(args, meta(1, nc, l, g, 1, p))
    floats = 2 * nc * l * g * p + 2 * nc * l * g + 2 * nc * l * g * n \
        + nc * g * n * p
    assert nbytes == 4 * floats
    assert abs(nbytes / (nc / 4) - 22.08e6) < 0.01e6
    assert abs(ops / (nc / 4) - 0.81e9) < 0.01e9
