"""SSD_INTRA's plain version and the port's Mamba2 against the JAX
reference, on the CPU.

Seeded numpy inputs go through the reference's Pallas ``ssd_intra_pallas``
(interpret mode), its ``ssd_intra_reference``, ``ssd_core``, ``mamba2_seq``
and ``mamba2_step``, and through the port's counterparts.  The CUDA
wrapper's CPU route is the plain version; the kernel itself is checked on
the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import test_torch_harness  # noqa: F401  (installs the shim first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as r_get_config  # noqa: E402
from repro.configs.registry import smoke as r_smoke  # noqa: E402
from repro.kernels import ssd as rssd  # noqa: E402
from repro.models import mamba2 as rmamba  # noqa: E402
from repro.models.config import LOCAL as R_LOCAL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.registry import get_config, smoke  # noqa: E402
from repro_torch.kernels import ops, ref, ssd, ssd_cuda  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models.config import LOCAL  # noqa: E402

# float32 on both sides; the decay exponents are differences of cumulative
# sums that the two packages accumulate in another order, so a few ulp of
# |cum| (up to ~L) show up relative to the output's scale.
TOL = 2e-5


def _inputs(seed, bsz, nc, l, g, r, n, p):
    """The reference test's distributions, drawn with numpy."""
    rs = np.random.RandomState(seed)
    softplus = lambda a: np.log1p(np.exp(a))
    f = lambda *s: rs.randn(*s).astype(np.float32)
    x = f(bsz, nc, l, g, r, p)
    ld = -softplus(f(bsz, nc, l, g, r)).astype(np.float32)
    dt = softplus(f(bsz, nc, l, g, r)).astype(np.float32)
    b_, c_ = f(bsz, nc, l, g, n), f(bsz, nc, l, g, n)
    s0 = (f(bsz, nc, g, r, n, p) * 0.3).astype(np.float32)
    return x, ld, dt, b_, c_, s0


def _close(got, want, what="", tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


SHAPES = [(1, 2, 16, 1, 4, 8, 8), (2, 1, 32, 2, 2, 16, 8),
          (1, 3, 8, 1, 8, 4, 16), (2, 2, 48, 1, 3, 8, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_ssd_intra_matches_pallas_interpret_and_oracle(shape):
    args = _inputs(0, *shape)
    got = ssd.ssd_intra_reference(*map(torch.from_numpy, args))
    jargs = [jnp.asarray(a) for a in args]
    _close(got, rssd.ssd_intra_pallas(*jargs, interpret=True), "pallas")
    _close(got, rssd.ssd_intra_reference(*jargs), "oracle")
    # the op surface and the CUDA wrapper's CPU route are this function
    before = dict(ssd_cuda.LAUNCHES)
    for out in (ops.ssd_intra(*map(torch.from_numpy, args)),
                ssd_cuda.ssd_intra(*map(torch.from_numpy, args))):
        assert torch.equal(out, got)
    assert ssd_cuda.LAUNCHES == before


# SSD_INTRA's kernel against its plain version on the card
# (chip_smoke.SSD_RTOL, tests/test_torch_cuda.py): 1e-4 of max|y|
SSD_RTOL = 1e-4
# the zamba2-1.2b chunk: L 128, one group, N 64, P 64 (4 of its 64 heads)
ZAMBA2_CHUNK = (1, 2, 128, 1, 4, 64, 64)


def test_tf32_round_is_round_to_nearest_ties_away():
    t = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      1 + 3 * 2.0 ** -11, 3.0, 0.0])
    want = [1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 3.0, 0.0]
    assert ref.tf32_round(t).tolist() == want


@pytest.mark.parametrize("shape", SHAPES + [ZAMBA2_CHUNK])
def test_3xtf32_twin_matches_pallas_interpret(shape):
    """The CPU twin of the kernel's tensor-core arithmetic (3xTF32) stays
    within the card's SSD_RTOL of the reference's Pallas kernel."""
    args = _inputs(1, *shape)
    got = ref.ssd_intra_3xtf32_reference(*map(torch.from_numpy, args))
    want = rssd.ssd_intra_pallas(*map(jnp.asarray, args), interpret=True)
    _close(got, want, "3xtf32", tol=SSD_RTOL)


def test_single_tf32_exceeds_ssd_rtol_at_the_zamba2_chunk():
    """Why the kernel splits its operands: one TF32 product a term (~11
    bits) misses SSD_RTOL at the zamba2 chunk shape, the split meets it."""
    args = _inputs(1, *ZAMBA2_CHUNK)
    want = np.asarray(rssd.ssd_intra_pallas(*map(jnp.asarray, args),
                                            interpret=True))
    scale = max(1.0, float(np.abs(want).max()))
    errs = {}
    for split in (False, True):
        got = ref.ssd_intra_3xtf32_reference(*map(torch.from_numpy, args),
                                             split=split).numpy()
        errs[split] = float(np.abs(got - want).max()) / scale
    assert errs[False] > SSD_RTOL, errs
    assert errs[True] <= SSD_RTOL, errs


def test_wrapper_checks_its_inputs():
    args = [torch.from_numpy(a) for a in _inputs(0, 1, 2, 16, 1, 4, 8, 8)]
    with pytest.raises(TypeError, match="float32"):
        ssd_cuda.ssd_intra(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="expected"):
        ssd_cuda.ssd_intra(*args[:3], args[3][..., :4].contiguous(),
                           *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda.ssd_intra(args[0].transpose(4, 5).contiguous().transpose(4, 5),
                           *args[1:])
    with pytest.raises(ValueError, match="dimensions"):
        ssd_cuda.ssd_intra(args[0][0], *args[1:])


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s,chunk", [(48, 16), (37, 16), (10, 16)])
def test_ssd_core_matches_reference(s, chunk, init):
    """The chunked core with padding (S not a multiple of the chunk), the
    inter-chunk relay and an optional incoming state."""
    bsz, g, r, n, p = 2, 1, 3, 8, 4
    rs = np.random.RandomState(s)
    f = lambda *sh: rs.randn(*sh).astype(np.float32)
    x, b_, c_ = f(bsz, s, g, r, p), f(bsz, s, g, n), f(bsz, s, g, n)
    ld = -np.log1p(np.exp(f(bsz, s, g, r))).astype(np.float32)
    sc = np.log1p(np.exp(f(bsz, s, g, r))).astype(np.float32)
    st = f(bsz, g, r, n, p) if init else None
    args = (x, ld, sc, b_, c_)
    ry, rfin = rmamba.ssd_core(*map(jnp.asarray, args), chunk,
                               None if st is None else jnp.asarray(st))
    py, pfin = mamba2.ssd_core(*map(torch.from_numpy, args), chunk,
                               None if st is None else torch.from_numpy(st))
    _close(py, ry, "y")
    _close(pfin, rfin, "final state")


def _mamba_pair(seed=0):
    rcfg = r_smoke(r_get_config("zamba2-1.2b"))
    cfg = smoke(get_config("zamba2-1.2b"))
    rp = rmamba.init_mamba2(jax.random.PRNGKey(seed), rcfg)
    pp = mamba2.Mamba2(None, cfg, "meta")
    state = {".".join(k): convert._tensor(np.asarray(v)) for k, v in
             convert._flatten(jax.tree.map(np.asarray, rp))}
    pp.load_state_dict(state, strict=True, assign=True)
    return rcfg, cfg, rp, pp


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_seq_and_step_match_reference(with_state):
    rcfg, cfg, rp, pp = _mamba_pair()
    x = np.random.RandomState(1).randn(2, 37, cfg.d_model).astype(np.float32)
    rstate = pstate = None
    if with_state:
        rs = np.random.RandomState(2)
        conv = rs.randn(2, cfg.conv_width - 1, cfg.conv_dim).astype(np.float32)
        ssm = rs.randn(2, cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups,
                       cfg.ssm_state, cfg.ssm_head_dim).astype(np.float32)
        rstate = rmamba.Mamba2State(jnp.asarray(conv), jnp.asarray(ssm))
        pstate = mamba2.Mamba2State(torch.from_numpy(conv),
                                    torch.from_numpy(ssm))
    ry, rst = rmamba.mamba2_seq(rp, rcfg, jnp.asarray(x), R_LOCAL,
                                state=rstate, return_state=True)
    py, pst = mamba2.mamba2_seq(pp, cfg, torch.from_numpy(x), LOCAL,
                                state=pstate, return_state=True)
    _close(py, ry, "seq")
    _close(pst.conv, rst.conv, "conv state")
    _close(pst.ssm, rst.ssm, "ssm state")
    # then three recurrent steps from those states
    xs = np.random.RandomState(3).randn(3, 2, cfg.d_model).astype(np.float32)
    for t in range(3):
        ry, rst = rmamba.mamba2_step(rp, rcfg, jnp.asarray(xs[t]), rst)
        py, pst = mamba2.mamba2_step(pp, cfg, torch.from_numpy(xs[t]), pst)
        _close(py, ry, f"step {t}")
        _close(pst.ssm, rst.ssm, f"step {t} ssm")
        _close(pst.conv, rst.conv, f"step {t} conv")


def test_mamba2_init_draws_the_reference_distributions():
    rcfg, cfg, rp, _ = _mamba_pair()
    pp = mamba2.Mamba2(torch.Generator().manual_seed(0), cfg, "cpu")
    np.testing.assert_allclose(pp.A_log.numpy(), np.asarray(rp["A_log"]),
                               rtol=1e-6)
    assert torch.equal(pp.D, torch.ones(cfg.ssm_heads))
    dt0 = torch.nn.functional.softplus(pp.dt_bias)   # the init's dt
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt0.max()) <= 1e-1 * (1 + 1e-5)
    w = pp.in_proj.w.float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) * (1 + 1e-6)
    ref_shapes = {".".join(k): np.shape(v) for k, v in
                  convert._flatten(jax.tree.map(np.asarray, rp))}
    assert {k: tuple(v.shape) for k, v in pp.state_dict().items()} == ref_shapes
