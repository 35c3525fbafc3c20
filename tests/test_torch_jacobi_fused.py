"""The fused Jacobi smoother of the port against the reference, on the CPU.

The port's plain ``jacobi_fused_ref`` (what the JACOBI_FUSED CUDA kernel
is checked against on the card) is held to the reference's Pallas
``jacobi_fused`` in interpret mode and to its jnp ``jacobi_fused_ref`` on
the same seeded inputs, for k = 1, 2, 3 sweeps, at a tile-divisible and an
odd interior, with rtol 1e-5: the same float32 sweeps, which XLA may
evaluate in another order.  Within the port a slot batch equals per-slot
calls bitwise.  The card's tests are in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_harness import seeded  # installs the shim

import jax.numpy as jnp
from repro.kernels import jacobi as ref_jacobi
from repro.kernels import ops as ref_ops

from repro_torch.kernels import jacobi_cuda, ops
from repro_torch.kernels.jacobi import jacobi_fused_ref

RTOL, ATOL = 1e-5, 1e-6
H, OMEGA = 1.0 / 48, 0.8
# interior shapes: (16, 8, 8) splits into 8^3 tiles; (5, 7, 3) is odd
INTERIORS = {"divisible": (16, 8, 8), "odd": (5, 7, 3)}


def _inputs(interior, k, seed=0, slots=None):
    lead = () if slots is None else (slots,)
    shape = lead + tuple(n + 2 * k for n in interior)
    return seeded(shape, seed), seeded(shape, seed + 1)


@pytest.mark.parametrize("form", list(INTERIORS))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_version_matches_reference_fused_kernel(k, form):
    p, rhs = _inputs(INTERIORS[form], k, seed=10 * k)
    got = jacobi_fused_ref(torch.from_numpy(p), torch.from_numpy(rhs),
                           h=H, omega=OMEGA, sweeps=k).numpy()
    pallas = ref_jacobi.jacobi_fused(jnp.asarray(p), jnp.asarray(rhs), h=H,
                                     omega=OMEGA, sweeps=k, interpret=True)
    oracle = ref_jacobi.jacobi_fused_ref(jnp.asarray(p), jnp.asarray(rhs),
                                         h=H, omega=OMEGA, sweeps=k)
    assert got.shape == INTERIORS[form]
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_slot_batch_equals_per_slot_calls_bitwise(k):
    p, rhs = (torch.from_numpy(a) for a in _inputs((5, 7, 3), k, 4, slots=3))
    batched = jacobi_fused_ref(p, rhs, h=H, omega=OMEGA, sweeps=k)
    for s in range(3):
        one = jacobi_fused_ref(p[s], rhs[s], h=H, omega=OMEGA, sweeps=k)
        assert torch.equal(batched[s], one)


def test_jacobi_smooth_on_a_cpu_tensor_takes_torch_and_launches_nothing():
    p, rhs = (torch.from_numpy(a) for a in _inputs((6, 5, 4), 2, 7))
    want = jacobi_fused_ref(p, rhs, h=H, omega=OMEGA, sweeps=2)
    before = dict(jacobi_cuda.LAUNCHES)
    assert ops.default_template(p.device) == "TORCH"
    assert torch.equal(ops.jacobi_smooth(p, rhs, h=H, omega=OMEGA, sweeps=2), want)
    # the CUDA template on a CPU tensor runs the kernel's plain version
    got = ops.jacobi_smooth(p, rhs, h=H, omega=OMEGA, sweeps=2, template="CUDA")
    assert torch.equal(got, want)
    assert jacobi_cuda.LAUNCHES == before
    ref = ref_ops.jacobi_smooth(jnp.asarray(p.numpy()), jnp.asarray(rhs.numpy()),
                                h=H, omega=OMEGA, sweeps=2, template="JNP")
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="template"):
        ops.jacobi_smooth(p, rhs, h=H, sweeps=2, template="3DBLOCK")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, rhs = (torch.from_numpy(a) for a in _inputs((4, 5, 6), 2, 1))
    call = jacobi_cuda.jacobi_fused
    assert call(p, rhs, h=H, sweeps=2).shape == (4, 5, 6)
    with pytest.raises(TypeError, match="float32"):
        call(p.double(), rhs, h=H, sweeps=2)
    with pytest.raises(ValueError, match="contiguous"):
        call(p.transpose(0, 1), rhs.transpose(0, 1), h=H, sweeps=2)
    with pytest.raises(ValueError, match="differ"):
        call(p, rhs[:-1], h=H, sweeps=2)
    with pytest.raises(ValueError, match="empty interior"):
        call(p, rhs, h=H, sweeps=4)
    with pytest.raises(ValueError, match="sweeps"):
        call(p, rhs, h=H, sweeps=0)
    with pytest.raises(TypeError, match="Python scalar"):
        call(p, rhs, h=torch.tensor(H), sweeps=2)
    with pytest.raises(ValueError, match=r"\(\[S,\] X, Y, Z\)"):
        call(p[0], rhs[0], h=H, sweeps=1)
