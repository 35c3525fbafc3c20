"""Harness for holding the PyTorch port (``repro_torch``) against the JAX
reference (``repro``) on the CPU.

Importing this module installs a shim that lets the reference import under
jax 0.9: there ``jax.interpreters.batching.primitive_batchers`` is a
write-only proxy, so the ``in`` test at ``repro/core/generator.py:65``
raises ``TypeError``.  The shim replaces the proxy with a subclass whose
``__contains__`` consults the registries the proxy writes to.  It must run
before any ``repro`` import, and it is idempotent: pytest imports this file
as ``test_torch_harness`` while the other port tests import it as
``tests.test_torch_harness``.

The module also makes the seeded numpy inputs that both packages receive.
"""
from __future__ import annotations

import os

import numpy as np


def install_reference_shim() -> None:
    """Make ``prim in batching.primitive_batchers`` work on jax 0.9."""
    from jax.interpreters import batching

    proxy = batching.primitive_batchers
    if getattr(type(proxy), "_repro_torch_shim", False):
        return
    if hasattr(type(proxy), "__contains__"):   # older jax: a real dict
        return
    from jax._src.interpreters import batching as _batching

    class _ContainsProxy(type(proxy)):
        _repro_torch_shim = True

        def __contains__(self, prim) -> bool:
            return (prim in _batching.fancy_primitive_batchers
                    or prim in _batching.primitive_batchers)

    batching.primitive_batchers = _ContainsProxy()


install_reference_shim()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeded(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    """Standard-normal float32 array from ``np.random.RandomState(seed)``."""
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def padded_inputs(desc, interior, seed: int, slots: int | None = None,
                  scale: float = 0.3) -> dict:
    """Seeded inputs for descriptor ``desc``: cached inputs padded by its
    stencil radii, uncached ones interior-shaped; optional slot axis."""
    out = {}
    lead = () if slots is None else (slots,)
    for i, name in enumerate(desc.inputs):
        cached = name in desc.cached_inputs
        shape = tuple(n + ((lo + hi) if cached else 0) for n, lo, hi in
                      zip(interior, desc.halo_lo, desc.halo_hi))
        out[name] = seeded(lead + shape, seed + i, scale)
    return out


def test_reference_imports_and_runs_a_kernel():
    import jax.numpy as jnp

    from repro.core.generator import generate
    from repro.kernels import stencil3d

    k = generate(stencil3d.JACOBI_PRESSURE, stencil3d.jacobi_pressure_body,
                 template="JNP")
    p = jnp.asarray(seeded((6, 6, 6), 0))
    rhs = jnp.asarray(seeded((4, 4, 4), 1))
    assert k({"p": p, "rhs": rhs}, h=0.5, omega=1.0)["p"].shape == (4, 4, 4)


def test_shim_is_idempotent():
    from jax.interpreters import batching

    before = batching.primitive_batchers
    install_reference_shim()
    assert batching.primitive_batchers is before


def test_cuda_marker_is_registered(pytestconfig):
    markers = pytestconfig.getini("markers")
    assert any(m.startswith("cuda:") for m in markers)
