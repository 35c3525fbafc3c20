"""The port's ``cacuda.ccl`` parser and MoL integrators against the reference.

``repro_torch.core.ccl.parse_ccl`` gives descriptors field-equal to
``repro.core.ccl.parse_ccl`` on the paper's Listing 1 (and equal to the
port's own stencil descriptors when fed their declarations), and raises on
bad input as the reference does.  The Runge-Kutta integrators of
``repro_torch.core.mol`` match ``repro.core.mol`` on a seeded linear ODE
within rtol 1e-6 (float32) and keep its convergence orders.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_harness  # noqa: F401  (installs the shim)

from repro.core import ccl as ref_ccl
from repro.core import mol as ref_mol

from repro_torch.core import ccl, mol
from repro_torch.kernels import stencil3d
from tests.test_core import PAPER_CCL

MOL_RTOL = 1e-6


def _fields(d) -> dict:
    """A descriptor as plain data (enums by value), comparable across the
    two packages."""
    return {"name": d.name, "stencil": d.stencil, "tile": d.tile,
            "type": d.type, "parameters": d.parameters,
            "variables": [(v.names, v.intent.value, v.cached, v.group)
                          for v in d.variables]}


def test_paper_listing_parses_field_equal_to_the_reference():
    (ours,) = ccl.parse_ccl(PAPER_CCL)
    (ref,) = ref_ccl.parse_ccl(PAPER_CCL)
    assert _fields(ours) == _fields(ref)
    assert (ours.inputs, ours.outputs, ours.cached_inputs) == \
        (ref.inputs, ref.outputs, ref.cached_inputs)
    assert ours.halo_lo == ref.halo_lo and ours.halo_hi == ref.halo_hi


def _declaration(d) -> str:
    """The cacuda.ccl text that declares descriptor ``d``."""
    lines = [f"CCTK_CUDA_KERNEL {d.name}", f"  TYPE={d.type}",
             f'  STENCIL="{",".join(map(str, d.stencil))}"',
             f'  TILE="{",".join(map(str, d.tile))}"', "{"]
    for v in d.variables:
        lines += [f"  CCTK_CUDA_KERNEL_VARIABLE "
                  f"CACHED={'YES' if v.cached else 'NO'} "
                  f"INTENT={v.intent.value}",
                  "  {", "    " + ", ".join(v.names), f'  }} "{v.group}"']
    lines += ["  CCTK_CUDA_KERNEL_PARAMETER", "  {",
              "    " + ", ".join(d.parameters), "  }", "}"]
    return "\n".join(lines) + "\n"


def test_the_ports_stencil_declarations_parse_to_its_descriptors(tmp_path):
    text = "# the four 3DBLOCK kernels of the projection step\n" + "".join(
        _declaration(d) for d in stencil3d.DESCRIPTORS.values())
    path = tmp_path / "cacuda.ccl"
    path.write_text(text)
    got = ccl.parse_ccl_file(str(path))
    assert got == list(stencil3d.DESCRIPTORS.values())
    assert [_fields(d) for d in got] == \
        [_fields(d) for d in ref_ccl.parse_ccl(text)]


@pytest.mark.parametrize("text", [
    "CCTK_CUDA_KERNEL X TYPE=3DBLOCK { BOGUS { } }",
    "CCTK_CUDA_KERNEL X TYPE=3DBLOCK {",
    "KERNEL X { }",
    "CCTK_CUDA_KERNEL X TYPE 3DBLOCK { }",
    "CCTK_CUDA_KERNEL X { CCTK_CUDA_KERNEL_VARIABLE INTENT=SIDEWAYS { u } }",
    "CCTK_CUDA_KERNEL X ; { }",
])
def test_bad_input_raises_as_the_reference_does(text):
    with pytest.raises(ValueError) as ref_err:
        ref_ccl.parse_ccl(text)
    with pytest.raises(ValueError) as err:
        ccl.parse_ccl(text)
    assert type(err.value).__name__ == type(ref_err.value).__name__
    assert str(err.value) == str(ref_err.value)


# -- MoL ----------------------------------------------------------------------
def _linear_ode(seed: int = 0):
    """dy/dt = A y on a dict state {"u": (6,), "w": (3, 2)}, A seeded."""
    rng = np.random.RandomState(seed)
    a_u = (rng.randn(6, 6) * 0.3).astype(np.float32)
    a_w = (rng.randn(2, 2) * 0.3).astype(np.float32)
    y0 = {"u": rng.randn(6).astype(np.float32),
          "w": rng.randn(3, 2).astype(np.float32)}
    return a_u, a_w, y0


@pytest.mark.parametrize("name", sorted(ref_mol.INTEGRATORS))
def test_integrators_match_the_reference_on_a_linear_ode(name):
    a_u, a_w, y0 = _linear_ode()
    tu, tw = torch.from_numpy(a_u), torch.from_numpy(a_w)
    ju, jw = jnp.asarray(a_u), jnp.asarray(a_w)

    def rhs_t(y, t):
        return {"u": tu @ y["u"] * (1.0 + 0.1 * t), "w": y["w"] @ tw}

    def rhs_j(y, t):
        return {"u": ju @ y["u"] * (1.0 + 0.1 * t), "w": y["w"] @ jw}

    y_t = {k: torch.from_numpy(v) for k, v in y0.items()}
    y_j = {k: jnp.asarray(v) for k, v in y0.items()}
    t, dt = 0.0, 0.05
    for _ in range(20):
        y_t = mol.INTEGRATORS[name](rhs_t, y_t, t, dt)
        y_j = ref_mol.INTEGRATORS[name](rhs_j, y_j, t, dt)
        t += dt
    for k in y0:
        want = np.asarray(y_j[k])
        assert y_t[k].dtype == torch.float32
        np.testing.assert_allclose(y_t[k].numpy(), want, rtol=MOL_RTOL,
                                   atol=MOL_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name, order", [("euler", 1), ("rk2", 2),
                                         ("rk3", 3), ("rk4", 4)])
def test_integrators_keep_their_convergence_order(name, order):
    """dy/dt = -y to t = 1: halving dt cuts the error by about 2^order, as
    the reference's test holds its integrators (float64 here, so that
    rk4's error stays above the rounding floor)."""
    errs = []
    for dt in (0.2, 0.1):
        y, t = torch.tensor(1.0, dtype=torch.float64), 0.0
        for _ in range(int(round(1.0 / dt))):
            y = mol.INTEGRATORS[name](lambda v, _t: -v, y, t, dt)
            t += dt
        errs.append(abs(float(y) - np.exp(-1.0)))
    assert errs[0] / errs[1] > 2 ** order * 0.6, (name, errs)


def test_integrators_take_lists_tuples_and_device_scalars():
    y = {"a": [torch.ones(3), (torch.full((2,), 2.0),)]}
    dt = torch.tensor(0.1)
    out = mol.rk4(lambda v, t: mol.tree_map(lambda x: -x, v), y, 0.0, dt)
    assert isinstance(out["a"], list) and isinstance(out["a"][1], tuple)
    np.testing.assert_allclose(out["a"][0].numpy(), np.exp(-0.1), rtol=1e-6)
    np.testing.assert_allclose(out["a"][1][0].numpy(), 2 * np.exp(-0.1),
                               rtol=1e-6)
