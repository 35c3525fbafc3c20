"""Halo padding of the port against the reference, on the CPU.

Padding is pure data movement (slices, flips, fills, concatenation), so the
port must equal the reference bitwise: every boundary rule, periodic wrap,
one-sided widths and the corners the two-phase per-axis padding produces.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_harness import seeded  # installs the shim

import jax
import jax.numpy as jnp
from repro.cfd import ns3d as ref_ns3d
from repro.core import halo as ref_halo

from repro_torch.cfd import ns3d
from repro_torch.core import halo
from repro_torch.kernels import ops

# rule name -> (reference rule, port rule)
RULES = {
    "none": (lambda: None, lambda: None),
    "dirichlet0": (lambda: ref_halo.bc_dirichlet(0.0), lambda: halo.bc_dirichlet(0.0)),
    "dirichlet": (lambda: ref_halo.bc_dirichlet(2.5), lambda: halo.bc_dirichlet(2.5)),
    "neumann": (ref_halo.bc_neumann, halo.bc_neumann),
    "mirror": (lambda: ref_halo.bc_mirror(-1.0), lambda: halo.bc_mirror(-1.0)),
    "mirror_half": (lambda: ref_halo.bc_mirror(0.5), lambda: halo.bc_mirror(0.5)),
    "moving_wall": (lambda: ref_ns3d.bc_moving_wall(1.0),
                    lambda: ns3d.bc_moving_wall(1.0)),
    # the lid speed as a traced/tensor per-simulation scalar, as the step passes it
    "moving_wall_tensor": (lambda: ref_ns3d.bc_moving_wall(jnp.float32(0.7)),
                           lambda: ns3d.bc_moving_wall(torch.tensor(0.7))),
}

# (widths, per-axis (periodic, lo rule, hi rule))
CASES = {
    "walls_sym": ((1, 1, 1), [(False, "mirror", "moving_wall"),
                              (False, "neumann", "dirichlet"), (True, None, None)]),
    "all_periodic": ((2, 1, 1), [(True, None, None)] * 3),
    "lo_side": (((1, 0),) * 3, [(False, "dirichlet0", "none"),
                                (False, "moving_wall", "mirror"),
                                (True, None, None)]),
    "hi_side": (((0, 1),) * 3, [(False, "neumann", "neumann"),
                                (False, "mirror_half", "moving_wall_tensor"),
                                (False, "none", "dirichlet")]),
    "wide_mixed": (((2, 1), (1, 2), 0), [(False, "mirror", "neumann"),
                                         (True, None, None),
                                         (False, "dirichlet", "dirichlet")]),
    "lid_tensor": ((1, 1, 1), [(False, "dirichlet0", "dirichlet0"),
                               (False, "moving_wall", "moving_wall_tensor"),
                               (True, None, None)]),
}


def _specs(axes, which):
    ref_cls, port_cls = ref_halo.AxisSpec, halo.AxisSpec
    out = []
    for a, (periodic, lo, hi) in enumerate(axes):
        pick = (lambda r: None if r is None else RULES[r][which]())
        cls = ref_cls if which == 0 else port_cls
        out.append(cls(array_axis=a, periodic=periodic, bc_lo=pick(lo),
                       bc_hi=pick(hi)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_exchange_pad_bitwise_equal_to_reference(case):
    widths, axes = CASES[case]
    u = seeded((5, 6, 4), 21)
    want = np.asarray(ref_halo.exchange_pad(jnp.asarray(u), widths, _specs(axes, 0)))
    got = halo.exchange_pad(torch.from_numpy(u), widths, _specs(axes, 1)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_exchange_pad_random_sweep_bitwise(seed):
    """Seeded sweep over shapes, widths and rules (the property sweep of the
    reference's halo tests, with a fixed seed list)."""
    rng = np.random.RandomState(seed)
    names = list(RULES)
    shape = tuple(int(s) for s in rng.randint(2, 7, size=3))
    widths, axes = [], []
    for a in range(3):
        lo, hi = (int(w) for w in rng.randint(0, min(shape[a], 3), size=2))
        widths.append((lo, hi))
        if rng.rand() < 0.3:
            axes.append((True, None, None))
        else:
            axes.append((False, names[rng.randint(len(names))],
                         names[rng.randint(len(names))]))
    u = seeded(shape, 100 + seed)
    want = np.asarray(ref_halo.exchange_pad(jnp.asarray(u), widths, _specs(axes, 0)))
    got = halo.exchange_pad(torch.from_numpy(u), widths, _specs(axes, 1)).numpy()
    np.testing.assert_array_equal(got, want)


def test_decomposed_axis_needs_a_link_and_a_virtual_one_counts():
    """A decomposed spec without its link raises; on a virtual link the
    count transport books one strip a side as the reference's
    collective-permute operands — the edge rank's hi strip too — sends
    only the one with a receiver, and the pad comes out
    on ``meta`` at the padded shape (the multi-rank exchange is
    ``tests/test_torch_dist.py``'s)."""
    spec = halo.AxisSpec(array_axis=0, mesh_axis="shard")
    with pytest.raises(ValueError, match="carries no link"):
        halo.exchange_pad(torch.zeros(4, 4, 4), (1,), [spec])
    count = halo.CountTransport()
    link = halo.AxisLink(name="shard", size=2, index=1, transport=count)
    specs = [halo.AxisSpec(array_axis=0, mesh_axis="shard", link=link,
                           bc_hi=halo.bc_neumann()),
             halo.AxisSpec(array_axis=1, periodic=True)]
    u = torch.empty(2, 4, 5, 6, device="meta")
    out = halo.exchange_pad(u, (1, (2, 0)), specs)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 6, 7, 6)
    strip = (2 * 1 * 5 * 6) * 4
    assert (count.permute_operand_bytes, count.permute_ops) == (2 * strip, 2)
    # the last rank's hi strip has no receiver: only the lo one is sent
    assert (count.sent_bytes, count.sent_ops) == (strip, 1)
    assert link.peer(-1, False) == 0 and link.peer(+1, False) is None
    assert link.peer(+1, True) == 0


def test_width_larger_than_extent_raises():
    spec = halo.AxisSpec(array_axis=0, periodic=True)
    with pytest.raises(ValueError, match="smaller than halo width"):
        halo.exchange_pad(torch.zeros(2, 3, 3), (3,), [spec])


@pytest.mark.parametrize("template", ["TORCH", "CUDA"])
def test_stencil_step_overlap_equals_pad_then_kernel(template):
    """The interior/shell split equals pad + kernel bitwise (the same
    element-wise arithmetic on the same values), and the reference's split
    within float32 tolerance."""
    axes = CASES["walls_sym"][1]
    specs = _specs(axes, 1)
    packed = torch.from_numpy(np.stack([seeded((6, 5, 4), s, 0.3) for s in (1, 2, 3)]))
    kw = dict(dt=0.01, h=0.2, nu=0.05, fx=0.1, fy=0.0, fz=-0.1)

    def kernel(padded):
        return torch.stack(ops.update_velocity(padded[0], padded[1], padded[2],
                                               template=template, **kw))

    def pad_fn(pack):
        return torch.stack([halo.exchange_pad(pack[i], (1, 1, 1), specs)
                            for i in range(3)])

    got = halo.stencil_step_overlap(packed, (0, 1, 1, 1), None, kernel,
                                    pad_fn=pad_fn)
    want = kernel(pad_fn(packed))
    np.testing.assert_array_equal(got.numpy(), want.numpy())

    from repro.kernels import ops as ref_ops

    rspecs = _specs(axes, 0)
    jpacked = jnp.asarray(packed.numpy())
    ref = jax.jit(lambda pk: ref_halo.stencil_step_overlap(
        pk, (0, 1, 1, 1), None,
        lambda p: jnp.stack(ref_ops.update_velocity(p[0], p[1], p[2],
                                                    template="JNP", **kw)),
        pad_fn=lambda pack: jnp.stack([ref_halo.exchange_pad(pack[i], (1, 1, 1),
                                                             rspecs)
                                       for i in range(3)])))(jpacked)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
