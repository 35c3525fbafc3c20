"""The seeded inputs and traffic: the same for a seed, another for another,
and the same work on every seed."""
from collections import Counter

import pytest
import torch

import harness
import traffic

GRID = (12, 10, 8)
KW = dict(modes=3, amplitude=0.5, lid_velocity=1.0, device="cpu")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**40 + 1, -9])
def test_initial_fields_repeat_for_a_seed(seed):
    a = traffic.initial_fields(GRID, seed, 3, **KW)
    b = traffic.initial_fields(GRID, seed, 3, **KW)
    for f in traffic.FIELDS:
        assert torch.equal(a[f], b[f])
        assert a[f].dtype == torch.float32 and tuple(a[f].shape) == GRID
    assert not a["vx"][-1].any() and not a["vy"][:, -1].any()
    assert not a["p"].any()
    for f in traffic.VELOCITY:
        assert 0 < float(a[f].abs().max()) <= 0.5


def test_initial_fields_differ_across_seeds_and_members():
    a = traffic.initial_fields(GRID, 11, 0, **KW)
    for other in (traffic.initial_fields(GRID, 12, 0, **KW),
                  traffic.initial_fields(GRID, 11, 1, **KW)):
        assert all(not torch.equal(a[f], other[f]) for f in traffic.VELOCITY)


def _sweep(seed, n=40):
    tr = harness.workload("sweep256.members")["traffic"]
    sw = traffic.Sweep(tr, seed)
    return tr, sw.probe(), [sw.member(i) for i in range(1, n + 1)]


def test_sweep_repeats_for_a_seed_and_reorders_across_seeds():
    _, pa, a = _sweep(2**31 + 3)
    _, pb, b = _sweep(2**31 + 3)
    _, _, c = _sweep(2**31 + 4)
    assert a == b and pa == pb
    assert [m.re for m in a] != [m.re for m in c]


def test_every_seed_gets_the_same_members_in_another_order():
    tr, probe, a = _sweep(1)
    assert probe.index == 0 and probe.steps == tr["probe_steps"]
    assert probe.t_end is None and probe.re in tr["reynolds"]
    for seed in (2, 2**33 + 1, -3):
        _, _, b = _sweep(seed)
        for lo in range(0, 40, 8):
            assert Counter(m.re for m in a[lo:lo + 8]) == Counter(
                m.re for m in b[lo:lo + 8]) == Counter(
                    float(r) for r in tr["reynolds"])
        # every member runs to the sweep's end time, as a user submits it
        assert {(m.steps, m.t_end) for m in b} == {(None, tr["t_end"])}
    assert [m.index for m in a] == list(range(1, 41))


def test_members_outlast_the_window_at_the_cells_size():
    """At 256^3 a member of t_end 4 takes thousands of steps: far more
    than a window's few hundred batched steps."""
    tr = harness.workload("sweep256.members")["traffic"]
    cfg = harness.config("cavity3d-sweep-n256-s8")
    ns = harness.module("reference", cfg["reference"])
    steps = [round(tr["t_end"] / ns.params(
        r, cfg["grid"], lid_velocity=cfg["lid_velocity"],
        cfl_factor=cfg["dt_cfl_factor"])["dt"]) for r in tr["reynolds"]]
    assert min(steps) > 5000 and max(steps) < 50000
