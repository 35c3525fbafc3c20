"""Method of Lines time integrators (the Cactus MoL thorn analogue).

The port of ``repro.core.mol``: explicit Runge-Kutta integrators over a
state that is a tensor or a nested dict, list or tuple of tensors, as the
MoL thorn provides them to Cactus applications.  ``rhs(y, t) -> dy/dt`` is
supplied by the application (e.g. the CFD momentum equation); the
integrators are pure and launch no host sync.  Each combines its stages in
the reference's order of operations, and a division by a Python number is
a true division on every device (:func:`repro_torch.device.true_divide`).
"""
from __future__ import annotations

from typing import Callable, TypeVar

from repro_torch.device import true_divide

T = TypeVar("T")
RHS = Callable[[T, object], T]


def tree_map(fn, *trees):
    """``fn`` over the leaves of identically-structured trees (dicts,
    lists and tuples; anything else is a leaf)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _axpy(a, x: T, y: T) -> T:
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def euler(rhs: RHS, y: T, t, dt) -> T:
    return _axpy(dt, rhs(y, t), y)


def rk2(rhs: RHS, y: T, t, dt) -> T:
    """Heun's method (SSP-RK2)."""
    k1 = rhs(y, t)
    y1 = _axpy(dt, k1, y)
    k2 = rhs(y1, t + dt)
    return tree_map(lambda yi, a, b: yi + 0.5 * dt * (a + b), y, k1, k2)


def rk3_ssp(rhs: RHS, y: T, t, dt) -> T:
    """Shu-Osher strong-stability-preserving RK3 (standard for advection)."""
    k1 = rhs(y, t)
    y1 = _axpy(dt, k1, y)
    k2 = rhs(y1, t + dt)
    y2 = tree_map(lambda yi, y1i, ki: 0.75 * yi + 0.25 * (y1i + dt * ki),
                  y, y1, k2)
    k3 = rhs(y2, t + 0.5 * dt)
    return tree_map(
        lambda yi, y2i, ki: true_divide(yi, 3.0)
        + (2.0 / 3.0) * (y2i + dt * ki), y, y2, k3)


def rk4(rhs: RHS, y: T, t, dt) -> T:
    k1 = rhs(y, t)
    k2 = rhs(_axpy(0.5 * dt, k1, y), t + 0.5 * dt)
    k3 = rhs(_axpy(0.5 * dt, k2, y), t + 0.5 * dt)
    k4 = rhs(_axpy(dt, k3, y), t + dt)
    return tree_map(
        lambda yi, a, b, c, d: yi + true_divide(dt, 6.0)
        * (a + 2 * b + 2 * c + d), y, k1, k2, k3, k4)


INTEGRATORS = {"euler": euler, "rk2": rk2, "rk3": rk3_ssp, "rk4": rk4}
