"""One step of the lid-driven cavity on a staggered MAC grid, in plain PyTorch.

The paper's explicit projection scheme (Chorin, Hirt-Nichols), written out
with tensor slices and nothing else:

  1. u* = u + dt (-(flux-form central advection) + nu lap u + f), the
     wall-normal hi faces zeroed;
  2. rhs = div(u*) / dt;
  3. ``jacobi_iters`` weighted-Jacobi sweeps of lap p = rhs from the last p;
  4. p less its mean (the Neumann problem's null space);
  5. u = u* - dt grad p, the wall-normal hi faces zeroed.

Grid: p[i, j, k] at the centre of cell (i, j, k); vx[i, j, k] at the right
x-face of cell i, vy at the upper y-face, vz at the upper z-face.  Walls at
x = 0, 1 and y = 0, 1, the lid at y = 1 moving in +x; z periodic.  The
ghost cells of each field (one wide) are made axis after axis, x, y, then
z, each from the array padded so far, so that an edge ghost takes both
walls' rules:

  ========  =============  ====================  ==========
  field     x walls        y walls               z
  ========  =============  ====================  ==========
  vx        0              -v (lo), 2U - v (hi)  periodic
  vy        -v             0                     periodic
  vz        -v             -v                    periodic
  p         v (Neumann)    v (Neumann)           periodic
  ========  =============  ====================  ==========

The arithmetic runs in the dtype of the fields it is given: float32 for
the reference, bfloat16 for the control.  Nothing here imports the
program: the masks, the padded fields, the right-hand side and the
derived parameters are worked out again from the configuration.
"""
from __future__ import annotations

import torch

VELOCITY = ("vx", "vy", "vz")
FIELDS = VELOCITY + ("p",)

# (lo, hi) ghost rule of each field on x and y; z wraps for every field
ZERO, NEG, NEUMANN, LID = "zero", "neg", "neumann", "lid"
RULES = {
    "vx": ((ZERO, ZERO), (NEG, LID)),
    "vy": ((NEG, NEG), (ZERO, ZERO)),
    "vz": ((NEG, NEG), (NEG, NEG)),
    "p": ((NEUMANN, NEUMANN), (NEUMANN, NEUMANN)),
}


def params(re: float, grid, *, lid_velocity: float = 1.0,
           cfl_factor: float = 0.8, extent: float = 1.0) -> dict:
    """nu = 1/Re and dt = ``cfl_factor`` x the stable step for a speed of
    the lid's: min(h/(2U), 0.9 h^2/(6 nu)), reckoned in double."""
    h = extent / grid[0]
    nu = 1.0 / re
    dt = cfl_factor * min(0.5 * h / max(lid_velocity, 1e-12),
                          h * h / (6.0 * nu) * 0.9)
    return {"nu": nu, "dt": dt, "h": h, "lid_velocity": lid_velocity}


def masks(grid, device, dtype=torch.float32) -> dict:
    """1 everywhere but on the hi wall's normal faces: vx at x = 1, vy at
    y = 1 (vz has none: z is periodic)."""
    mx = torch.ones(grid, dtype=dtype, device=device)
    my = torch.ones(grid, dtype=dtype, device=device)
    mx[-1, :, :] = 0
    my[:, -1, :] = 0
    return {"vx": mx, "vy": my, "vz": torch.ones(grid, dtype=dtype,
                                                 device=device)}


def _ghost(rule: str, edge: torch.Tensor, lid) -> torch.Tensor:
    if rule == ZERO:
        return torch.zeros_like(edge)
    if rule == NEG:
        return -edge
    if rule == NEUMANN:
        return edge
    return 2 * lid - edge                       # LID: 2U - v


def pad(u: torch.Tensor, field: str, lid, lo: bool = True,
        hi: bool = True) -> torch.Tensor:
    """``u`` with one ghost cell on the asked sides of every axis, written
    into one new array: the interior, then each axis's ghost planes from
    the array padded so far."""
    rules = RULES[field]
    a, b = int(lo), int(hi)
    out = u.new_empty(tuple(n + a + b for n in u.shape))
    end = [n + a for n in u.shape]          # one past the interior
    out[a:end[0], a:end[1], a:end[2]] = u
    for axis in range(3):
        # the planes padded so far: every axis before this one whole
        span = [slice(None) if d < axis else slice(a, end[d])
                for d in range(3)]

        def plane(i):
            idx = list(span)
            idx[axis] = i
            return tuple(idx)

        if axis < 2:
            rule_lo, rule_hi = rules[axis]
            if lo:
                out[plane(0)] = _ghost(rule_lo, out[plane(1)], lid)
            if hi:
                out[plane(end[axis])] = _ghost(rule_hi,
                                               out[plane(end[axis] - 1)], lid)
        else:
            if lo:
                out[plane(0)] = out[plane(end[axis] - 1)]
            if hi:
                out[plane(end[axis])] = out[plane(a)]
    return out


class _Shift:
    """Neighbour access into a field padded by one on both sides."""

    def __init__(self, padded: torch.Tensor):
        self.a = padded
        self.n = tuple(s - 2 for s in padded.shape)

    def __call__(self, dx: int = 0, dy: int = 0, dz: int = 0):
        (nx, ny, nz) = self.n
        return self.a[1 + dx:1 + dx + nx, 1 + dy:1 + dy + ny,
                      1 + dz:1 + dz + nz]


def _avg(f, o1, o2):
    return 0.5 * (f(*o1) + f(*o2))


def _lap(f, ih2):
    return (f(1, 0, 0) + f(-1, 0, 0) + f(0, 1, 0) + f(0, -1, 0)
            + f(0, 0, 1) + f(0, 0, -1) - 6.0 * f()) * ih2


def update_velocity(vx, vy, vz, *, dt, nu, ih, ih2, lid):
    u = _Shift(pad(vx, "vx", lid))
    v = _Shift(pad(vy, "vy", lid))
    w = _Shift(pad(vz, "vz", lid))
    o = (0, 0, 0)

    def flux(a_h, a_l, b_h, b_l):
        return (a_h * b_h - a_l * b_l) * ih

    # x-momentum at the x-face
    duu = flux(_avg(u, o, (1, 0, 0)), _avg(u, (-1, 0, 0), o),
               _avg(u, o, (1, 0, 0)), _avg(u, (-1, 0, 0), o))
    duv = flux(_avg(u, o, (0, 1, 0)), _avg(u, (0, -1, 0), o),
               _avg(v, o, (1, 0, 0)), _avg(v, (0, -1, 0), (1, -1, 0)))
    duw = flux(_avg(u, o, (0, 0, 1)), _avg(u, (0, 0, -1), o),
               _avg(w, o, (1, 0, 0)), _avg(w, (0, 0, -1), (1, 0, -1)))
    nx_ = u() + dt * (-(duu + duv + duw) + nu * _lap(u, ih2))
    # y-momentum at the y-face
    dvv = flux(_avg(v, o, (0, 1, 0)), _avg(v, (0, -1, 0), o),
               _avg(v, o, (0, 1, 0)), _avg(v, (0, -1, 0), o))
    dvu = flux(_avg(v, o, (1, 0, 0)), _avg(v, (-1, 0, 0), o),
               _avg(u, o, (0, 1, 0)), _avg(u, (-1, 0, 0), (-1, 1, 0)))
    dvw = flux(_avg(v, o, (0, 0, 1)), _avg(v, (0, 0, -1), o),
               _avg(w, o, (0, 1, 0)), _avg(w, (0, 0, -1), (0, 1, -1)))
    ny_ = v() + dt * (-(dvu + dvv + dvw) + nu * _lap(v, ih2))
    # z-momentum at the z-face
    dww = flux(_avg(w, o, (0, 0, 1)), _avg(w, (0, 0, -1), o),
               _avg(w, o, (0, 0, 1)), _avg(w, (0, 0, -1), o))
    dwu = flux(_avg(w, o, (1, 0, 0)), _avg(w, (-1, 0, 0), o),
               _avg(u, o, (0, 0, 1)), _avg(u, (-1, 0, 0), (-1, 0, 1)))
    dwv = flux(_avg(w, o, (0, 1, 0)), _avg(w, (0, -1, 0), o),
               _avg(v, o, (0, 0, 1)), _avg(v, (0, -1, 0), (0, -1, 1)))
    nz_ = w() + dt * (-(dwu + dwv + dww) + nu * _lap(w, ih2))
    return nx_, ny_, nz_


def divergence(vx, vy, vz, *, ih, lid):
    """(u - u_west) + (v - v_south) + (w - w_below), over h."""
    u = pad(vx, "vx", lid, hi=False)[:, 1:, 1:]
    v = pad(vy, "vy", lid, hi=False)[1:, :, 1:]
    w = pad(vz, "vz", lid, hi=False)[1:, 1:, :]
    return ((u[1:] - u[:-1]) + (v[:, 1:] - v[:, :-1])
            + (w[:, :, 1:] - w[:, :, :-1])) * ih


def jacobi(p, h2rhs, *, omega, lid):
    """One sweep; ``h2rhs`` is h^2 rhs.  At ``omega`` 1 the weighted sum
    is the Jacobi value itself, and is not formed."""
    q = _Shift(pad(p, "p", lid))
    nbr = (q(1, 0, 0) + q(-1, 0, 0) + q(0, 1, 0) + q(0, -1, 0)
           + q(0, 0, 1) + q(0, 0, -1))
    six = torch.tensor(6.0, dtype=p.dtype, device=p.device)
    jac = (nbr - h2rhs) / six
    if omega == 1.0:
        return jac
    return (1.0 - omega) * p + omega * jac


def project(vx, vy, vz, p, *, s, lid):
    """u - (dt/h) (p_east - p), and so on; p padded on the hi sides."""
    q = pad(p, "p", lid, lo=False)
    c = q[:-1, :-1, :-1]
    return (vx - s * (q[1:, :-1, :-1] - c), vy - s * (q[:-1, 1:, :-1] - c),
            vz - s * (q[:-1, :-1, 1:] - c))


def step(state: dict, prm: dict, *, jacobi_iters: int, omega: float = 1.0,
         dtype=torch.float32) -> dict:
    """One dt of the cavity from ``state`` (``vx, vy, vz, p``), computed in
    ``dtype``; ``prm`` from :func:`params`."""
    vx, vy, vz, p = (state[f].to(dtype) for f in FIELDS)
    dev = vx.device

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    dt, nu, lid = scalar(prm["dt"]), scalar(prm["nu"]), scalar(
        prm["lid_velocity"])
    h = prm["h"]
    ih, ih2, h2 = 1.0 / h, 1.0 / (h * h), h * h
    m = masks(tuple(vx.shape), dev, dtype)

    us = update_velocity(vx, vy, vz, dt=dt, nu=nu, ih=ih, ih2=ih2, lid=lid)
    us = [a * m[f] for a, f in zip(us, VELOCITY)]
    rhs = divergence(*us, ih=ih, lid=lid) / dt
    h2rhs = h2 * rhs
    del rhs
    for _ in range(jacobi_iters):
        p = jacobi(p, h2rhs, omega=omega, lid=lid)
    p = p - p.to(torch.float64).mean().to(dtype)
    out = project(*us, p, s=dt / scalar(h), lid=lid)
    out = [a * m[f] for a, f in zip(out, VELOCITY)]
    return dict(zip(FIELDS, out + [p]))
