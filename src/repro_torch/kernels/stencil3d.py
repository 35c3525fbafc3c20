"""The paper's CFD hot-spot kernels, declared as CaCUDA descriptors.

The port's copy of ``repro.kernels.stencil3d``: the same descriptors and the
same bodies, which the generator either dispatches to their hand-written
CUDA kernels (``CUDA`` template, :mod:`repro_torch.kernels.stencil3d_cuda`)
or expands eagerly over torch tensors (``TORCH`` template):

  UPDATE_VELOCITY   advection (MAC staggered, central) + viscous diffusion
  DIVERGENCE        cell-centered divergence of the face velocity field
  JACOBI_PRESSURE   one weighted-Jacobi sweep of the pressure Poisson eq.
  PROJECT_VELOCITY  pressure-gradient correction of the face velocities

Grid convention (staggered MAC):
  p[i,j,k]  at cell center ((i+.5)h, (j+.5)h, (k+.5)h)
  vx[i,j,k] at x-face     ((i+1 )h, (j+.5)h, (k+.5)h)   (right face of cell i)
  vy[i,j,k] at y-face     ((i+.5)h, (j+1 )h, (k+.5)h)
  vz[i,j,k] at z-face     ((i+.5)h, (j+.5)h, (k+1 )h)

All kernels read halo-padded arrays (ghosts filled by the driver's padding,
exactly as in Cactus) and write interior arrays.  Parameters may be Python
scalars or float32 tensors (0-d, or per slot).  The bodies read the terms
the reference computes from ``h`` and ``omega`` (``1/h``, ``1/h^2``,
``h^2``, ``1 - omega``) through ``ctx.param``, which derives them as the
reference does (:data:`repro_torch.core.generator.DERIVED`: in double for a
Python scalar); the CUDA template's per-slot table carries exactly those
values, in the column order of :data:`TABLES`.
"""
from __future__ import annotations

from repro_torch.core.descriptor import descriptor
from repro_torch.core.generator import KernelContext
from repro_torch.device import true_divide


# --------------------------------------------------------------------------
# descriptors (the cacuda.ccl declarations)
# --------------------------------------------------------------------------
UPDATE_VELOCITY = descriptor(
    "UPDATE_VELOCITY",
    stencil=(1, 1, 1, 1, 1, 1),
    tile=(8, 8, 8),
    velocity=dict(names=("vx", "vy", "vz"), intent="SEPARATEINOUT", cached=True),
    parameters=("dt", "h", "nu", "fx", "fy", "fz"),
)

DIVERGENCE = descriptor(
    "DIVERGENCE",
    stencil=(1, 0, 1, 0, 1, 0),
    tile=(8, 8, 8),
    velocity=dict(names=("vx", "vy", "vz"), intent="IN", cached=True),
    div=dict(names=("div",), intent="OUT"),
    parameters=("h",),
)

JACOBI_PRESSURE = descriptor(
    "JACOBI_PRESSURE",
    stencil=(1, 1, 1, 1, 1, 1),
    tile=(8, 8, 8),
    pressure=dict(names=("p",), intent="SEPARATEINOUT", cached=True),
    rhs=dict(names=("rhs",), intent="IN", cached=False),
    parameters=("h", "omega"),
)

PROJECT_VELOCITY = descriptor(
    "PROJECT_VELOCITY",
    stencil=(0, 1, 0, 1, 0, 1),
    tile=(8, 8, 8),
    velocity=dict(names=("vx", "vy", "vz"), intent="SEPARATEINOUT", cached=False),
    pressure=dict(names=("p",), intent="IN", cached=True),
    parameters=("dt", "h"),
)


# --------------------------------------------------------------------------
# kernel bodies (what the application author writes; CaCUDA generates the rest)
# --------------------------------------------------------------------------
def update_velocity_body(ctx: KernelContext) -> dict:
    """Explicit advection-diffusion update for the three face velocities.

    Central (NASA-VOF2D style, donor-cell blending left to the solver layer)
    flux-form advection on the MAC grid + 7-point viscous Laplacian.
    """
    vx, vy, vz = ctx["vx"], ctx["vy"], ctx["vz"]
    dt, nu = ctx.param("dt"), ctx.param("nu")
    fx, fy, fz = ctx.param("fx"), ctx.param("fy"), ctx.param("fz")
    ih, ih2 = ctx.param("ih"), ctx.param("ih2")    # 1/h and (1/h)^2

    def lap(f):
        return (
            f.at(1, 0, 0) + f.at(-1, 0, 0) + f.at(0, 1, 0) + f.at(0, -1, 0)
            + f.at(0, 0, 1) + f.at(0, 0, -1) - 6.0 * f.c
        ) * ih2

    def avg(f, o1, o2):
        return 0.5 * (f.at(*o1) + f.at(*o2))

    # ---- x-momentum at x-face (i+1)h ------------------------------------
    # d(u^2)/dx: u^2 at cell centers i and i+1
    uc_r = avg(vx, (0, 0, 0), (1, 0, 0))   # u at center of cell i+1
    uc_l = avg(vx, (-1, 0, 0), (0, 0, 0))  # u at center of cell i
    duu = (uc_r * uc_r - uc_l * uc_l) * ih
    # d(uv)/dy: corner fluxes at y = jh and (j+1)h on the x-face line
    u_yh = avg(vx, (0, 0, 0), (0, 1, 0))   # u at corner y=(j+1)h
    u_yl = avg(vx, (0, -1, 0), (0, 0, 0))  # u at corner y=jh
    v_yh = avg(vy, (0, 0, 0), (1, 0, 0))   # v at corner y=(j+1)h (avg in x)
    v_yl = avg(vy, (0, -1, 0), (1, -1, 0))
    duv = (u_yh * v_yh - u_yl * v_yl) * ih
    # d(uw)/dz
    u_zh = avg(vx, (0, 0, 0), (0, 0, 1))
    u_zl = avg(vx, (0, 0, -1), (0, 0, 0))
    w_zh = avg(vz, (0, 0, 0), (1, 0, 0))
    w_zl = avg(vz, (0, 0, -1), (1, 0, -1))
    duw = (u_zh * w_zh - u_zl * w_zl) * ih
    new_vx = vx.c + dt * (-(duu + duv + duw) + nu * lap(vx) + fx)

    # ---- y-momentum at y-face (j+1)h ------------------------------------
    vc_r = avg(vy, (0, 0, 0), (0, 1, 0))
    vc_l = avg(vy, (0, -1, 0), (0, 0, 0))
    dvv = (vc_r * vc_r - vc_l * vc_l) * ih
    v_xh = avg(vy, (0, 0, 0), (1, 0, 0))
    v_xl = avg(vy, (-1, 0, 0), (0, 0, 0))
    u_xh = avg(vx, (0, 0, 0), (0, 1, 0))
    u_xl = avg(vx, (-1, 0, 0), (-1, 1, 0))
    dvu = (v_xh * u_xh - v_xl * u_xl) * ih
    v_zh = avg(vy, (0, 0, 0), (0, 0, 1))
    v_zl = avg(vy, (0, 0, -1), (0, 0, 0))
    w_zh_y = avg(vz, (0, 0, 0), (0, 1, 0))
    w_zl_y = avg(vz, (0, 0, -1), (0, 1, -1))
    dvw = (v_zh * w_zh_y - v_zl * w_zl_y) * ih
    new_vy = vy.c + dt * (-(dvu + dvv + dvw) + nu * lap(vy) + fy)

    # ---- z-momentum at z-face (k+1)h ------------------------------------
    wc_r = avg(vz, (0, 0, 0), (0, 0, 1))
    wc_l = avg(vz, (0, 0, -1), (0, 0, 0))
    dww = (wc_r * wc_r - wc_l * wc_l) * ih
    w_xh = avg(vz, (0, 0, 0), (1, 0, 0))
    w_xl = avg(vz, (-1, 0, 0), (0, 0, 0))
    u_xh_z = avg(vx, (0, 0, 0), (0, 0, 1))
    u_xl_z = avg(vx, (-1, 0, 0), (-1, 0, 1))
    dwu = (w_xh * u_xh_z - w_xl * u_xl_z) * ih
    w_yh = avg(vz, (0, 0, 0), (0, 1, 0))
    w_yl = avg(vz, (0, -1, 0), (0, 0, 0))
    v_yh_z = avg(vy, (0, 0, 0), (0, 0, 1))
    v_yl_z = avg(vy, (0, -1, 0), (0, -1, 1))
    dwv = (w_yh * v_yh_z - w_yl * v_yl_z) * ih
    new_vz = vz.c + dt * (-(dwu + dwv + dww) + nu * lap(vz) + fz)

    return {"vx": new_vx, "vy": new_vy, "vz": new_vz}


def divergence_body(ctx: KernelContext) -> dict:
    vx, vy, vz = ctx["vx"], ctx["vy"], ctx["vz"]
    ih = ctx.param("ih")
    div = (
        (vx.c - vx.at(-1, 0, 0))
        + (vy.c - vy.at(0, -1, 0))
        + (vz.c - vz.at(0, 0, -1))
    ) * ih
    return {"div": div}


def jacobi_pressure_body(ctx: KernelContext) -> dict:
    """Weighted Jacobi sweep: p' = (1-w) p + w (Σ nbr - h² rhs) / 6."""
    p, rhs = ctx["p"], ctx["rhs"]
    h2, omega, omc = ctx.param("h2"), ctx.param("omega"), ctx.param("omc")
    nbr = (
        p.at(1, 0, 0) + p.at(-1, 0, 0) + p.at(0, 1, 0) + p.at(0, -1, 0)
        + p.at(0, 0, 1) + p.at(0, 0, -1)
    )
    jac = true_divide(nbr - h2 * rhs.c, 6.0)
    return {"p": omc * p.c + omega * jac}


def project_velocity_body(ctx: KernelContext) -> dict:
    """u <- u - dt grad(p) at the faces (the Chorin projection correction)."""
    vx, vy, vz, p = ctx["vx"], ctx["vy"], ctx["vz"], ctx["p"]
    s = true_divide(ctx.param("dt"), ctx.param("h"))
    return {
        "vx": vx.c - s * (p.at(1, 0, 0) - p.c),
        "vy": vy.c - s * (p.at(0, 1, 0) - p.c),
        "vz": vz.c - s * (p.at(0, 0, 1) - p.c),
    }


BODIES = {
    "UPDATE_VELOCITY": update_velocity_body,
    "DIVERGENCE": divergence_body,
    "JACOBI_PRESSURE": jacobi_pressure_body,
    "PROJECT_VELOCITY": project_velocity_body,
}
# The parameter-table columns each CUDA kernel reads (csrc/stencil3d.cu),
# one row per slot: declared parameters and the terms derived from them.
TABLES = {
    "UPDATE_VELOCITY": ("dt", "ih", "ih2", "nu", "fx", "fy", "fz"),
    "DIVERGENCE": ("ih",),
    "JACOBI_PRESSURE": ("h2", "omega", "omc"),
    "PROJECT_VELOCITY": ("dt", "h"),
}
DESCRIPTORS = {
    "UPDATE_VELOCITY": UPDATE_VELOCITY,
    "DIVERGENCE": DIVERGENCE,
    "JACOBI_PRESSURE": JACOBI_PRESSURE,
    "PROJECT_VELOCITY": PROJECT_VELOCITY,
}
