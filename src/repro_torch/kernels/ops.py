"""Public wrappers around the kernels of this package.

Each op dispatches between the CUDA template (the hand-written Hopper
kernels) and the TORCH template (the eager expansion of the body, or the
kernel's plain version).  The CFD solver and the LM stack call these or the
model functions, never the launch wrappers directly.  Fields with a
leading slot axis ``(S, X, Y, Z)`` go to ``GeneratedKernel.apply_batched``,
with every ``(S,)`` tensor parameter as a per-slot one: one launch advances
every slot.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.generator import generate
from repro_torch.device import default_template, resolve_template
from repro_torch.kernels import (
    attention as attention_plain, attention_cuda, autograd, jacobi_cuda,
    ssd_cuda, stencil3d, stencil3d_cuda,
)
from repro_torch.kernels.jacobi import jacobi_fused_ref
from repro_torch.kernels.ref import MaskSpec
from repro_torch.kernels.ssd import ssd_intra_reference
from repro_torch.obs.spans import span


@functools.lru_cache(maxsize=None)
def _kernel(name: str, template: str, tile: tuple | None):
    return generate(stencil3d.DESCRIPTORS[name], stencil3d.BODIES[name],
                    template=template, tile=tile)


def _auto_tile(name: str, arrays: dict, padded: bool = True) -> tuple:
    """The autotuned launch tile for this kernel's local interior.

    Resolved from one slot's interior (the slot axis is no part of it), so
    the farm's batched call and a serial run of the same grid tune
    identically: the memoized choice lives in ``autotune._TILE_CACHE``."""
    from repro_torch.core import autotune

    desc = stencil3d.DESCRIPTORS[name]
    first = arrays[desc.inputs[0]]
    space = tuple(first.shape[-3:])
    if padded and desc.inputs[0] in desc.cached_inputs:
        space = tuple(s - lo - hi for s, lo, hi in
                      zip(space, desc.halo_lo, desc.halo_hi))
    return autotune.tile_for(desc, space, itemsize=first.element_size()).tile


def apply_kernel(name: str, arrays: dict, *, template: str | None = None,
                 tile: tuple | str | None = None, ghosts=None, **params):
    """Run one descriptor kernel.  ``tile`` is the CUDA template's launch
    tile: a concrete ``(tx, ty, tz)``, ``"auto"`` for the autotuner's
    chip-aware choice (:func:`repro_torch.core.autotune.tile_for`), or
    ``None`` for the wrapper's ``block_for``; the TORCH template has no
    tiles and ignores it, as the reference's JNP template does.
    ``ghosts`` (CUDA template, ``stencil3d_cuda.GHOSTED`` kernels): the
    cached fields are unpadded and the kernel makes their ghost values from
    these faces (:func:`ghosted_inputs`, :func:`bound_ghosts`); for a
    kernel whose ghosted load sets its own launch
    (``stencil3d_cuda.OWN_TILE``) ``"auto"`` resolves to that launch."""
    first = arrays[stencil3d.DESCRIPTORS[name].inputs[0]]
    tmpl = template or default_template(first.device)
    if tmpl != "CUDA" or (tile == "auto" and ghosts is not None
                          and name in stencil3d_cuda.OWN_TILE):
        tile = None          # no tiles, or the kernel's own launch
    elif tile == "auto":
        tile = _auto_tile(name, arrays, padded=ghosts is None)
    kern = _kernel(name, tmpl, None if tile is None else tuple(tile))
    if first.dim() == 3:
        return kern(arrays, ghosts=ghosts, **params)
    per_slot = tuple(k for k, v in params.items()
                     if torch.is_tensor(v) and v.dim() == 1)
    return kern.apply_batched(arrays, batched_params=per_slot, ghosts=ghosts,
                              **params)


def ghosted_inputs(name: str, fields, specs) -> tuple:
    """The CUDA template's inputs for a GHOSTED kernel's cached
    ``fields`` (each with its three :class:`~repro_torch.core.halo.AxisSpec`
    in ``specs``): their strips are exchanged
    (:func:`~repro_torch.core.halo.exchange_strips`, nothing padded) and
    ``(fields, ghosts)`` returned, the fields unpadded beside their faces.
    Where a face's rule declares no form, ``(padded fields, None)``: each
    field padded with the strips in hand, the kernel's padded load, counted
    in ``stencil3d_cuda.PADDED_ROUTE[name]``."""
    from repro_torch.core import halo

    with span("ops.ghosted_inputs"):
        widths = (1, 1, 1)
        strips = [halo.exchange_strips(u, widths, sp)
                  for u, sp in zip(fields, specs)]
        ghosts = [halo.field_ghosts(sp, st)
                  for sp, st in zip(specs, strips)]
        if all(g is not None for g in ghosts):
            return list(fields), ghosts
        stencil3d_cuda.PADDED_ROUTE[name] += 1
        return [halo.pad_with_strips(u, widths, sp, st)
                for u, sp, st in zip(fields, specs, strips)], None


def bound_ghosts(name: str, fields, specs):
    """The faces of a GHOSTED kernel's cached ``fields`` (each with its
    three specs in ``specs``) bound once for every launch that shares them
    (``stencil3d_cuda.bind_ghosts``): where no axis is decomposed, so no
    strip travels and the faces stay the same for a whole step.  None
    where an axis is decomposed or a rule declares no form: each launch
    then takes :func:`ghosted_inputs`."""
    from repro_torch.core import halo

    if any(s.mesh_axis is not None for sp in specs for s in sp):
        return None
    with span("ops.bound_ghosts"):
        ghosts = [halo.field_ghosts(sp) for sp in specs]
        if any(g is None for g in ghosts):
            return None
        return stencil3d_cuda.bind_ghosts(name, ghosts, fields[0])


# -- convenience wrappers (the public op surface) ---------------------------
def update_velocity(vx, vy, vz, *, dt, h, nu, fx=0.0, fy=0.0, fz=0.0, **kw):
    out = apply_kernel(
        "UPDATE_VELOCITY", {"vx": vx, "vy": vy, "vz": vz},
        dt=dt, h=h, nu=nu, fx=fx, fy=fy, fz=fz, **kw)
    return out["vx"], out["vy"], out["vz"]


def divergence(vx, vy, vz, *, h, **kw):
    return apply_kernel("DIVERGENCE", {"vx": vx, "vy": vy, "vz": vz}, h=h, **kw)["div"]


def jacobi_pressure(p, rhs, *, h, omega=1.0, **kw):
    return apply_kernel("JACOBI_PRESSURE", {"p": p, "rhs": rhs},
                        h=h, omega=omega, **kw)["p"]


def project_velocity(vx, vy, vz, p, *, dt, h, **kw):
    out = apply_kernel(
        "PROJECT_VELOCITY", {"vx": vx, "vy": vy, "vz": vz, "p": p},
        dt=dt, h=h, **kw)
    return out["vx"], out["vy"], out["vz"]


def jacobi_smooth(p, rhs, *, h, omega=1.0, sweeps=1, template=None):
    """Communication-avoiding fused smoother; inputs padded by ``sweeps``.

    ``TORCH`` runs the plain ``jacobi_fused_ref``, ``CUDA`` the hand-written
    JACOBI_FUSED kernel (``jacobi_cuda.jacobi_fused``), which takes any
    interior shape and a leading slot axis."""
    if resolve_template(template, p.device) == "TORCH":
        return jacobi_fused_ref(p, rhs, h=h, omega=omega, sweeps=sweeps)
    return jacobi_cuda.jacobi_fused(p, rhs, h=h, omega=omega, sweeps=sweeps)


def mha(q, k, v, *, causal=True, q_offset=0, template=None, block_q=128,
        block_k=128):
    """Attention hot-spot: the FLASH_ATTENTION kernel on the card, else the
    plain chunked online softmax.

    q: (H, Sq, D); k/v: (Hkv, Sk, D).  The mask is a ``MaskSpec`` built from
    ``causal`` and ``q_offset`` on both routes (the reference's non-TPU
    branch passes them to ``chunked_mha`` as keywords it does not take).
    """
    if resolve_template(template, q.device) == "TORCH":
        return attention_plain.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, block_q=block_q,
            block_k=block_k)
    to, back = attention_plain.to_bshd, attention_plain.from_bshd
    return back(attention_cuda.flash_attention(
        to(q), to(k), to(v), MaskSpec(causal=causal, q_offset=q_offset)))


def ssd_intra(x, log_decay, in_scale, b_, c_, s_in, *, template=None):
    """Intra-chunk SSD (shapes as ``kernels.ssd.ssd_intra_reference``): the
    SSD_INTRA kernel on the card, else its plain version.  When autograd
    records the call, the kernel goes through ``autograd.SSDIntraFn`` (the
    plain version's gradient)."""
    if resolve_template(template, x.device) == "TORCH":
        return ssd_intra_reference(x, log_decay, in_scale, b_, c_, s_in)
    args = [t.contiguous() for t in (x, log_decay, in_scale, b_, c_, s_in)]
    if autograd.wants_grad(*args):
        return autograd.ssd_intra(*args)
    return ssd_cuda.ssd_intra(*args)
