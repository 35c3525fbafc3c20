"""Launch wrapper for the hand-written fused Jacobi smoother.

``jacobi_fused(p, rhs, h=, omega=, sweeps=k)`` runs ``k`` weighted-Jacobi
sweeps in one launch of ``csrc/jacobi.cu`` (JACOBI_FUSED), replacing the
reference's Pallas ``repro.kernels.jacobi.jacobi_fused``.  ``p`` and
``rhs`` are float32, C-contiguous, padded by ``k`` on every side of the
last three axes, with an optional leading slot axis; the result is the
interior.  ``h`` and ``omega`` are Python scalars, shared by every slot:
the kernel receives ``h*h`` and ``1 - omega`` computed in double and
rounded once to float32, the values the plain version's Python arithmetic
gives.  The wrapper checks all of that and raises on anything else.

On a CUDA tensor the wrapper allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and adds one to
``LAUNCHES["JACOBI_FUSED"]``.  On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.jacobi.jacobi_fused_ref`, which is also what the
kernel is checked against on the card (:func:`jacobi_fused_plain`).  On
a ``meta`` tensor (a cost trace) it books its declared cost
(``op_cost.jacobi_fused_cost``) and returns an empty output, launching
nothing.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from repro_torch.kernels.jacobi import jacobi_fused_ref

MAX_SWEEPS = 4          # the kernel's shared-memory rings take k <= 4
SEGMENT = 64            # output planes in x one block marches over

# launches since the last reset (CUDA launches only)
LAUNCHES = {"JACOBI_FUSED": 0}


def reset_launches() -> None:
    LAUNCHES["JACOBI_FUSED"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("jacobi")
    lib.jacobi_fused.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_float] * 3 + [ctypes.c_int]
        + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
    lib.jacobi_fused.restype = ctypes.c_int
    lib.jacobi_max_sweeps.restype = ctypes.c_int
    lib.jacobi_segment.restype = ctypes.c_int
    lib.jacobi_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.jacobi_blocks_per_sm.restype = ctypes.c_int
    lib.jacobi_error_string.argtypes = [ctypes.c_int]
    lib.jacobi_error_string.restype = ctypes.c_char_p
    if (lib.jacobi_max_sweeps(), lib.jacobi_segment()) != (MAX_SWEEPS, SEGMENT):
        raise RuntimeError("csrc/jacobi.cu and jacobi_cuda.MAX_SWEEPS/SEGMENT "
                           "disagree")
    return lib


def blocks_per_sm(sweeps: int) -> int:
    """Resident blocks of the kernel per SM for ``sweeps`` (its occupancy
    on the current card)."""
    got = _lib().jacobi_blocks_per_sm(sweeps)
    if got < 0:
        raise RuntimeError(f"JACOBI_FUSED occupancy query failed: CUDA error "
                           f"{-got} ({_lib().jacobi_error_string(-got).decode()})")
    return got


def _check(p, rhs, h, omega, sweeps) -> tuple[int, int, int]:
    """Validate a call; return the interior shape."""
    if not isinstance(sweeps, numbers.Integral) or sweeps < 1:
        raise ValueError(f"JACOBI_FUSED: sweeps must be an int >= 1, got {sweeps!r}")
    for name, v in (("h", h), ("omega", omega)):
        if not isinstance(v, numbers.Real):
            raise TypeError(f"JACOBI_FUSED: {name} must be a Python scalar, "
                            f"got {type(v).__name__}")
    for name, t in (("p", p), ("rhs", rhs)):
        if not torch.is_tensor(t) or t.dim() not in (3, 4):
            raise ValueError(f"JACOBI_FUSED: {name} must be ([S,] X, Y, Z)")
        if t.dtype != torch.float32:
            raise TypeError(f"JACOBI_FUSED: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"JACOBI_FUSED: {name} is not contiguous")
    if p.shape != rhs.shape or p.device != rhs.device:
        raise ValueError(f"JACOBI_FUSED: p {tuple(p.shape)} on {p.device} and "
                         f"rhs {tuple(rhs.shape)} on {rhs.device} differ")
    interior = tuple(n - 2 * sweeps for n in p.shape[-3:])
    if min(interior) < 1:
        raise ValueError(f"JACOBI_FUSED: {tuple(p.shape)} padded by {sweeps} "
                         f"leaves an empty interior {interior}")
    return interior


def _run(p, rhs, h, omega, sweeps, plain: bool):
    nx, ny, nz = _check(p, rhs, h, omega, sweeps)
    if plain or p.device.type == "cpu":
        return jacobi_fused_ref(p, rhs, h=h, omega=omega, sweeps=sweeps)
    if p.device.type not in ("cuda", "meta"):
        raise ValueError(f"JACOBI_FUSED: unsupported device {p.device}")
    if sweeps > MAX_SWEEPS:
        raise ValueError(f"JACOBI_FUSED: the kernel takes sweeps <= "
                         f"{MAX_SWEEPS}, got {sweeps}")
    lead = p.shape[:-3]
    S = p.shape[0] if lead else 1
    out = torch.empty((*lead, nx, ny, nz), dtype=torch.float32, device=p.device)
    if p.device.type == "meta":
        from repro_torch.launch import op_cost

        op_cost.book("JACOBI_FUSED", *op_cost.jacobi_fused_cost(p, rhs, out,
                                                                sweeps))
        return out
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.jacobi_fused(p.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                               h * h, omega, 1.0 - omega, sweeps,
                               S, nx, ny, nz, stream)
    if err != 0:
        raise RuntimeError(f"JACOBI_FUSED kernel launch failed: CUDA error "
                           f"{err} ({lib.jacobi_error_string(err).decode()})")
    LAUNCHES["JACOBI_FUSED"] += 1
    return out


def jacobi_fused(p, rhs, *, h, omega=1.0, sweeps=1):
    """k sweeps in one launch on the card; the plain version on the CPU."""
    return _run(p, rhs, h, omega, sweeps, plain=False)


def jacobi_fused_plain(p, rhs, *, h, omega=1.0, sweeps=1):
    """The plain version, on any device, with the wrapper's checks."""
    return _run(p, rhs, h, omega, sweeps, plain=True)
