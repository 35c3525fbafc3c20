"""Launch wrapper for the hand-written SSD_INTRA kernel.

``ssd_intra(x, log_decay, in_scale, b_, c_, s_in)`` computes the
intra-chunk SSD of the reference's ``__kernel__ssd`` region
(``models/mamba2.py:ssd_core``) in one launch of ``csrc/ssd.cu``, replacing
the reference's Pallas ``repro.kernels.ssd.ssd_intra_pallas``.

Shapes: x (B, nc, L, G, R, P), log_decay/in_scale (B, nc, L, G, R),
b_/c_ (B, nc, L, G, N), s_in (B, nc, G, R, N, P), all float32 and
C-contiguous on one device, with L <= 256, N <= 512 and P <= 512 (the
zamba2 chunk's N 64 / P 64 and the mLSTM's N 384 / P 385 among them); the
result is a new (B, nc, L, G, R, P) float32 tensor.  The wrapper checks all
of that and raises on anything else.

On a CUDA tensor the wrapper launches the kernel on the current stream
without synchronising and adds one to ``LAUNCHES["SSD_INTRA"]``.  On a CPU
tensor it runs the plain version, :func:`repro_torch.kernels.ssd.
ssd_intra_reference`, which is also what the kernel is checked against on
the card (:func:`ssd_intra_plain`).  On a ``meta`` tensor (a cost trace)
it books its declared cost (``op_cost.ssd_intra_cost``) and returns an
empty output, launching nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ssd import ssd_intra_reference

MAX_L, MAX_N, MAX_P = 256, 512, 512     # csrc/ssd.cu's kMaxL, kMaxN, kMaxP

# launches since the last reset (CUDA launches only)
LAUNCHES = {"SSD_INTRA": 0}


def reset_launches() -> None:
    LAUNCHES["SSD_INTRA"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("ssd")
    lib.ssd_intra.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                              + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_intra.restype = ctypes.c_int
    lib.ssd_max_dims.argtypes = [ctypes.c_int]
    lib.ssd_max_dims.restype = ctypes.c_int
    lib.ssd_heads_per_block.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 4
    lib.ssd_heads_per_block.restype = ctypes.c_int
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    if tuple(lib.ssd_max_dims(i) for i in range(3)) != (MAX_L, MAX_N, MAX_P):
        raise RuntimeError("csrc/ssd.cu and ssd_cuda.MAX_* disagree")
    return lib


def heads_per_block(x) -> int:
    """Heads one block of the kernel takes for an x of shape
    (B, nc, L, G, R, P) on the current card."""
    bsz, nc, l, g, r, p = x.shape
    return _lib().ssd_heads_per_block(bsz * nc, l, g, r, p)


def _check(x, log_decay, in_scale, b_, c_, s_in) -> tuple:
    """Validate a call; return (B, nc, L, G, R, N, P)."""
    named = (("x", x, 6), ("log_decay", log_decay, 5),
             ("in_scale", in_scale, 5), ("b_", b_, 5), ("c_", c_, 5),
             ("s_in", s_in, 6))
    for name, t, nd in named:
        if not torch.is_tensor(t) or t.dim() != nd:
            raise ValueError(f"SSD_INTRA: {name} must have {nd} dimensions")
        if t.dtype != torch.float32:
            raise TypeError(f"SSD_INTRA: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"SSD_INTRA: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError(f"SSD_INTRA: {name} on {t.device}, x on "
                             f"{x.device}")
    bsz, nc, l, g, r, p = x.shape
    n = b_.shape[-1]
    want = {"log_decay": (bsz, nc, l, g, r), "in_scale": (bsz, nc, l, g, r),
            "b_": (bsz, nc, l, g, n), "c_": (bsz, nc, l, g, n),
            "s_in": (bsz, nc, g, r, n, p)}
    for name, t, _ in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"SSD_INTRA: {name} is {tuple(t.shape)}, "
                             f"expected {want[name]}")
    return bsz, nc, l, g, r, n, p


def _run(x, log_decay, in_scale, b_, c_, s_in, plain: bool):
    bsz, nc, l, g, r, n, p = _check(x, log_decay, in_scale, b_, c_, s_in)
    if plain or x.device.type == "cpu":
        return ssd_intra_reference(x, log_decay, in_scale, b_, c_, s_in)
    if x.device.type == "meta":
        from repro_torch.launch import op_cost

        y = torch.empty_like(x)
        op_cost.book("SSD_INTRA", *op_cost.ssd_intra_cost(
            (x, log_decay, in_scale, b_, c_, s_in), y))
        return y
    if x.device.type != "cuda":
        raise ValueError(f"SSD_INTRA: unsupported device {x.device}")
    if l > MAX_L or n > MAX_N or p > MAX_P:
        raise ValueError(f"SSD_INTRA: the kernel takes L <= {MAX_L}, N <= "
                         f"{MAX_N}, P <= {MAX_P}; got L {l}, N {n}, P {p}")
    if r > 65535 or bsz * nc * g > 65535:
        raise ValueError(f"SSD_INTRA: grid too large (R {r}, B·nc·G "
                         f"{bsz * nc * g})")
    lib = _lib()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_intra(x.data_ptr(), log_decay.data_ptr(),
                            in_scale.data_ptr(), b_.data_ptr(), c_.data_ptr(),
                            s_in.data_ptr(), y.data_ptr(), bsz * nc, l, g, r,
                            n, p, stream)
    if err != 0:
        raise RuntimeError(f"SSD_INTRA kernel launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    LAUNCHES["SSD_INTRA"] += 1
    return y


def ssd_intra(x, log_decay, in_scale, b_, c_, s_in):
    """One launch of the kernel on the card; the plain version on the CPU."""
    return _run(x, log_decay, in_scale, b_, c_, s_in, plain=False)


def ssd_intra_plain(x, log_decay, in_scale, b_, c_, s_in):
    """The plain version, on any device, with the wrapper's checks."""
    return _run(x, log_decay, in_scale, b_, c_, s_in, plain=True)
