"""Launch wrapper for the hand-written FLASH_ATTENTION kernel.

``flash_attention(q, k, v, spec, kv_valid_len, scale)`` computes the
attention of the reference's ``__kernel__attention`` regions
(``models/attention.py``: ``full_mha``, ``chunked_mha``) in one launch of
``csrc/attention.cu``, replacing the reference's Pallas
``repro.kernels.attention.flash_attention``.

Layout BSHD: q (B, Sq, H, D), k/v (B, Sk, KH, D) with H a multiple of KH
and D in ``HEAD_DIMS`` (32, 64, 112, 128, 256; any other raises); each may
be a strided view whose last dimension is contiguous (the decode path passes
its cache directly).  q is bfloat16 or float32; k and v are bfloat16 or
float32 and are read in q's dtype.
``spec`` is a ``MaskSpec`` (causal, q_offset, prefix_len); ``kv_valid_len``
is None, an int, a 0-d tensor or a (B,) integer tensor on q's device.  The
output is a new contiguous (B, Sq, H, D) tensor in q's dtype.  The wrapper
checks all of that and raises on anything else.

The kernel has three routes, chosen by :func:`route` from q's dtype, k/v's
dtype and Sq (``csrc/attention.cu`` explains each design):

    q dtype   k/v dtype        Sq     route
    bfloat16  bfloat16         > 8    tensor_core_prefill  (mma.sync bf16)
    bfloat16  bf16 or float32  <= 8   split_k_decode       (flash-decoding)
    bfloat16  float32          > 8    cuda_core            (float32 FMAs)
    float32   any              any    cuda_core

The two new routes load 16 bytes at a time, so they need k and v (and, for
the prefill, q) with 16-byte aligned rows; the wrapper raises otherwise.
The split-K decode writes per-split partials into a ``torch.empty``
workspace and merges them in the same launch through ticket counters that
the wrapper zeroes once per (device, stream) and the kernel leaves at 0.
Launches on one stream are ordered, so the calls on a stream share its
counters; launches on two streams of one card may run at once, so each
stream has counters of its own.

On a CUDA tensor the wrapper launches the kernel on the current stream
without synchronising and adds one to ``LAUNCHES["FLASH_ATTENTION"]`` and to
``ROUTE_LAUNCHES[route]``.  On a CPU tensor it runs the plain version,
``kernels.ref.full_mha_reference``, which is also what the kernel is
checked against on the card (:func:`flash_attention_plain`).  On a
``meta`` tensor (a cost trace) it books its declared cost
(``op_cost.flash_attention_cost``, every key valid) and returns an empty
output, launching nothing.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from repro_torch.kernels.ref import full_mha_reference

HEAD_DIMS = (32, 64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_core_prefill", "split_k_decode", "cuda_core")
DECODE_MAX_SQ = 8        # the split-K decode takes Sq <= 8 query rows

# launches since the last reset (CUDA launches only), in all and by route
LAUNCHES = {"FLASH_ATTENTION": 0}
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)

# the split-K decode's ticket counters, per (device, CUDA stream handle):
# zeroed once, left at 0 by every launch
_TICKETS: dict = {}


def reset_launches() -> None:
    LAUNCHES["FLASH_ATTENTION"] = 0
    for name in ROUTES:
        ROUTE_LAUNCHES[name] = 0


def route(q_dtype, kv_dtype, sq: int) -> str:
    """The kernel route for q's dtype, k/v's dtype and Sq (the table in
    the module docstring)."""
    if q_dtype == torch.bfloat16 and sq <= DECODE_MAX_SQ:
        return "split_k_decode"
    if q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16:
        return "tensor_core_prefill"
    return "cuda_core"


def decode_rows(sq: int, rep: int) -> tuple[int, int]:
    """(rows a block, row groups) of the split-K decode: a block serves the
    Sq x rep query rows of one kv head, at most 8 of them."""
    rows = sq * rep
    per_block = next(n for n in (1, 2, 4, 8) if n >= min(rows, 8))
    return per_block, -(-rows // per_block)


def decode_split(per_block: int) -> int:
    """Keys a split-K decode block takes (``csrc/attention.cu``
    ``dec::split_keys``): 256, or 128 where a block serves 4 or more rows."""
    return 128 if per_block >= 4 else 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("attention")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    common = ([ptr] * 4 + [ctypes.c_int] * 2 + [i64] * 5 + [ctypes.c_int]
              + [i64] * 9 + [ctypes.c_float, ctypes.c_int, i64, i64, ptr, i64])
    for fn in (lib.flash_attention, lib.flash_attention_prefill):
        fn.argtypes = common + [ptr]
        fn.restype = ctypes.c_int
    lib.flash_attention_decode.argtypes = (
        common + [ctypes.c_int] * 2 + [ptr] * 4)
    lib.flash_attention_decode.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def check_rows_aligned(t, name: str, why: str) -> None:
    """Raise unless every (b, s, h) row of ``t`` starts on 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(n > 1 and st * size % 16 for n, st in
                                zip(t.shape[:3], t.stride()[:3])):
        raise ValueError(f"FLASH_ATTENTION: {name}'s rows are not 16-byte "
                         f"aligned (strides {tuple(t.stride())}); the {why} "
                         "route loads 16 bytes at a time")


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters of ``stream`` (its ``cuda_stream``
    handle) on ``device``, made on that stream when first asked for."""
    key = (device, stream)
    have = _TICKETS.get(key)
    if have is None or have.numel() < n:
        have = _TICKETS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return have


def _check(q, k, v, kv_valid_len) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.dim() != 4:
            raise ValueError(f"FLASH_ATTENTION: {name} must be (B, S, H, D)")
        if t.dtype not in _DTYPES:
            raise TypeError(f"FLASH_ATTENTION: {name} is {t.dtype}, not "
                            "bfloat16 or float32")
        if t.stride(-1) != 1:
            raise ValueError(f"FLASH_ATTENTION: {name}'s last dimension is "
                             "not contiguous")
        if t.device != q.device:
            raise ValueError(f"FLASH_ATTENTION: {name} on {t.device}, q on "
                             f"{q.device}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"FLASH_ATTENTION: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if k.shape[2] < 1 or h % k.shape[2] or sq < 1 or k.shape[1] < 1:
        raise ValueError(f"FLASH_ATTENTION: {h} heads over {k.shape[2]} kv "
                         f"heads, Sq {sq}, Sk {k.shape[1]}")
    if torch.is_tensor(kv_valid_len):
        if kv_valid_len.dim() not in (0, 1) or kv_valid_len.is_floating_point():
            raise ValueError("FLASH_ATTENTION: kv_valid_len must be an integer "
                             "scalar or (B,) tensor")
        if kv_valid_len.dim() == 1 and kv_valid_len.shape[0] != b:
            raise ValueError(f"FLASH_ATTENTION: kv_valid_len has "
                             f"{kv_valid_len.shape[0]} rows, batch is {b}")
    elif kv_valid_len is not None and not isinstance(kv_valid_len,
                                                     numbers.Integral):
        raise TypeError("FLASH_ATTENTION: kv_valid_len must be None, an int "
                        "or an integer tensor")


def _launch(q, k, v, spec, kv_valid_len, scale):
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"FLASH_ATTENTION: head dim {d} not in {HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"FLASH_ATTENTION: B x H = {b * h} > 65535")
    valid_ptr, valid_all = None, sk
    if torch.is_tensor(kv_valid_len):
        if kv_valid_len.device != q.device:
            raise ValueError("FLASH_ATTENTION: kv_valid_len is on "
                             f"{kv_valid_len.device}, q on {q.device}")
        if kv_valid_len.dim() == 0:
            kv_valid_len = kv_valid_len.expand(b)
        valid = kv_valid_len.to(torch.int64).contiguous()
        valid_ptr = valid.data_ptr()
    elif kv_valid_len is not None:
        valid_all = int(kv_valid_len)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    path = route(q.dtype, k.dtype, sq)
    if path == "tensor_core_prefill":
        check_rows_aligned(q, "q", path)
    if path != "cuda_core":
        check_rows_aligned(k, "k", path)
        check_rows_aligned(v, "v", path)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], _DTYPES[k.dtype], b, sq, sk, h, kh, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                float(scale), int(bool(spec.causal)), int(spec.q_offset),
                int(spec.prefix_len), valid_ptr, valid_all)
        if path == "split_k_decode":
            per_block, groups = decode_rows(sq, h // kh)
            n_split = -(-sk // decode_split(per_block))
            parts = b * kh * groups * n_split * per_block
            acc = torch.empty(parts * d, dtype=torch.float32, device=q.device)
            ml = torch.empty(parts * 2, dtype=torch.float32, device=q.device)
            tickets = _tickets(q.device, stream, b * kh * groups)
            err = lib.flash_attention_decode(
                *args, per_block, groups, acc.data_ptr(), ml.data_ptr(),
                tickets.data_ptr(), stream)
        elif path == "tensor_core_prefill":
            err = lib.flash_attention_prefill(*args, stream)
        else:
            err = lib.flash_attention(*args, stream)
    if err != 0:
        raise RuntimeError(f"FLASH_ATTENTION kernel launch failed ({path}): "
                           f"CUDA error {err} "
                           f"({lib.attention_error_string(err).decode()})")
    LAUNCHES["FLASH_ATTENTION"] += 1
    ROUTE_LAUNCHES[path] += 1
    return out


def _run(q, k, v, spec, kv_valid_len, scale, plain: bool):
    _check(q, k, v, kv_valid_len)
    if plain or q.device.type == "cpu":
        return full_mha_reference(q, k, v, spec, kv_valid_len, scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"FLASH_ATTENTION: unsupported device {q.device}")
    if k.dtype != v.dtype:
        raise TypeError(f"FLASH_ATTENTION: k is {k.dtype}, v is {v.dtype}")
    if q.device.type == "meta":
        return _book(q, k, spec, kv_valid_len)
    return _launch(q, k, v, spec, kv_valid_len, scale)


def _book(q, k, spec, kv_valid_len):
    """A cost trace's call: the declared cost booked, an empty output.  The
    valid lengths of a ``meta`` call are not known, so every key counts as
    valid (the most the call could need)."""
    from repro_torch.launch import op_cost

    b, sq, h, d = q.shape
    mask = op_cost.attention_mask(b, sq, k.shape[1], spec.causal,
                                  spec.q_offset, spec.prefix_len)
    nbytes, ops = op_cost.flash_attention_cost(q, k, mask)
    if torch.is_tensor(kv_valid_len):
        nbytes += b * 8
    op_cost.book("FLASH_ATTENTION", nbytes, ops)
    return torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)


def flash_attention(q, k, v, spec, kv_valid_len=None, scale=None):
    """One launch of the kernel on the card; the plain version on the CPU."""
    return _run(q, k, v, spec, kv_valid_len, scale, plain=False)


def flash_attention_plain(q, k, v, spec, kv_valid_len=None, scale=None):
    """The plain version, on any device, with the wrapper's checks."""
    return _run(q, k, v, spec, kv_valid_len, scale, plain=True)
