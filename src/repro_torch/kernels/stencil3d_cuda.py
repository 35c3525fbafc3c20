"""Launch wrappers for the hand-written CUDA stencil kernels.

One wrapper per kernel of ``csrc/stencil3d.cu``, each replacing one
instance of the reference's 3DBLOCK Pallas template
(``repro.core.generator.GeneratedKernel._apply_pallas``):

  update_velocity(vx, vy, vz, table, tile=None)      UPDATE_VELOCITY
  divergence(vx, vy, vz, table, tile=None)           DIVERGENCE
  jacobi_pressure(p, rhs, table, tile=None)          JACOBI_PRESSURE
  project_velocity(vx, vy, vz, p, table, tile=None)  PROJECT_VELOCITY

Inputs are float32, C-contiguous, padded as the descriptor declares
(cached inputs by the stencil radii, uncached ones interior-shaped), with
an optional leading slot axis S; ``table`` is the ``(S, n_params)`` float32
parameter table (``(n_params,)`` unbatched) with the columns of
``stencil3d.TABLES[name]`` (``generator.param_table`` builds it), on the
same device.  ``tile`` is the launch's ``(tx, ty, tz)``: a block of
``tz x ty`` threads (z, the contiguous axis, first) walking ``tx``
consecutive (slot, x) rows; ``None`` takes :func:`block_for`, the
autotuner's choice comes from ``repro_torch.core.autotune.tile_for``.  Every
tile gives the same bits.  A wrapper checks all of that
(:func:`check_tile` for the tile) and raises on anything else.

On a CUDA tensor the wrapper allocates its outputs with ``torch.empty``,
launches the kernel on the current stream without synchronising, and adds
one to ``LAUNCHES[name]``.  On a CPU tensor it runs the kernel's plain
version (``<kernel>_plain``: the descriptor body expanded eagerly, reading
its parameters from the same table), which is also what the card's kernels
are checked against.  On a ``meta`` tensor (a cost trace,
:mod:`repro_torch.launch.op_cost`) it books its declared bytes and
operations with the active counter and returns ``torch.empty`` outputs:
nothing is launched or counted in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.generator import generate
from repro_torch.kernels import stencil3d

_C_NAMES = {
    "UPDATE_VELOCITY": "stencil3d_update_velocity",
    "DIVERGENCE": "stencil3d_divergence",
    "JACOBI_PRESSURE": "stencil3d_jacobi_pressure",
    "PROJECT_VELOCITY": "stencil3d_project_velocity",
}

# launches per kernel since the last reset (CUDA launches only)
LAUNCHES = dict.fromkeys(_C_NAMES, 0)

# the most threads a block may have: the kernels' __launch_bounds__
# (kThreads in csrc/stencil3d.cu)
MAX_THREADS = 256
# registers a thread of each kernel uses, (tx = 1, tx > 1): its two
# instantiations, from the ptxas report of the sm_90a build
# (build/kernels/libstencil3d-*.log; chip_smoke.py's build phase prints
# it).  The autotuner's occupancy model reads these constants, never the
# build, so the CPU and the card tune alike.
REGISTERS = {"UPDATE_VELOCITY": (40, 40), "DIVERGENCE": (32, 32),
             "JACOBI_PRESSURE": (32, 40), "PROJECT_VELOCITY": (32, 32)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("stencil3d")
    for name, cname in _C_NAMES.items():
        desc = stencil3d.DESCRIPTORS[name]
        n_ptr = len(desc.inputs) + len(desc.outputs) + 1      # + the table
        fn = getattr(lib, cname)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.stencil3d_error_string.argtypes = [ctypes.c_int]
    lib.stencil3d_error_string.restype = ctypes.c_char_p
    return lib


def _interior(desc, inputs) -> tuple[int, int, int]:
    """The interior shape every input agrees on, or raise."""
    interior = None
    for name, t in zip(desc.inputs, inputs):
        cached = name in desc.cached_inputs
        lo = desc.halo_lo if cached else (0, 0, 0)
        hi = desc.halo_hi if cached else (0, 0, 0)
        got = tuple(s - l - h for s, l, h in zip(t.shape[-3:], lo, hi))
        if interior is None:
            interior = got
        elif got != interior:
            raise ValueError(
                f"{desc.name}: input {name!r} of shape {tuple(t.shape)} "
                f"implies interior {got}, others {interior}")
    if min(interior) < 1:
        raise ValueError(f"{desc.name}: empty interior {interior}")
    return interior


def block_for(ny: int, nz: int) -> tuple[int, int, int]:
    """The default tile ``(1, by, bz)``: up to 32 threads along z (the
    contiguous axis), the rest of ``MAX_THREADS`` along y, shrunk for small
    interiors so thin shells do not launch idle threads."""
    bz = 1
    while bz < nz and bz < 32:
        bz <<= 1
    by = MAX_THREADS // bz
    while by > 1 and by // 2 >= ny:
        by >>= 1
    return (1, by, bz)


def check_tile(tile, interior, name: str = "stencil") -> tuple[int, int, int]:
    """``tile`` as a tuple of three ints, or raise.

    Legal: every extent at least 1; ``tx`` at most the interior's x extent;
    ``ty`` and ``tz`` below twice the interior's extent (a block at most
    half idle along an axis, as :func:`block_for`'s are); ``ty * tz`` at
    most ``MAX_THREADS``."""
    try:
        tx, ty, tz = (int(t) for t in tile)
    except (TypeError, ValueError):
        raise ValueError(f"{name}: tile must be three ints (tx, ty, tz), "
                         f"got {tile!r}") from None
    if (tx, ty, tz) != tuple(tile):
        raise ValueError(f"{name}: tile must be three ints, got {tile!r}")
    nx, ny, nz = interior
    if min(tx, ty, tz) < 1 or tx > nx or ty >= 2 * ny or tz >= 2 * nz:
        raise ValueError(f"{name}: tile {tile} does not fit the interior "
                         f"{tuple(interior)} (1 <= tx <= nx, 1 <= ty < 2 ny, "
                         f"1 <= tz < 2 nz)")
    if ty * tz > MAX_THREADS:
        raise ValueError(f"{name}: tile {tile} has {ty * tz} threads a block, "
                         f"more than the kernels' {MAX_THREADS}")
    return tx, ty, tz


def _check(desc, inputs, table) -> tuple[int, tuple[int, int, int]]:
    """Validate a batched call; return (S, interior)."""
    dev = inputs[0].device
    for name, t in zip(desc.inputs, inputs):
        if t.dim() != 4:
            raise ValueError(f"{desc.name}: input {name!r} must be (S, X, Y, Z), "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{desc.name}: input {name!r} is {t.dtype}, not float32")
        if t.device != dev:
            raise ValueError(f"{desc.name}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{desc.name}: input {name!r} is not contiguous")
    S = inputs[0].shape[0]
    if any(t.shape[0] != S for t in inputs):
        raise ValueError(f"{desc.name}: slot counts differ: "
                         f"{[t.shape[0] for t in inputs]}")
    columns = stencil3d.TABLES[desc.name]
    want = (S, len(columns))
    if tuple(table.shape) != want:
        raise ValueError(f"{desc.name}: parameter table must be {want} "
                         f"({columns}), got {tuple(table.shape)}")
    if (table.dtype != torch.float32 or table.device != dev
            or not table.is_contiguous()):
        raise ValueError(f"{desc.name}: parameter table must be contiguous "
                         f"float32 on {dev}")
    return S, _interior(desc, inputs)


@functools.lru_cache(maxsize=None)
def _torch_kernel(name: str):
    return generate(stencil3d.DESCRIPTORS[name], stencil3d.BODIES[name],
                    template="TORCH")


def _plain(name: str, inputs, table) -> tuple[torch.Tensor, ...]:
    """The plain version: the body expanded eagerly, one table row per slot
    (the body reads each table column as the parameter of its name)."""
    desc = stencil3d.DESCRIPTORS[name]
    params = {c: table[:, i].reshape(-1, 1, 1, 1)
              for i, c in enumerate(stencil3d.TABLES[name])}
    out = _torch_kernel(name)._apply_torch(dict(zip(desc.inputs, inputs)),
                                           params)
    return tuple(out[n] for n in desc.outputs)


def _run(name: str, inputs, table, plain: bool = False, tile=None):
    desc = stencil3d.DESCRIPTORS[name]
    batched = inputs[0].dim() == 4
    if not batched:
        inputs = [t.unsqueeze(0) for t in inputs]
        table = table.unsqueeze(0)
    S, (nx, ny, nz) = _check(desc, inputs, table)
    tx, ty, tz = (block_for(ny, nz) if tile is None
                  else check_tile(tile, (nx, ny, nz), name))
    dev = inputs[0].device
    if plain or dev.type == "cpu":
        outs = _plain(name, inputs, table)
    elif dev.type in ("cuda", "meta"):
        outs = tuple(torch.empty((S, nx, ny, nz), dtype=torch.float32,
                                 device=dev) for _ in desc.outputs)
        if dev.type == "meta":
            from repro_torch.launch import op_cost

            op_cost.book(name, *op_cost.stencil_cost(name, inputs, outs,
                                                     table))
        else:
            _launch(name, inputs, outs, table, (tx, ty, tz))
    else:
        raise ValueError(f"{name}: unsupported device {dev}")
    if not batched:
        outs = tuple(o[0] for o in outs)
    return outs if len(outs) > 1 else outs[0]


def _launch(name: str, inputs, outs, table, tile) -> None:
    lib = _lib()
    S, nx, ny, nz = outs[0].shape
    dev = outs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _C_NAMES[name])(
            *(t.data_ptr() for t in (*inputs, *outs, table)),
            S, nx, ny, nz, *tile, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.stencil3d_error_string(err).decode()})")
    LAUNCHES[name] += 1


# -- the wrappers (CUDA kernel on the card, plain version on the CPU) -------
def update_velocity(vx, vy, vz, table, tile=None):
    return _run("UPDATE_VELOCITY", [vx, vy, vz], table, tile=tile)


def divergence(vx, vy, vz, table, tile=None):
    return _run("DIVERGENCE", [vx, vy, vz], table, tile=tile)


def jacobi_pressure(p, rhs, table, tile=None):
    return _run("JACOBI_PRESSURE", [p, rhs], table, tile=tile)


def project_velocity(vx, vy, vz, p, table, tile=None):
    return _run("PROJECT_VELOCITY", [vx, vy, vz, p], table, tile=tile)


# -- the plain versions, on any device ---------------------------------------
def update_velocity_plain(vx, vy, vz, table):
    return _run("UPDATE_VELOCITY", [vx, vy, vz], table, plain=True)


def divergence_plain(vx, vy, vz, table):
    return _run("DIVERGENCE", [vx, vy, vz], table, plain=True)


def jacobi_pressure_plain(p, rhs, table):
    return _run("JACOBI_PRESSURE", [p, rhs], table, plain=True)


def project_velocity_plain(vx, vy, vz, p, table):
    return _run("PROJECT_VELOCITY", [vx, vy, vz, p], table, plain=True)


KERNELS = {
    "UPDATE_VELOCITY": update_velocity,
    "DIVERGENCE": divergence,
    "JACOBI_PRESSURE": jacobi_pressure,
    "PROJECT_VELOCITY": project_velocity,
}
PLAIN = {
    "UPDATE_VELOCITY": update_velocity_plain,
    "DIVERGENCE": divergence_plain,
    "JACOBI_PRESSURE": jacobi_pressure_plain,
    "PROJECT_VELOCITY": project_velocity_plain,
}
