"""Launch wrappers for the hand-written CUDA stencil kernels.

One wrapper per kernel of ``csrc/stencil3d.cu``, each replacing one
instance of the reference's 3DBLOCK Pallas template
(``repro.core.generator.GeneratedKernel._apply_pallas``):

  update_velocity(vx, vy, vz, table, tile=None, ghosts=None)
                                                     UPDATE_VELOCITY
  divergence(vx, vy, vz, table, tile=None)           DIVERGENCE
  jacobi_pressure(p, rhs, table, tile=None, ghosts=None)
                                                     JACOBI_PRESSURE
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

JACOBI_PRESSURE and UPDATE_VELOCITY (``GHOSTED``) also take their cached
fields unpadded, ``(S, X, Y, Z)``, with ``ghosts``: each field's
:class:`~repro_torch.core.halo.FieldGhosts` (its six faces as rules and
received strips, :func:`repro_torch.core.halo.field_ghosts`), one for p,
three for vx, vy, vz, or those faces bound once for the launches that
share them (:func:`bind_ghosts`).  The kernel then makes the ghost values
itself (the *ghosted* load); without ``ghosts`` it reads the fields padded
(the *padded* load of the same kernel).  A ghosted launch also counts in
``GHOSTED_LAUNCHES``; the plain version pads by the same specs, the
received strips on the decomposed faces
(:func:`repro_torch.core.halo.pad_with_strips`), and runs the body.

On a CUDA tensor the wrapper allocates its outputs with ``torch.empty``,
launches the kernel on the current stream without synchronising, and adds
one to ``LAUNCHES[name]``.  On a CPU tensor it runs the kernel's plain
version (``<kernel>_plain``: the descriptor body expanded eagerly, reading
its parameters from the same table), which is also what the card's kernels
are checked against.  On a ``meta`` tensor (a cost trace,
:mod:`repro_torch.launch.op_cost`) it books its declared bytes and
operations with the active counter and returns ``torch.empty`` outputs:
nothing is launched or counted in ``LAUNCHES``.

Any other 3DBLOCK descriptor gets a kernel generated from its body
(:func:`generated`, the CUDA template's route for a descriptor with no
hand-written kernel): the body is traced once, each field read, parameter,
Python number and operation becoming one line of a straight-line body
(:class:`GeneratedStencil`), rounded as written as in the four kernels,
and ``csrc/stencil3d.cu``'s template is built around it by nvcc when it is
first launched.  It keeps the same rules (CUDA launch on a CUDA tensor,
counted in ``GENERATED_LAUNCHES`` under the descriptor's name; the body
expanded eagerly on a CPU tensor; booked on ``meta``).  A body the trace
cannot translate raises on every device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import struct

import torch

from repro_torch.core.generator import KernelContext, generate
from repro_torch.kernels import stencil3d

_C_NAMES = {
    "UPDATE_VELOCITY": "stencil3d_update_velocity",
    "DIVERGENCE": "stencil3d_divergence",
    "JACOBI_PRESSURE": "stencil3d_jacobi_pressure",
    "PROJECT_VELOCITY": "stencil3d_project_velocity",
}

# the kernels that make their own ghost values (the ghosted load)
GHOSTED = ("UPDATE_VELOCITY", "JACOBI_PRESSURE")

# launches per kernel since the last reset (CUDA launches only)
LAUNCHES = dict.fromkeys(_C_NAMES, 0)
# of those, the launches of the GHOSTED kernels that took the ghosted load
GHOSTED_LAUNCHES = dict.fromkeys(GHOSTED, 0)
# calls of the CUDA template that gave a GHOSTED kernel padded fields
# because a face's rule declares no form (kernels.ops.ghosted_inputs)
PADDED_ROUTE = dict.fromkeys(GHOSTED, 0)
# the same for the kernels generated from a body, by descriptor name
GENERATED_LAUNCHES: dict[str, int] = {}

# the most threads a block may have: the kernels' __launch_bounds__
# (kThreads in csrc/stencil3d.cu)
MAX_THREADS = 256
# registers a thread of each kernel uses, (tx = 1, tx > 1): its two
# instantiations, from the ptxas report of the sm_90a build
# (build/kernels/libstencil3d-*.log; chip_smoke.py's build phase prints
# it).  The autotuner's occupancy model reads these constants, never the
# build, so the CPU and the card tune alike.
# The GHOSTED kernels' entries are those of their ghosted instantiations,
# the main path's.
REGISTERS = {"UPDATE_VELOCITY": (64, 64), "DIVERGENCE": (32, 32),
             "JACOBI_PRESSURE": (40, 40), "PROJECT_VELOCITY": (32, 32)}
# the most (slot, x) rows a block of a kernel walks (a tile's tx), where
# the autotuner must not walk further: UPDATE_VELOCITY's ghosted load, the
# main path's, ran 0.4314 ms at 256^3 walking 8 rows against 0.3945 at
# block_for (kernel_study.py's tiles section, PERF.md section 6): a block
# that walks a face row waits on its Ghosted reads, two rules composed in
# many of them, and the x faces' rows fall in the grid's first and last
# blocks.  Its padded load (the overlap split's thin shells) gives up 9%.
MAX_WALK = {"UPDATE_VELOCITY": 1}
# face kinds of the ghosted load (the enum in csrc/stencil3d.cu)
FACE_KINDS = {"const": 0, "linear": 1, "affine": 2, "wrap": 3, "strip": 4}


def reset_launches() -> None:
    for counts in (LAUNCHES, GENERATED_LAUNCHES, GHOSTED_LAUNCHES,
                   PADDED_ROUTE):
        for name in counts:
            counts[name] = 0


class _Face(ctypes.Structure):
    """struct Face of csrc/stencil3d.cu."""
    _fields_ = [("strip", ctypes.c_void_p), ("a", ctypes.c_float),
                ("kind", ctypes.c_int)]


class _Ghosts(ctypes.Structure):
    """struct Ghosts of csrc/stencil3d.cu: three fields of six faces."""
    _fields_ = [("f", _Face * 18)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("stencil3d")
    for name, cname in _C_NAMES.items():
        desc = stencil3d.DESCRIPTORS[name]
        n_ptr = len(desc.inputs) + len(desc.outputs) + 1      # + the table
        if name in GHOSTED:
            n_ptr += 2                          # + the faces and their b
        fn = getattr(lib, cname)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 4
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.stencil3d_error_string.argtypes = [ctypes.c_int]
    lib.stencil3d_error_string.restype = ctypes.c_char_p
    return lib


def _interior(desc, inputs, padded: bool = True) -> tuple[int, int, int]:
    """The interior shape every input agrees on, or raise (``padded``:
    the cached inputs carry the stencil's halo)."""
    interior = None
    for name, t in zip(desc.inputs, inputs):
        cached = padded and name in desc.cached_inputs
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


def _check(desc, inputs, table, columns=None, padded: bool = True
           ) -> tuple[int, tuple[int, int, int]]:
    """Validate a batched call whose table has ``columns`` (default: the
    kernel's ``stencil3d.TABLES`` row); return (S, interior)."""
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
    columns = stencil3d.TABLES[desc.name] if columns is None else columns
    want = (S, len(columns))
    if tuple(table.shape) != want:
        raise ValueError(f"{desc.name}: parameter table must be {want} "
                         f"({columns}), got {tuple(table.shape)}")
    if (table.dtype != torch.float32 or table.device != dev
            or not table.is_contiguous()):
        raise ValueError(f"{desc.name}: parameter table must be contiguous "
                         f"float32 on {dev}")
    return S, _interior(desc, inputs, padded)


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


def _lead(g):
    """``g`` (a FieldGhosts) with a slot axis in front of its strips."""
    from repro_torch.core import halo

    def up(t):
        return t.unsqueeze(0) if torch.is_tensor(t) else t

    strips = tuple(tuple(up(t) for t in pair) for pair in g.strips)
    return halo.FieldGhosts(g.specs, strips, tuple(up(f) for f in g.faces))


def _check_ghosts(name: str, ghosts, S: int, interior, dev) -> tuple:
    """``ghosts`` as a tuple of one FieldGhosts a cached input, its strips
    checked against the shapes the kernel reads, or raise."""
    from repro_torch.core import halo

    if name not in GHOSTED:
        raise ValueError(f"{name}: only {GHOSTED} take ghosts")
    if isinstance(ghosts, halo.FieldGhosts):
        ghosts = (ghosts,)
    ghosts = tuple(ghosts)
    n = len(stencil3d.DESCRIPTORS[name].cached_inputs)
    if len(ghosts) != n or not all(isinstance(g, halo.FieldGhosts)
                                   for g in ghosts):
        raise ValueError(f"{name}: ghosts must be {n} FieldGhosts "
                         "(core.halo.field_ghosts), one a cached input")
    for g in ghosts:
        for q, face in enumerate(g.faces):
            if torch.is_tensor(face):
                a = q // 2
                want = (S, *(n + 2 for n in interior[:a]), 1,
                        *interior[a + 1:])
                if (tuple(face.shape) != want or face.dtype != torch.float32
                        or face.device != dev or not face.is_contiguous()):
                    raise ValueError(
                        f"{name}: the strip of face {q} must be contiguous "
                        f"float32 {want} on {dev}, got "
                        f"{tuple(face.shape)} {face.dtype} on {face.device}")
            elif face.kind not in FACE_KINDS:
                raise ValueError(f"{name}: face {q} of kind {face.kind!r}")
    return ghosts


def face_table(ghosts, S: int, device) -> torch.Tensor:
    """The ``(S, 6 x fields)`` float32 table of each face's b, one row a
    slot, on ``device`` (0 where a face has none): Python numbers make a
    constant table, built once; tensors (0-d, or one value a slot) are
    stacked on the device, with no host sync."""
    from repro_torch.core.generator import _constant_table

    vals = [f.b if not torch.is_tensor(f) and f.kind in ("const", "affine")
            else 0.0 for g in ghosts for f in g.faces]
    table = _constant_table(tuple(0.0 if torch.is_tensor(v) else float(v)
                                  for v in vals), S, torch.device(device))
    if not any(torch.is_tensor(v) for v in vals):
        return table
    # one stack of the constant columns and the tensors: nothing crosses
    # from the host (an index list would, and wait for the stream)
    return torch.stack(
        [v.to(device=device, dtype=torch.float32).reshape(-1).expand(S)
         if torch.is_tensor(v) else table[:, c] for c, v in enumerate(vals)],
        dim=-1)


def _ghost_struct(ghosts) -> _Ghosts:
    g = _Ghosts()
    for m, fg in enumerate(ghosts):
        for q, face in enumerate(fg.faces):
            slot = g.f[m * 6 + q]
            if torch.is_tensor(face):
                slot.kind, slot.strip = FACE_KINDS["strip"], face.data_ptr()
            else:
                slot.kind, slot.a = FACE_KINDS[face.kind], float(face.a)
    return g


@dataclasses.dataclass(frozen=True, eq=False)
class BoundGhosts:
    """A GHOSTED kernel's faces checked and laid out once, for the launches
    that share them (the Jacobi sweeps of a step where no strip travels):
    the fields' FieldGhosts with a slot axis, the table of their b on the
    device and, on a card, the C struct a launch passes.  It serves
    launches of kernel ``name`` on ``shape`` (slots first) on ``device``."""

    name: str
    shape: tuple
    device: torch.device
    ghosts: tuple
    faces: torch.Tensor
    struct: object = None


def bind_ghosts(name: str, ghosts, field: torch.Tensor) -> BoundGhosts:
    """``ghosts`` of kernel ``name`` (one FieldGhosts a cached input, or
    one alone) for launches whose first cached input is shaped like
    ``field``, unpadded (a slot axis in front, or none): checked, their
    face table made and their struct built once."""
    if field.dim() == 3:
        ghosts = ([_lead(ghosts)] if not isinstance(ghosts, (list, tuple))
                  else [_lead(g) for g in ghosts])
    S = field.shape[0] if field.dim() == 4 else 1
    interior, dev = tuple(field.shape[-3:]), field.device
    checked = _check_ghosts(name, ghosts, S, interior, dev)
    faces = face_table(checked, S, dev)
    return BoundGhosts(name, (S, *interior), dev, checked, faces,
                       _ghost_struct(checked) if dev.type == "cuda" else None)


def _plain_ghosted(name: str, inputs, table, ghosts):
    """The plain version on unpadded cached fields: each padded by its
    specs with its received strips inserted, then the body."""
    from repro_torch.core import halo

    desc = stencil3d.DESCRIPTORS[name]
    it = iter(ghosts)
    padded = []
    for var, t in zip(desc.inputs, inputs):
        if var in desc.cached_inputs:
            g = next(it)
            t = halo.pad_with_strips(t, (1, 1, 1), g.specs, g.strips)
        padded.append(t)
    return _plain(name, padded, table)


def _run(name: str, inputs, table, plain: bool = False, tile=None,
         ghosts=None):
    desc = stencil3d.DESCRIPTORS[name]
    batched = inputs[0].dim() == 4
    if ghosts is not None and not isinstance(ghosts, BoundGhosts):
        ghosts = bind_ghosts(name, ghosts, inputs[0])
    if not batched:
        inputs = [t.unsqueeze(0) for t in inputs]
        table = table.unsqueeze(0)
    S, (nx, ny, nz) = _check(desc, inputs, table, padded=ghosts is None)
    tx, ty, tz = (block_for(ny, nz) if tile is None
                  else check_tile(tile, (nx, ny, nz), name))
    dev = inputs[0].device
    if ghosts is not None and (ghosts.name, ghosts.shape, ghosts.device) != (
            name, (S, nx, ny, nz), dev):
        raise ValueError(
            f"{name}: ghosts bound for {ghosts.name} on {ghosts.shape} on "
            f"{ghosts.device}, launched on {(S, nx, ny, nz)} on {dev}")
    if plain or dev.type == "cpu":
        outs = (_plain(name, inputs, table) if ghosts is None
                else _plain_ghosted(name, inputs, table, ghosts.ghosts))
    elif dev.type in ("cuda", "meta"):
        outs = tuple(torch.empty((S, nx, ny, nz), dtype=torch.float32,
                                 device=dev) for _ in desc.outputs)
        if dev.type == "meta":
            from repro_torch.launch import op_cost

            op_cost.book(name, *op_cost.stencil_cost(
                name, inputs, outs, table,
                ghosts=None if ghosts is None
                else (ghosts.ghosts, ghosts.faces)))
        else:
            _launch(name, inputs, outs, table, (tx, ty, tz), ghosts)
    else:
        raise ValueError(f"{name}: unsupported device {dev}")
    if not batched:
        outs = tuple(o[0] for o in outs)
    return outs if len(outs) > 1 else outs[0]


def _launch(name: str, inputs, outs, table, tile,
            ghosts: BoundGhosts | None = None) -> None:
    lib = _lib()
    S, nx, ny, nz = outs[0].shape
    dev = outs[0].device
    extra = ()
    if name in GHOSTED:
        extra = ((None, None) if ghosts is None
                 else (ctypes.addressof(ghosts.struct),
                       ghosts.faces.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _C_NAMES[name])(
            *(t.data_ptr() for t in (*inputs, *outs, table)), *extra,
            S, nx, ny, nz, *tile, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.stencil3d_error_string(err).decode()})")
    LAUNCHES[name] += 1
    if ghosts is not None:
        GHOSTED_LAUNCHES[name] += 1


# -- the wrappers (CUDA kernel on the card, plain version on the CPU) -------
def update_velocity(vx, vy, vz, table, tile=None, ghosts=None):
    return _run("UPDATE_VELOCITY", [vx, vy, vz], table, tile=tile,
                ghosts=ghosts)


def divergence(vx, vy, vz, table, tile=None):
    return _run("DIVERGENCE", [vx, vy, vz], table, tile=tile)


def jacobi_pressure(p, rhs, table, tile=None, ghosts=None):
    return _run("JACOBI_PRESSURE", [p, rhs], table, tile=tile,
                ghosts=ghosts)


def project_velocity(vx, vy, vz, p, table, tile=None):
    return _run("PROJECT_VELOCITY", [vx, vy, vz, p], table, tile=tile)


# -- the plain versions, on any device ---------------------------------------
def update_velocity_plain(vx, vy, vz, table, ghosts=None):
    return _run("UPDATE_VELOCITY", [vx, vy, vz], table, plain=True,
                ghosts=ghosts)


def divergence_plain(vx, vy, vz, table):
    return _run("DIVERGENCE", [vx, vy, vz], table, plain=True)


def jacobi_pressure_plain(p, rhs, table, ghosts=None):
    return _run("JACOBI_PRESSURE", [p, rhs], table, plain=True,
                ghosts=ghosts)


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


# -- the generated 3DBLOCK template ------------------------------------------
# The body is run once on symbolic views.  Each node of the trace is one
# (op, args) pair, numbered in order; equal pairs are one node (a body's
# repeated read or product is computed once, which changes no bit).  The
# operations are those whose rounding the card and the CPU share: + - *
# and true division, each rounded once (__fadd_rn, __fsub_rn, __fmul_rn,
# __fdiv_rn), negation and absolute value (exact), square root
# (__fsqrt_rn), and ``x ** 2`` as x * x; a Python number is rounded to
# float32 where it meets the field, as PyTorch rounds it.  ``c / x`` is
# PyTorch's ``x.reciprocal() * c``.  A division by a Python number is a true
# division here and on the CPU; PyTorch on the card multiplies by the
# reciprocal instead, so there the plain version may part from the kernel
# by an ulp (``repro_torch.device.true_divide`` gives the true quotient).
MAX_FIELDS = 16          # kGenMaxFields in csrc/stencil3d.cu
_EXPR = {"add": "add({0}, {1})", "sub": "sub({0}, {1})",
         "mul": "mul({0}, {1})", "div": "__fdiv_rn({0}, {1})",
         "rcp": "__fdiv_rn(1.0f, {0})", "neg": "-{0}", "abs": "fabsf({0})",
         "sqrt": "__fsqrt_rn({0})"}
_TORCH_OPS = {torch.sqrt: "sqrt", torch.Tensor.sqrt: "sqrt",
              torch.abs: "abs", torch.Tensor.abs: "abs",
              torch.neg: "neg", torch.Tensor.neg: "neg",
              torch.square: "square", torch.Tensor.square: "square"}


class _Trace:
    def __init__(self, name: str):
        self.name = name
        self.nodes: list[tuple] = []
        self._index: dict[tuple, int] = {}

    def node(self, op: str, *args) -> "_Sym":
        key = (op, *args)
        if key not in self._index:
            self._index[key] = len(self.nodes)
            self.nodes.append(key)
        return _Sym(self, self._index[key])

    def lift(self, v) -> int:
        """The node of ``v``: a traced value, or a Python number."""
        if isinstance(v, _Sym) and v.trace is self:
            return v.index
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            f32 = struct.unpack("f", struct.pack("f", float(v)))[0]
            return self.node("const", f32).index
        self.refuse(f"{type(v).__name__} {v!r}")

    def refuse(self, what: str):
        raise ValueError(
            f"{self.name}: the generated CUDA template cannot translate "
            f"{what} in the body (field reads, parameters, Python numbers "
            "and + - * / sqrt abs neg ** 2 only); use template='TORCH'")


class _Sym:
    """A value of the traced body (a node of its :class:`_Trace`)."""

    __slots__ = ("trace", "index")

    def __init__(self, trace: _Trace, index: int):
        self.trace, self.index = trace, index

    def _op(self, op, *others, first=None):
        t = self.trace
        args = [t.lift(o) for o in others]
        if first is not None:
            return t.node(op, t.lift(first), self.index, *args)
        return t.node(op, self.index, *args)

    def __add__(self, o): return self._op("add", o)
    def __radd__(self, o): return self._op("add", first=o)
    def __sub__(self, o): return self._op("sub", o)
    def __rsub__(self, o): return self._op("sub", first=o)
    def __mul__(self, o): return self._op("mul", o)
    def __rmul__(self, o): return self._op("mul", first=o)
    def __truediv__(self, o): return self._op("div", o)

    def __rtruediv__(self, o):          # PyTorch: x.reciprocal() * o
        return self._op("rcp")._op("mul", o)

    def __neg__(self): return self._op("neg")
    def __pos__(self): return self
    def __abs__(self): return self._op("abs")

    def __pow__(self, e):
        if isinstance(e, (int, float)) and e == 2:
            return self._op("mul", self)
        self.trace.refuse(f"** {e!r}")

    def _refuse(self, *_):
        self.trace.refuse("a data-dependent value")

    __bool__ = __float__ = __int__ = __index__ = _refuse
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _refuse
    __rpow__ = __getitem__ = _refuse
    __hash__ = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        op = _TORCH_OPS.get(func)
        x = args[0] if args else None
        if op is None or kwargs or len(args) != 1 or not isinstance(x, _Sym):
            trace = next(a.trace for a in (*args, *(kwargs or {}).values())
                         if isinstance(a, _Sym))
            trace.refuse(f"torch.{getattr(func, '__name__', func)}")
        return x._op("mul", x) if op == "square" else x._op(op)


class _SymView:
    """:class:`~repro_torch.core.generator.FieldView` on the trace."""

    __slots__ = ("trace", "field", "halo_lo", "halo_hi")

    def __init__(self, trace, field, halo_lo, halo_hi):
        self.trace, self.field = trace, field
        self.halo_lo, self.halo_hi = halo_lo, halo_hi

    def at(self, dx: int = 0, dy: int = 0, dz: int = 0) -> _Sym:
        off = (int(dx), int(dy), int(dz))
        if any(not -lo <= o <= hi
               for o, lo, hi in zip(off, self.halo_lo, self.halo_hi)):
            raise ValueError(
                f"stencil offset {off} exceeds declared radii "
                f"(lo={self.halo_lo}, hi={self.halo_hi})")
        return self.trace.node("load", self.field, off)

    @property
    def c(self) -> _Sym:
        return self.at(0, 0, 0)


def _halos(desc, name):
    if name in desc.cached_inputs:
        return desc.halo_lo, desc.halo_hi
    return (0, 0, 0), (0, 0, 0)


def _const(v: float) -> str:
    if math.isfinite(v):
        return f"({v.hex()}f)"
    return f"__int_as_float(0x{struct.unpack('I', struct.pack('f', v))[0]:08x})"


@dataclasses.dataclass(frozen=True)
class GeneratedStencil:
    """A descriptor's body as a kernel of the generated 3DBLOCK template.

    ``nodes`` is the traced body (``(op, *args)``, args the numbers of
    earlier nodes; leaves ``("load", field, (dx, dy, dz))``, ``("param",
    column)``, ``("const", value)``), ``outputs`` the node each output takes
    in the descriptor's order, ``header`` the C++ ``gen_body`` built into
    ``csrc/stencil3d.cu``'s template.  Call it as a wrapper:
    ``kernel(*inputs, table, tile=None)`` with the inputs padded as the
    descriptor declares and the ``(S, len(columns))`` table
    (``columns``: the declared parameters)."""

    desc: object
    body: object
    nodes: tuple
    outputs: tuple
    header: str

    @property
    def columns(self) -> tuple:
        return tuple(self.desc.parameters)

    @property
    def ops_per_cell(self) -> int:
        return sum(op not in ("load", "param", "const")
                   for op, *_ in self.nodes)

    def __call__(self, *args, tile=None):
        return self._run(list(args[:-1]), args[-1], tile=tile)

    def plain(self, *args):
        return self._run(list(args[:-1]), args[-1], plain=True)

    def _plain(self, inputs, table):
        params = {c: table[:, i].reshape(-1, 1, 1, 1)
                  for i, c in enumerate(self.columns)}
        kern = generate(self.desc, self.body, template="TORCH")
        out = kern._apply_torch(dict(zip(self.desc.inputs, inputs)), params)
        return tuple(out[n] for n in self.desc.outputs)

    def _run(self, inputs, table, plain: bool = False, tile=None):
        desc = self.desc
        batched = inputs[0].dim() == 4
        if not batched:
            inputs = [t.unsqueeze(0) for t in inputs]
            table = table.unsqueeze(0)
        S, (nx, ny, nz) = _check(desc, inputs, table, self.columns)
        tile = (block_for(ny, nz) if tile is None
                else check_tile(tile, (nx, ny, nz), desc.name))
        dev = inputs[0].device
        if plain or dev.type == "cpu":
            outs = self._plain(inputs, table)
        elif dev.type in ("cuda", "meta"):
            outs = tuple(torch.empty((S, nx, ny, nz), dtype=torch.float32,
                                     device=dev) for _ in desc.outputs)
            if dev.type == "meta":
                from repro_torch.launch import op_cost

                op_cost.book(desc.name, op_cost._nbytes(
                    [*inputs, *outs, table]),
                    self.ops_per_cell * outs[0].numel())
            else:
                self._launch(inputs, outs, table, tile)
        else:
            raise ValueError(f"{desc.name}: unsupported device {dev}")
        if not batched:
            outs = tuple(o[0] for o in outs)
        return outs if len(outs) > 1 else outs[0]

    def library(self) -> ctypes.CDLL:
        """The template built around ``header`` (by nvcc, if its library
        is absent), loaded."""
        from repro_torch.kernels import _build

        tag = "".join(ch if ch.isalnum() or ch == "_" else "_"
                      for ch in self.desc.name)
        lib = _build.load_generated(tag, self.header)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.stencil3d_generated.argtypes = (
            [ptrs, ctypes.c_int, ptrs, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_int64] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.stencil3d_generated.restype = ctypes.c_int
        lib.stencil3d_error_string.argtypes = [ctypes.c_int]
        lib.stencil3d_error_string.restype = ctypes.c_char_p
        return lib

    def _launch(self, inputs, outs, table, tile) -> None:
        lib = self.library()
        S, nx, ny, nz = outs[0].shape
        ins = (ctypes.c_void_p * len(inputs))(*(t.data_ptr() for t in inputs))
        ous = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))
        dev = outs[0].device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.stencil3d_generated(
                ins, len(inputs), ous, len(outs), table.data_ptr(),
                len(self.columns), S, nx, ny, nz, *tile, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.desc.name} (generated) kernel launch failed: CUDA "
                f"error {err} ({lib.stencil3d_error_string(err).decode()})")
        GENERATED_LAUNCHES[self.desc.name] = \
            GENERATED_LAUNCHES.get(self.desc.name, 0) + 1


@functools.lru_cache(maxsize=None)
def generated(desc, body) -> GeneratedStencil:
    """The kernel of the generated 3DBLOCK template for ``desc`` and
    ``body``: the body traced (raising if it cannot be translated) and its
    ``gen_body`` written; nothing is built until it is launched."""
    if len(desc.inputs) > MAX_FIELDS or len(desc.outputs) > MAX_FIELDS:
        raise ValueError(f"{desc.name}: the generated template takes at most "
                         f"{MAX_FIELDS} inputs and {MAX_FIELDS} outputs")
    trace = _Trace(desc.name)
    views = {n: _SymView(trace, m, *_halos(desc, n))
             for m, n in enumerate(desc.inputs)}
    params = {c: trace.node("param", i) for i, c in enumerate(desc.parameters)}
    out = body(KernelContext(views, params))
    missing = set(desc.outputs) - set(out)
    if missing:
        raise ValueError(f"kernel body did not produce outputs: "
                         f"{sorted(missing)}")
    outputs = tuple(trace.lift(out[n]) for n in desc.outputs)
    return GeneratedStencil(desc, body, tuple(trace.nodes), outputs,
                            _render(desc, trace.nodes, outputs))


def _render(desc, nodes, outputs) -> str:
    """``gen_body``: the traced body as C++ for csrc/stencil3d.cu."""
    lines = [f"// {desc.name}, generated from its body by "
             "repro_torch.kernels.stencil3d_cuda",
             f"constexpr int kGenInputs = {len(desc.inputs)};",
             f"constexpr int kGenOutputs = {len(desc.outputs)};",
             f"constexpr int kGenParams = {len(desc.parameters)};",
             "__device__ __forceinline__ void gen_body(",
             "    const GenArgs& a, const float* __restrict__ prm, int64_t s,",
             "    int64_t i, int64_t j, int64_t k, int64_t nx, int64_t ny,",
             "    int64_t nz, int64_t o) {"]
    read = {args[0] for op, *args in nodes if op == "load"}
    for m, name in enumerate(desc.inputs):
        if m not in read:
            continue
        (lx, ly, lz), (hx, hy, hz) = _halos(desc, name)
        lines += [
            f"  // {name}: padded by {(lx, ly, lz)} below, {(hx, hy, hz)} above",
            f"  const int64_t sy{m} = nz + {lz + hz}, "
            f"sx{m} = (ny + {ly + hy}) * sy{m}, ss{m} = (nx + {lx + hx}) * sx{m};",
            f"  const float* __restrict__ f{m} = a.in[{m}] + s * ss{m} + "
            f"(i + {lx}) * sx{m} + (j + {ly}) * sy{m} + (k + {lz});"]
    for t, (op, *args) in enumerate(nodes):
        if op == "load":
            m, off = args
            terms = [f"{d} * {st}{m}" for d, st in zip(off[:2], ("sx", "sy"))
                     if d] + ([str(off[2])] if off[2] else [])
            expr = f"f{m}[{' + '.join(terms) or '0'}]"
        elif op == "param":
            expr = f"prm[{args[0]}]"
        elif op == "const":
            expr = _const(args[0])
        else:
            expr = _EXPR[op].format(*(f"t{a}" for a in args))
        lines.append(f"  const float t{t} = {expr};")
    lines += [f"  a.out[{q}][o] = t{t};  // {name}"
              for q, (name, t) in enumerate(zip(desc.outputs, outputs))]
    return "\n".join(lines + ["}", ""])
