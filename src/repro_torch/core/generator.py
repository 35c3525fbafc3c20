"""CaCUDA code generator, on PyTorch: one descriptor, two templates.

The paper's generator parses kernel descriptors and expands optimized CUDA
templates so that application authors write only the per-cell update.  In
the port the same descriptor drives two templates:

* ``CUDA`` — dispatches to the hand-written Hopper kernel registered for
  ``desc.name`` (:mod:`repro_torch.kernels.stencil3d_cuda`), with the
  runtime parameters packed into an ``(S, n_params)`` float32 table on the
  device, one row per slot, in the kernel's column order
  (``stencil3d.TABLES``: declared parameters and the terms ``DERIVED``
  from them) — the twin of the reference 3DBLOCK template's scalar table.
  A descriptor with no kernel raises; the body is never run in its place.
  The launch tile is the kernel's ``tile`` (``None``: the wrapper's
  ``block_for``; ``kernels.ops.apply_kernel(tile="auto")`` gives the
  autotuner's choice).
* ``TORCH`` — the eager expansion of the body (shifted slices of the padded
  tensors), the twin of the reference JNP template: the oracle for kernel
  tests, the shape-polymorphic kernel, and the path on the CPU.

The *kernel body* is a function ``body(ctx) -> dict`` where ``ctx[name]`` is
a :class:`FieldView` supporting ``.at(dx, dy, dz)`` shifted reads.  Views
slice the last three axes, so the same body runs on one grid ``(X, Y, Z)``
or on a slot batch ``(S, X, Y, Z)``.

A descriptor of TYPE ``3DBLOCK`` defaults to the ``CUDA`` template and one
of TYPE ``JNP`` to ``TORCH``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping

import torch

from repro_torch.core.descriptor import StencilDescriptor

TEMPLATES = ("CUDA", "TORCH")
_TEMPLATE_OF_TYPE = {"3DBLOCK": "CUDA", "JNP": "TORCH"}


class FieldView:
    """Shifted-stencil accessor over the last three axes of a padded tensor."""

    __slots__ = ("arr", "halo_lo", "halo_hi")

    def __init__(self, arr, halo_lo, halo_hi):
        self.arr = arr
        self.halo_lo = halo_lo
        self.halo_hi = halo_hi

    def at(self, dx: int = 0, dy: int = 0, dz: int = 0) -> torch.Tensor:
        off = (dx, dy, dz)
        shape = self.arr.shape[-3:]
        idx = [Ellipsis]
        for a, o in enumerate(off):
            lo, hi = self.halo_lo[a], self.halo_hi[a]
            if not -lo <= o <= hi:
                raise ValueError(
                    f"stencil offset {off} exceeds declared radii "
                    f"(lo={self.halo_lo}, hi={self.halo_hi})"
                )
            stop = shape[a] - hi + o
            idx.append(slice(lo + o, stop))
        return self.arr[tuple(idx)]

    @property
    def c(self) -> torch.Tensor:
        return self.at(0, 0, 0)


# Parameters a body may read that derive from a declared one, computed by
# the expression the reference's body applies to it: in Python double when
# the declared parameter is a Python scalar (the reference bakes such terms
# as literals, so float32 sees them rounded once), in float32 when it is a
# tensor.  The CUDA template's table carries these values, so a kernel and
# the eager body use the same rounded constants.
DERIVED = {
    "ih": lambda param: 1.0 / param("h"),
    "ih2": lambda param: param("ih") * param("ih"),
    "h2": lambda param: param("h") * param("h"),
    "omc": lambda param: 1.0 - param("omega"),
}


class KernelContext(Mapping):
    """What the kernel body sees: field views + runtime parameters."""

    def __init__(self, views: dict[str, FieldView], params: dict[str, Any]):
        self._views = views
        self._params = params

    def __getitem__(self, name: str) -> FieldView:
        return self._views[name]

    def __iter__(self):
        return iter(self._views)

    def __len__(self):
        return len(self._views)

    def param(self, name: str):
        """A runtime parameter, or one derived from it (``DERIVED``)."""
        if name in self._params or name not in DERIVED:
            return self._params[name]
        return DERIVED[name](self.param)


def param_table(desc: StencilDescriptor, params: Mapping[str, Any],
                nslots: int | None, device,
                columns: tuple[str, ...] | None = None) -> torch.Tensor:
    """Pack parameters into an ``(S, n)`` float32 table on ``device``.

    ``columns`` names the table's columns, declared or derived parameters
    (``DERIVED``); the default is ``desc.parameters`` in declaration order
    (``param_index``).  Tensor values (0-d, or ``(S,)`` per slot) are
    stacked on the device beside device fills of the Python scalars — no
    host-to-device copy and no host sync.  A table of Python scalars only
    is a constant, copied to the device once and cached.  ``nslots=None``
    gives the single row of an unbatched call.
    """
    rows = 1 if nslots is None else nslots
    ctx = KernelContext({}, params)
    values = [ctx.param(name) for name in columns or desc.parameters]
    if not any(torch.is_tensor(v) for v in values):
        # all Python scalars (the solver's h and omega): a constant table,
        # built once per device instead of at every launch
        return _constant_table(tuple(float(v) for v in values), rows,
                               torch.device(device))
    cols = []
    for v in values:
        if torch.is_tensor(v):
            v = v.to(device=device, dtype=torch.float32).reshape(-1)
            cols.append(v.expand(rows))
        else:
            cols.append(torch.full((rows,), float(v), dtype=torch.float32,
                                   device=device))
    return torch.stack(cols, dim=-1)


@functools.lru_cache(maxsize=256)
def _constant_table(values: tuple[float, ...], rows: int,
                    device: torch.device) -> torch.Tensor:
    """An ``(rows, len(values))`` float32 table of constants (read-only:
    the kernels and the plain versions only read their tables)."""
    return torch.tensor([values] * rows, dtype=torch.float32, device=device)


@dataclasses.dataclass
class GeneratedKernel:
    """A kernel generated from a descriptor, callable on padded inputs.

    ``__call__(arrays, **params) -> dict[name, interior tensor]`` where
    ``arrays[name]`` for read variables is the *padded* tensor (interior +
    stencil ghosts) and outputs are interior-shaped.
    """

    desc: StencilDescriptor
    body: Callable[[KernelContext], dict[str, torch.Tensor]]
    template: str
    tile: tuple[int, int, int] | None = None    # CUDA launch tile

    # ---- TORCH template ---------------------------------------------------
    def _apply_torch(self, arrays: dict[str, torch.Tensor],
                     params: dict[str, Any]):
        views = {}
        for name in self.desc.inputs:
            cached = name in self.desc.cached_inputs
            hl = self.desc.halo_lo if cached else (0, 0, 0)
            hh = self.desc.halo_hi if cached else (0, 0, 0)
            views[name] = FieldView(arrays[name], hl, hh)
        out = self.body(KernelContext(views, params))
        missing = set(self.desc.outputs) - set(out)
        if missing:
            raise ValueError(f"kernel body did not produce outputs: {sorted(missing)}")
        return {k: out[k] for k in self.desc.outputs}

    # ---- CUDA template ----------------------------------------------------
    def _cuda_kernel(self):
        from repro_torch.kernels import stencil3d, stencil3d_cuda

        name = self.desc.name
        launch = stencil3d_cuda.KERNELS.get(name)
        if launch is None:
            raise ValueError(
                f"descriptor {name!r} has no hand-written CUDA kernel "
                f"(have {sorted(stencil3d_cuda.KERNELS)}); use "
                "template='TORCH' to expand its body eagerly")
        ref = stencil3d.DESCRIPTORS[name]
        same = (self.desc.stencil, self.desc.variables, self.desc.parameters
                ) == (ref.stencil, ref.variables, ref.parameters)
        if not same or self.body is not stencil3d.BODIES[name]:
            raise ValueError(
                f"descriptor {name!r} differs from the one its CUDA kernel "
                "implements (stencil, variables, parameters and body must "
                "be those of repro_torch.kernels.stencil3d)")
        return launch

    def _apply_cuda(self, arrays: dict[str, torch.Tensor],
                    params: dict[str, Any], *, batched: bool):
        from repro_torch.kernels import stencil3d

        launch = self._cuda_kernel()
        first = arrays[self.desc.inputs[0]]
        table = param_table(self.desc, params,
                            first.shape[0] if batched else None, first.device,
                            columns=stencil3d.TABLES[self.desc.name])
        if not batched:
            table = table[0]
        outs = launch(*(arrays[n] for n in self.desc.inputs), table,
                      tile=self.tile)
        if torch.is_tensor(outs):
            outs = (outs,)
        return dict(zip(self.desc.outputs, outs))

    # ---- entry points -----------------------------------------------------
    def _check_params(self, params):
        for p in self.desc.parameters:
            if p not in params:
                raise ValueError(f"missing runtime parameter {p!r}")

    def apply_batched(self, arrays: dict[str, torch.Tensor],
                      batched_params: frozenset | tuple = (), **params):
        """Apply the kernel over a leading slot axis of every array.

        ``batched_params`` names runtime parameters that carry the slot axis
        (tensors of shape ``(S,)``, e.g. per-simulation viscosity); the rest
        are shared.  The TORCH template broadcasts them as ``(S, 1, 1, 1)``;
        the CUDA template gives each slot its own table row, so one launch
        advances slots with different physics.
        """
        self._check_params(params)
        for k in batched_params:
            if not torch.is_tensor(params.get(k)):
                raise ValueError(
                    f"batched parameter {k!r} must be a tensor with a "
                    "leading slot axis")
        if self.template == "CUDA":
            return self._apply_cuda(arrays, params, batched=True)
        params = {k: v.reshape(-1, 1, 1, 1) if k in batched_params else v
                  for k, v in params.items()}
        return self._apply_torch(arrays, params)

    def __call__(self, arrays: dict[str, torch.Tensor], **params):
        self._check_params(params)
        if self.template == "CUDA":
            return self._apply_cuda(arrays, params, batched=False)
        return self._apply_torch(arrays, params)


def generate(
    desc: StencilDescriptor,
    body: Callable[[KernelContext], dict[str, torch.Tensor]],
    *,
    template: str | None = None,
    tile: tuple[int, int, int] | None = None,
) -> GeneratedKernel:
    """Expand ``desc`` + ``body`` into an executable kernel.

    ``template=None`` uses the descriptor's TYPE (``3DBLOCK`` -> ``CUDA``,
    ``JNP`` -> ``TORCH``).  ``tile`` is the CUDA template's launch tile
    ``(tx, ty, tz)``; the TORCH template has none and ignores it.
    """
    tmpl = template or _TEMPLATE_OF_TYPE[desc.type]
    if tmpl not in TEMPLATES:
        raise ValueError(f"unknown template {tmpl!r} (have {TEMPLATES})")
    return GeneratedKernel(desc=desc, body=body, template=tmpl,
                           tile=None if tile is None else tuple(tile))


def generate_pair(desc, body):
    """(cuda, torch_oracle) pair for validation tests."""
    return (
        generate(desc, body, template="CUDA"),
        generate(desc, body, template="TORCH"),
    )
