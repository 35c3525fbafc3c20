"""Tile autotuner: pick the CUDA stencils' launch tile from the roofline model.

The port's counterpart of ``repro.core.autotune``.  The paper auto-tunes
data distribution and relies on hand-tuned TILE choices in the descriptors;
the reference enumerates TPU-aligned tiles that fit VMEM and maximises
arithmetic intensity.  Here the search is retargeted to the hand-written
CUDA stencils (``kernels/csrc/stencil3d.cu``), whose tile ``(tx, ty, tz)``
is a block of ``tz x ty`` threads walking ``tx`` planes along x:

* z tiles are multiples of the warp (32 threads), so a warp reads
  contiguous floats; y and x tiles divide the interior.  Where no aligned
  tile divides (n = 48, odd shapes) the reference's fallbacks hold in their
  CUDA form: the whole z extent, then the largest block the kernel takes.
* A block has at most the kernel's ``MAX_THREADS`` (its launch bounds,
  below the chip's 1024), and blocks of whole warps are preferred.
* The halo-expanded working set (``StencilDescriptor.vmem_block_bytes``)
  must fit ``vmem_fraction`` of the chip's shared memory a block, the
  on-chip memory that also serves as L1 for the neighbour reuse.
* Occupancy comes from the chip's limits (threads, blocks and registers an
  SM) and each kernel's register count (``stencil3d_cuda.REGISTERS``, from
  the ptxas report; a constant, so the CPU and the card tune alike): a tile
  must give the grid of one slot at least ``waves`` full waves of resident
  blocks, or, where none can, as large a share of one as any tile gives.
* A tile that walks x (tx > 1) must stage at least ``WALK_GAIN`` fewer
  bytes a cell (``vmem_block_bytes`` over its cells) than ``block_for``'s:
  the walk's loop costs more than the reuse of cached inputs' halo planes
  saves where there is little to reuse.  PROJECT_VELOCITY reads three of
  its four inputs without a halo, so no walk of it saves even 30%.  A
  kernel walks no more than its ``stencil3d_cuda.MAX_WALK`` rows
  (UPDATE_VELOCITY: 1, for its ghosted load's face rows).
* Among those it maximises ``stencil_arithmetic_intensity``, as the
  reference does (then the smaller working set, then the earlier
  candidate).  The wrapper's default, ``stencil3d_cuda.block_for``, is
  always a candidate.

``WAVES`` and ``WALK_GAIN`` are the model's two constants, set from
``kernel_study.py --only tiles`` on an H100 (PERF.md, §6): at 256^3 the
walks the other three kernels take (4-8 planes) read 6-11% faster than
``block_for``, every walk of PROJECT_VELOCITY 0.2-4% slower, and with 4
waves or fewer the walks grow long enough to lose the tail.

Deterministic: no search on the device.  :func:`tile_for` is the memoized
entry point the solver's hot path reaches (``ops.apply_kernel(tile="auto")``
on the CUDA template): one choice per (kernel, stencil, local interior,
itemsize, chip, options), with hit and miss counters.  The slot count is no
part of the key, so a farm and a serial run of one grid share the choice.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.descriptor import StencilDescriptor
from repro_torch.core.rooflinemodel import Chip, resolve_chip, \
    stencil_arithmetic_intensity

# full waves of resident blocks a tile's grid must give (one slot's grid)
WAVES = 8
# the least share of block_for's staged bytes a cell that a tile walking x
# planes must save, to pay for the walk's loop
WALK_GAIN = 1 / 3
# registers a warp is allocated in units of (sm_90)
_REG_UNIT = 256
# a descriptor with no hand-written kernel: a thread's assumed registers
_DEFAULT_REGISTERS = 32


def _divisors(n: int, step: int) -> list[int]:
    return [d for d in range(step, n + 1, step) if n % d == 0]


@dataclasses.dataclass(frozen=True)
class TileChoice:
    tile: tuple[int, int, int]
    vmem_bytes: int
    intensity: float
    blocks_per_sm: int = 0       # resident blocks an SM holds
    waves: float = 0.0           # the grid's blocks over the card's resident


def blocks_per_sm(threads: int, registers: int, chip: Chip) -> int:
    """Resident blocks of ``threads`` threads using ``registers`` each on
    one SM of ``chip``: the least of its block, thread and register
    limits."""
    warps = math.ceil(threads / chip.warp)
    regs_warp = math.ceil(registers * chip.warp / _REG_UNIT) * _REG_UNIT
    return min(chip.max_blocks_sm,
               chip.max_threads_sm // (warps * chip.warp),
               chip.regs_sm // (warps * regs_warp))


def _kernel_limits(desc: StencilDescriptor, chip: Chip):
    """(registers a thread at tx = 1 and tx > 1, most threads a block, the
    default tile) of the kernel behind ``desc``."""
    from repro_torch.kernels import stencil3d_cuda

    regs = stencil3d_cuda.REGISTERS.get(desc.name, (_DEFAULT_REGISTERS,) * 2)
    return regs, min(chip.max_threads_block, stencil3d_cuda.MAX_THREADS), \
        stencil3d_cuda.block_for


def _max_walk(desc: StencilDescriptor) -> int | None:
    from repro_torch.kernels import stencil3d_cuda

    return stencil3d_cuda.MAX_WALK.get(desc.name)


def candidates(desc: StencilDescriptor, local_shape, chip: Chip
               ) -> list[tuple[int, int, int]]:
    """The tiles :func:`choose_tile` weighs for ``desc`` on one slot's
    interior ``local_shape``, block_for's first: blocks of whole warps
    where any exist."""
    nx, ny, nz = (int(n) for n in local_shape)
    _, max_threads, block_for = _kernel_limits(desc, chip)
    zc = [z for z in (_divisors(nz, chip.warp) or [nz]) if z <= max_threads]
    zc = zc or [min(nz, max_threads)]
    tiles = [block_for(ny, nz)] + [(tx, ty, tz) for tz in zc
                                   for ty in _divisors(ny, 1)
                                   if ty * tz <= max_threads
                                   for tx in _divisors(nx, 1)]
    whole = [t for t in tiles if (t[1] * t[2]) % chip.warp == 0]
    return whole or tiles


def choose_tile(
    desc: StencilDescriptor,
    local_shape: tuple[int, int, int],
    *,
    itemsize: int = 4,
    flops_per_cell: float = 10.0,
    chip: Chip | str | None = "auto",
    vmem_fraction: float = 0.5,
    waves: float = WAVES,
) -> TileChoice:
    """Best launch tile ``(tx, ty, tz)`` of ``desc``'s CUDA kernel for one
    slot's interior ``local_shape`` (see the module docstring).

    ``chip`` accepts a :class:`Chip`, a registry name, or ``"auto"`` (the
    default): the limits are those of the hardware that runs the kernel.
    """
    chip = resolve_chip(chip)
    nx, ny, nz = (int(n) for n in local_shape)
    budget = chip.vmem_bytes * vmem_fraction
    nread = len(desc.inputs)
    nwrite = len(desc.outputs)
    halo = desc.halo_width
    registers, _, block_for = _kernel_limits(desc, chip)
    best, best_key = None, None
    def staged(tile):      # bytes a cell the descriptor stages for ``tile``
        return (dataclasses.replace(desc, tile=tile).vmem_block_bytes(itemsize)
                / math.prod(tile))

    walk_limit = (1 - WALK_GAIN) * staged(block_for(ny, nz))
    max_walk = _max_walk(desc)
    for tx, ty, tz in candidates(desc, (nx, ny, nz), chip):
        if max_walk is not None and tx > max_walk:
            continue
        vmem = dataclasses.replace(desc, tile=(tx, ty, tz)).vmem_block_bytes(
            itemsize)
        if vmem > budget:
            continue
        if tx > 1 and staged((tx, ty, tz)) > walk_limit:
            continue
        bps = blocks_per_sm(ty * tz, registers[tx > 1], chip)
        if bps < 1:
            continue
        blocks = math.ceil(nx / tx) * math.ceil(ny / ty) * math.ceil(nz / tz)
        resident = chip.sms * bps
        ai = stencil_arithmetic_intensity((tx, ty, tz), halo, flops_per_cell,
                                          nread, nwrite, itemsize)
        key = (min(1.0, blocks / (waves * resident)), ai, -vmem)
        if best_key is None or key > best_key:
            best_key = key
            best = TileChoice((tx, ty, tz), vmem, ai, bps, blocks / resident)
    if best is None:
        raise ValueError(
            f"no tile of {local_shape} fits the shared-memory budget "
            f"{budget:.0f}B and the occupancy limits of {chip.name} for "
            f"kernel {desc.name}")
    return best


def tuned(desc: StencilDescriptor, local_shape, **kw) -> StencilDescriptor:
    """Return the descriptor with its TILE replaced by the tuned choice."""
    return dataclasses.replace(desc, tile=choose_tile(desc, local_shape, **kw).tile)


# -- memoized production path ------------------------------------------------
# One tuned choice per (kernel, local interior, itemsize, chip) signature.
# Both the serial driver and the simulation farm resolve through here with
# the same local interior, so they always run the same tile.
_TILE_CACHE: dict[tuple, TileChoice] = {}
_TILE_STATS = {"hits": 0, "misses": 0}


def tile_for(desc: StencilDescriptor, local_shape: tuple[int, int, int],
             *, itemsize: int = 4, chip: Chip | str | None = "auto",
             **kw) -> TileChoice:
    """Memoized :func:`choose_tile` keyed on the tuning signature."""
    chip = resolve_chip(chip)
    key = (desc.name, desc.stencil, tuple(local_shape), itemsize, chip.name,
           tuple(sorted(kw.items())))
    hit = _TILE_CACHE.get(key)
    if hit is not None:
        _TILE_STATS["hits"] += 1
        return hit
    _TILE_STATS["misses"] += 1
    choice = choose_tile(desc, tuple(local_shape), itemsize=itemsize,
                         chip=chip, **kw)
    _TILE_CACHE[key] = choice
    return choice


def tile_cache_stats() -> dict:
    return {**_TILE_STATS, "entries": len(_TILE_CACHE)}


def reset_tile_cache():
    _TILE_CACHE.clear()
    _TILE_STATS.update(hits=0, misses=0)
