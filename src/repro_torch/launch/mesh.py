"""Meshes of ranks, and the port's one launcher of rank processes.

The reference's mesh is single-controller: one process owns every device
and ``jax.shard_map`` runs the per-shard program on each.  The port takes
PyTorch's idiom for the same thing, which is also the paper's (Cactus runs
one MPI rank per grid block): one process per rank, joined by
``torch.distributed``, and a ``DeviceMesh`` naming the ranks' axes.

* :func:`make_mesh` lays the ranks of the initialised process group out
  as ``shape`` with named axes.  It never degrades to one process: no
  process group, or a world size that is not ``prod(shape)``, raises.
* :class:`CountingMesh` stands in for a ``DeviceMesh`` where no ranks
  run: the extents and axis names of one, and one rank's coordinate.
  The collectives of :mod:`repro_torch.dist.collectives` on it book
  what they would move and run nothing (the dry run over a mesh,
  ``launch.dryrun``).
* :func:`spawn` starts ``world_size`` rank processes (``spawn`` start
  method, a ``file://`` rendezvous in a fresh temporary directory, so
  concurrent launches never race for a port), runs ``fn(*args)`` in each
  and returns the ranks' return values.  One rank that raises ends the
  whole launch: the survivors are killed and that rank's traceback is
  raised here, within the deadline, so no rank is left blocked in a
  collective.

The backend is the caller's choice: ``"nccl"`` when every rank has a card
of its own, ``"gloo"`` otherwise (ranks that share one card, or the CPU).
NCCL refuses two ranks on one device, so ranks that share a card use gloo
and move their ghost strips through pinned host buffers
(:class:`repro_torch.core.halo.P2PTransport`).  Nothing switches backend on
a failure.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of the initialised process group's ranks, laid out
    row-major as ``shape`` with axes named ``axes``.

    ``device`` is the mesh's device type (``None``: ``cuda`` under NCCL,
    ``cpu`` under gloo, whose collectives take host tensors).  Every rank
    must call it: building the mesh makes one subgroup per axis line."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up "
                         "axis for axis")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} over axes {axes} needs {math.prod(shape)} ranks of "
            "an initialised torch.distributed process group; none is "
            "initialised (start the ranks with repro_torch.launch.mesh.spawn)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                           f"process group has {world}")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production layout: ``(16, 16)`` over
    ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
    "model")``.  Raises with the rank count it needs unless the process
    group has exactly that many ranks."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {have} — "
                           "start them with repro_torch.launch.mesh.spawn")
    return make_mesh(shape, axes, device)


class CountingMesh:
    """A mesh with no process group: its ``shape`` and ``mesh_dim_names``
    as ``make_mesh`` would lay them out, and ``coordinate`` ({axis:
    index}; default the first rank's, all zeros), which
    ``get_coordinate`` returns as a ``DeviceMesh`` does.  On it every
    collective books its call and bytes and returns an empty tensor of
    its result's shape (``dist.collectives``' counting mode)."""

    counting = True

    def __init__(self, shape, axes, coordinate: dict | None = None):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.mesh_dim_names} must pair up")
        coordinate = dict(coordinate or {})
        self.coordinate = {a: int(coordinate.pop(a, 0))
                           for a in self.mesh_dim_names}
        if coordinate:
            raise ValueError(f"axes {sorted(coordinate)} are not axes of "
                             f"the mesh {self.mesh_dim_names}")
        for a, n in zip(self.mesh_dim_names, self.shape):
            if not 0 <= self.coordinate[a] < n:
                raise ValueError(f"coordinate {self.coordinate[a]} on axis "
                                 f"{a!r} of extent {n}")

    def get_coordinate(self) -> list:
        return [self.coordinate[a] for a in self.mesh_dim_names]


def production_counting_mesh(*, multi_pod: bool = False) -> CountingMesh:
    """:func:`make_production_mesh`'s layout as a :class:`CountingMesh` at
    the first rank."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    return CountingMesh(shape, axes)


def mesh_extents(mesh) -> dict[str, int]:
    """``{axis name: extent}`` of a ``DeviceMesh``, or of any object with
    the reference mesh's ``axis_names`` and ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


# -- the launcher --------------------------------------------------------------
def _rank_main(fn, args, rank, world_size, backend, device, init_file,
               timeout_s, results):
    try:
        torch.set_num_threads(1)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*args)
        dist.barrier()      # no rank tears down while a peer still talks
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    results.put((rank, "ok", out))
    dist.destroy_process_group()


class RankFailed(RuntimeError):
    """A rank of a :func:`spawn` launch raised, died or missed the
    deadline."""


def spawn(fn: Callable, world_size: int, *, backend: str = "gloo",
          device=None, args: tuple = (),
          timeout_s: float = 300.0) -> list[Any]:
    """Run ``fn(*args)`` in ``world_size`` rank processes joined by a
    ``backend`` process group; return the ranks' return values in rank
    order.

    ``device`` is every rank's current card, named with its index
    (``cuda:0`` for ranks that share one card), or None for ranks on the
    CPU.  ``fn`` and ``args`` are pickled
    (``spawn`` start method): ``fn`` must be importable by name.  Each
    rank sets ``torch.set_num_threads(1)`` and initialises its process
    group with ``timeout=timeout_s``.  The launch
    is joined with a deadline of ``timeout_s``: the first rank that raises
    (or dies, or a deadline missed) kills the others, and
    :class:`RankFailed` carries that rank's traceback."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            raise ValueError("spawn needs the card's index (e.g. 'cuda:0'), "
                             f"got {str(device)!r}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rdzv = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
    procs = [ctx.Process(
        target=_rank_main,
        args=(fn, args, r, world_size, backend, device,
              os.path.join(rdzv, "init"), timeout_s, results), daemon=True)
        for r in range(world_size)]
    out: dict[int, Any] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world_size and failure is None:
            try:
                rank, status, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out]
                if dead:
                    # a rank that exits without reporting (a crash) may
                    # still have its report in flight: read it once more
                    try:
                        rank, status, value = results.get(timeout=1.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} without a "
                                   "result")
                        break
                elif time.monotonic() > deadline:
                    failure = (f"deadline of {timeout_s} s passed with ranks "
                               f"{sorted(set(range(world_size)) - set(out))} "
                               "unfinished")
                    break
                else:
                    continue
            if status == "ok":
                out[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
    finally:
        procs = [p for p in procs if p.pid is not None]   # those started
        for p in procs:
            if p.is_alive() and failure is not None:
                p.kill()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(rdzv, ignore_errors=True)
    if failure is not None:
        raise RankFailed(failure)
    return [out[r] for r in range(world_size)]
