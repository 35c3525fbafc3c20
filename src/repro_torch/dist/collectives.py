"""Collectives over the axes of a mesh of ranks, and the autograd Functions
the sharded LM is written with.

The reference places its collectives through GSPMD; here every rank runs
its own program (``launch.mesh``), so the model code calls them itself.
A c10d collective is opaque to autograd, so the ones on a training path are
explicit ``torch.autograd.Function``s:

* :func:`gather_many` — all-gather blocks of one dtype over mesh axes,
  each along its own dimension, in one collective; the backward
  reduce-scatters the gradients in one collective (a sum, the data axes:
  each rank's rows contribute to every block), or takes this rank's
  blocks of them (``reduce_back=False``: the gathered leaf is used the
  same way by every rank of those axes, so their gradients are one
  gradient, not parts); :func:`gather` is its one-tensor case;
* :func:`tp_reduce` — all-reduce (sum) over the tensor-parallel axis, the
  backward the identity (the rows after it are replicated on ``tp``);
* :func:`tp_copy` — the identity, the backward an all-reduce over ``tp``
  (a replicated tensor entering a tensor-parallel region).

Groups: one process group a line of every subset of the mesh's axes, made
on all ranks, in one order, the first time a mesh is used; a line's group
ranks are its global ranks in ascending order, which for axes named in the
mesh's order is the row-major index over those axes (the reference's order
of a tuple of axes).

The backend is the process group's, chosen when it was made: NCCL takes
the tensors on the card; gloo moves host memory only, so a tensor on the
card goes through a pinned host buffer (as ``core.halo.P2PTransport``
does).  Gathers and point-to-point copies move bfloat16 as its bytes
(gloo takes no 16-bit integers); reductions run in float32 and round back
once.  Only names that
torch 2.11 and 2.13 both have are used.  :data:`STATS` books the calls,
the operand bytes and the host seconds spent in them.
"""
from __future__ import annotations

import itertools
import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_extents

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_LINES: dict = {}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)


def _book(t: torch.Tensor, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0


def axes_of(axes) -> tuple:
    """None -> (), a name -> (name,), a tuple as it is."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def coordinate(mesh) -> dict:
    """{axis name: this rank's index along it}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _build(mesh) -> dict:
    """This rank's group on every subset of the mesh's axes."""
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh.cpu().numpy()
    me = dist.get_rank()
    mine = {}
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), k):
            rest = [i for i in range(len(names)) if i not in sub]
            n = 1
            for i in sub:
                n *= grid.shape[i]
            for line in grid.transpose(*rest, *sub).reshape(-1, n):
                ranks = sorted(int(r) for r in line)
                group = dist.new_group(ranks)
                if me in ranks:
                    mine[tuple(names[i] for i in sub)] = (
                        group, len(ranks), ranks.index(me), ranks)
    return mine


def line(mesh, axes) -> tuple:
    """(group, size, this rank's index, the line's global ranks) over
    ``axes`` (named in the mesh's order)."""
    axes = axes_of(axes)
    names = tuple(mesh.mesh_dim_names)
    if tuple(a for a in names if a in axes) != axes:
        raise ValueError(f"axes {axes} must be axes of the mesh {names}, "
                         "in its order")
    key = id(mesh)
    if key not in _LINES:
        _LINES[key] = (mesh, _build(mesh))
    return _LINES[key][1][axes]


def prepare(mesh) -> None:
    """Make this rank's group of every line of ``mesh`` now, where a
    process group is up (every rank must call it: the groups are made
    together), so that a collective over one line that only some ranks run
    does not wait for the others to make theirs; a mesh without a process
    group (a stub) has none to make."""
    if dist.is_available() and dist.is_initialized():
        line(mesh, tuple(mesh.mesh_dim_names)[:1])


def size(mesh, axes) -> int:
    ext = mesh_extents(mesh)
    out = 1
    for a in axes_of(axes):
        out *= ext[a]
    return out


# -- plain collectives (no autograd) ----------------------------------------------
def _staged(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend() != "nccl"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    if t.dtype == torch.bfloat16 and t.dim():
        t = t.view(torch.uint8)
    if _staged(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    t = t.to(like.device)
    return t.view(torch.bfloat16) if t.dtype != like.dtype else t


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``op`` over the ranks of ``axes``, in float32 for a
    16-bit ``t``, rounded back once."""
    t0 = time.perf_counter()
    group = line(mesh, axes)[0]
    work = t.float() if t.dtype in (torch.bfloat16, torch.float16) \
        else t.clone()
    buf = _to_wire(work)
    if buf is work:
        buf = work.contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _book(buf, t0)
    return buf.to(t.device).to(t.dtype)


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``axes`` concatenated along ``dim``."""
    t0 = time.perf_counter()
    group, n, _, _ = line(mesh, axes)
    buf = _to_wire(t)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    _book(buf, t0)
    return _from_wire(torch.cat(parts, dim), t)


def all_to_all(t: torch.Tensor, mesh, axes, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """``t``'s ``split_dim`` cut into one equal block a rank of ``axes``
    (block j to the rank at index j of the line), and the blocks this rank
    receives concatenated along ``cat_dim`` in the line's order: one
    ``all_to_all_single``."""
    t0 = time.perf_counter()
    group, n, _, _ = line(mesh, axes)
    if t.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                         f"divide over {n} ranks")
    blocks = t.movedim(split_dim, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])
    buf = _to_wire(blocks)
    got = torch.empty_like(buf)
    dist.all_to_all_single(got, buf, group=group)
    _book(buf, t0)
    got = _from_wire(got, t)                       # (n, block, ...)
    return torch.cat([b.movedim(0, split_dim) for b in got.unbind(0)],
                     cat_dim)


def own_block(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes``."""
    _, n, i, _ = line(mesh, axes)
    b = t.shape[dim] // n
    return t.narrow(dim, i * b, b).contiguous()


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over the ranks of
    ``axes``.  NCCL reduce-scatters; gloo all-reduces and keeps the
    block."""
    if dist.get_backend() != "nccl":
        return own_block(all_reduce(t, mesh, axes), mesh, axes, dim)
    t0 = time.perf_counter()
    group, n, _, _ = line(mesh, axes)
    work = t.float().movedim(dim, 0).contiguous()
    out = torch.empty((work.shape[0] // n, *work.shape[1:]),
                      dtype=work.dtype, device=work.device)
    dist.reduce_scatter_tensor(out, work, group=group)
    _book(work, t0)
    return out.movedim(0, dim).contiguous().to(t.dtype)


def broadcast(t: torch.Tensor, mesh, axes, src_index: int) -> torch.Tensor:
    """``t`` of the rank at index ``src_index`` of the line, on every
    rank of it."""
    t0 = time.perf_counter()
    group, _, _, ranks = line(mesh, axes)
    buf = _to_wire(t.clone())
    dist.broadcast(buf, src=ranks[src_index], group=group)
    _book(buf, t0)
    return _from_wire(buf, t)


def send(t: torch.Tensor, peer: int) -> None:
    """``t`` to the global rank ``peer`` (point to point)."""
    t0 = time.perf_counter()
    buf = _to_wire(t)
    dist.send(buf, dst=peer)
    _book(buf, t0)


def recv(like: torch.Tensor, peer: int) -> torch.Tensor:
    """A tensor shaped as ``like`` from the global rank ``peer``."""
    t0 = time.perf_counter()
    buf = _to_wire(torch.empty_like(like))
    dist.recv(buf, src=peer)
    _book(buf, t0)
    return _from_wire(buf, like)


# -- the autograd Functions --------------------------------------------------------
class _GatherMany(torch.autograd.Function):
    """Blocks ``ts`` (one dtype) gathered over ``axes``, ``ts[i]`` along
    ``dims[i]``: one all-gather of their concatenation; the backward one
    reduce-scatter of the gradients' rank-major blocks."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, reduce_back, *ts):
        ctx.args = (mesh, axes, dims, reduce_back)
        ctx.shapes = [t.shape for t in ts]
        flat = torch.cat([t.reshape(-1) for t in ts])
        parts = all_gather(flat[None], mesh, axes, 0)           # (n, L)
        out, at = [], 0
        for t, d in zip(ts, dims):
            blocks = parts[:, at:at + t.numel()].reshape(-1, *t.shape)
            out.append(torch.cat(blocks.unbind(0), d))
            at += t.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        mesh, axes, dims, reduce_back = ctx.args
        n = line(mesh, axes)[1]
        if not reduce_back:
            blocks = [own_block(g, mesh, axes, d) for g, d in zip(gs, dims)]
        else:
            rows = torch.stack([torch.cat([g.chunk(n, d)[r].reshape(-1)
                                           for g, d in zip(gs, dims)])
                                for r in range(n)])            # (n, L)
            mine = reduce_scatter(rows, mesh, axes, 0)[0]
            blocks, at = [], 0
            for s in ctx.shapes:
                k = s.numel()
                blocks.append(mine[at:at + k].reshape(s))
                at += k
        return (None, None, None, None, *blocks)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return all_reduce(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


def gather_many(ts: list, mesh, axes, dims: list,
                reduce_back: bool = True) -> tuple:
    """Each block of ``ts`` (one dtype) all-gathered over ``axes`` along its
    entry of ``dims``, in one collective; see the module's text for the
    backward."""
    return _GatherMany.apply(mesh, axes_of(axes), tuple(dims), reduce_back,
                             *ts)


def gather(t, mesh, axes, dim: int, reduce_back: bool = True):
    """All-gather along ``dim`` over ``axes`` (:func:`gather_many` of one
    tensor)."""
    return gather_many([t], mesh, axes, [dim], reduce_back)[0]


def tp_reduce(t, shard):
    """Sum over ``shard``'s tensor-parallel axis; backward the identity."""
    return _Reduce.apply(t, shard.mesh, axes_of(shard.tp))


def tp_copy(t, shard):
    """The identity; backward sums the gradient over the tensor-parallel
    axis."""
    return _Copy.apply(t, shard.mesh, axes_of(shard.tp))
