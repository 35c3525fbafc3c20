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
  (a replicated tensor entering a tensor-parallel region);
  :func:`sum_back` is the same for many tensors, one all-reduce of their
  gradients in float32 (parameters used on a sequence block, whose
  gradients are parts);
* :func:`exchange` — :func:`all_to_all` that trains: the backward is the
  same exchange of the gradient with the split and concatenation dims
  swapped;
* :func:`seq_split` — this rank's block of a tensor replicated on the
  axes; the backward all-gathers the blocks' gradients (every rank of
  the line holds the whole tensor, and each block's gradient is that of
  the rank that used it).

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
the operand bytes and the host seconds spent in them, and under
``by_kind`` the calls, operand bytes and wire bytes of each kind of
collective (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all``, ``broadcast`` (a tensor's, or a host object's pickle,
:func:`broadcast_object`), and ``permute`` for a point-to-point
send, ``recv`` for its receive).  The bytes are booked as the operation
means them: gloo's reduce-scatter, an all_to_all whose rows each rank
sums on its device, is booked as a reduce-scatter of its float32 operand.  The wire bytes take
the reference's ring factors on the line's N ranks
(``repro.launch.hlo_analysis``): all-reduce 2(N-1)/N, all-gather N-1
(the operand is the block), reduce-scatter and all-to-all (N-1)/N, a
send 1; a broadcast 1 (each rank receives the operand once) and a receive
0 (its bytes are a peer's send).

**Counting mode.**  On a mesh with a true ``counting`` attribute
(:class:`repro_torch.launch.mesh.CountingMesh`: extents, axis names and
one rank's coordinate, no process group) every collective books what the
live call books and returns an empty tensor of the live result's shape
and dtype on the input's device (``meta`` in the dry run), running
nothing; the model code is the same in both modes, so a rank's step is
reckoned, collectives included, before any rank is started.
"""
from __future__ import annotations

import itertools
import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_extents

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "by_kind": {}}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_LINES: dict = {}
# the most elements a rank's float32 slice of a gloo reduce-scatter holds
# (256 MB)
GLOO_SLICE = 1 << 26
# wire bytes per operand byte of a collective over N ranks
RING = {"all_reduce": lambda n: 2.0 * (n - 1) / n,
        "all_gather": lambda n: float(n - 1),
        "reduce_scatter": lambda n: (n - 1) / n,
        "all_to_all": lambda n: (n - 1) / n,
        "broadcast": lambda n: 1.0,
        "permute": lambda n: 1.0,
        "recv": lambda n: 0.0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, by_kind={})


def _book(kind: str, nbytes: int, n: int, t0: float) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    STATS["seconds"] += time.perf_counter() - t0
    row = STATS["by_kind"].setdefault(
        kind, {"calls": 0, "bytes": 0, "wire_bytes": 0.0})
    row["calls"] += 1
    row["bytes"] += nbytes
    row["wire_bytes"] += nbytes * RING[kind](n)


def counting(mesh) -> bool:
    """Whether ``mesh`` is a counting mesh (the module's text)."""
    return bool(getattr(mesh, "counting", False))


def _nbytes(t: torch.Tensor, dtype=None) -> int:
    return t.numel() * (dtype.itemsize if dtype is not None
                        else t.element_size())


def _reduced_dtype(t: torch.Tensor):
    """The dtype a reduction runs in: float32 for a 16-bit float."""
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=like.dtype, device=like.device)


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


def _counted_line(mesh, axes: tuple) -> tuple:
    """A counting mesh's line: (None, size, index, global ranks), the
    ranks row-major over the mesh as ``_build`` lays them out."""
    names = tuple(mesh.mesh_dim_names)
    ext = mesh_extents(mesh)
    coord = coordinate(mesh)
    n, i = 1, 0
    for a in axes:
        n *= ext[a]
        i = i * ext[a] + coord[a]
    ranks = []
    for j in range(n):
        at, rest = dict(coord), j
        for a in reversed(axes):
            at[a], rest = rest % ext[a], rest // ext[a]
        r = 0
        for a in names:
            r = r * ext[a] + at[a]
        ranks.append(r)
    return None, n, i, sorted(ranks)


def line(mesh, axes) -> tuple:
    """(group, size, this rank's index, the line's global ranks) over
    ``axes`` (named in the mesh's order); a counting mesh's group is
    None."""
    axes = axes_of(axes)
    names = tuple(mesh.mesh_dim_names)
    if tuple(a for a in names if a in axes) != axes:
        raise ValueError(f"axes {axes} must be axes of the mesh {names}, "
                         "in its order")
    if counting(mesh):
        return _counted_line(mesh, axes)
    key = id(mesh)
    if key not in _LINES:
        _LINES[key] = (mesh, _build(mesh))
    return _LINES[key][1][axes]


def prepare(mesh) -> None:
    """Make this rank's group of every line of ``mesh`` now, where a
    process group is up (every rank must call it: the groups are made
    together), so that a collective over one line that only some ranks run
    does not wait for the others to make theirs; a mesh without a process
    group (a stub, a counting mesh) has none to make."""
    if counting(mesh):
        return
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
    group, n, _, _ = line(mesh, axes)
    nbytes = _nbytes(t, _reduced_dtype(t))
    if counting(mesh):
        _book("all_reduce", nbytes, n, t0)
        return _empty(t.shape, t)
    work = t.float() if t.dtype in (torch.bfloat16, torch.float16) \
        else t.clone()
    buf = _to_wire(work)
    if buf is work:
        buf = work.contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _book("all_reduce", nbytes, n, t0)
    return buf.to(t.device).to(t.dtype)


def all_gather(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``axes`` concatenated along ``dim``."""
    t0 = time.perf_counter()
    group, n, _, _ = line(mesh, axes)
    if counting(mesh):
        _book("all_gather", _nbytes(t), n, t0)
        shape = list(t.shape)
        shape[dim] *= n
        return _empty(shape, t)
    buf = _to_wire(t)
    got = torch.empty((n, *buf.shape), dtype=buf.dtype,
                      pin_memory=_staged(t))
    dist.all_gather(list(got.unbind(0)), buf, group=group)
    _book("all_gather", _nbytes(t), n, t0)
    return torch.cat(_from_wire(got, t).unbind(0), dim)


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
    if counting(mesh):
        _book("all_to_all", _nbytes(t), n, t0)
        shape = list(t.shape)
        shape[split_dim] //= n
        shape[cat_dim] *= n
        return _empty(shape, t)
    blocks = t.movedim(split_dim, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])
    buf = _to_wire(blocks)
    got = torch.empty_like(buf)
    dist.all_to_all_single(got, buf, group=group)
    _book("all_to_all", _nbytes(t), n, t0)
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
    ``axes``, summed in float32 and rounded back once.  NCCL
    reduce-scatters; gloo has no reduce-scatter, so each float32 slice of
    at most :data:`GLOO_SLICE` elements a rank goes through one
    all_to_all (row j to rank j) and the rows this rank receives are
    summed on its device in the line's order (booked as the one
    reduce-scatter it stands for).  That moves (N-1)/N of the operand a
    rank where an all-reduce would move twice that and sum on the host,
    and the card holds one slice's rows at a time beside the block."""
    t0 = time.perf_counter()
    group, n, _, _ = line(mesh, axes)
    nbytes = _nbytes(t, torch.float32)
    shape = list(t.shape)
    shape[dim] //= n
    if counting(mesh):
        _book("reduce_scatter", nbytes, n, t0)
        return _empty(shape, t)
    if dist.get_backend() != "nccl":
        rows = t.movedim(dim, 0).reshape(n, -1)
        out = torch.empty(rows.shape[1], dtype=t.dtype, device=t.device)
        for a in range(0, rows.shape[1], GLOO_SLICE):
            buf = _to_wire(rows[:, a:a + GLOO_SLICE].to(torch.float32,
                                                         copy=True))
            got = torch.empty_like(buf, pin_memory=_staged(t))
            dist.all_to_all_single(got, buf, group=group)
            got = got.to(t.device)
            acc = got[0].clone()
            for k in range(1, n):
                acc += got[k]
            out[a:a + GLOO_SLICE].copy_(acc)
            del buf, got, acc
        _book("reduce_scatter", nbytes, n, t0)
        block = (shape[dim], *(s for d, s in enumerate(shape) if d != dim))
        return out.reshape(block).movedim(0, dim).contiguous()
    work = t.float().movedim(dim, 0).contiguous()
    out = torch.empty((work.shape[0] // n, *work.shape[1:]),
                      dtype=work.dtype, device=work.device)
    dist.reduce_scatter_tensor(out, work, group=group)
    _book("reduce_scatter", nbytes, n, t0)
    return out.movedim(0, dim).contiguous().to(t.dtype)


def broadcast(t: torch.Tensor, mesh, axes, src_index: int) -> torch.Tensor:
    """``t`` of the rank at index ``src_index`` of the line, on every
    rank of it."""
    t0 = time.perf_counter()
    group, n, _, ranks = line(mesh, axes)
    if counting(mesh):
        _book("broadcast", _nbytes(t), n, t0)
        return _empty(t.shape, t)
    buf = _to_wire(t.clone())
    dist.broadcast(buf, src=ranks[src_index], group=group)
    _book("broadcast", _nbytes(t), n, t0)
    return _from_wire(buf, t)


def broadcast_object(obj, src: int = 0):
    """A picklable host object of global rank ``src`` on every rank of the
    world group: its pickle's length, then its bytes (two broadcasts, on
    this rank's card under NCCL).  ``src`` returns ``obj`` itself, the
    others an unpickled copy; ``obj`` is read on ``src`` alone.  Without
    a process group, or in a world of one, it is ``obj``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    t0 = time.perf_counter()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    me = dist.get_rank()
    data = (torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
            if me == src else None)
    n = torch.tensor([data.numel() if me == src else 0], dtype=torch.int64,
                     device=dev)
    dist.broadcast(n, src=src)
    buf = (data.to(dev) if me == src
           else torch.empty(int(n.item()), dtype=torch.uint8, device=dev))
    dist.broadcast(buf, src=src)
    _book("broadcast", buf.numel(), dist.get_world_size(), t0)
    return obj if me == src else pickle.loads(buf.cpu().numpy().tobytes())


def send(t: torch.Tensor, peer: int) -> None:
    """``t`` to the global rank ``peer`` (point to point)."""
    t0 = time.perf_counter()
    buf = _to_wire(t)
    dist.send(buf, dst=peer)
    _book("permute", _nbytes(t), 2, t0)


def recv(like: torch.Tensor, peer: int) -> torch.Tensor:
    """A tensor shaped as ``like`` from the global rank ``peer``."""
    t0 = time.perf_counter()
    buf = _to_wire(torch.empty_like(like))
    dist.recv(buf, src=peer)
    _book("recv", _nbytes(like), 2, t0)
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


class _SumBack(torch.autograd.Function):
    """The identity on each tensor of ``ts``; the backward sums their
    gradients over ``axes`` in one all-reduce of their float32
    concatenation, each rounded back to its dtype once."""

    @staticmethod
    def forward(ctx, mesh, axes, *ts):
        ctx.args = (mesh, axes)
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        flat = all_reduce(torch.cat([g.float().reshape(-1) for g in gs]),
                          *ctx.args)
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
            at += g.numel()
        return (None, None, *out)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, split_dim, cat_dim):
        ctx.args = (mesh, axes, split_dim, cat_dim)
        return all_to_all(t, mesh, axes, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, cat_dim = ctx.args
        return all_to_all(g, mesh, axes, cat_dim, split_dim), None, None, \
            None, None


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return own_block(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return all_gather(g.contiguous(), mesh, axes, dim), None, None, None


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


def sum_back(ts: list, mesh, axes) -> tuple:
    """The tensors ``ts`` as they are; the backward sums each one's
    gradient over ``axes`` (one all-reduce for all of them)."""
    return _SumBack.apply(mesh, axes_of(axes), *ts)


def exchange(t, mesh, axes, split_dim: int, cat_dim: int):
    """:func:`all_to_all` under autograd: the backward sends each block
    of the gradient back to the rank it came from (the same exchange with
    ``split_dim`` and ``cat_dim`` swapped)."""
    return _Exchange.apply(t, mesh, axes_of(axes), split_dim, cat_dim)


def seq_split(t, mesh, axes, dim: int):
    """This rank's block along ``dim`` over ``axes`` of a tensor every rank
    of the line holds whole; the backward all-gathers the blocks'
    gradients."""
    return _SeqSplit.apply(t, mesh, axes_of(axes), dim)
