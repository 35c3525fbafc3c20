"""Driver-managed ghost-zone (halo) exchange — the paper's §1.1/§2.

In Cactus, the driver partitions the grid over MPI ranks and fills each
rank's *ghost region* from its neighbours before stencil kernels run.  The
port does the same over ``torch.distributed``: a grid axis decomposed over
a mesh axis sends each face's strip to its neighbour rank with
``batch_isend_irecv`` (the reference's ``lax.ppermute`` per face), and the
edge ranks of a non-periodic axis fill their ghosts from the boundary
rule.  An undecomposed axis degenerates to boundary-condition padding and
periodic wrap.  Axes are padded one after another, so the corners come out
right.

Fields are stored **unpadded**; the halo is materialized transiently per
kernel application (``exchange_pad``).  :func:`stencil_step_overlap` keeps
the reference's interior/shell split: it starts the exchange, computes the
deep interior (which needs no ghosts) while the strips travel, waits, and
computes the thin shells from the padded block.

Fields are ``(*lead, X, Y, Z)``: any leading axes (the farm's slot axis)
pass through untouched.  ``AxisSpec.array_axis`` names a grid axis (0, 1 or
2) and the padding acts on tensor axis ``array_axis - 3``, counted from the
end (:func:`tensor_axis`, the one place that maps the two), so the same
specs pad one grid and a slot batch of grids.  Strips of any axis but a
leading one are not contiguous; they are made contiguous before they are
sent and are received into contiguous buffers.

A decomposed spec carries an :class:`AxisLink`: this rank's place on the
mesh axis and the :class:`Transport` its strips travel by —
:class:`P2PTransport` between processes, or :class:`CountTransport`, which
books the bytes and returns ``meta`` strips for a cost trace.

A BC rule is ``rule(strip, side, axis) -> ghost strip``: the axis is passed
explicitly, as that negative tensor axis (the reference injects it through
a function attribute).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

# A BC rule maps (strip, side, axis) -> ghost strip, where ``strip`` is the
# ``width``-wide slab of interior cells adjacent to the physical boundary
# (ordered as stored, i.e. strip[0] is closest to the domain for side "lo"
# ... strip[-1] closest for side "hi").
BCRule = Callable[[torch.Tensor, str, int], torch.Tensor]

GRID_DIMS = 3


def tensor_axis(array_axis: int) -> int:
    """The tensor axis of grid axis ``array_axis``, counted from the end."""
    if not 0 <= array_axis < GRID_DIMS:
        raise ValueError(f"grid axis {array_axis} not in 0..{GRID_DIMS - 1}")
    return array_axis - GRID_DIMS


def bc_dirichlet(value: float) -> BCRule:
    def rule(strip: torch.Tensor, side: str, axis: int) -> torch.Tensor:
        return torch.full_like(strip, value)

    return rule


def bc_neumann() -> BCRule:
    """Zero-gradient: mirror the adjacent interior cells."""

    def rule(strip: torch.Tensor, side: str, axis: int) -> torch.Tensor:
        return torch.flip(strip, dims=(axis,))

    return rule


def bc_mirror(sign: float = -1.0) -> BCRule:
    """Reflection BC: ghost = sign * mirrored interior (no-slip walls)."""

    def rule(strip: torch.Tensor, side: str, axis: int) -> torch.Tensor:
        return sign * torch.flip(strip, dims=(axis,))

    return rule


# -- transports ----------------------------------------------------------------
class Transport(abc.ABC):
    """How the ghost strips and the small reductions of one mesh axis travel
    between its ranks.

    Every exchange keeps two counts.  ``permute_operand_bytes`` and
    ``permute_ops`` book the strips it is given as the reference's
    ``collective-permute`` operands: one strip a side with a width, on
    every rank — an edge rank of a non-periodic axis too, whose strip on
    that side has no receiver and is never sent.  Their equality with
    ``repro_torch.obs.perf.halo_bytes_per_step``, the analytic count of
    the same operands, is an accounting identity, not a measure of
    traffic.  ``sent_bytes`` and ``sent_ops`` book only the strips that
    have a receiver: what crosses to a neighbour."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.permute_operand_bytes = 0
        self.permute_ops = 0
        self.sent_bytes = 0
        self.sent_ops = 0

    def _book(self, link: "AxisLink", periodic: bool, to_hi, to_lo):
        for s, step in ((to_hi, +1), (to_lo, -1)):
            if s is None:
                continue
            n = s.numel() * s.element_size()
            self.permute_operand_bytes += n
            self.permute_ops += 1
            if link.peer(step, periodic) is not None:
                self.sent_bytes += n
                self.sent_ops += 1

    @abc.abstractmethod
    def start(self, link: "AxisLink", periodic: bool, to_hi, to_lo):
        """Post one exchange: ``to_hi`` (this rank's hi strip, or None)
        goes to the hi neighbour, ``to_lo`` to the lo neighbour.  Returns a
        zero-argument callable that waits and returns ``(from_lo,
        from_hi)``, the neighbours' strips, None where this rank has no
        neighbour on that side."""

    @abc.abstractmethod
    def all_gather(self, link: "AxisLink", t: torch.Tensor) -> torch.Tensor:
        """``(link.size, *t.shape)``: every rank's ``t``, in index order."""

    @abc.abstractmethod
    def all_reduce(self, link: "AxisLink", t: torch.Tensor,
                   op: str) -> torch.Tensor:
        """The elementwise ``"max"`` or ``"min"`` of every rank's ``t``."""


class CountTransport(Transport):
    """Books each strip and returns ``meta`` strips of the shape the
    neighbour would send: the transport of a cost trace on ``meta``
    tensors (``repro_torch.obs.perf.decomposed_step_hlo``), which needs no
    process group."""

    def start(self, link, periodic, to_hi, to_lo):
        self._book(link, periodic, to_hi, to_lo)

        def recv(strip, step):
            if strip is None or link.peer(step, periodic) is None:
                return None
            return torch.empty(strip.shape, dtype=strip.dtype, device="meta")

        got = (recv(to_hi, -1), recv(to_lo, +1))
        return lambda: got

    def all_gather(self, link, t):
        return torch.empty((link.size, *t.shape), dtype=t.dtype,
                           device="meta")

    def all_reduce(self, link, t, op):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")


class P2PTransport(Transport):
    """Strips over ``torch.distributed`` point-to-point, peers by global
    rank.  Under NCCL the device tensors travel as they are (a strip sent
    to this rank itself goes through NCCL too).  Gloo moves host memory
    only: a strip on the card is copied into a pinned host buffer, the copy
    is synchronised before the send, and what arrives is copied back to the
    card; gloo cannot pair a rank with itself, so a strip a rank sends to
    itself (a periodic axis of extent 1) is copied locally.  Reductions
    stage through the host the same way."""

    @staticmethod
    def _staged(t: torch.Tensor) -> bool:
        return t.device.type == "cuda" and dist.get_backend() != "nccl"

    def start(self, link, periodic, to_hi, to_lo):
        self._book(link, periodic, to_hi, to_lo)
        me = link.rank
        hi_peer, lo_peer = link.peer(+1, periodic), link.peer(-1, periodic)
        probe = to_hi if to_hi is not None else to_lo
        gloo = dist.get_backend() != "nccl"
        staged = gloo and probe.device.type == "cuda"
        dev = probe.device
        ops, got, local = [], {}, {}

        def outgoing(t):
            t = t.contiguous()
            if not staged:
                return t
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host

        def incoming(t):
            return torch.empty(t.shape, dtype=t.dtype,
                               device="cpu" if staged else dev,
                               pin_memory=staged)

        # the send toward hi carries tag 0 and lands in the receiver's lo
        # ghost; toward lo, tag 1 and the hi ghost.  Every rank posts them
        # in this order, so NCCL (which ignores tags) pairs them as gloo
        # (which matches them) does, also when both peers are one rank.
        plan = []
        if to_hi is not None:
            plan += [("send", to_hi, hi_peer, 0), ("recv", to_hi, lo_peer, 0)]
        if to_lo is not None:
            plan += [("send", to_lo, lo_peer, 1), ("recv", to_lo, hi_peer, 1)]
        for kind, t, peer, tag in plan:
            if peer is None:
                continue
            if gloo and peer == me:
                if kind == "recv":
                    local["lo" if tag == 0 else "hi"] = t.clone()
                continue
            if kind == "send":
                buf = outgoing(t)
                ops.append(dist.P2POp(dist.isend, buf, peer, tag=tag))
            else:
                buf = incoming(t)
                got["lo" if tag == 0 else "hi"] = buf
                ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        if staged:
            # the sends read host buffers the copies above still fill
            torch.cuda.current_stream(dev).synchronize()
        reqs = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for r in reqs:
                r.wait()
            ops.clear()          # the send buffers lived until here
            out = {k: (v.to(dev, non_blocking=True) if staged else v)
                   for k, v in got.items()}
            out.update(local)
            return out.get("lo"), out.get("hi")

        return wait

    def all_gather(self, link, t):
        src = t.detach()
        staged = self._staged(src)
        if staged:
            src = src.cpu()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in range(link.size)]
        dist.all_gather(parts, src, group=link.group)
        out = torch.stack(parts)
        return out.to(t.device) if staged else out

    def all_reduce(self, link, t, op):
        red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        staged = self._staged(t)
        buf = t.detach().cpu().clone() if staged else t.detach().clone()
        dist.all_reduce(buf, op=red, group=link.group)
        return buf.to(t.device) if staged else buf


@dataclasses.dataclass(frozen=True)
class AxisLink:
    """One decomposed mesh axis as this rank sees it: the axis's ``size``,
    this rank's ``index`` on it, the global ``ranks`` of its line in index
    order, the line's process ``group``, and the ``transport`` its strips
    travel by.  A *virtual* link (no ranks, no group) places a cost trace
    on the axis without any process."""

    name: str
    size: int
    index: int
    ranks: tuple = ()
    group: Any = None
    transport: Transport = dataclasses.field(default_factory=CountTransport)

    @property
    def rank(self) -> int:
        return self.ranks[self.index] if self.ranks else self.index

    def peer(self, step: int, periodic: bool) -> int | None:
        """Global rank ``step`` places along the line (wrapping when
        ``periodic``), None past an edge."""
        j = self.index + step
        if periodic:
            j %= self.size
        elif not 0 <= j < self.size:
            return None
        return self.ranks[j] if self.ranks else j

    @classmethod
    def from_mesh(cls, mesh, name: str, transport: Transport) -> "AxisLink":
        """This rank's link on axis ``name`` of a ``DeviceMesh``."""
        dim = mesh.mesh_dim_names.index(name)
        coord = list(mesh.get_coordinate())
        index = coord[dim]
        coord[dim] = slice(None)
        ranks = tuple(int(r) for r in mesh.mesh[tuple(coord)].tolist())
        return cls(name=name, size=len(ranks), index=index, ranks=ranks,
                   group=mesh.get_group(name), transport=transport)


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """How one grid axis (``array_axis`` in 0..2) is decomposed and
    bounded.

    ``mesh_axis=None`` means the axis is not decomposed: the exchange then
    degenerates to boundary-condition padding.  A decomposed axis names
    its mesh axis and carries this rank's ``link`` on it
    (``GridDriver.axis_specs`` builds both)."""

    array_axis: int
    mesh_axis: str | None = None
    periodic: bool = False
    bc_lo: BCRule | None = None
    bc_hi: BCRule | None = None
    link: AxisLink | None = dataclasses.field(default=None, compare=False)


def _norm_width(w) -> tuple[int, int]:
    """Width spec: int (symmetric) or (lo, hi) one-sided ghost widths."""
    if isinstance(w, int):
        return (w, w)
    lo, hi = w
    return (int(lo), int(hi))


def _start_axis(u: torch.Tensor, width, spec: AxisSpec) -> Callable:
    """Start filling the ghosts along one axis; the returned callable
    finishes (waits for the neighbours' strips) and returns ``u`` padded.
    A decomposed axis posts its strips now; an undecomposed one pads at
    once."""
    wlo, whi = _norm_width(width)
    if wlo == 0 and whi == 0:
        return lambda: u
    ax = tensor_axis(spec.array_axis)
    size = u.shape[ax]
    if size < max(wlo, whi):
        raise ValueError(
            f"local extent {size} on axis {spec.array_axis} smaller than "
            f"halo width {(wlo, whi)}"
        )

    def apply_bc(rule: BCRule | None, strip: torch.Tensor, side: str):
        if rule is None:
            return torch.zeros_like(strip)
        return rule(strip, side, ax)

    if spec.mesh_axis is None:
        from_lo = u.narrow(ax, size - wlo, wlo) if wlo and spec.periodic \
            else None
        from_hi = u.narrow(ax, 0, whi) if whi and spec.periodic else None
        wait = lambda: (from_lo, from_hi)   # noqa: E731
    else:
        if spec.link is None:
            raise ValueError(
                f"axis {spec.array_axis} is decomposed over mesh axis "
                f"{spec.mesh_axis!r} but its spec carries no link to it "
                "(build the specs with GridDriver(domain, device, mesh))")
        # this rank's hi strip becomes the hi neighbour's lo ghost
        wait = spec.link.transport.start(
            spec.link, spec.periodic,
            u.narrow(ax, size - wlo, wlo) if wlo else None,
            u.narrow(ax, 0, whi) if whi else None)

    def finish() -> torch.Tensor:
        from_lo, from_hi = wait()
        parts = [u]
        if wlo:
            parts.insert(0, from_lo if from_lo is not None else
                         apply_bc(spec.bc_lo, u.narrow(ax, 0, wlo), "lo"))
        if whi:
            parts.append(from_hi if from_hi is not None else
                         apply_bc(spec.bc_hi, u.narrow(ax, size - whi, whi),
                                  "hi"))
        return torch.cat(parts, dim=ax)

    return finish


def _pad_axis(u: torch.Tensor, width, spec: AxisSpec) -> torch.Tensor:
    """Fill ghosts along one axis: neighbour exchange, periodic wrap or
    physical BCs."""
    return _start_axis(u, width, spec)()


def exchange_pad(
    u: torch.Tensor, widths: Sequence, specs: Sequence[AxisSpec]
) -> torch.Tensor:
    """Materialize the ghost region: pad ``u`` by ``widths[i]`` along each spec.

    Each width is an int (symmetric) or a ``(lo, hi)`` pair for one-sided
    stencils.  Corner ghosts are produced correctly because later axes
    exchange the already-padded earlier axes (the standard two-phase corner
    trick).  On a decomposed spec every rank of its mesh axis must call it
    with the same widths.
    """
    if len(widths) != len(specs):
        raise ValueError("widths and specs length mismatch")
    for w, spec in zip(widths, specs):
        u = _pad_axis(u, w, spec)
    return u


def exchange_pad_start(
    u: torch.Tensor, widths: Sequence, specs: Sequence[AxisSpec]
) -> Callable[[], torch.Tensor]:
    """:func:`exchange_pad`, started: the axes before the first decomposed
    one are padded now and that axis's strips are posted; the returned
    callable waits for them and pads the remaining axes (their corners
    need that axis's ghosts).  Work enqueued between the two calls runs
    while the strips travel."""
    if len(widths) != len(specs):
        raise ValueError("widths and specs length mismatch")
    pairs = list(zip(widths, specs))
    for i, (w, spec) in enumerate(pairs):
        finish = _start_axis(u, w, spec)
        if spec.mesh_axis is not None and _norm_width(w) != (0, 0):
            rest = pairs[i + 1:]

            def wait(finish=finish, rest=rest):
                v = finish()
                for w2, s2 in rest:
                    v = _pad_axis(v, w2, s2)
                return v

            return wait
        u = finish()
    return lambda: u


def stencil_step_overlap(
    u: torch.Tensor,
    widths: Sequence[int],
    specs: Sequence[AxisSpec],
    kernel: Callable[[torch.Tensor], torch.Tensor],
    kernel_deep: Callable[[torch.Tensor], torch.Tensor] | None = None,
    pad_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Apply ``kernel`` (padded -> interior) with the interior/shell split.

    The *deep interior* of the block needs no ghost data, so ``kernel(u)``
    has no dependency on the padding: the exchange is started first, the
    deep interior is computed while the strips travel, and only then are
    the thin boundary *shells* (width = halo, per face) computed from the
    padded array.

    ``kernel`` must take any shape (maps an array padded by ``widths`` to
    its interior); ``kernel_deep``, if given, is used for the large
    interior block while ``kernel`` handles the thin shells.

    Result equals ``kernel(exchange_pad(u, widths, specs))`` (tested).
    """
    if len(widths) != u.dim():
        raise ValueError("widths must cover every array axis (use 0 to skip)")
    ws = [_norm_width(w) for w in widths]
    # start the exchange FIRST.  pad_fn lets callers pad packed multi-field
    # arrays with per-field BC rules (ghosts matching `widths`); it returns
    # the padded array, or a callable that waits for it (a started exchange)
    pending = (pad_fn(u) if pad_fn is not None
               else exchange_pad_start(u, widths, specs))
    deep = (kernel_deep or kernel)(u)  # no ghost dependency: overlaps
    padded = pending() if callable(pending) else pending

    # Assemble per axis, peeling lo/hi shells computed from the padded array.
    # Output rows [a, b) on an axis with ghosts (lo, hi) need padded rows
    # [a, b + lo + hi).
    def shell(axis: int, side: str, row_lo: list[int], row_hi: list[int]):
        """kernel() over the slab producing the (lo|hi) shell of `axis`."""
        lo, hi = ws[axis]
        sl = []
        for a, ((la, ha), na) in enumerate(zip(ws, u.shape)):
            if a < axis:
                sl.append(slice(row_lo[a], row_hi[a] + la + ha))
            elif a == axis:
                sl.append(slice(0, 2 * lo + hi) if side == "lo"
                          else slice(na - hi, na + lo + hi))
            else:
                sl.append(slice(None))  # full padded extent
        return kernel(padded[tuple(sl)].contiguous())

    # innermost: deep block; wrap outwards in reverse axis order
    out = deep
    row_lo = [lo for lo, _ in ws]
    row_hi = [n - hi for n, (_, hi) in zip(u.shape, ws)]
    for axis in reversed(range(len(ws))):
        lo, hi = ws[axis]
        if lo == 0 and hi == 0:
            continue
        pieces = []
        if lo:
            pieces.append(shell(axis, "lo", row_lo, row_hi))
        pieces.append(out)
        if hi:
            pieces.append(shell(axis, "hi", row_lo, row_hi))
        row_lo[axis] = 0
        row_hi[axis] = u.shape[axis]
        out = torch.cat(pieces, dim=axis) if len(pieces) > 1 else out
    return out
