"""Cost model of what a step runs: FLOPs and HBM bytes of one invocation.

Stands in for the reference's ``repro.launch.hlo_cost`` and
``repro.launch.hlo_analysis``, which parse the HLO text XLA compiles and
have no torch meaning: PyTorch runs eagerly, so the port counts the step by
running it once on ``meta`` tensors of the real shapes under a counting
``TorchDispatchMode`` (:class:`OpCounter`).  A ``meta`` tensor has a shape
and no data, so the trace costs no device time and touches no field,
counter or launch of the live run.

* Each aten op outside a kernel books the bytes of its tensor inputs read
  and its outputs written; views and bare allocations book nothing, a fill
  books only what it writes.  FLOPs follow ``hlo_cost``'s conventions where
  they have a torch meaning: a matrix product is 2·prod(result)·K, and
  elementwise work books bytes only (it is bandwidth-bound and priced by
  the bytes term).
* Each hand-written kernel books its declared cost instead: on a ``meta``
  tensor its wrapper returns ``torch.empty`` outputs, launches nothing and
  calls :func:`book` with the bytes and operations of the formulas below,
  the ones ``chip_smoke.py`` computes its bounds from.  The trace therefore
  follows the CUDA template's own glue code, and the kernel part of a count
  is the same work whatever implements it.
* Every count is attributed to an op class (the counterpart of
  ``hlo_cost``'s per-opcode attribution): each kernel by name, and ``cat``
  (``torch.cat``/``torch.stack`` copies, the ghost-zone padding), ``flip``,
  ``fill`` and ``other`` for the rest.
* :func:`safe_count` never raises into a drive loop: a trace that fails
  gives ``status="unparsed"`` and the error, as ``hlo_cost.safe_analyze``
  does.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

# float32 operations per interior cell of each stencil (and per cell and
# sweep of JACOBI_FUSED), counted from the kernel sources
# (csrc/stencil3d.cu, csrc/jacobi.cu), an FMA as two; none depends on the
# data
OPS_PER_CELL = {"UPDATE_VELOCITY": 144, "DIVERGENCE": 6,
                "JACOBI_PRESSURE": 11, "PROJECT_VELOCITY": 10,
                "JACOBI_FUSED": 11}

_aten = torch.ops.aten
_CLASS = {
    _aten.cat.default: "cat", _aten.stack.default: "cat",
    _aten.flip.default: "flip",
    _aten.full.default: "fill", _aten.full_like.default: "fill",
    _aten.zeros.default: "fill", _aten.zeros_like.default: "fill",
    _aten.ones.default: "fill", _aten.ones_like.default: "fill",
    _aten.fill_.Scalar: "fill", _aten.fill.Scalar: "fill",
    _aten.zero_.default: "fill",
}
# allocations: no data moves
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.lift_fresh.default}
# matrix products: (index of the left operand in args)
_MATMUL = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.addmm.default: 1,
           _aten.baddbmm.default: 1}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# -- declared kernel costs: (bytes, operations) of one call ------------------
def stencil_cost(name: str, inputs, outs, table) -> tuple[int, int]:
    """A stencil kernel: each input, output and the parameter table once;
    ``OPS_PER_CELL[name]`` per output cell (slots included)."""
    nbytes = _nbytes(list(inputs)) + _nbytes(list(outs)) + _nbytes(table)
    return nbytes, OPS_PER_CELL[name] * outs[0].numel()


def jacobi_fused_cost(p, rhs, out, sweeps: int) -> tuple[int, int]:
    """JACOBI_FUSED: p, rhs and the output once; sweep s updates the
    interior grown by ``sweeps - s`` rings."""
    lead = math.prod(out.shape[:-3])
    ops = OPS_PER_CELL["JACOBI_FUSED"] * lead * sum(
        math.prod(n + 2 * (sweeps - s) for n in out.shape[-3:])
        for s in range(1, sweeps + 1))
    return _nbytes([p, rhs, out]), ops


def attention_mask(b: int, sq: int, sk: int, causal: bool, q_offset: int,
                   prefix_len: int, valid=None, device="cpu"):
    """(B, Sq, Sk) boolean: which keys each query row sees (``valid``: the
    (B,) valid key lengths, ``None`` for all)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m = (kpos <= qpos + q_offset) | (kpos < prefix_len)
    v = torch.full((b,), sk, device=device) if valid is None else valid
    return m[None] & (kpos[None] < v[:, None, None])


def flash_attention_cost(q, k, mask, valid=None) -> tuple[int, int]:
    """FLASH_ATTENTION on q (B, Sq, H, D) and k/v (B, Sk, KH, D): q and the
    output once, the k/v rows some query row sees (``mask`` from
    :func:`attention_mask`), the valid lengths; 4·D operations per (head,
    query, key) pair the mask keeps: what this call's data needs."""
    _, _, h, d = q.shape
    kh = k.shape[2]
    kv_rows = int(mask.any(dim=1).sum())
    nbytes = 2 * q.numel() * q.element_size() + 2 * kv_rows * kh * d * \
        k.element_size()
    if valid is not None:
        nbytes += valid.numel() * 8
    return nbytes, 4 * h * d * int(mask.sum())


def ssd_intra_cost(args, out) -> tuple[int, int]:
    """SSD_INTRA on (x, log_decay, in_scale, b_, c_, s_in) with x (B, nc,
    L, G, R, P) and b_ (B, nc, L, G, N): every input and the output once;
    per (batch, chunk, group) the causal half of C·Bᵀ, and per head the
    weights (exp, two products), W·x over m <= l, C·s_in and its scaling."""
    bsz, nc, l, g, r, p = args[0].shape
    n = args[3].shape[-1]
    tri = l * (l + 1) // 2
    ops = bsz * nc * g * (tri * 2 * n + r * (tri * (2 * p + 3)
                                             + l * (2 * n * p + 2 * p)))
    return _nbytes(list(args)) + _nbytes(out), ops


# -- the counter ---------------------------------------------------------------
_ACTIVE: list["OpCounter"] = []


def book(name: str, nbytes: float, ops: float) -> None:
    """A kernel wrapper's declared cost, booked with the innermost active
    :class:`OpCounter` (nothing outside one)."""
    if _ACTIVE:
        _ACTIVE[-1].add(name, nbytes, ops)


class OpCounter(TorchDispatchMode):
    """Counts what runs under it: aten ops by their tensors' bytes, kernel
    wrappers by their declared cost, each by op class."""

    def __init__(self):
        super().__init__()
        self.classes: dict[str, dict] = {}

    def add(self, cls: str, nbytes: float, flops: float) -> None:
        row = self.classes.setdefault(cls, {"bytes": 0.0, "flops": 0.0,
                                            "calls": 0})
        row["bytes"] += float(nbytes)
        row["flops"] += float(flops)
        row["calls"] += 1

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE:
            return out
        cls = _CLASS.get(func, "other")
        reads = 0 if cls == "fill" else _nbytes((args, kwargs))
        flops = 0
        if func in _MATMUL:
            a = args[_MATMUL[func]]
            flops = 2 * out.numel() * a.shape[-1]
        self.add(cls, reads + _nbytes(out), flops)
        return out

    @property
    def flops(self) -> float:
        return sum(r["flops"] for r in self.classes.values())

    @property
    def hbm_bytes(self) -> float:
        return sum(r["bytes"] for r in self.classes.values())


def meta_like(tree):
    """``tree`` with every tensor replaced by an empty ``meta`` tensor of
    its shape and dtype (the live tensors are never read)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, tree)


def count(fn, *args) -> OpCounter:
    """Run ``fn(*args)`` (``meta`` tensors) once to fill the caches a
    steady step finds filled (constant tables, 0-dim divisors), then once
    more under an :class:`OpCounter`, which it returns."""
    with torch.no_grad():
        fn(*args)
        with OpCounter() as counter:
            fn(*args)
    return counter


def safe_count(fn, *args) -> tuple[OpCounter | None, str, str | None]:
    """``(counter, status, error)``: :func:`count`, or ``(None,
    "unparsed", error)`` when the trace raises — never into a drive
    loop."""
    try:
        return count(fn, *args), "ok", None
    except Exception as e:     # a step the trace cannot follow
        return None, "unparsed", f"{type(e).__name__}: {e}"
