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
* An op on ``meta`` tensors alone that writes and aliases nothing (its
  schema says so) is run once for each signature (the op, its tensors'
  shapes, strides and dtypes, its other arguments): a repeat returns fresh
  ``meta`` tensors of the recorded shapes and strides without running the
  op's meta function again, which for many ops is Python.  The counts are
  the same; a loop over tokens (the sLSTM's) traces in a fraction of the
  time.
* The counter also follows the **live bytes** of what the trace allocates
  (the counterpart of XLA's ``memory_analysis().peak_memory_in_bytes``):
  a storage counts once, when an op under the trace first returns it, and
  is released when the last tensor on it dies; views, in-place results and
  the storages the trace was given (its arguments) count nothing.
  ``peak_bytes`` is the most that was live at once.  With ``count(...,
  grad=True)`` autograd stays on, so a train step's backward (and remat's
  recompute) is traced and what autograd saves for it stays live, as on
  the card.
"""
from __future__ import annotations

import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

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


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """Whether ``func`` returns only new tensors and writes nothing: no
    alias annotation on an argument or a return (views, in-place and
    ``out=`` ops have one)."""
    sch = func._schema
    return (not any(a.alias_info for a in sch.arguments)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in sch.returns))


def _key(x, tensors: list):
    """A hashable signature of argument ``x`` (a tensor by its metadata),
    collecting its tensors into ``tensors``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, *(_key(v, tensors) for v in x))
    if isinstance(x, dict):
        return tuple((k, _key(v, tensors)) for k, v in sorted(x.items()))
    hash(x)
    return (type(x).__name__, x)


def _tensors(x, into: list) -> list:
    """The tensors of an op's arguments or result (nested tuples, lists and
    dicts), into ``into``."""
    if isinstance(x, torch.Tensor):
        into.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, into)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, into)
    return into


def _spec(out):
    """(whether a tuple, each tensor's metadata) of a ``meta`` result, or
    None for any other."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in outs):
        return None
    return (isinstance(out, tuple),
            tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs))


def _remake(spec):
    many, specs = spec
    outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                     device="meta")
                 for shape, stride, dtype in specs)
    return outs if many else outs[0]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree, []))


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


def attention_counts(sq: int, sk: int, causal: bool, q_offset: int,
                     prefix_len: int) -> tuple[int, int]:
    """(query-key pairs, key rows some query sees) of one batch row of
    :func:`attention_mask` with every key valid, without building the
    mask: each row sees the keys [0, clamp(max(i + q_offset + 1,
    prefix_len), 0, sk))."""
    if not causal:
        return sq * sk, sk if sq else 0
    seen = torch.clamp(torch.clamp(torch.arange(sq) + q_offset + 1,
                                   min=prefix_len), 0, sk)
    return int(seen.sum()), int(seen.max()) if sq else 0


def _flash_cost(q, k, kv_rows: int, pairs: int) -> tuple[int, int]:
    _, _, h, d = q.shape
    kh = k.shape[2]
    nbytes = 2 * q.numel() * q.element_size() + 2 * kv_rows * kh * d * \
        k.element_size()
    return nbytes, 4 * h * d * pairs


def lse_bytes(q) -> int:
    """The log-sum-exp output of a ``return_lse`` call: float32 (B, Sq, H)."""
    return q.shape[0] * q.shape[1] * q.shape[2] * 4


def flash_attention_cost(q, k, mask, valid=None,
                         lse: bool = False) -> tuple[int, int]:
    """FLASH_ATTENTION on q (B, Sq, H, D) and k/v (B, Sk, KH, D): q and the
    output once, the k/v rows some query row sees (``mask`` from
    :func:`attention_mask`), the valid lengths and, with ``lse``, the
    log-sum-exp output; 4·D operations per (head, query, key) pair the
    mask keeps: what this call's data needs."""
    nbytes, ops = _flash_cost(q, k, int(mask.any(dim=1).sum()),
                              int(mask.sum()))
    if valid is not None:
        nbytes += valid.numel() * 8
    return nbytes + (lse_bytes(q) if lse else 0), ops


def flash_attention_spec_cost(q, k, causal: bool, q_offset: int,
                              prefix_len: int,
                              lse: bool = False) -> tuple[int, int]:
    """:func:`flash_attention_cost` with every key valid, from the mask's
    parameters (:func:`attention_counts`): a cost trace's call, whose
    (B, Sq, Sk) mask could take gigabytes at 32k positions."""
    b, sq = q.shape[:2]
    pairs, rows = attention_counts(sq, k.shape[1], causal, q_offset,
                                   prefix_len)
    nbytes, ops = _flash_cost(q, k, b * rows, b * pairs)
    return nbytes + (lse_bytes(q) if lse else 0), ops


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
    wrappers by their declared cost, each by op class (:attr:`classes`)
    and by op (:attr:`ops`); and the live bytes of the storages the ops
    allocate, with their peak."""

    def __init__(self):
        super().__init__()
        self.classes: dict[str, dict] = {}
        self.ops: dict[str, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        # storages seen alive, by their StorageImpl's address: the bytes
        # each counts (0 for one the trace did not allocate)
        self._storages: dict[int, int] = {}
        # the recorded results of fresh ops, by signature
        self._memo: dict = {}

    def add(self, cls: str, nbytes: float, flops: float,
            op: str | None = None) -> None:
        """Book one call of class ``cls``, and of ``op`` in :attr:`ops`
        (the aten op's name; a kernel's is its class)."""
        for table, key in ((self.classes, cls), (self.ops, op or cls)):
            row = table.setdefault(key, {"bytes": 0.0, "flops": 0.0,
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

    def _release(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key)

    def _see(self, t: torch.Tensor, allocated: bool) -> None:
        """Note ``t``'s storage: counted when ``allocated`` and new."""
        s = t.untyped_storage()
        key = s._cdata
        if key in self._storages:
            return
        nbytes = s.nbytes() if allocated else 0
        self._storages[key] = nbytes
        weakref.finalize(s, self._release, key)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _run(self, func, args, kwargs, ins: list):
        """``func``'s result: recorded for a fresh op's signature, or run
        (and recorded when it returned ``meta`` tensors)."""
        if not _fresh(func):
            _tensors((args, kwargs), ins)
            return func(*args, **kwargs)
        try:
            key = (func, _key(args, ins), _key(kwargs, ins))
        except TypeError:                   # an argument with no hash
            ins.clear()
            _tensors((args, kwargs), ins)
            return func(*args, **kwargs)
        if any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)    # a shape may follow its values
        spec = self._memo.get(key)
        if spec is not None:
            return _remake(spec)
        out = func(*args, **kwargs)
        spec = _spec(out)
        if spec is not None:
            self._memo[key] = spec
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins: list = []
        out = self._run(func, args, kwargs, ins)
        for t in ins:
            self._see(t, allocated=False)
        outs = _tensors(out, [])
        for t in outs:
            self._see(t, allocated=True)
        if func.is_view or func in _FREE:
            return out
        cls = _CLASS.get(func, "other")
        reads = 0 if cls == "fill" else _nbytes(ins)
        flops = 0
        if func in _MATMUL:
            a = args[_MATMUL[func]]
            flops = 2 * out.numel() * a.shape[-1]
        self.add(cls, reads + _nbytes(outs), flops, str(func))
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


def count(fn, *args, grad: bool = False) -> OpCounter:
    """Run ``fn(*args)`` (``meta`` tensors) once to fill the caches a
    steady step finds filled (constant tables, 0-dim divisors), then once
    more under an :class:`OpCounter`, which it returns.  With ``grad``
    (a train step) autograd stays on and ``fn`` runs once, under the
    counter: a second run would double a trace that is long."""
    if grad:
        with torch.enable_grad(), OpCounter() as counter:
            fn(*args)
        return counter
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
