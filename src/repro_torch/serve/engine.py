"""Batched serving engine: continuous batching over a fixed-slot cache.

The port's copy of ``repro.serve.engine``: a fixed decode batch of
``slots``, each slot holding one request's KV/SSM state at a fixed
``max_seq`` budget (float32 caches).  Requests queue in a ``SlotTable``;
whenever a slot frees (EOS or length budget), the next request is prefilled
into that slot and decoding continues for the whole batch every step.
Per-slot lengths live on the host; the device step is one ``decode_step``
over the full slot batch (free slots decode garbage that the host ignores).

Admission keeps the reference's bucketing exactly: the prompt is padded
with token 0 up to its length bucket, the whole bucket is prefilled into
the slot, and the last real prompt token is decoded again at position
``plen - 1`` to give the first new token.  For attention that re-decode is
harmless (the pads are masked and the KV rewrite is idempotent); for the
hybrid family the Mamba states absorb the pads and the repeated token, so
zamba2's and xlstm's tokens depend on the bucket, as they do in the
reference (ROADMAP queue 3).  The port prefills into views of the slot's
cache rows, first set to a fresh cache's values (``model.reset_caches``:
zeros, and the sLSTM max-state's -1e30), where the reference prefills a
fresh one-slot cache and copies it in: the same values.  Each cache leaf's
slot axis is found as the reference finds it, as the axis whose extent
follows the number of slots (1 under a stacked layer axis, 0 for the
``ssm`` family's per-layer states).

Over a mesh of ranks (``shard=make_shard_cfg(mesh, cfg, slots)``, every
rank building its engine with the same arguments), each rank holds its
block of the caches as ``cache_spec_tree`` places them
(``dist.sharding.local_caches``): the slots of its ``dp`` index and, of the
attention KV caches, its ``tp`` rank's block of the sequence; the model's
parameters are taken once in the form their use takes
(``dist.sharding.serving_params``).  A request's prefill runs on the ranks
that hold its slot (its data index's ``tp`` line); the decode step runs on
every rank, and its logits come back gathered, so that every rank makes
the same host decisions (the same ``SlotTable`` admissions, tokens and
finished requests).  The training postures serve as the reference's
do: under ``moe_mode="a2a"`` a decode step raises ``ValueError`` (its one
token does not split over ``tp``), and under ``ssm_sp`` a prefill does
(the sequence-parallel Mamba2 block returns no state to cache).

``device`` and ``backend`` mean what they mean in ``repro_torch.api``:
``device`` None is ``cuda``; ``backend`` ``torch`` runs the plain versions,
``cuda`` the hand-written kernels (a card only), ``auto`` the kernels on the
card and the plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_backend, resolve_device
from repro_torch.dist import collectives, sharding
from repro_torch.models import model
from repro_torch.models.config import LOCAL, ModelConfig, ShardCfg
from repro_torch.serve.slots import SlotTable


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int
    max_new_tokens: int = 32
    eos_id: int | None = None
    # filled by the engine
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


def _map(fn, tree, *rest):
    """``fn`` over the tensors of a cache tree (dicts, tuples and named
    tuples of tensors) and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in
                tree.items()}
    if isinstance(tree, tuple):
        out = [_map(fn, *leaves) for leaves in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def _batch_axes(cfg: ModelConfig, slots: int, max_seq: int):
    """Each cache leaf's slot axis: the one whose extent differs between
    caches for ``slots`` and ``slots + 1`` (shapes on ``meta``)."""
    shapes = [model.init_caches(cfg, n, max_seq, torch.float32, "meta")
              for n in (slots, slots + 1)]
    return _map(lambda a, b: next(i for i, (u, v) in
                                  enumerate(zip(a.shape, b.shape)) if u != v),
                *shapes)


def _slot_view(caches, axes, s: int):
    """Each cache leaf's rows for slot ``s`` along its slot axis, as
    views."""
    return _map(lambda t, ax: t.narrow(ax, s, 1), caches, axes)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_seq: int = 512, shard: ShardCfg = LOCAL,
                 device=None, backend: str = "auto"):
        self.device = resolve_device(device)
        self.template = resolve_backend(backend, self.device)
        where = next(params.parameters()).device
        if where.type != self.device.type:
            raise ValueError(f"params are on {where}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.shard = shard
        self.table = SlotTable(slots)
        self.finished: list[Request] = []
        self.lengths = np.zeros((slots,), np.int64)   # filled tokens per slot
        self.budgets = np.zeros((slots,), np.int64)
        self.kv_block = None
        self.rows = slice(0, slots)          # the slots this rank holds
        self._prefill_shard = shard
        if shard.mesh is None:
            self.caches = model.init_caches(cfg, slots, max_seq,
                                            torch.float32, self.device)
        else:
            collectives.prepare(shard.mesh)
            self.params = sharding.serving_params(params, cfg, shard)
            self.caches, self.kv_block = sharding.local_caches(
                cfg, slots, max_seq, shard, torch.float32, self.device)
            self.rows = sharding.local_rows(slots, shard)
            # one slot's prefill: its rows only, on its data index's ranks
            self._prefill_shard = dataclasses.replace(shard,
                                                      batch_sharded=False)
        self._batch_axes = _batch_axes(cfg, slots, max_seq)
        self.last_token = np.zeros((slots, 1), np.int64)
        self.steps = 0

    # -- request intake ---------------------------------------------------------
    def submit(self, req: Request):
        self.table.submit(req)

    @property
    def active(self) -> list[Request | None]:
        return [self.table.get(s) for s in range(self.slots)]

    def _admit(self):
        while True:
            admitted = self.table.admit_next()
            if admitted is None:
                return
            s, req = admitted
            plen = len(req.prompt)
            if self.rows.start <= s < self.rows.stop:
                toks = np.zeros((1, _bucket(plen)), np.int64)
                toks[0, :plen] = req.prompt
                one_cache = _slot_view(self.caches, self._batch_axes,
                                       s - self.rows.start)
                model.reset_caches(self.cfg, one_cache)
                model.prefill(
                    self.params, self.cfg,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    one_cache, self._prefill_shard, template=self.template,
                    kv_block=self.kv_block)
            # re-decode the last real prompt token at position plen-1: it
            # yields the first new token (bucketed pads beyond plen are
            # masked by the per-slot valid length)
            self.lengths[s] = plen - 1
            self.budgets[s] = req.max_new_tokens
            self.last_token[s, 0] = int(req.prompt[-1])

    # -- one engine step -------------------------------------------------------
    def step(self):
        self._admit()
        if self.table.n_active == 0:
            return False
        cache_len = torch.from_numpy(self.lengths[self.rows]).to(self.device)
        token = torch.from_numpy(self.last_token[self.rows]).to(self.device)
        logits, self.caches = model.decode_step(
            self.params, self.cfg, token, self.caches, cache_len, self.shard,
            template=self.template, kv_block=self.kv_block)
        toks = logits[:, -1].argmax(dim=-1).cpu().numpy()
        self.steps += 1
        for s, req in list(self.table.occupied()):
            t = int(toks[s])
            req.output.append(t)
            self.last_token[s, 0] = t
            self.lengths[s] += 1
            self.budgets[s] -= 1
            if ((req.eos_id is not None and t == req.eos_id)
                    or self.budgets[s] <= 0
                    or self.lengths[s] >= self.max_seq - 1):
                req.done = True
                self.finished.append(req)
                self.table.release(s)
                self.lengths[s] = 0
        return True

    def run_until_drained(self, max_steps: int = 10_000):
        while self.steps < max_steps:
            if not self.step():
                if self.table.idle:
                    break
        return self.finished
