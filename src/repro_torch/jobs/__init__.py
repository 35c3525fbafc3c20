"""repro_torch.jobs — durable job engine: checkpoint state *is* the job state.

The port of ``repro.jobs``, on the same store schema and payload format.

`JobStore` persists simulation requests, status transitions, latest-
snapshot pointers, and process leases in one SQLite file (WAL,
``BEGIN IMMEDIATE``) beside atomic-rename checkpoint directories.  Wire
it in with ``RuntimeConfig(store=...)`` / ``runtime(..., store=...)``:
submits become durable before admission, every evict/harvest/terminal
transition lands in the store next to the snapshot write, a restarted
Runtime resumes incomplete simulations first, and two farm processes can
drain one queue via lease takeover.  With no store configured the farm
path runs exactly as before (pinned by test).  On a mesh of ranks,
:class:`MeshStore` (``repro_torch.jobs.meshed``) keeps the store global
rank 0's alone and broadcasts its answers, so every rank admits the same
work.
"""
from __future__ import annotations

import os

from repro_torch.jobs.codec import (PAYLOAD_VERSION, config_from_dict,
                              config_to_dict, decode_request, encode_request)
from repro_torch.jobs.store import (DIVERGED, DONE, EVICTED, FAILED, INCOMPLETE,
                              QUEUED, RUNNING, SNAPSHOT_KINDS, STATUSES,
                              TERMINAL, Job, JobStore, default_owner)
from repro_torch.jobs.meshed import WRITER, MeshStore, spans_ranks

__all__ = [
    "PAYLOAD_VERSION", "config_from_dict", "config_to_dict",
    "decode_request", "encode_request",
    "QUEUED", "RUNNING", "EVICTED", "DONE", "FAILED", "DIVERGED",
    "TERMINAL", "INCOMPLETE", "STATUSES", "SNAPSHOT_KINDS",
    "Job", "JobStore", "MeshStore", "WRITER", "default_owner",
    "on_mesh", "resolve_store",
]


def resolve_store(spec, ckpt_dir: str | None = None, mesh=None):
    """Normalize a ``RuntimeConfig.store`` spec to a JobStore (or None).

    ``None``/``False`` → no store (the bitwise-identical in-memory path);
    a ``JobStore`` passes through; ``True`` → ``<ckpt_dir>/jobs.sqlite``
    (requires ``ckpt_dir``); a path string → a store at that file; a dict
    → ``JobStore(**spec)`` for tuned ttl/prune knobs.  With a ``mesh``
    whose process group has more than one rank, a :class:`MeshStore`:
    the spec is resolved on global rank 0 alone (a JobStore handed in on
    another rank is closed there and ignored), and every rank must call
    this at the same point.
    """
    if spec is None or spec is False:
        return None
    if spans_ranks(mesh):
        return MeshStore.open(spec, mesh, ckpt_dir)
    if isinstance(spec, JobStore):
        return spec
    if spec is True:
        if not ckpt_dir:
            raise ValueError(
                "store=True needs ckpt_dir to place jobs.sqlite; "
                "pass store='/path/to/jobs.sqlite' or set ckpt_dir")
        return JobStore(os.path.join(ckpt_dir, "jobs.sqlite"))
    if isinstance(spec, str):
        return JobStore(spec)
    if isinstance(spec, dict):
        return JobStore(**spec)
    raise TypeError(f"cannot resolve a job store from {spec!r}")


def on_mesh(store, mesh):
    """``store`` as a farm on ``mesh`` must hold it: a JobStore handed in
    on every rank of a process group of more than one becomes a
    :class:`MeshStore` (the writer's used, the others' closed and
    ignored); anything else passes through."""
    if store is None or isinstance(store, MeshStore) or not spans_ranks(mesh):
        return store
    return MeshStore.wrap(store, mesh)
