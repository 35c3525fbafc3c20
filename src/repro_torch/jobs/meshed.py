"""repro_torch.jobs.meshed — one job store for a mesh of ranks.

The reference runs one controller process over its whole mesh, so its
store, leases, eviction snapshots and claims are that process's business.
The port runs one process a rank (``repro_torch.launch.mesh``), each with
its own Runtime, service and farm making the same calls.  Were every rank
to open the store, each would insert its own rows, hold its own leases
and claim its own jobs: the ranks would admit different work and hang in
the next halo exchange.  :class:`MeshStore` keeps the store one process's
business:

* **One writer.**  Global rank 0 (:data:`WRITER`) alone opens the
  :class:`~repro_torch.jobs.store.JobStore`, holds and renews the leases,
  and writes rows, events and snapshots; the store's ``owner`` is that
  process's, so a launch is one owner.  The other ranks hold no JobStore:
  one handed to them is closed there and never written through.
* **Decisions broadcast.**  Every call but :meth:`MeshStore.renew` is a
  collective over the world group: the writer makes it, and its answer
  (job ids, claimed rows, row views, snapshot pointers, counts — or the
  exception it raised) reaches every rank as one pickled object
  (``dist.collectives.broadcast_object``).  So every rank takes the same
  branch on it, and a write that fails raises on every rank at the same
  point.  The ranks reach each call together because they run the same
  host code (the farm's rule, ``repro_torch.sim.farm``).
* **Lease clocks stay local.**  ``renew`` rides the service's heartbeat,
  whose rate limit reads each rank's own clock; it runs on the writer
  alone and moves nothing between ranks.
* **Fields on the writer.**  A snapshot's fields are read where the store
  is: :meth:`MeshStore.load_snapshot` returns them on the writer and None
  in their place elsewhere (they reach the slot's holders through
  ``EnsembleExecutor.write_slot(src=WRITER)``), and
  :meth:`MeshStore.load_result` returns ``{}`` elsewhere, as a farm
  result's ``state`` is; metadata is on every rank.

A mesh must span the world group (the writer answers every rank).  In a
world of one, or with no process group, there is no one to tell, and
:func:`~repro_torch.jobs.resolve_store` returns the plain JobStore.
"""
from __future__ import annotations

import math
import pickle

import torch.distributed as dist

from repro_torch.jobs.store import INCOMPLETE, QUEUED, JobStore

WRITER = 0


def spans_ranks(mesh) -> bool:
    """Whether ``mesh`` needs a :class:`MeshStore`: a process group of more
    than one rank is up (a mesh without one — a stub — runs in one
    process)."""
    return (mesh is not None and dist.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1)


def _portable(exc: BaseException) -> BaseException:
    """``exc`` if it pickles, else a RuntimeError naming it."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


class MeshStore:
    """A :class:`JobStore` written by global rank 0 alone, its answers
    broadcast to every rank of the mesh (the module's text): the verbs
    and views the runtime, the service and the farm call.  Build one
    with :meth:`open` (a ``RuntimeConfig.store`` spec) or :meth:`wrap` (a
    JobStore handed in on every rank), on every rank at the same point:
    the store's settings are broadcast from the writer.  Any process may
    open the store file itself to read the rest (events, leases)."""

    def __init__(self, store: JobStore | None):
        self.writer = dist.get_rank() == WRITER
        self._store = store if self.writer else None
        self.takeovers = 0           # the writer's count, on every rank
        for k, v in self._ask(lambda: {k: getattr(store, k) for k in (
                "path", "ttl_s", "owner", "keep_results")}).items():
            setattr(self, k, v)

    @staticmethod
    def _spans(mesh) -> None:
        from repro_torch.launch.mesh import mesh_extents

        world = dist.get_world_size()
        ranks = math.prod(mesh_extents(mesh).values())
        if ranks != world:
            raise ValueError(
                f"a job store on a mesh needs the mesh to span the world "
                f"group (its writer, global rank {WRITER}, answers every "
                f"rank): the mesh has {ranks} ranks, the world {world}")

    @classmethod
    def open(cls, spec, mesh, ckpt_dir: str | None = None) -> "MeshStore":
        """Resolve ``spec`` (any ``resolve_store`` spec) on the writer; a
        JobStore handed in on another rank is closed there and ignored."""
        from repro_torch.jobs import resolve_store

        cls._spans(mesh)
        writer = dist.get_rank() == WRITER
        if not writer and isinstance(spec, JobStore):
            spec.close()
        store = cls._broadcast(writer, lambda: resolve_store(spec, ckpt_dir),
                               strip=lambda got: None)
        return cls(store)

    @classmethod
    def wrap(cls, store: JobStore, mesh) -> "MeshStore":
        """A JobStore handed in on every rank: the writer's is used, the
        others' are closed and ignored."""
        cls._spans(mesh)
        if dist.get_rank() != WRITER:
            store.close()
        return cls(store)

    @property
    def local(self) -> JobStore | None:
        """This rank's open JobStore: the writer's, None elsewhere."""
        return self._store

    # -- the protocol -----------------------------------------------------------
    @staticmethod
    def _broadcast(writer: bool, fn, strip=None):
        """``fn()`` on the writer, its answer (``strip(answer)`` for the
        other ranks, when given) or its exception on every rank."""
        from repro_torch.dist.collectives import broadcast_object

        if writer:
            try:
                full = fn()
            except Exception as e:
                broadcast_object(("err", _portable(e)), src=WRITER)
                raise
            broadcast_object(("ok", strip(full) if strip else full),
                             src=WRITER)
            return full
        kind, value = broadcast_object(None, src=WRITER)
        if kind == "err":
            raise value
        return value

    def _ask(self, fn, strip=None):
        return self._broadcast(self.writer, fn, strip)

    def on_writer(self, fn, *args, strip=None):
        """``fn(*args)`` run on the writer, where the store's files are
        written; the other ranks get ``strip(answer)`` (the answer itself
        when ``strip`` is None), or the exception it raised."""
        return self._ask(lambda: fn(*args), strip)

    # -- answers: made on the writer, broadcast ---------------------------------
    def submit(self, req, signature: str = "", *, lease: bool = False) -> int:
        return self._ask(lambda: self._store.submit(req, signature,
                                                    lease=lease))

    def get(self, job_id: int):
        return self._ask(lambda: self._store.get(job_id))

    def jobs(self, status=None) -> list:
        return self._ask(lambda: self._store.jobs(status))

    def counts(self) -> dict:
        return self._ask(lambda: self._store.counts())

    def queue_depth(self) -> int:
        return self._ask(lambda: self._store.queue_depth())

    def latest_snapshot(self, job_id: int, kind: str = "evict"):
        return self._ask(lambda: self._store.latest_snapshot(job_id, kind))

    def claim(self, limit: int = 1, statuses: tuple = (QUEUED,)) -> list:
        jobs, self.takeovers = self._ask(lambda: (
            self._store.claim(limit, statuses), self._store.takeovers))
        return jobs

    def claim_incomplete(self, limit: int = 64) -> list:
        return self.claim(limit, INCOMPLETE)

    # -- writes: the writer's, acknowledged on every rank -----------------------
    def transition(self, job_id: int, status: str, **kw) -> None:
        self._ask(lambda: self._store.transition(job_id, status, **kw))

    def record_snapshot(self, job_id: int, kind: str, directory: str,
                        step_key: int, steps_done: int = 0,
                        fields: list | None = None) -> None:
        self._ask(lambda: self._store.record_snapshot(
            job_id, kind, directory, step_key, steps_done, fields))

    def save_snapshot(self, job_id: int, state: dict | None, steps_done: int,
                      kind: str = "evict", status: str | None = None) -> None:
        """``state`` is read on the writer (the other ranks pass None or
        ``{}``: the farm gathered the fields to the writer)."""
        self._ask(lambda: self._store.save_snapshot(
            job_id, state, steps_done, kind=kind, status=status))

    def renew(self) -> int | None:
        """Extend the writer's leases; no collective (see the module's
        text), None on the other ranks."""
        return self._store.renew() if self.writer else None

    # -- fields: on the writer --------------------------------------------------
    def load_snapshot(self, job_id: int, kind: str = "evict") -> tuple:
        """``(steps_done, fields)`` on the writer, ``(steps_done, None)``
        on the other ranks."""
        return self._ask(lambda: self._store.load_snapshot(job_id, kind),
                         strip=lambda got: (got[0], None))

    def load_result(self, job_id: int) -> dict:
        """A done job's fields on the writer, ``{}`` on the other ranks."""
        return self._ask(lambda: self._store.load_result(job_id),
                         strip=lambda got: {})

    def close(self) -> None:
        if self._store is not None:
            self._store.close()
