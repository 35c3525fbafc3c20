"""repro_torch.jobs.store — the durable job engine: checkpoint state IS the job state.

The port of ``repro.jobs.store``, on the same SQLite schema and the same
snapshot layout, so one store file (and its snapshot directories) is
readable by either package.  The farm's queue, slot table and
evict/readmit bookkeeping live in process memory, so one crash loses every
queued and running request; this module is the Cactus-style
checkpoint/recovery service for the farm: **one SQLite file is the single
source of truth** for job rows, latest-snapshot pointers and lease locks,
next to atomic-rename :class:`~repro_torch.ckpt.checkpointer.Checkpointer`
directories that hold the field snapshots themselves.

* **WAL + ``BEGIN IMMEDIATE``** — every mutation is one immediate
  transaction, so two farm processes sharing the file serialize on claims
  and can never double-claim a job; readers never block the writer.
* **Leases in the database** — each lease carries an owner identity
  (``host:pid:token``), an explicit TTL, and renew/release verbs; a crashed
  owner's lease expires and the next claimer *takes it over* (counted,
  audited in ``job_events``).
* **Snapshot pointers, not blobs** — field state stays in the
  checkpointer's npz-per-step layout; the store records ``(kind, dir,
  step_key, steps_done)`` per job, so a restarted process resumes from the
  latest snapshot and pruning never orphans a directory (flight records
  included).
* **Terminal pruning** — ``prune_terminal`` drops rows AND snapshot/flight
  directories of ``done/failed/diverged`` jobs older than a threshold
  (after each terminal transition when ``prune_after_s`` is set).

The store is host-side bookkeeping only: with no store configured the farm
runs exactly as before.  Snapshots read back as CPU tensors
(:meth:`JobStore.load_snapshot`), ready to re-enter a farm slot.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import secrets
import socket
import sqlite3
import time

import torch

from repro_torch.jobs.codec import decode_request, encode_request

# job status vocabulary — matches the service's poll() statuses
QUEUED = "queued"
RUNNING = "running"
EVICTED = "evicted"
DONE = "done"
FAILED = "failed"
DIVERGED = "diverged"
TERMINAL = (DONE, FAILED, DIVERGED)
INCOMPLETE = (RUNNING, EVICTED)
STATUSES = (QUEUED,) + INCOMPLETE + TERMINAL

# snapshot kinds: "evict" is the resume pointer (latest mid-flight field
# state), "result" the terminal field state of a done job, "flight" a
# health flight record (frames + poisoned state) registered so restarts
# and pruning both resolve it
SNAPSHOT_KINDS = ("evict", "result", "flight")

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
  job_id       INTEGER PRIMARY KEY AUTOINCREMENT,
  status       TEXT NOT NULL,
  signature    TEXT NOT NULL DEFAULT '',
  tag          TEXT NOT NULL DEFAULT '',
  priority     INTEGER NOT NULL DEFAULT 0,
  payload      TEXT NOT NULL,
  init_npz     BLOB,
  steps_done   INTEGER NOT NULL DEFAULT 0,
  terminated   TEXT,
  error        TEXT,
  submitted_at REAL NOT NULL,
  updated_at   REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS jobs_by_status
  ON jobs (status, priority DESC, job_id);
CREATE TABLE IF NOT EXISTS snapshots (
  job_id     INTEGER NOT NULL,
  kind       TEXT NOT NULL,
  dir        TEXT NOT NULL,
  step_key   INTEGER NOT NULL,
  steps_done INTEGER NOT NULL DEFAULT 0,
  fields     TEXT,
  updated_at REAL NOT NULL,
  PRIMARY KEY (job_id, kind)
);
CREATE TABLE IF NOT EXISTS leases (
  job_id      INTEGER PRIMARY KEY,
  owner       TEXT NOT NULL,
  acquired_at REAL NOT NULL,
  expires_at  REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS job_events (
  seq    INTEGER PRIMARY KEY AUTOINCREMENT,
  job_id INTEGER NOT NULL,
  event  TEXT NOT NULL,
  owner  TEXT NOT NULL,
  at     REAL NOT NULL,
  detail TEXT
);
"""


def default_owner() -> str:
    """``host:pid:token`` — the lease owner identity.  The random token
    distinguishes two stores (or two runtimes) inside one process and a
    recycled pid on one host."""
    return f"{socket.gethostname()}:{os.getpid()}:{secrets.token_hex(3)}"


@dataclasses.dataclass
class Job:
    """One durable job row (host-side view)."""

    job_id: int
    status: str
    signature: str
    tag: str
    priority: int
    payload: str
    init_npz: bytes | None
    steps_done: int
    terminated: str | None
    error: str | None

    def request(self):
        """The SimRequest this row describes (sid unassigned)."""
        return decode_request(self.payload, self.init_npz)


_JOB_COLS = ("job_id", "status", "signature", "tag", "priority", "payload",
             "init_npz", "steps_done", "terminated", "error")
_SELECT_JOB = f"SELECT {', '.join('j.' + c for c in _JOB_COLS)} FROM jobs j"


class JobStore:
    """SQLite-backed durable queue + lease table + snapshot registry.

    One instance per process per store file; safe to share the *file*
    across processes (WAL), not the instance across threads.  ``ttl_s``
    is the lease lifetime — an owner that neither renews nor releases for
    that long is presumed dead and its jobs become claimable.
    ``prune_after_s`` (when set) opportunistically prunes terminal rows
    older than that after each terminal transition.
    """

    def __init__(self, path: str, *, ttl_s: float = 30.0,
                 owner: str | None = None, prune_after_s: float | None = None,
                 keep_results: bool = True):
        self.path = os.path.abspath(path)
        self.dir = os.path.dirname(self.path)
        os.makedirs(self.dir, exist_ok=True)
        self.ttl_s = float(ttl_s)
        self.owner = owner if owner is not None else default_owner()
        self.prune_after_s = prune_after_s
        self.keep_results = keep_results
        self.takeovers = 0        # expired leases this instance took over
        self._ckpts: dict[str, object] = {}
        # autocommit mode: transactions are explicit BEGIN IMMEDIATE, so
        # two processes' claims serialize at BEGIN, not at first write
        self._conn = sqlite3.connect(self.path, timeout=30.0,
                                     isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.executescript(_SCHEMA)

    # -- plumbing -------------------------------------------------------------
    @contextlib.contextmanager
    def _tx(self):
        self._conn.execute("BEGIN IMMEDIATE")
        try:
            yield self._conn
        except BaseException:
            self._conn.execute("ROLLBACK")
            raise
        self._conn.execute("COMMIT")

    def _event(self, c, job_id: int, event: str, detail: dict | None = None):
        c.execute(
            "INSERT INTO job_events (job_id, event, owner, at, detail) "
            "VALUES (?, ?, ?, ?, ?)",
            (job_id, event, self.owner, time.time(),
             json.dumps(detail, sort_keys=True) if detail else None))

    def _job(self, row) -> Job:
        return Job(**dict(zip(_JOB_COLS, row)))

    def snapshot_dir(self, kind: str) -> str:
        return os.path.join(self.dir, "snapshots", kind)

    def _ckpt(self, kind: str):
        """The store-owned checkpointer for one snapshot kind (evict /
        result).  Separate directories per kind, step key = job_id —
        globally unique, so two farm processes sharing the store never
        collide on a directory name."""
        if kind not in self._ckpts:
            from repro_torch.ckpt.checkpointer import Checkpointer

            self._ckpts[kind] = Checkpointer(self.snapshot_dir(kind),
                                             keep_last=0)
        return self._ckpts[kind]

    def close(self):
        self._conn.close()

    # -- intake ---------------------------------------------------------------
    def submit(self, req, signature: str = "", *, lease: bool = False) -> int:
        """Persist one request as a ``queued`` row; returns its job_id.

        This is the durability point: the row is committed before the
        farm ever sees the request, so a crash one instruction later
        loses nothing.  ``lease=True`` additionally acquires this owner's
        lease in the same transaction — the submitting process intends to
        run the job itself (the Runtime's ``submit`` path), so a peer
        must not claim it unless this process dies.
        """
        payload, blob = encode_request(req)
        now = time.time()
        with self._tx() as c:
            cur = c.execute(
                "INSERT INTO jobs (status, signature, tag, priority, payload,"
                " init_npz, steps_done, submitted_at, updated_at) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (QUEUED, signature, req.tag, int(req.priority), payload,
                 sqlite3.Binary(blob) if blob is not None else None,
                 int(req.step0), now, now))
            job_id = int(cur.lastrowid)
            if lease:
                c.execute(
                    "REPLACE INTO leases (job_id, owner, acquired_at,"
                    " expires_at) VALUES (?, ?, ?, ?)",
                    (job_id, self.owner, now, now + self.ttl_s))
            self._event(c, job_id, "submit",
                        {"tag": req.tag, "leased": bool(lease)})
        return job_id

    # -- views ----------------------------------------------------------------
    def get(self, job_id: int) -> Job | None:
        row = self._conn.execute(
            _SELECT_JOB + " WHERE j.job_id = ?", (job_id,)).fetchone()
        return self._job(row) if row is not None else None

    def jobs(self, status: str | tuple | None = None) -> list[Job]:
        q, args = _SELECT_JOB, ()
        if status is not None:
            statuses = (status,) if isinstance(status, str) else tuple(status)
            q += (" WHERE j.status IN ("
                  + ",".join("?" * len(statuses)) + ")")
            args = statuses
        q += " ORDER BY j.job_id"
        return [self._job(r) for r in self._conn.execute(q, args)]

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in STATUSES}
        for status, n in self._conn.execute(
                "SELECT status, COUNT(*) FROM jobs GROUP BY status"):
            out[status] = n
        return out

    def queue_depth(self) -> int:
        """Rows still waiting in the durable queue (status ``queued``)."""
        (n,) = self._conn.execute(
            "SELECT COUNT(*) FROM jobs WHERE status = ?", (QUEUED,)).fetchone()
        return int(n)

    def events(self, job_id: int | None = None,
               event: str | None = None, after_seq: int = 0) -> list[dict]:
        """The audit log, oldest first — who claimed/admitted/resolved
        what, when (the no-double-execution assertions read this)."""
        q = ("SELECT seq, job_id, event, owner, at, detail FROM job_events "
             "WHERE seq > ?")
        args: list = [after_seq]
        if job_id is not None:
            q += " AND job_id = ?"
            args.append(job_id)
        if event is not None:
            q += " AND event = ?"
            args.append(event)
        q += " ORDER BY seq"
        return [dict(zip(("seq", "job_id", "event", "owner", "at", "detail"),
                         r)) for r in self._conn.execute(q, args)]

    def last_seq(self) -> int:
        (n,) = self._conn.execute(
            "SELECT COALESCE(MAX(seq), 0) FROM job_events").fetchone()
        return int(n)

    # -- leases / claims ------------------------------------------------------
    def claim(self, limit: int = 1,
              statuses: tuple = (QUEUED,)) -> list[Job]:
        """Transactionally lease up to ``limit`` claimable jobs.

        Claimable: status in ``statuses`` AND no lease, an expired lease
        (dead owner -> *takeover*, counted), or this owner's own expired
        lease.  Ordered priority-descending then FIFO by job_id — the
        same admission order the in-memory SlotTable uses.  Two processes
        racing this method serialize on ``BEGIN IMMEDIATE``; a job can
        never be leased twice while a lease is live.
        """
        now = time.time()
        marks = ",".join("?" * len(statuses))
        cols = ", ".join("j." + c for c in _JOB_COLS)
        out: list[Job] = []
        with self._tx() as c:
            rows = c.execute(
                f"SELECT {cols}, l.owner, l.expires_at FROM jobs j"
                " LEFT JOIN leases l ON l.job_id = j.job_id"
                f" WHERE j.status IN ({marks})"
                " AND (l.job_id IS NULL OR l.expires_at <= ?)"
                " ORDER BY j.priority DESC, j.job_id LIMIT ?",
                (*statuses, now, int(limit))).fetchall()
            for row in rows:
                job = self._job(row[:len(_JOB_COLS)])
                prev_owner = row[len(_JOB_COLS)]
                takeover = (prev_owner is not None
                            and prev_owner != self.owner)
                if takeover:
                    self.takeovers += 1
                c.execute(
                    "REPLACE INTO leases (job_id, owner, acquired_at,"
                    " expires_at) VALUES (?, ?, ?, ?)",
                    (job.job_id, self.owner, now, now + self.ttl_s))
                self._event(c, job.job_id,
                            "takeover" if takeover else "claim",
                            {"from": prev_owner} if takeover else None)
                out.append(job)
        return out

    def claim_incomplete(self, limit: int = 64) -> list[Job]:
        """Claim orphaned in-flight work: ``running``/``evicted`` rows
        whose lease expired (their process died).  The restart contract —
        resume these FIRST, then claim queued work."""
        return self.claim(limit=limit, statuses=INCOMPLETE)

    def renew(self) -> int:
        """Extend every lease this owner holds; returns the count.  The
        service calls this from its heartbeat, so liveness is 'the farm
        is stepping', not a dedicated thread."""
        now = time.time()
        with self._tx() as c:
            cur = c.execute(
                "UPDATE leases SET expires_at = ? WHERE owner = ?",
                (now + self.ttl_s, self.owner))
            return cur.rowcount

    def release(self, job_id: int) -> bool:
        with self._tx() as c:
            cur = c.execute(
                "DELETE FROM leases WHERE job_id = ? AND owner = ?",
                (job_id, self.owner))
            return cur.rowcount > 0

    def lease_of(self, job_id: int) -> dict | None:
        row = self._conn.execute(
            "SELECT owner, acquired_at, expires_at FROM leases "
            "WHERE job_id = ?", (job_id,)).fetchone()
        if row is None:
            return None
        return dict(zip(("owner", "acquired_at", "expires_at"), row))

    # -- transitions ----------------------------------------------------------
    def transition(self, job_id: int, status: str, *,
                   steps_done: int | None = None,
                   terminated: str | None = None, error: str | None = None,
                   event: str | None = None):
        """One status transition, transactionally, with its audit event.
        Terminal transitions release the lease in the same transaction
        (the job needs no owner once resolved) and — when
        ``prune_after_s`` is configured — sweep old terminal rows after
        commit."""
        if status not in STATUSES:
            raise ValueError(f"unknown job status {status!r}")
        sets, args = ["status = ?", "updated_at = ?"], [status, time.time()]
        if steps_done is not None:
            sets.append("steps_done = ?")
            args.append(int(steps_done))
        if terminated is not None:
            sets.append("terminated = ?")
            args.append(terminated)
        if error is not None:
            sets.append("error = ?")
            args.append(error)
        with self._tx() as c:
            c.execute(f"UPDATE jobs SET {', '.join(sets)} WHERE job_id = ?",
                      (*args, job_id))
            if status in TERMINAL:
                c.execute("DELETE FROM leases WHERE job_id = ?", (job_id,))
            self._event(c, job_id, event or status,
                        {"status": status, "steps_done": steps_done})
        if status in TERMINAL and self.prune_after_s is not None:
            self.prune_terminal(self.prune_after_s)

    # -- snapshots ------------------------------------------------------------
    def record_snapshot(self, job_id: int, kind: str, directory: str,
                        step_key: int, steps_done: int = 0,
                        fields: list | None = None):
        """Register an externally written snapshot (e.g. a health flight
        record) so restarts can resolve it and pruning removes it with
        the job — nothing under a registered pointer is ever orphaned."""
        with self._tx() as c:
            c.execute(
                "REPLACE INTO snapshots (job_id, kind, dir, step_key,"
                " steps_done, fields, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (job_id, kind, os.path.abspath(directory), int(step_key),
                 int(steps_done),
                 json.dumps(fields) if fields is not None else None,
                 time.time()))
            self._event(c, job_id, "snapshot",
                        {"kind": kind, "steps_done": steps_done})

    def save_snapshot(self, job_id: int, state: dict, steps_done: int,
                      kind: str = "evict", status: str | None = None):
        """Write a field snapshot through the store's checkpointer
        (atomic rename, step key = job_id), then register the pointer —
        and optionally the status transition — in ONE transaction, so the
        job row and its resume pointer can never disagree.  A crash
        between the file write and the commit leaves only an unregistered
        directory, overwritten by the next save and swept by pruning."""
        self._ckpt(kind).save(job_id, dict(state), blocking=True)
        now = time.time()
        with self._tx() as c:
            c.execute(
                "REPLACE INTO snapshots (job_id, kind, dir, step_key,"
                " steps_done, fields, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (job_id, kind, self.snapshot_dir(kind), job_id,
                 int(steps_done), json.dumps(sorted(state)), now))
            if status is not None:
                c.execute(
                    "UPDATE jobs SET status = ?, steps_done = ?,"
                    " updated_at = ? WHERE job_id = ?",
                    (status, int(steps_done), now, job_id))
            self._event(c, job_id, "snapshot",
                        {"kind": kind, "steps_done": steps_done,
                         "status": status})

    def latest_snapshot(self, job_id: int, kind: str = "evict") -> dict | None:
        row = self._conn.execute(
            "SELECT dir, step_key, steps_done, fields, updated_at "
            "FROM snapshots WHERE job_id = ? AND kind = ?",
            (job_id, kind)).fetchone()
        if row is None:
            return None
        out = dict(zip(("dir", "step_key", "steps_done", "fields",
                        "updated_at"), row))
        if out["fields"] is not None:
            out["fields"] = json.loads(out["fields"])
        return out

    def load_snapshot(self, job_id: int,
                      kind: str = "evict") -> tuple[int, dict]:
        """``(steps_done, {field: CPU tensor})`` of a job's registered
        snapshot — template-free: the field names ride in the snapshot
        row, and dict trees flatten with keys sorted, so the npz leaves
        zip back against the sorted field list."""
        from repro_torch.ckpt.checkpointer import Checkpointer

        snap = self.latest_snapshot(job_id, kind)
        if snap is None:
            raise KeyError(f"job {job_id} has no {kind!r} snapshot")
        fields = snap["fields"]
        if not fields:
            raise ValueError(f"job {job_id} {kind!r} snapshot registered "
                             "without a field list — cannot rebuild")
        _, leaves = Checkpointer(snap["dir"]).read_arrays(snap["step_key"])
        if len(leaves) != len(fields):
            raise ValueError(
                f"job {job_id} {kind!r} snapshot has {len(leaves)} leaves, "
                f"expected {len(fields)}")
        return int(snap["steps_done"]), {
            k: torch.from_numpy(v) for k, v in zip(sorted(fields), leaves)}

    def load_result(self, job_id: int) -> dict:
        """The persisted final field state of a ``done`` job — readable
        from any process, long after the one that ran it exited."""
        return self.load_snapshot(job_id, kind="result")[1]

    # -- pruning --------------------------------------------------------------
    def prune_terminal(self, max_age_s: float = 0.0) -> int:
        """Drop terminal jobs (``done/failed/diverged``) untouched for
        ``max_age_s``: their snapshot/flight directories first (via
        ``Checkpointer.remove`` — self-healing order: a crash mid-prune
        leaves rows pointing at removed dirs, swept on the next pass),
        then their rows, leases, and events.  Returns the number of jobs
        pruned."""
        from repro_torch.ckpt.checkpointer import Checkpointer

        cutoff = time.time() - max(max_age_s, 0.0)
        marks = ",".join("?" * len(TERMINAL))
        rows = self._conn.execute(
            f"SELECT job_id FROM jobs WHERE status IN ({marks})"
            " AND updated_at <= ?", (*TERMINAL, cutoff)).fetchall()
        ids = [r[0] for r in rows]
        if not ids:
            return 0
        idmarks = ",".join("?" * len(ids))
        snaps = self._conn.execute(
            f"SELECT dir, step_key FROM snapshots WHERE job_id IN ({idmarks})",
            ids).fetchall()
        by_dir: dict[str, list[int]] = {}
        for d, key in snaps:
            by_dir.setdefault(d, []).append(key)
        for d, keys in by_dir.items():
            ck = Checkpointer(d, keep_last=0)
            for key in keys:
                ck.remove(key)
        with self._tx() as c:
            c.execute(f"DELETE FROM snapshots WHERE job_id IN ({idmarks})",
                      ids)
            c.execute(f"DELETE FROM leases WHERE job_id IN ({idmarks})", ids)
            c.execute(f"DELETE FROM job_events WHERE job_id IN ({idmarks})",
                      ids)
            c.execute(f"DELETE FROM jobs WHERE job_id IN ({idmarks})", ids)
        return len(ids)
