"""Fixed-slot occupancy table + FIFO admission queue.

The port's copy of ``repro.serve.slots``: the continuous-batching pattern
of the CFD simulation farm (:mod:`repro_torch.sim.farm`; the LM serving
engine that shares it in the reference is ROADMAP queue 1, item 11): a
fixed device batch of ``n_slots`` resident items, a host-side FIFO of
waiting work, and slot reclamation — whenever a slot frees, the next queued
item is admitted into it and the whole batch keeps stepping.  The table
owns only host-side bookkeeping; callers own the device-side state keyed by
slot index.
"""
from __future__ import annotations

import collections
from typing import Any, Iterator


class SlotTable:
    """Host bookkeeping for a fixed pool of device slots."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._entries: list[Any | None] = [None] * n_slots
        # admission queue, split by priority level: pop always serves the
        # highest level first and is FIFO *within* a level, so urgent work
        # (an interactive request, a readmission) jumps the backlog without
        # reordering peers.  Level 0 is the default; the common case is a
        # single-level FIFO, exactly the old behaviour.
        self._queues: dict[int, collections.deque] = collections.defaultdict(
            collections.deque)

    # -- intake ---------------------------------------------------------------
    def submit(self, item: Any, priority: int = 0) -> None:
        """Queue ``item`` for admission when a slot frees.

        Higher ``priority`` levels admit first; ties admit in submission
        order (FIFO within a level).
        """
        self._queues[int(priority)].append(item)

    # -- admission ------------------------------------------------------------
    def _pop_next(self) -> Any | None:
        for prio in sorted(self._queues, reverse=True):
            q = self._queues[prio]
            if q:
                return q.popleft()
        return None

    def admit_next(self) -> tuple[int, Any] | None:
        """Pop the next queued item into the first free slot.

        Returns ``(slot, item)``, or ``None`` when there is no free slot or
        nothing is queued.  Call repeatedly to fill every free slot.
        """
        slot = next(self.free_slots(), None)
        if slot is None:
            return None
        item = self._pop_next()
        if item is None:
            return None
        self._entries[slot] = item
        return slot, item

    # -- occupancy ------------------------------------------------------------
    def get(self, slot: int) -> Any | None:
        return self._entries[slot]

    def replace(self, slot: int, item: Any) -> None:
        """Swap the occupant of ``slot`` (e.g. queued request -> live entry)."""
        if self._entries[slot] is None:
            raise ValueError(f"slot {slot} is free; admit into it instead")
        self._entries[slot] = item

    def release(self, slot: int) -> Any:
        """Free ``slot``; returns the item that occupied it."""
        item = self._entries[slot]
        if item is None:
            raise ValueError(f"slot {slot} is already free")
        self._entries[slot] = None
        return item

    def free_slots(self) -> Iterator[int]:
        return (s for s, e in enumerate(self._entries) if e is None)

    def slots(self) -> tuple:
        """Fixed-order occupancy view: one element per slot, ``None`` for
        a free slot — what a dashboard renders (``occupied()`` skips free
        slots, which a live per-slot view must not)."""
        return tuple(self._entries)

    def occupied(self) -> Iterator[tuple[int, Any]]:
        return ((s, e) for s, e in enumerate(self._entries) if e is not None)

    @property
    def n_active(self) -> int:
        return sum(1 for e in self._entries if e is not None)

    @property
    def n_queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queued_items(self) -> Iterator[Any]:
        """Every waiting item in admission order — priority levels high
        to low, FIFO within a level: the order ``admit_next`` would pop
        them.  A durable job store walks this to mirror the in-memory
        queue without disturbing it."""
        for prio in sorted(self._queues, reverse=True):
            yield from self._queues[prio]

    def queue_depths(self) -> dict[int, int]:
        """Waiting-item count per priority level.  Every level that ever
        held work is reported (emptied levels at 0), so a gauge fed from
        this view decays to zero instead of freezing at the last depth."""
        return {p: len(q) for p, q in self._queues.items()}

    @property
    def idle(self) -> bool:
        """Nothing resident and nothing waiting."""
        return self.n_active == 0 and self.n_queued == 0
