"""Schedule tree — the Cactus ``schedule.ccl`` analogue.

Cactus applications register routines into named schedule bins (INITIAL,
PRESTEP, EVOL, POSTSTEP, ANALYSIS) with BEFORE/AFTER ordering constraints;
the flesh topologically sorts and runs them.  Here a schedule composes
state->state functions over dicts of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch import obs

State = dict  # dict of fields

BINS = ("INITIAL", "PRESTEP", "EVOL", "POSTSTEP", "ANALYSIS")

# Accepted spellings for callers that use Cactus's long bin names (the
# scenario registry registers into INITIAL/EVOLVE/ANALYSIS).
BIN_ALIASES = {"EVOLVE": "EVOL", "POST": "POSTSTEP", "PRE": "PRESTEP"}


def canonical_bin(bin: str) -> str:
    """Resolve a bin name or alias to its canonical BINS entry."""
    name = BIN_ALIASES.get(bin, bin)
    if name not in BINS:
        raise ScheduleError(
            f"unknown schedule bin {bin!r} (have {BINS}, "
            f"aliases {tuple(BIN_ALIASES)})")
    return name


@dataclasses.dataclass
class _Entry:
    name: str
    fn: Callable[[State], State]
    before: tuple[str, ...]
    after: tuple[str, ...]


class ScheduleError(RuntimeError):
    pass


def _device_of(state):
    """The device of the state's first tensor (None for any other state)."""
    if isinstance(state, dict):
        for v in state.values():
            if hasattr(v, "device"):
                return v.device
    return None


class Schedule:
    def __init__(self):
        self._bins: dict[str, list[_Entry]] = {b: [] for b in BINS}

    def register(
        self,
        bin: str,
        name: str | None = None,
        *,
        before: tuple[str, ...] = (),
        after: tuple[str, ...] = (),
    ):
        """Decorator: schedule ``fn`` in ``bin`` with ordering constraints."""
        bin = canonical_bin(bin)

        def deco(fn):
            self._bins[bin].append(
                _Entry(name or fn.__name__, fn, tuple(before), tuple(after))
            )
            return fn

        return deco

    def _sorted(self, bin: str) -> list[_Entry]:
        entries = self._bins[canonical_bin(bin)]
        names = {e.name for e in entries}
        # build edges: after=X means X -> self ; before=Y means self -> Y
        edges: dict[str, set[str]] = {e.name: set() for e in entries}
        for e in entries:
            for a in e.after:
                if a in names:
                    edges[e.name].add(a)
            for b in e.before:
                if b in names:
                    edges[b].add(e.name)
        order: list[str] = []
        mark: dict[str, int] = {}

        def visit(n: str):
            if mark.get(n) == 1:
                raise ScheduleError(f"cycle through {n!r} in bin {bin}")
            if mark.get(n) == 2:
                return
            mark[n] = 1
            for d in sorted(edges[n]):
                visit(d)
            mark[n] = 2
            order.append(n)

        # preserve registration order among unconstrained entries
        for e in entries:
            visit(e.name)
        by_name = {e.name: e for e in entries}
        return [by_name[n] for n in order]

    def compile_bin(self, bin: str,
                    telemetry=None) -> Callable[[State], State]:
        """Compose the bin's routines (topologically sorted) into one fn.

        The bin runs in a ``schedule.<BIN>`` span and each routine in a
        span of its name (:mod:`repro_torch.obs.spans`): ranges on a
        running profiler's host timeline and, with an enabled
        :class:`repro_torch.obs.Telemetry`, the Cactus timer tree's nodes
        and the bin's device time where the state lives on a card.  No
        span synchronises: the composition launches what the routines
        launch, with telemetry or without.
        """
        entries = self._sorted(bin)
        bname = canonical_bin(bin)
        tel = telemetry if telemetry is not None else obs.NULL
        timed = tel.enabled

        def run(state: State) -> State:
            device = _device_of(state) if timed else None
            with tel.span(f"schedule.{bname}", device=device):
                for e in entries:
                    with tel.span(e.name):
                        state = e.fn(state)
            return state

        run.__name__ = f"schedule_{bname}"
        return run

    def names(self, bin: str) -> list[str]:
        return [e.name for e in self._sorted(bin)]
