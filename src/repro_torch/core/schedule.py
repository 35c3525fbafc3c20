"""Schedule tree — the Cactus ``schedule.ccl`` analogue.

Cactus applications register routines into named schedule bins (INITIAL,
PRESTEP, EVOL, POSTSTEP, ANALYSIS) with BEFORE/AFTER ordering constraints;
the flesh topologically sorts and runs them.  Here a schedule composes
state->state functions over dicts of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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

        With an *enabled* :class:`repro_torch.obs.Telemetry`, the composed
        runner is the Cactus-instrumented one: the bin and each routine get
        hierarchical wall-clock timer sections (fenced with
        ``torch.cuda.synchronize`` so asynchronous launches are charged to
        the routine that issued them) plus profiler ranges.  Telemetry
        ``None``/disabled returns exactly the uninstrumented composition —
        no fences, no clocks, the same launches.
        """
        entries = self._sorted(bin)
        bname = canonical_bin(bin)

        if telemetry is None or not telemetry.enabled:
            def run(state: State) -> State:
                for e in entries:
                    state = e.fn(state)
                return state

            run.__name__ = f"schedule_{bname}"
            return run

        tel = telemetry
        # ANALYSIS routines may return device scalars still being computed
        # (build on the device, fetch once at the end): a fence after every
        # entry would serialise them, so that bin fences once
        per_entry_fence = bname != "ANALYSIS"

        def run(state: State) -> State:
            with tel.section(f"schedule.{bname}"):
                for e in entries:
                    with tel.section(e.name), \
                            tel.named_scope(f"{bname}.{e.name}"):
                        state = e.fn(state)
                        if per_entry_fence:
                            tel.fence(state)
                if not per_entry_fence:
                    tel.fence(state)
            return state

        run.__name__ = f"schedule_{bname}"
        return run

    def names(self, bin: str) -> list[str]:
        return [e.name for e in self._sorted(bin)]
