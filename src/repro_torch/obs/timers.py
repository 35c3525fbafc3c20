"""Hierarchical wall-clock timers — the Cactus ``TimerReport`` analogue.

The port of ``repro.obs.timers`` (pure stdlib, the same tree and report).

Cactus attaches a clock to every thorn routine in every schedule bin and
prints the nested accumulation at shutdown; that report is how the source
paper's CaKernel work located its GPU hot spots.  :class:`TimerTree` is
the same shape: ``with tree.section("EVOLVE"):`` opens a node under the
current position (a per-thread stack), repeated sections accumulate into
one node, and ``report()`` renders the tree with per-node totals, counts,
and percent-of-parent.

The tree itself is clock-agnostic: ``section`` reads the tree's clock,
and :meth:`TimerTree.enter` / :meth:`TimerTree.leave` take an interval
measured elsewhere (``Telemetry.span`` feeds them the host interval it
records, with no fence: CUDA launches are asynchronous, so a span over
device work times its enqueue).  Tests inject a fake clock, which is also
what keeps the nesting invariant (sum of child totals <= parent total
once the parent is closed) exactly testable.
"""
from __future__ import annotations

import contextlib
import threading
import time


class TimerNode:
    __slots__ = ("name", "total", "count", "children")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0          # accumulated wall seconds
        self.count = 0            # completed sections
        self.children: dict[str, "TimerNode"] = {}

    def child(self, name: str) -> "TimerNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = TimerNode(name)
        return node

    def snapshot(self) -> dict:
        return {
            "total_s": self.total,
            "count": self.count,
            "children": {n: c.snapshot() for n, c in self.children.items()},
        }


class TimerTree:
    """Nested section timers with a per-thread position stack.

    The tree (nodes, totals) is shared and lock-guarded; *where you are*
    in it is thread-local, so two threads timing concurrently each nest
    correctly under their own open sections.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._root = TimerNode("")
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = [self._root]
        return st

    def enter(self, name: str) -> TimerNode:
        """Open ``name`` under this thread's current node."""
        stack = self._stack()
        with self._lock:
            node = stack[-1].child(name)
        stack.append(node)
        return node

    def leave(self, node: TimerNode, seconds: float) -> str | None:
        """Close ``node`` (the one this thread opened last), adding
        ``seconds``; returns the name of the node it nests in (None at
        the top)."""
        stack = self._stack()
        stack.pop()
        with self._lock:
            node.total += seconds
            node.count += 1
        return stack[-1].name if len(stack) > 1 else None

    @contextlib.contextmanager
    def section(self, name: str):
        """Time a nested section; re-entering a name accumulates."""
        node = self.enter(name)
        t0 = self._clock()
        try:
            yield node
        finally:
            self.leave(node, self._clock() - t0)

    # -- views ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """Nested ``{name: {total_s, count, children}}`` dict."""
        with self._lock:
            return {n: c.snapshot() for n, c in self._root.children.items()}

    def reset(self):
        with self._lock:
            self._root.children.clear()

    def report(self) -> str:
        """Indented TimerReport-style rendering (totals, counts, %parent)."""
        lines = ["-- timers (wall s) --"]

        def emit(node: TimerNode, depth: int, parent_total: float | None):
            pct = ("" if parent_total is None or parent_total <= 0.0
                   else f"  {100.0 * node.total / parent_total:5.1f}%")
            avg = node.total / node.count if node.count else 0.0
            lines.append(
                f"  {'  ' * depth}{node.name:<{max(40 - 2 * depth, 8)}} "
                f"total {node.total:9.4f}  count {node.count:6d}  "
                f"avg {avg:9.6f}{pct}")
            for c in node.children.values():
                emit(c, depth + 1, node.total)

        with self._lock:
            roots = list(self._root.children.values())
        for r in roots:
            emit(r, 0, None)
        if len(lines) == 1:
            lines.append("  (no sections recorded)")
        return "\n".join(lines)
