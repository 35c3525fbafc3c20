"""Reductions of the program's own spans in a traced window.

The program marks its layers with FUNCTION-scope profiler ranges (the
solver step and its phases, the ghost-zone set-up, the farm's phases, the
schedule's bins): they are host operations of the window's trace
(``rec["host_ops"]``, the harness's thread), named after the layer.  A
program that marks nothing leaves every reduction here empty, and the
metrics that read them report nothing.
"""
from __future__ import annotations

import bisect

import traceread

# a program span's name begins with its layer's
PROGRAM_LAYERS = ("ns3d.", "ops.", "farm.", "ensemble.", "service.",
                  "schedule.", "run.")


def is_program_span(name: str) -> bool:
    return name.startswith(PROGRAM_LAYERS)


def program_spans(rec: dict, names=None) -> list[tuple[str, int, int]]:
    """The program's spans (``names`` alone when given), by start."""
    return sorted((op for op in rec["host_ops"]
                   if (op[0] in names if names else is_program_span(op[0]))),
                  key=lambda op: op[1])


def in_active(rec: dict, t: int) -> bool:
    return any(a <= t < b for a, b in traceread.active(rec))


def covered(intervals: list[tuple[int, int]], t: int) -> bool:
    """Is ``t`` inside one of ``intervals`` (sorted, disjoint)?"""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t < intervals[i][1]


def union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def clip(intervals, spans) -> list[tuple[int, int]]:
    """The parts of ``intervals`` inside ``spans`` (disjoint)."""
    out = []
    for a, b in intervals:
        for s0, s1 in spans:
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                out.append((lo, hi))
    return out
