"""Reductions of a traced window (``window.Window.record``) to numbers.

Every time here is cut to the window's active part: the window less its
pauses.  Device operations are kernels, copies and fills alike.
"""
from __future__ import annotations

import re
from collections import defaultdict

from window import PAUSE_SPAN, SPAN_PREFIX, WINDOW_SPAN

# device gaps shorter than this are the launch-to-launch spacing of a
# queue the host keeps full; they are booked together, not by host activity
BACK_TO_BACK_NS = 10_000
BACK_TO_BACK = "back to back (gaps under 10 us)"


def active(rec: dict) -> list[tuple[int, int]]:
    """The window less its pauses, as sorted intervals."""
    w0, w1 = rec["window_ns"]
    out, t = [], w0
    for p0, p1 in rec["pauses_ns"]:
        p0, p1 = max(p0, w0), min(p1, w1)
        if p0 > t:
            out.append((t, p0))
        t = max(t, p1)
    if w1 > t:
        out.append((t, w1))
    return out


def window_ns(rec: dict) -> int:
    return sum(b - a for a, b in active(rec))


def _clipped(ops, spans):
    """Each op's part inside ``spans`` (sorted): (name, t0, t1) pieces."""
    for name, t0, t1 in ops:
        for a, b in spans:
            if t1 <= a:
                break
            lo, hi = max(t0, a), min(t1, b)
            if hi > lo:
                yield name, lo, hi


def device_in_window(rec: dict) -> list[tuple[str, int, int]]:
    return sorted(_clipped(rec["device_ops"], active(rec)),
                  key=lambda op: op[1])


def busy_intervals(rec: dict) -> list[tuple[int, int]]:
    """The union of the device operations' intervals in the window."""
    merged: list[list[int]] = []
    for _, t0, t1 in device_in_window(rec):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def busy_ns(rec: dict) -> int:
    return sum(b - a for a, b in busy_intervals(rec))


def launches(rec: dict, symbol: str) -> tuple[int, int]:
    """(count, total ns) of the device operations named ``symbol`` that
    start in the window's active part."""
    spans = active(rec)
    n = total = 0
    for name, t0, t1 in rec["device_ops"]:
        if symbol in name and any(a <= t0 < b for a, b in spans):
            n += 1
            total += t1 - t0
    return n, total


def short_name(name: str) -> str:
    """A device function's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:160]


def device_ops_by_time(rec: dict, top: int = 10) -> list[list]:
    """The device operations that took the most time, by name."""
    total: dict[str, int] = defaultdict(int)
    for name, t0, t1 in device_in_window(rec):
        total[short_name(name)] += t1 - t0
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_gaps(rec: dict) -> list[tuple[int, int]]:
    """The window's intervals in which no device operation runs."""
    gaps = []
    busy = busy_intervals(rec)
    for a, b in active(rec):
        t = a
        for s0, s1 in busy:
            if s1 <= t:
                continue
            if s0 >= b:
                break
            if s0 > t:
                gaps.append((t, s0))
            t = max(t, s1)
        if b > t:
            gaps.append((t, b))
    return gaps


def _host_labels(rec: dict, times: list[int]) -> list[str]:
    """What the host thread of the window was doing at each of ``times``
    (sorted): its outermost harness range and its innermost operation."""
    ops = sorted((op for op in rec["host_ops"]
                  if op[0] not in (WINDOW_SPAN, PAUSE_SPAN)),
                 key=lambda op: op[1])
    labels, live, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][1] <= t:
            live.append(ops[i])
            i += 1
        live = [op for op in live if op[2] >= t]
        spans = [op for op in live if op[0].startswith(SPAN_PREFIX)]
        inner = [op for op in live if not op[0].startswith(SPAN_PREFIX)]
        parts = []
        if spans:
            parts.append(min(spans, key=lambda op: op[1])[0])
        if inner:
            parts.append(max(inner, key=lambda op: op[1])[0])
        labels.append(" > ".join(parts) if parts else "python")
    return labels


def idle_by_host(rec: dict, top: int = 10) -> list[list]:
    """Idle device time summed by what the host was doing in each gap."""
    gaps = idle_gaps(rec)
    total: dict[str, int] = defaultdict(int)
    long_gaps = []
    for g0, g1 in gaps:
        if g1 - g0 < BACK_TO_BACK_NS:
            total[BACK_TO_BACK] += g1 - g0
        else:
            long_gaps.append((g0, g1))
    mids = [(g0 + g1) // 2 for g0, g1 in long_gaps]
    for (g0, g1), label in zip(long_gaps, _host_labels(rec, mids)):
        total[label] += g1 - g0
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def breakdown(rec: dict) -> dict:
    return {"device_ops": device_ops_by_time(rec),
            "idle_gaps": idle_by_host(rec)}
