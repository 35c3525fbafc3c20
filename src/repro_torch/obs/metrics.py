"""Labeled metrics registry — counters, gauges, histograms.

The port of ``repro.obs.metrics``: pure stdlib, kept call for call so that
the same calls give the same snapshot, JSON, Prometheus and report text.

The Cactus performance-reporting analogue at the metrics level: every
layer of the stack (farm scheduler, ensemble executor, service front-end,
runtime front door) records its load-bearing quantities into one
:class:`Registry`, which snapshots to a plain dict and dumps as JSON, so
the same numbers feed the human-readable ``repro_torch.obs.report()``, the
``BENCH_*.json`` trajectory, and any external scrape.

Series are identified by a metric name plus optional key=value labels
(``farm.queue_depth{priority=1}``, ``farm.compile_cache{result=hit}``);
the flat ``name{k=v,...}`` spelling — labels sorted by key — is the
canonical serialized form, so a snapshot round-trips through JSON without
a schema.  All mutation is lock-guarded: the registry is shared between
the drive loop and any poller thread.
"""
from __future__ import annotations

import bisect
import json
import re
import threading

# histogram bucket upper bounds: 1-2-5 per decade from 1 µs to 10 ks —
# wide enough for both per-entry schedule timings and submit->result
# latencies without configuration
DEFAULT_BOUNDS = tuple(m * 10.0 ** e for e in range(-6, 5)
                       for m in (1.0, 2.0, 5.0))


def series_key(name: str, labels: dict) -> str:
    """Canonical flat spelling of a labeled series."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    Buckets are cumulative-free (each holds its own count, ``le`` upper
    bound); quantiles are estimated from the bucket containing the target
    rank (its upper bound), which is accurate to one 1-2-5 step — plenty
    for wall-clock latencies.
    """

    __slots__ = ("bounds", "counts", "overflow", "count", "sum", "min", "max")

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, value: float):
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        i = bisect.bisect_left(self.bounds, value)
        if i < len(self.bounds):
            self.counts[i] += 1
        else:
            self.overflow += 1

    def percentile(self, q: float) -> float | None:
        """Estimated q-th percentile (0..100); None when empty."""
        if not self.count:
            return None
        rank = max(1, int(round(q / 100.0 * self.count)))
        seen = 0
        for le, n in zip(self.bounds, self.counts):
            seen += n
            if seen >= rank:
                return le
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            # sparse: only occupied buckets travel
            "buckets": [[le, n] for le, n in zip(self.bounds, self.counts)
                        if n] + ([["inf", self.overflow]] if self.overflow
                                 else []),
        }


class Registry:
    """Thread-safe registry of counters, gauges, and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    # -- recording ------------------------------------------------------------
    def inc(self, name: str, value: int = 1, **labels) -> int:
        """Add ``value`` to a counter series; returns the new total."""
        key = series_key(name, labels)
        with self._lock:
            new = self._counters.get(key, 0) + value
            self._counters[key] = new
        return new

    def set(self, name: str, value: float, **labels):
        """Set a gauge series to ``value`` (last-write-wins)."""
        key = series_key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels):
        """Record one sample into a histogram series."""
        key = series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            h.observe(value)

    def remove(self, name: str, **labels) -> bool:
        """Drop a series outright (any kind); True if it existed.

        Long-lived registries otherwise accumulate dead per-entity
        series — the health monitor retires its per-sim state gauge
        here when a sim leaves the farm.
        """
        key = series_key(name, labels)
        removed = False
        with self._lock:
            for store in (self._counters, self._gauges, self._hists):
                removed |= store.pop(key, None) is not None
        return removed

    # -- reading --------------------------------------------------------------
    def get(self, name: str, **labels):
        """Counter/gauge value or Histogram for a series; None if absent."""
        key = series_key(name, labels)
        with self._lock:
            for store in (self._counters, self._gauges, self._hists):
                if key in store:
                    return store[key]
        return None

    def snapshot(self) -> dict:
        """Plain-dict view: ``{"counters", "gauges", "histograms"}`` keyed
        by the canonical ``name{k=v,...}`` series spelling."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- rendering ------------------------------------------------------------
    def to_prometheus(self, prefix: str = "repro") -> str:
        """Prometheus text-exposition rendering of every series.

        Series names are sanitized (``farm.queue_depth{priority=1}`` ->
        ``repro_farm_queue_depth{priority="1"}``); histograms emit the
        standard cumulative ``_bucket``/``_sum``/``_count`` triple.  This
        is what :meth:`repro_torch.sim.service.SimulationService.prometheus_text`
        serves, so the farm is scrape-able from day one.
        """
        lines: list[str] = []
        snap = self.snapshot()

        def split(key: str) -> tuple[str, str]:
            name, _, inner = key.partition("{")
            metric = prefix + "_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)
            if not inner:
                return metric, ""
            pairs = []
            for kv in inner.rstrip("}").split(","):
                k, _, v = kv.partition("=")
                pairs.append(f'{re.sub(r"[^a-zA-Z0-9_]", "_", k.strip())}'
                             f'="{v.strip()}"')
            return metric, "{" + ",".join(pairs) + "}"

        typed: set = set()

        def emit(key: str, value, kind: str, suffix: str = "",
                 extra_label: str | None = None):
            metric, labels = split(key)
            if (metric, kind) not in typed:
                typed.add((metric, kind))
                lines.append(f"# TYPE {metric}{suffix} {kind}")
            if extra_label:
                labels = (labels[:-1] + "," + extra_label + "}" if labels
                          else "{" + extra_label + "}")
            lines.append(f"{metric}{suffix}{labels} {value:g}")

        for k in sorted(snap["counters"]):
            emit(k, snap["counters"][k], "counter")
        for k in sorted(snap["gauges"]):
            emit(k, snap["gauges"][k], "gauge")
        with self._lock:
            hists = dict(self._hists)
        for k in sorted(hists):
            h = hists[k]
            metric, labels = split(k)
            if (metric, "histogram") not in typed:
                typed.add((metric, "histogram"))
                lines.append(f"# TYPE {metric} histogram")
            seen = 0
            base = labels[1:-1] + "," if labels else ""
            for le, n in zip(h.bounds, h.counts):
                if n:
                    seen += n
                    lines.append(f'{metric}_bucket{{{base}le="{le:g}"}} '
                                 f"{seen}")
            lines.append(f'{metric}_bucket{{{base}le="+Inf"}} {h.count}')
            lines.append(f"{metric}_sum{labels} {h.sum:g}")
            lines.append(f"{metric}_count{labels} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def report(self) -> str:
        """Human-readable block for ``repro_torch.obs.report()``."""
        snap = self.snapshot()
        lines = []
        if snap["counters"]:
            lines.append("-- counters --")
            for k in sorted(snap["counters"]):
                lines.append(f"  {k:<44} {snap['counters'][k]}")
        if snap["gauges"]:
            lines.append("-- gauges --")
            for k in sorted(snap["gauges"]):
                lines.append(f"  {k:<44} {snap['gauges'][k]:g}")
        if snap["histograms"]:
            lines.append("-- histograms --")
            with self._lock:
                hists = dict(self._hists)
            for k in sorted(hists):
                h = hists[k]
                mean = h.sum / h.count if h.count else 0.0
                p50, p95, p99 = (h.percentile(q) for q in (50, 95, 99))
                lines.append(
                    f"  {k:<44} count {h.count}  mean {mean:.4g}  "
                    f"p50 {p50:.4g}  p95 {p95:.4g}  p99 {p99:.4g}  "
                    f"max {h.max:.4g}")
        return "\n".join(lines)
