"""The share of the traced window in which no device operation runs: the
window less the union of the kernels', copies' and fills' intervals."""
import traceread


def read(rec: dict) -> float | None:
    if rec["trace"] is None:
        return None
    window = traceread.window_ns(rec["trace"])
    if not window:
        return None
    return 100.0 * (1.0 - traceread.busy_ns(rec["trace"]) / window)
