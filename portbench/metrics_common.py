"""Arithmetic the per-layer metrics share."""
import traceread


def roofline(rec: dict, kernel) -> float | None:
    """``kernel``'s least time a launch over its mean device time in the
    traced window, in percent; None where it did not run."""
    if rec["trace"] is None:
        return None
    n, total_ns = traceread.launches(rec["trace"], kernel.symbol)
    if not n:
        return None
    return 100.0 * kernel.least_s(rec["cells_per_step"]) / (total_ns / 1e9 / n)
