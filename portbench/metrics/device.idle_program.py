"""The share of the traced window in which the device is idle while the
host is inside one of the program's spans: each idle gap of 10 us or more
booked whole by what the host was doing at its midpoint (as the
breakdown's ``idle_gaps``).  ``device.idle`` less this share is the idle
that the harness and the Python between the program's calls leave."""
import spanread
import traceread


def read(rec: dict) -> float | None:
    if rec["trace"] is None:
        return None
    tr = rec["trace"]
    spans = spanread.union((a, b) for _, a, b in spanread.program_spans(tr))
    window = traceread.window_ns(tr)
    if not spans or not window:
        return None
    idle = sum(g1 - g0 for g0, g1 in traceread.idle_gaps(tr)
               if g1 - g0 >= traceread.BACK_TO_BACK_NS
               and spanread.covered(spans, (g0 + g1) // 2))
    return 100.0 * idle / window
