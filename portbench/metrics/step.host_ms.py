"""The host's own time to enqueue one (batched) solver step, ms: the mean
length of the program's ``ns3d.step`` spans that start in the window's
active part while no device operation is in flight.  Such a step follows
a sync (a residual check), so the launch queue is empty and its time is
the host's work alone, never a wait for a launch slot."""
import spanread
import traceread


def read(rec: dict) -> float | None:
    if rec["trace"] is None:
        return None
    tr = rec["trace"]
    busy = traceread.busy_intervals(tr)
    lengths = [t1 - t0 for _, t0, t1 in spanread.program_spans(
        tr, {"ns3d.step"})
        if spanread.in_active(tr, t0) and not spanread.covered(busy, t0)]
    if not lengths:
        return None
    return sum(lengths) / len(lengths) / 1e6
