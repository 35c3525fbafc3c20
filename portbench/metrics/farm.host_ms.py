"""The farm's own host time a batched device step, ms: the window's
``farm.admit``, ``farm.step_chunk`` and ``farm.harvest`` spans less the
parts their ``ns3d.step`` (the solver's enqueue) and ``farm.residuals``
(the farm's wait on the device) children cover, over the device steps."""
import spanread
import traceread

OWN = {"farm.admit", "farm.step_chunk", "farm.harvest"}
CHILDREN = {"ns3d.step", "farm.residuals"}


def read(rec: dict) -> float | None:
    if rec["trace"] is None or not rec["steps"]:
        return None
    tr = rec["trace"]
    active = traceread.active(tr)
    own = spanread.program_spans(tr, OWN)
    if not own:
        return None
    own = spanread.clip(spanread.union((a, b) for _, a, b in own), active)
    kids = spanread.clip(spanread.union(
        (a, b) for _, a, b in spanread.program_spans(tr, CHILDREN)), own)
    return (spanread.length(own) - spanread.length(kids)) / 1e6 / rec["steps"]
