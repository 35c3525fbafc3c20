"""Device time a step in every operation other than the four stencil
kernels (and the fused smoother): the pads, the masks, the right-hand
side's division, the mean pin, the residual checks, copies."""
import traceread
from cost import stencils


def read(rec: dict) -> float | None:
    if rec["trace"] is None or not rec["steps"]:
        return None
    other = sum(t1 - t0 for name, t0, t1 in
                traceread.device_in_window(rec["trace"])
                if not any(s in name for s in stencils.STENCIL_SYMBOLS))
    return other / 1e6 / rec["steps"]
