"""The whole step's share of the chip's peak: the step's least time (the
larger of its four kernels' operations over 67 TFLOP/s and their 137 field
passes at 40 Jacobi sweeps over 3.35 TB/s) over the traced wall time a
(batched) step.  The count stays whichever kernels implement the step."""
import traceread
from cost import stencils


def read(rec: dict) -> float | None:
    if rec["trace"] is None or not rec["steps"]:
        return None
    per_step_s = traceread.window_ns(rec["trace"]) / 1e9 / rec["steps"]
    least = stencils.step_least_s(rec["cells_per_step"], rec["jacobi_iters"])
    return 100.0 * least / per_step_s
