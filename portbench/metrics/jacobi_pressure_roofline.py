"""JACOBI_PRESSURE's share of its roofline: the least time of one launch
(p and rhs read, p written, unpadded, over 3.35 TB/s, or its operations
over 67 TFLOP/s if longer) over its mean device time in the trace."""
from cost import stencils
from metrics_common import roofline


def read(rec: dict) -> float | None:
    return roofline(rec, stencils.JACOBI_PRESSURE)
