"""UPDATE_VELOCITY's share of its roofline: the least time of one launch
(three velocities read and three written, unpadded) over its mean device
time in the trace."""
from cost import stencils
from metrics_common import roofline


def read(rec: dict) -> float | None:
    return roofline(rec, stencils.UPDATE_VELOCITY)
