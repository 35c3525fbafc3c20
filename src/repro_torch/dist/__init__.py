"""repro_torch.dist — the distribution substrate of the port.

The paper's framework pushes every placement decision (domain
decomposition, ghost-zone exchange, device mapping) into a substrate layer
so that application code stays serial-looking.  This package is that
layer for the port's ranks:

  sharding           — placement rules (FSDP×TP layouts, divisibility
                       guards, batch/cache placements, mesh postures, the
                       grid and slot rules), blocks and gathers
  collectives        — collectives over mesh axes, and the autograd
                       Functions of the tensor-parallel layers
  compression        — int8 error-feedback gradient mean for the slow
                       (cross-pod) links
  pipeline_parallel  — GPipe microbatch relay over a ``pod`` axis
"""
from repro_torch.dist import (  # noqa: F401
    collectives, compression, pipeline_parallel, sharding)
