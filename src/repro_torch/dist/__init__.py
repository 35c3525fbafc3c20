"""repro_torch.dist — the distribution substrate of the port.

The paper's framework pushes every placement decision (domain
decomposition, ghost-zone exchange, device mapping) into a substrate layer
so that application code stays serial-looking.  This package holds the
port's placement rules: :mod:`repro_torch.dist.sharding` says which mesh
axis each axis of a slot-stacked grid field lies on, with the reference's
divisibility rules and error texts.
"""
from repro_torch.dist import sharding  # noqa: F401
