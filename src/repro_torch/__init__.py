"""repro_torch — the stencil framework (CaCUDA) on PyTorch and CUDA.

The serial Navier-Stokes path of :mod:`repro`, ported module for module:
descriptor-generated stencil kernels (an eager PyTorch template and
hand-written CUDA kernels for Hopper), driver-managed halo padding, the
MAC-grid projection solver and the ``api`` front door.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; see :mod:`repro_torch.device`.
"""


def __getattr__(name):
    # `from repro_torch import api` without importing the solver stack at
    # package import
    if name == "api":
        import importlib

        return importlib.import_module("repro_torch.api")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
