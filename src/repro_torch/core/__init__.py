"""repro_torch.core — the stencil framework's core, on PyTorch.

Public surface:
  descriptor.StencilDescriptor / descriptor()  — CaCUDA kernel descriptors
  generator.generate                           — descriptor -> CUDA/TORCH kernel
  halo.exchange_pad / stencil_step_overlap     — ghost-zone padding + overlap
  driver.GridDriver / Domain                   — storage and halo specs
  schedule.Schedule                            — schedule tree
  ccl.parse_ccl / parse_ccl_file               — the paper's cacuda.ccl syntax
  mol.INTEGRATORS                              — MoL Runge-Kutta integrators
  autotune.choose_tile / tile_for              — roofline-driven launch tiles
  rooflinemodel.resolve_chip / CHIPS           — chip registry and terms
"""
from repro_torch.core.descriptor import Intent, StencilDescriptor, VariableGroup, descriptor
from repro_torch.core.generator import FieldView, GeneratedKernel, KernelContext, generate, generate_pair
from repro_torch.core.halo import (
    AxisSpec,
    bc_dirichlet,
    bc_mirror,
    bc_neumann,
    exchange_pad,
    stencil_step_overlap,
)
from repro_torch.core.driver import Domain, GridDriver
from repro_torch.core.schedule import Schedule
from repro_torch.core.ccl import CCLSyntaxError, parse_ccl, parse_ccl_file
from repro_torch.core.mol import INTEGRATORS
from repro_torch.core.autotune import (
    choose_tile, reset_tile_cache, tile_cache_stats, tile_for, tuned,
)
from repro_torch.core.rooflinemodel import (
    CHIPS, CPU_HOST, H100_SXM, Chip, RooflineTerms, resolve_chip,
    terms_from_counts,
)
