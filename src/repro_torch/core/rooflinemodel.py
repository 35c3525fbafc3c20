"""Roofline model: per-chip hardware constants + term computation.

The port's counterpart of ``repro.core.rooflinemodel``: the same ``Chip``,
``RooflineTerms``, ``terms_from_counts`` and
``stencil_arithmetic_intensity``, and a registry so that utilization is
always reported against the peaks of the hardware that ran.  The registry
keeps the reference's ``cpu-host`` and ``gpu-generic`` entries with their
constants unchanged and adds the card the port is written for,
``h100-sxm``: NVIDIA's data-sheet peaks of the H100 SXM (3.35 TB/s of HBM,
67 TFLOP/s of float32 outside the tensor cores, 989 TFLOP/s of dense bf16),
its shared memory as the on-chip staging budget (``vmem_bytes``: 227 KB a
block), and the few occupancy limits the tile autotuner needs (SMs, warp
width, threads a block and an SM, blocks and registers an SM).  A TPU entry
has no meaning here.

``resolve_chip("auto")`` resolves from the device the port runs on: an H100
SXM card is ``h100-sxm``, any other CUDA card ``gpu-generic``, the CPU
``cpu-host``.
"""
from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12   # FLOP/s, dense tensor cores
    peak_flops_fp32: float = 67e12    # FLOP/s, CUDA cores
    hbm_bandwidth: float = 3.35e12    # B/s
    hbm_bytes: float = 80e9
    ici_link_bandwidth: float = 450e9  # B/s: NVLink, each way, all links
    ici_links: int = 1
    vmem_bytes: float = 232448        # on-chip staging: shared memory a block
    # occupancy limits (the tile autotuner's; sm_90 values by default)
    sms: int = 132
    warp: int = 32
    max_threads_block: int = 1024
    max_threads_sm: int = 2048
    max_blocks_sm: int = 32
    regs_sm: int = 65536

    def peak_flops(self, dtype: str = "bf16") -> float:
        return self.peak_flops_bf16 if dtype in ("bf16", "bfloat16") else self.peak_flops_fp32


H100_SXM = Chip()

# The reference's host-class numbers, unchanged: utilization on the CPU is
# labeled against an honest same-order peak, never against the card's.
CPU_HOST = Chip(
    name="cpu-host",
    peak_flops_bf16=2e11,
    peak_flops_fp32=2e11,
    hbm_bandwidth=3e10,
    hbm_bytes=8e9,
    ici_link_bandwidth=1e10,
    ici_links=1,
    vmem_bytes=32 * 2**20,     # L2/L3-class working set
)

# The reference's A100-class placeholder for any other card, its constants
# unchanged (and an A100's 108 SMs for the occupancy model).
GPU_GENERIC = Chip(
    name="gpu-generic",
    peak_flops_bf16=312e12,
    peak_flops_fp32=19.5e12,
    hbm_bandwidth=1.6e12,
    hbm_bytes=40e9,
    ici_link_bandwidth=100e9,
    ici_links=2,
    vmem_bytes=40 * 2**20,
    sms=108,
)

CHIPS: dict[str, Chip] = {
    "h100-sxm": H100_SXM,
    "cpu-host": CPU_HOST,
    "gpu-generic": GPU_GENERIC,
}


def chip_for_device_name(name: str) -> str:
    """The registry name of a CUDA card called ``name``: the H100 SXM part
    (``NVIDIA H100 80GB HBM3``, or a name with ``SXM``) is ``h100-sxm``;
    every other card, the H100's PCIe and NVL parts included, is
    ``gpu-generic``."""
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return "h100-sxm"
    return "gpu-generic"


@functools.lru_cache(maxsize=None)
def _auto(device_type: str, index: int) -> str:
    if device_type != "cuda":
        return "cpu-host"
    import torch

    return chip_for_device_name(torch.cuda.get_device_properties(index).name)


def resolve_chip(spec: "Chip | str | None" = "auto", device=None) -> Chip:
    """Coerce a chip spec to hardware constants.

    Accepts a :class:`Chip` (passes through), a registry name
    (``"h100-sxm"``, ``"cpu-host"``, ``"gpu-generic"``), or ``"auto"`` /
    ``None``, which resolves from ``device`` (a ``torch.device`` or its
    name; ``None`` is the port's default device: the card when
    ``torch.cuda.is_available()``, else the CPU).
    """
    if isinstance(spec, Chip):
        return spec
    if spec is None or spec == "auto":
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        index = dev.index
        if dev.type == "cuda" and index is None:
            index = torch.cuda.current_device()
        return CHIPS[_auto(dev.type, index or 0)]
    if spec in CHIPS:
        return CHIPS[spec]
    raise KeyError(f"unknown chip {spec!r} (have {sorted(CHIPS)} or 'auto')")


@dataclasses.dataclass
class RooflineTerms:
    """Per-device seconds for each roofline term; bottleneck = max."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: perfectly overlapped terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: 1.0 = pure compute-bound at peak."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.compute_fraction,
        }


def terms_from_counts(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
    *,
    dtype: str = "bf16",
    chip: Chip = H100_SXM,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / chip.peak_flops(dtype),
        memory_s=hbm_bytes_per_device / chip.hbm_bandwidth,
        collective_s=collective_bytes_per_device / chip.ici_link_bandwidth,
    )


def stencil_arithmetic_intensity(
    tile: tuple[int, int, int],
    halo: tuple[int, int, int],
    flops_per_cell: float,
    nvars_read: int,
    nvars_written: int,
    itemsize: int = 4,
) -> float:
    """FLOP/byte of one halo-expanded tile — drives tile autotuning.

    Larger tiles amortize the halo re-read: the paper's shared-memory
    tile-size tuning.
    """
    tx, ty, tz = tile
    hx, hy, hz = halo
    cells = tx * ty * tz
    read = (tx + 2 * hx) * (ty + 2 * hy) * (tz + 2 * hz) * nvars_read
    written = cells * nvars_written
    return (cells * flops_per_cell) / ((read + written) * itemsize)
