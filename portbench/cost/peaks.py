"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM5 data sheet, dense rates at the full 700 W power limit:
HBM3 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.  A card set
below 700 W runs slower under load; the benchmark states shares against
these published peaks.
"""
from __future__ import annotations

PEAKS = {
    "h100-sxm": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}
DEFAULT = "h100-sxm"


def least_s(nbytes: float, flops: float, chip: str = DEFAULT) -> float:
    """The larger of the bytes' and the operations' least times."""
    p = PEAKS[chip]
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["f32_flops_per_s"])
