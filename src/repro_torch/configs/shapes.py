"""Assigned input shapes — every LM arch runs each applicable shape.

The port's copy of ``repro.configs.shapes``:

  train_4k     train_step   seq 4096    global_batch 256
  prefill_32k  prefill      seq 32768   global_batch 32
  decode_32k   serve_step   KV len 32768, global_batch 128 (one new token)
  long_500k    serve_step   KV/state len 524288, global_batch 1 — requires
               sub-quadratic attention (SSM/hybrid only; skips recorded)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic sequence mixing (no dense 500k KV)."""
    if shape.name == "long_500k":
        return bool(cfg.subquadratic)
    return True
