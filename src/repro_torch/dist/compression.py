"""Gradient compression for the slow links: int8 + error feedback.

The port of ``repro.dist.compression``.  Inter-pod links are the slow
ones, and the data-parallel gradient mean is the only traffic across pods
in the ``dp`` posture, so it is the one transfer worth compressing:

  1. add the carried error-feedback residual to the local gradient
  2. symmetric per-tensor int8 quantization (scale = amax/127)
  3. move the int8 payload and its float32 scale (4× fewer wire bytes
     than float32) and average the dequantized values
  4. keep the NEW quantization error as the next step's residual

Error feedback (Seide et al. 1-bit SGD; Karimireddy et al. EF-SGD) makes
the compression unbiased over time: the residual re-enters the next step's
gradient.  ``train.step._make_dp_train_step(compress_pod_grads=True)``
carries the residual as explicit state.
"""
from __future__ import annotations

import torch

from repro_torch.device import true_divide


def quantize_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization: ``(q, scale, err)`` with
    ``q*scale + err == g`` (float32, up to one rounding)."""
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    scale = torch.where(amax > 0, true_divide(amax, 127.0),
                        torch.ones((), dtype=torch.float32, device=gf.device))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    err = gf - q.float() * scale
    return q, scale, err


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    """Inverse of :func:`quantize_int8` (up to the quantization error)."""
    return (q.float() * scale).reshape(shape)


def ef_allreduce_mean(g: torch.Tensor, err: torch.Tensor, mesh, axes):
    """Error-feedback int8 mean over the ranks of ``axes``: returns
    ``(grad_mean, new_err)``.  Each rank's int8 payload and scale travel
    (1 byte an element and 4, against 4 an element exact); every rank
    dequantizes them and sums in rank order, so the mean is the same on
    all of them."""
    from repro_torch.dist import collectives

    comp = g.float() + err.float()
    q, scale, new_err = quantize_int8(comp)
    qs = collectives.all_gather(q.reshape(1, -1), mesh, axes, 0)
    scales = collectives.all_gather(scale.reshape(1), mesh, axes, 0)
    total = dequantize_int8(qs[0], scales[0], comp.shape)
    for i in range(1, qs.shape[0]):
        total = total + dequantize_int8(qs[i], scales[i], comp.shape)
    return true_divide(total, float(qs.shape[0])), new_err


def wire_bytes(n_elements: int, *, compressed: bool) -> int:
    """Per-hop payload bytes for one gradient tensor (benchmark model)."""
    if compressed:
        return n_elements + 4          # int8 payload + fp32 scale
    return 4 * n_elements
