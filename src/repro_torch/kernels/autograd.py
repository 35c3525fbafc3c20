"""Gradients through the hand-written LM kernels.

FLASH_ATTENTION and SSD_INTRA are bound through ctypes: a launch returns a
fresh tensor with no ``grad_fn``, so autograd would stop at every attention
and SSD region without an error.  The two ``torch.autograd.Function``\\ s
here keep the training path on the kernels:

* **forward** — the hand-written kernel (``attention_cuda.flash_attention``,
  ``ssd_cuda.ssd_intra``), or any callable given as ``forward``;
* **backward** — the gradient of the region's plain formulation: the plain
  version (``chunked_attention`` / ``full_mha_reference`` /
  ``ssd_intra_reference``) recomputed on the saved inputs under
  ``torch.enable_grad()``, then ``torch.autograd.grad``.

That is what the reference does: it differentiates the jnp bodies of its
``__kernel__attention`` / ``__kernel__ssd`` regions
(``src/repro/models/attention.py:52,100``, ``src/repro/models/mamba2.py:150``)
and has no backward kernel.  Non-tensor arguments (``spec``,
``kv_valid_len``, ``scale``, the callables) get ``None`` gradients.

The models go through :func:`flash_attention` and :func:`ssd_intra` only
when grad mode is on and an input requires grad; otherwise they call the
kernels directly, so serving's launches are unchanged.  Both look the
Function and the kernel's wrapper up at call time, so a check can swap
either in.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import attention_cuda, ssd_cuda
from repro_torch.kernels.ssd import ssd_intra_reference


def _grads(outputs, inputs, grad_out):
    """d(outputs)/d(inputs) against ``grad_out``, ``None`` for an input that
    does not need one."""
    need = [t for t in inputs if t.requires_grad]
    got = iter(torch.autograd.grad(outputs, need, grad_out,
                                   allow_unused=True) if need else ())
    return [next(got) if t.requires_grad else None for t in inputs]


def _detached(saved, needs):
    return [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, spec, kv_valid_len, scale, plain, forward)``:
    ``forward(q, k, v, spec, kv_valid_len, scale)`` computes the output;
    the backward differentiates ``plain`` (same arguments)."""

    @staticmethod
    def forward(ctx, q, k, v, spec, kv_valid_len, scale, plain, forward):
        ctx.save_for_backward(q, k, v)
        ctx.args = (spec, kv_valid_len, scale, plain)
        return forward(q, k, v, spec, kv_valid_len, scale)

    @staticmethod
    def backward(ctx, grad_out):
        spec, kv_valid_len, scale, plain = ctx.args
        ins = _detached(ctx.saved_tensors, ctx.needs_input_grad[:3])
        with torch.enable_grad():
            out = plain(*ins, spec, kv_valid_len, scale)
            dq, dk, dv = _grads(out, ins, grad_out)
        return dq, dk, dv, None, None, None, None, None


class SSDIntraFn(torch.autograd.Function):
    """``apply(x, log_decay, in_scale, b_, c_, s_in, forward)``: ``forward``
    (same six tensors) computes the output; the backward differentiates
    ``ssd_intra_reference``."""

    @staticmethod
    def forward(ctx, x, log_decay, in_scale, b_, c_, s_in, forward):
        ctx.save_for_backward(x, log_decay, in_scale, b_, c_, s_in)
        return forward(x, log_decay, in_scale, b_, c_, s_in)

    @staticmethod
    def backward(ctx, grad_out):
        ins = _detached(ctx.saved_tensors, ctx.needs_input_grad[:6])
        with torch.enable_grad():
            out = ssd_intra_reference(*ins)
            grads = _grads(out, ins, grad_out)
        return (*grads, None)


def wants_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` now."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, spec, kv_valid_len=None, scale=None, *,
                    plain, forward=None):
    """The output of ``forward`` (by default the kernel's wrapper,
    ``attention_cuda.flash_attention``) with ``plain``'s gradient."""
    return FlashAttentionFn.apply(q, k, v, spec, kv_valid_len, scale, plain,
                                  forward or attention_cuda.flash_attention)


def ssd_intra(x, log_decay, in_scale, b_, c_, s_in, *, forward=None):
    """The output of ``forward`` (by default the kernel's wrapper,
    ``ssd_cuda.ssd_intra``) with ``ssd_intra_reference``'s gradient."""
    return SSDIntraFn.apply(x, log_decay, in_scale, b_, c_, s_in,
                            forward or ssd_cuda.ssd_intra)
