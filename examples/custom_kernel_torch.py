"""Define a NEW kernel from the paper's own declarative syntax on the
PyTorch port: parse a ``cacuda.ccl`` text block (paper Listing 1 format)
and run the generated kernel — the run of ``examples/custom_kernel.py``
through ``repro_torch.core``.

The descriptor has no hand-written kernel, so its ``CUDA`` template
(TYPE=3DBLOCK's default) generates one: the body is traced into the
3DBLOCK template of ``csrc/stencil3d.cu`` and built by nvcc at the first
launch.  On the card (``--device cuda``, the default) that kernel runs;
on ``cpu`` the template runs the body's plain version.  It is held against
the ``TORCH`` template, the body expanded eagerly.

Run:  PYTHONPATH=src python examples/custom_kernel_torch.py [--device cpu]
      [--n 24]
"""
import argparse
import sys

import torch

from repro_torch.core import generate, parse_ccl

CCL = """
CCTK_CUDA_KERNEL GRADIENT_MAG
  TYPE=3DBLOCK
  STENCIL="1,1,1,1,1,1"
  TILE="8,8,8"
{
  CCTK_CUDA_KERNEL_VARIABLE CACHED=YES INTENT=IN
  {
    phi
  } "SCALAR_FIELD"
  CCTK_CUDA_KERNEL_VARIABLE INTENT=OUT
  {
    gmag
  } "GRADIENT_MAGNITUDE"
  CCTK_CUDA_KERNEL_PARAMETER
  {
    h
  } "SPACING"
}
"""


def body(ctx):
    phi = ctx["phi"]
    h = ctx.param("h")
    gx = (phi.at(1, 0, 0) - phi.at(-1, 0, 0)) / (2 * h)
    gy = (phi.at(0, 1, 0) - phi.at(0, -1, 0)) / (2 * h)
    gz = (phi.at(0, 0, 1) - phi.at(0, 0, -1)) / (2 * h)
    return {"gmag": torch.sqrt(gx * gx + gy * gy + gz * gz)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--n", type=int, default=24)
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    desc = parse_ccl(CCL)[0]
    print(f"parsed descriptor: {desc.name}, stencil={desc.stencil}, "
          f"tile={desc.tile}")
    print(f"  variables: {[g.names for g in desc.variables]}")

    kernel = generate(desc, body, template="TORCH")
    # the 3DBLOCK template: CUDA, its kernel generated from the body
    kernel_cuda = generate(desc, body)

    n = args.n
    x = torch.linspace(0, 1, n + 2, device=dev)
    phi = (x[:, None, None] ** 2 + x[None, :, None]
           + 0 * x[None, None, :]) * torch.ones((n + 2, n + 2, n + 2),
                                                device=dev)
    h = float(x[1] - x[0])
    out_torch = kernel({"phi": phi}, h=h)["gmag"]
    out_cuda = kernel_cuda({"phi": phi}, h=h)["gmag"]
    err = float((out_torch - out_cuda).abs().max())
    print(f"TORCH vs CUDA(3DBLOCK, generated) max err: {err:.2e}")
    assert err < 1e-5
    # analytic: |grad| = sqrt((2x)^2 + 1)
    xc = x[1:-1]
    expect = torch.sqrt((2 * xc[:, None, None]) ** 2 + 1.0)
    mid_err = float((out_torch - expect).abs().mean())
    print(f"mean deviation from analytic gradient: {mid_err:.4f}")
    print("OK — new kernel from .ccl text, validated on both templates.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
