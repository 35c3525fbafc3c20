"""Lid-driven cavity at Re=100 on the PyTorch port, validated against
Ghia et al. (1982): the run of ``examples/cavity_flow.py`` through
``repro_torch.api`` — the paper's own demonstration application (its
Fig. 3), several hundred solver steps, the Ghia comparison delivered by
the scenario's ANALYSIS bin as run diagnostics.

On the card (``--device cuda``, the default) every step runs the
hand-written stencil kernels; on ``cpu`` their plain versions.  Beside the
reference's output it prints the final state's largest cell divergence,
which the reference's tests hold below 0.05.  Exits 1 if the validation
fails.

Run:  PYTHONPATH=src python examples/cavity_flow_torch.py [--n 48]
      [--t-end 12] [--device cpu]
"""
import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--t-end", type=float, default=12.0)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from repro_torch import api
    from repro_torch.cfd.cavity import GHIA_RE100_U

    print(f"lid-driven cavity Re=100, {args.n}^2 grid, t_end={args.t_end}")
    rt = api.runtime(n=args.n, device=args.device)
    res = rt.run("cavity", t_end=args.t_end, re=100.0, progress=200)
    errors = res.diagnostics["ghia"]
    print(f"steps: {res.steps_done}")
    print(f"Ghia centerline deviation: u_rms={errors['u_rms']:.4f} "
          f"v_rms={errors['v_rms']:.4f}")

    # ASCII profile: u(y) through the vertical centerline vs Ghia points
    y, u = res.diagnostics["centerline_u"]
    print("\n  u(y) at x=0.5   (*=ours, o=Ghia)")
    for gy, gu in GHIA_RE100_U[1:-1]:
        ui = float(np.interp(gy, y, u))
        col = int((ui + 0.4) / 1.4 * 58)
        gcol = int((gu + 0.4) / 1.4 * 58)
        line = [" "] * 60
        line[min(max(gcol, 0), 59)] = "o"
        line[min(max(col, 0), 59)] = "*"
        print(f"  y={gy:5.3f} |{''.join(line)}|")

    # the final state's divergence, from the run's own solver
    pr = rt.prepare("cavity", re=100.0)
    state = {k: v.to(pr.solver.device) for k, v in res.state.items()}
    div = float(pr.solver.divergence_of(state).abs().max())
    print(f"max |div u|: {div:.3e}")
    ok = errors["u_rms"] < 0.035 and errors["v_rms"] < 0.035
    print("\nVALIDATION", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
