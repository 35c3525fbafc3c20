"""Quickstart on the PyTorch port: the run of ``examples/quickstart.py``
through ``repro_torch.api``, the same three lines.

Scenarios are registered problem declarations; the Runtime resolves them
onto an execution stack (the serial driver here).  Nothing below names a
kernel, a halo exchange or a device beyond ``--device``: on the card
(``cuda``, the default) the steps run the hand-written stencil kernels, on
``cpu`` their plain versions.  Without a card ``--device cuda`` raises.

    rt = api.runtime(n=24)
    res = rt.run("cavity", t_end=2.0, re=100.0)
    print(res.diagnostics["ghia"])

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
      [--n 24] [--t-end 2.0] [--tg-steps 40]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--t-end", type=float, default=2.0)
    ap.add_argument("--tg-steps", type=int, default=40)
    args = ap.parse_args(argv)

    from repro_torch import api

    # the registry: every problem the runtime can serve by name
    print("registered scenarios:")
    for name in api.scenario_names():
        print(f"  {name:18s} {api.get_scenario(name).description}")

    # -- the three-line quickstart -------------------------------------------
    rt = api.runtime(n=args.n, device=args.device)
    res = rt.run("cavity", t_end=args.t_end, re=100.0)
    print(f"\ncavity Re=100, {res.steps_done} steps "
          f"(terminated: {res.terminated})")
    print("Ghia centerline deviation:",
          {k: round(v, 4) for k, v in res.diagnostics["ghia"].items()})

    # same front door, different scenario + per-run parameters
    tg = rt.run("taylor_green", steps=args.tg_steps, nu=0.05)
    err = tg.diagnostics["analytic_error"]
    print(f"taylor_green nu=0.05: max |v - analytic| = "
          f"{max(err['err_vx'], err['err_vy']):.2e} at t={err['t']:.3f}")
    assert max(err["err_vx"], err["err_vy"]) < 5e-3
    assert res.steps_done > 0
    print("OK — scenario registry -> runtime -> driver stack, one surface.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
