"""Reynolds-number sweep through the simulation farm on the PyTorch port:
the run of ``examples/ensemble_sweep.py`` through ``repro_torch.api``.

Eight lid-driven cavity variants share one device batch: submit them all
through the runtime front door, drain, and compare the centerline profiles
— one cached step served every simulation, each batched step advancing
every resident slot with one launch of each stencil kernel on the card
(``--device cuda``, the default; ``cpu`` runs their plain versions).

Run:  PYTHONPATH=src python examples/ensemble_sweep_torch.py [--n 24]
          [--slots 4] [--t-end 4.0] [--device cpu]
          [--trace-out events.jsonl] [--report]

``--trace-out`` enables telemetry and streams every per-sim lifecycle
event (submit -> admit -> first_step -> result) to a JSON-lines file; a
Chrome-trace twin (``<path>.chrome.json``) is written alongside for
Perfetto.  ``--report`` prints the Cactus-style timer/metrics summary.
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--t-end", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--trace-out", default=None,
                    help="stream lifecycle events here as JSON-lines")
    ap.add_argument("--report", action="store_true",
                    help="print the repro_torch.obs timer/metrics report")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch import api

    telemetry = ({"trace_path": args.trace_out} if args.trace_out
                 else bool(args.report))
    reynolds = [50, 75, 100, 150, 200, 250, 300, 400]
    rt = api.runtime(n=args.n, n_slots=args.slots, telemetry=telemetry,
                     device=args.device)
    print(f"cavity sweep: {len(reynolds)} Reynolds numbers through "
          f"{args.slots} slots on a {args.n}^2 grid")

    t0 = time.time()
    sids = {rt.submit("cavity", re=float(re), t_end=args.t_end,
                      tag=f"re{re}"): re
            for re in reynolds}
    results = {sid: rt.result(sid) for sid in sids}
    dt = time.time() - t0

    total_steps = sum(r.steps_done for r in results.values())
    print(f"{total_steps} sim-steps in {dt:.1f}s "
          f"({total_steps / dt:.0f} steps/s), "
          f"{rt.device_steps()} device dispatch rounds")
    print(f"compile cache: {api.compile_cache_stats()}")

    if args.report or args.trace_out:
        print(rt.report())
    if args.trace_out:
        chrome = rt.telemetry.trace.save_chrome(
            args.trace_out + ".chrome.json")
        print(f"trace: {len(rt.telemetry.trace.events)} events -> "
              f"{args.trace_out} (+ {chrome} for Perfetto)")

    print("\n  Re    min u(y)   max u(y)   (centerline, z-averaged)")
    u_max = []
    for sid, re in sorted(sids.items(), key=lambda kv: kv[1]):
        r = results[sid]
        _, u = rt.analyze(r)["centerline_u"]
        u_max.append(float(np.max(u)))
        print(f"  {re:4d}  {float(np.min(u)):9.4f}  {float(np.max(u)):9.4f}"
              f"   ({r.steps_done} steps, {r.terminated})")
    # at fixed (short) time the lid's momentum has diffused less at higher
    # Re: the near-lid boundary layer is thinner, so the centerline maximum
    # decreases monotonically with Re — the expected developing-flow trend
    ok = all(a > b for a, b in zip(u_max, u_max[1:]))
    print("OK" if ok else "FAILED: boundary layer did not thin with Re")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
