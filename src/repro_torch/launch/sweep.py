"""Full dry-run sweep: every (arch × applicable shape) cell on one device
(``--mesh single``), as one rank of the multi-pod production mesh
(``multi``) or both, with per-cell JSON artifacts under
``<out>/<mesh>/`` (``<out>/multi-a2a/`` under ``--moe-mode a2a``),
resumable (a cell whose artifact says ``ok`` or ``skipped`` is reused
unless ``--force``).

    PYTHONPATH=src python -m repro_torch.launch.sweep --mesh both
    PYTHONPATH=src python -m repro_torch.launch.sweep --mesh multi \\
        --moe-mode a2a

The port's copy of ``repro.launch.sweep`` over ``launch.dryrun``'s cells;
``--moe-mode`` reaches the meshed cells' ``ShardCfg`` (``a2a`` needs
``--mesh multi``: one device splits no sequence).  Exits 1 if any cell
errs.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--archs", default=None, help="comma-separated subset")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--moe-mode", default="tp", choices=["tp", "a2a"])
    ap.add_argument("--chip", default="h100-sxm")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun

    meshes = list(dryrun.MESHES) if args.mesh == "both" else [args.mesh]
    dryrun.check_posture(ap, meshes, args.moe_mode, False)
    out = args.out or os.path.abspath(dryrun.ARTIFACT_DIR)
    archs = args.archs.split(",") if args.archs else list(ARCHS)
    shapes = args.shapes.split(",") if args.shapes else list(SHAPES)

    t0 = time.time()
    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                path = dryrun.artifact_path(out, mesh_kind, arch, shape,
                                            args.moe_mode)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        art = json.load(f)
                    if art.get("status") in ("ok", "skipped"):
                        print(f"[sweep] cached {mesh_kind} {arch} {shape}: "
                              f"{art['status']}", flush=True)
                        results.append(art)
                        continue
                art = dryrun.run_cell(arch, shape, mesh_kind,
                                      moe_mode=args.moe_mode, chip=args.chip)
                dryrun.save_artifact(art, out)
                results.append(art)
    bad = [r for r in results if r["status"] == "error"]
    print(f"[sweep] {len(results)} cells in {time.time() - t0:.0f}s; "
          f"{len(bad)} errors", flush=True)
    for r in bad:
        print(f"  ERROR {r['mesh']} {r['arch']} {r['shape']}: "
              f"{r.get('error', '')[:200]}", flush=True)
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
