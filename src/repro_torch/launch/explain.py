"""Dry-run diagnostics: trace one cell (with optional knob overrides) and
print its roofline terms, its bytes by op class, and the costliest aten
ops — the dry run's "profiler".

    PYTHONPATH=src python -m repro_torch.launch.explain \\
        --arch qwen3-moe-235b-a22b --shape train_4k \\
        [--set num_layers=1] [--plan grad_accum=2] \\
        [--mesh multi] [--moe-mode a2a] [--ssm-sp]

The port's copy of ``repro.launch.explain``.  The reference parses the
compiled HLO and can ``--drill`` into one HLO computation; the port traces
aten ops on ``meta`` tensors (``launch.dryrun.trace_cell``), where no HLO
computation exists, so ``--drill`` has no torch meaning and raises.  Its
op classes are ``launch.op_cost``'s: each hand-written kernel by name,
``cat``, ``flip``, ``fill`` and ``other``.  ``--mesh multi`` traces one
rank of the multi-pod production mesh, with ``--moe-mode`` and
``--ssm-sp`` reaching its ``ShardCfg``, and prints the rank's collectives
by kind (``launch.dryrun``); ``a2a`` and ``--ssm-sp`` need that mesh.
"""
from __future__ import annotations

import argparse


def parse_kv(items):
    out = {}
    for kv in items or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "true"):
            v = True
        if v in ("False", "false"):
            v = False
        out[k] = v
    return out


def explain(arch, shape, mesh_kind="single", *, moe_mode="tp",
            cfg_overrides=None, plan_overrides=None, ssm_sp=False, top=6,
            drill=None, chip="h100-sxm"):
    """Print the cell's roofline terms, bytes by op class and its ``top``
    costliest ops by bytes; returns (terms, trace)."""
    from repro_torch.core.rooflinemodel import resolve_chip, terms_from_counts
    from repro_torch.launch import dryrun

    if drill is not None:
        raise ValueError("--drill names an HLO computation, which a torch "
                         "trace does not have: the port's dry run counts "
                         "aten ops (see the costliest ops below without it)")
    cell, tr = dryrun.trace_cell(arch, shape, cfg_overrides=cfg_overrides,
                                 plan_overrides=plan_overrides,
                                 mesh=mesh_kind, moe_mode=moe_mode,
                                 ssm_sp=ssm_sp)
    hw = resolve_chip(chip)
    terms = terms_from_counts(tr.flops, tr.hbm_bytes, tr.wire_bytes, chip=hw)
    total = max(tr.hbm_bytes, 1)
    print(f"== {arch} × {shape} ({dryrun.mesh_label(mesh_kind)}; "
          f"moe={cell.shard.moe_mode}, ssm_sp={cell.shard.ssm_sp}, "
          f"cfg={cfg_overrides}, plan={plan_overrides}; chip {hw.name})")
    print(f"   compute_s={terms.compute_s:.3f}  memory_s={terms.memory_s:.3f}"
          f"  collective_s={terms.collective_s:.3f}  "
          f"bottleneck={terms.bottleneck}  frac={terms.compute_fraction:.4f}")
    print(f"   memory: argument {sum(cell.memory.values()) / 1e9:.2f} GB "
          f"{ {k: round(v / 1e9, 3) for k, v in cell.memory.items()} }, "
          f"peak {tr.peak_bytes / 1e9:.2f} GB")
    print("   collectives:", {k: int(r["calls"]) for k, r in
                              sorted(tr.collectives.items())},
          f"wire {tr.wire_bytes / 1e9:.3f} GB")
    print("   bytes by op class:")
    for k, r in sorted(tr.classes.items(), key=lambda kv: -kv[1]["bytes"]):
        print(f"     {k:24s} {r['bytes'] / 1e9:10.1f} GB  "
              f"{100 * r['bytes'] / total:5.1f}%  {r['flops'] / 1e12:9.2f} TF")
    print("   top ops (bytes, FLOPs, calls):")
    rows = sorted(tr.ops.items(), key=lambda kv: -kv[1]["bytes"])[:top]
    for name, r in rows:
        print(f"     {r['bytes'] / 1e9:10.2f} GB {r['flops'] / 1e12:8.2f} TF "
              f"{int(r['calls']):7d}  {name[:70]}")
    return terms, tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--moe-mode", default="tp", choices=["tp", "a2a"])
    ap.add_argument("--set", nargs="*", default=None,
                    help="cfg overrides k=v")
    ap.add_argument("--plan", nargs="*", default=None,
                    help="train-plan overrides k=v")
    ap.add_argument("--ssm-sp", action="store_true")
    ap.add_argument("--drill", default=None,
                    help="an HLO computation (no torch meaning: raises)")
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    from repro_torch.launch import dryrun

    dryrun.check_posture(ap, [args.mesh], args.moe_mode, args.ssm_sp)
    explain(args.arch, args.shape, args.mesh, moe_mode=args.moe_mode,
            cfg_overrides=parse_kv(args.set) or None,
            plan_overrides=parse_kv(args.plan) or None,
            ssm_sp=args.ssm_sp, top=args.top, drill=args.drill)


if __name__ == "__main__":
    main()
