"""One-device dry run: each (arch × shape) cell's step traced on ``meta``
tensors, its bytes, FLOPs and memory reckoned before anything is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-moe-235b-a22b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Artifacts: artifacts/dryrun/<mesh>/<arch>__<shape>.json

The port's copy of ``repro.launch.dryrun``, with what has a torch meaning on
one device.  The reference lowers and compiles each cell for a 512-device
mesh and reads XLA's cost and memory analyses.  PyTorch runs eagerly, so
the port builds the cell's model (``init_params(..., device="meta")``),
optimizer state, caches and batch as ``meta`` tensors of the real shapes
and dtypes, which allocate nothing, and runs its step once under
``launch.op_cost``'s counter.  The trace follows the CUDA template's glue:
a kernel wrapper on ``meta`` books its declared cost, and its
``autograd.Function`` saves what it saves on the card.

* ``flops_per_device`` / ``hbm_bytes_per_device``: the counter's totals
  (``op_cost``'s conventions), ``bytes_by_class`` their split.
* ``memory.argument_bytes``: what the step is given, each leaf at its own
  dtype: the parameters, the optimizer state, the caches and the batch.
  ``memory.peak_bytes``: the most bytes the step's own allocations held at
  once (activations, what autograd saves, gradients, the float32
  accumulator, the optimizer's temporaries).  Their sum against the chip's
  memory is ``fits_hbm``.
* ``collective_wire_bytes_per_device`` is 0: one device, no collective.

A train cell with more microbatches than :data:`FULL_TRACE_MAX` traces the
step at 2 and at 3 microbatches and extrapolates: every microbatch after
the first does the same work, so the totals at ``grad_accum`` = A are
T(2) + (A - 2)·(T(3) - T(2)) exactly, and the peak is that of any step of
two or more (``traced_microbatches`` in the artifact says which ran).

``--mesh single`` is one device with no mesh.  ``--mesh multi|both`` (the
reference's production mesh, ``launch/mesh.py``) and ``--moe-mode a2a``
are ROADMAP queue 1, item 9b; ``--moe-mode tp`` on one device computes
every expert locally.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core.rooflinemodel import resolve_chip, terms_from_counts
from repro_torch.launch import op_cost
from repro_torch.models import model as model_lib
from repro_torch.models.config import LOCAL, ModelConfig, not_ported
from repro_torch.optim.adamw import AdamW
from repro_torch.train import step as step_lib

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun")
META = torch.device("meta")
# a train cell with more microbatches is traced at 2 and 3 and extrapolated
# (five traced microbatches either way)
FULL_TRACE_MAX = 5


# ---------------------------------------------------------------------------
# per-arch training plan (microbatching + optimizer dtypes at scale)
# ---------------------------------------------------------------------------
def train_plan(cfg: ModelConfig) -> dict:
    """The reference's plan: 16 microbatches and bf16 AdamW moments for a
    big model (d_model >= 4096 or >= 128 experts), else 4 and float32.
    The layout posture is ``local``: one device (the reference's
    ``fsdp_tp`` is ROADMAP queue 1, item 9b)."""
    big = cfg.d_model >= 4096 or cfg.num_experts >= 128
    return {
        "grad_accum": 16 if big else 4,
        "m_dtype": torch.bfloat16 if big else torch.float32,
        "v_dtype": torch.bfloat16 if big else torch.float32,
        "shard_mode": "local",
    }


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Model inputs for one cell as ``meta`` tensors: the reference's
    shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.family == "audio":
            batch["embeds"] = _meta((b, s, cfg.d_model), bf16)
        elif cfg.family == "vlm":
            batch["tokens"] = _meta((b, s - cfg.num_prefix_tokens), i32)
            batch["prefix_embeds"] = _meta(
                (b, cfg.num_prefix_tokens, cfg.d_model), bf16)
        else:
            batch["tokens"] = _meta((b, s), i32)
        if shape.kind == "train":
            tgt_len = s if cfg.family != "vlm" else s - cfg.num_prefix_tokens
            batch["targets"] = _meta((b, tgt_len), i32)
        return batch
    if shape.kind == "decode":
        return {"token": _meta((b, 1), i32)}
    raise ValueError(shape.kind)


def nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``, each at its own dtype."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """One cell ready to trace: ``fn(*args)`` runs its step on ``meta``."""
    fn: object
    args: tuple
    cfg: ModelConfig
    shape: ShapeSpec
    plan: dict
    memory: dict            # argument bytes by part


def check_mesh(mesh: str, moe_mode: str) -> None:
    """Raise for a posture that needs more than one device (item 9b)."""
    if mesh != "single":
        raise not_ported(f"--mesh {mesh} (the production mesh, "
                         "launch/mesh.py)", "9b")
    if moe_mode != "tp":
        raise not_ported(f"--moe-mode {moe_mode} (_a2a_moe)", "9b")


def build_cell(arch: str, shape_name: str, *, cfg_overrides=None,
               plan_overrides=None, shape_overrides=None,
               mesh: str = "single", moe_mode: str = "tp") -> Cell:
    """The cell's step and its ``meta`` arguments.

    ``cfg_overrides``/``plan_overrides`` are the reference's knobs (remat
    policy, chunk sizes, depth; grad_accum, optimizer dtypes,
    cache_dtype); ``shape_overrides`` replaces fields of the shape
    (``seq_len``, ``global_batch``), so that a drive's exact configuration
    can be reckoned."""
    check_mesh(mesh, moe_mode)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    lm = model_lib.init_params(cfg, device=META)
    batch = input_specs(cfg, shape)
    memory = {"params": nbytes(list(lm.parameters())),
              "batch": nbytes(batch)}

    plan_overrides = {k: getattr(torch, v) if k.endswith("_dtype")
                      and isinstance(v, str) else v
                      for k, v in (plan_overrides or {}).items()}
    if shape.kind == "train":
        plan = train_plan(cfg)
        plan.update(plan_overrides)
        opt = AdamW(m_dtype=plan["m_dtype"], v_dtype=plan["v_dtype"])
        state = opt.init(lm)
        memory["optimizer"] = nbytes(state)
        fn = step_lib.make_train_step(cfg, LOCAL, opt,
                                      grad_accum=plan["grad_accum"])
        return Cell(fn, (lm, state, batch), cfg, shape, plan, memory)

    # serving cells: cache max length = shape.seq_len
    plan = {"cache_dtype": torch.bfloat16, **plan_overrides}
    caches = model_lib.init_caches(cfg, shape.global_batch, shape.seq_len,
                                   plan["cache_dtype"], META)
    memory["caches"] = nbytes(caches)
    if shape.kind == "prefill":
        fn = step_lib.make_prefill_step(cfg, LOCAL)
        return Cell(fn, (lm, batch, caches), cfg, shape, plan, memory)
    if shape.kind == "decode":
        serve = step_lib.make_serve_step(cfg, LOCAL)
        # the cache holds seq_len - 1 positions; the step writes the last
        fn = lambda lm, token, caches: serve(lm, token, caches,
                                             shape.seq_len - 1)
        return Cell(fn, (lm, batch["token"], caches), cfg, shape, plan,
                    memory)
    raise ValueError(shape.kind)


@dataclasses.dataclass
class Trace:
    """A cell's counts: totals by op class and by op, and the peak of the
    live bytes its step allocated."""
    classes: dict
    ops: dict
    peak_bytes: int
    traced_microbatches: list

    @property
    def flops(self) -> float:
        return sum(r["flops"] for r in self.classes.values())

    @property
    def hbm_bytes(self) -> float:
        return sum(r["bytes"] for r in self.classes.values())


def _extrapolate(t2: dict, t3: dict, a: int) -> dict:
    """T(2) + (a - 2)·(T(3) - T(2)), row by row."""
    out = {}
    for key in t2.keys() | t3.keys():
        r2 = t2.get(key, {"bytes": 0.0, "flops": 0.0, "calls": 0})
        r3 = t3.get(key, {"bytes": 0.0, "flops": 0.0, "calls": 0})
        out[key] = {f: r2[f] + (a - 2) * (r3[f] - r2[f]) for f in r2}
    return out


def trace_cell(arch: str, shape_name: str, **kw) -> tuple[Cell, Trace]:
    """Build the cell (:func:`build_cell`'s arguments) and count its step;
    a train cell with more than :data:`FULL_TRACE_MAX` microbatches is
    counted at 2 and 3 and extrapolated."""
    cell = build_cell(arch, shape_name, **kw)
    accum = cell.plan.get("grad_accum", 1)
    if cell.shape.kind != "train":
        # once, under no_grad: the LM path keeps no constant tables for a
        # warm-up run to fill (op_cost.count's first run)
        with torch.no_grad(), op_cost.OpCounter() as c:
            cell.fn(*cell.args)
        return cell, Trace(c.classes, c.ops, c.peak_bytes, [])
    if accum <= FULL_TRACE_MAX:
        c = op_cost.count(cell.fn, *cell.args, grad=True)
        return cell, Trace(c.classes, c.ops, c.peak_bytes, [accum])
    micro = cell.shape.global_batch // accum
    counts = []
    for n in (2, 3):
        shape = dict(kw.get("shape_overrides") or {}, global_batch=micro * n)
        plan = dict(kw.get("plan_overrides") or {}, grad_accum=n)
        part = build_cell(arch, shape_name, **dict(
            kw, shape_overrides=shape, plan_overrides=plan))
        counts.append(op_cost.count(part.fn, *part.args, grad=True))
    c2, c3 = counts
    return cell, Trace(_extrapolate(c2.classes, c3.classes, accum),
                       _extrapolate(c2.ops, c3.ops, accum),
                       max(c2.peak_bytes, c3.peak_bytes), [2, 3])


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", *,
             moe_mode: str = "tp", verbose: bool = True, cfg_overrides=None,
             plan_overrides=None, shape_overrides=None,
             chip: str = "h100-sxm") -> dict:
    """One cell's artifact: the reference's keys where they keep their
    meaning, ``status`` ok, skipped (``long_500k`` on a full-attention
    arch) or error."""
    check_mesh(mesh_kind, moe_mode)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    hw = resolve_chip(chip)
    art = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": None, "devices": 1, "kind": shape.kind,
           "moe_mode": "local" if cfg.num_experts else None,
           "chip": hw.name}
    for key, val in (("cfg_overrides", cfg_overrides),
                     ("plan_overrides", plan_overrides),
                     ("shape_overrides", shape_overrides)):
        if val:
            art[key] = {k: str(v) for k, v in val.items()}
    if not applicable(cfg, shape):
        art["status"] = "skipped"
        art["reason"] = ("long_500k requires sub-quadratic sequence mixing; "
                         f"{arch} is full-attention (see DESIGN.md)")
        return art
    t0 = time.time()
    try:
        cell, tr = trace_cell(arch, shape_name, cfg_overrides=cfg_overrides,
                              plan_overrides=plan_overrides,
                              shape_overrides=shape_overrides)
        shape = cell.shape
        art["trace_s"] = round(time.time() - t0, 2)
        art["seq_len"], art["global_batch"] = shape.seq_len, shape.global_batch
        art["plan"] = {k: str(v) for k, v in cell.plan.items()}
        if shape.kind == "train":
            art["traced_microbatches"] = tr.traced_microbatches
        art["flops_per_device"] = tr.flops
        art["hbm_bytes_per_device"] = tr.hbm_bytes
        art["collective_wire_bytes_per_device"] = 0.0
        art["collective_counts"] = {}
        art["bytes_by_class"] = {k: r["bytes"] for k, r in
                                 sorted(tr.classes.items())}
        arg_b = sum(cell.memory.values())
        art["memory"] = {"argument_bytes": arg_b,
                         "argument_bytes_by_part": cell.memory,
                         "peak_bytes": tr.peak_bytes}
        n_active = cfg.active_param_count()
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        mult = 6 if shape.kind == "train" else 2
        model_flops = mult * n_active * tokens
        art["n_params"] = cfg.param_count()
        art["n_active_params"] = n_active
        art["model_flops_global"] = float(model_flops)
        art["model_flops_per_device"] = float(model_flops)
        art["useful_flops_ratio"] = (model_flops / tr.flops if tr.flops
                                     else None)
        art["roofline"] = terms_from_counts(tr.flops, tr.hbm_bytes, 0.0,
                                            chip=hw).as_dict()
        art["hbm_bytes_of_chip"] = hw.hbm_bytes
        art["fits_hbm"] = bool(arg_b + tr.peak_bytes <= hw.hbm_bytes)
        art["status"] = "ok"
    except Exception as e:      # one cell's failure never stops a sweep
        art["status"] = "error"
        art["error"] = f"{type(e).__name__}: {e}"
        art["traceback"] = traceback.format_exc()[-4000:]
    art["total_s"] = round(time.time() - t0, 2)
    if verbose:
        tag, extra = art["status"], ""
        if tag == "ok":
            r, m = art["roofline"], art["memory"]
            extra = (f" bottleneck={r['bottleneck']}"
                     f" frac={r['roofline_fraction']:.3f}"
                     f" argument={m['argument_bytes'] / 1e9:.2f}GB"
                     f" peak={m['peak_bytes'] / 1e9:.2f}GB"
                     f" fits_hbm={art['fits_hbm']} trace={art['trace_s']}s")
        print(f"[dryrun {mesh_kind}] {arch} × {shape_name}: {tag}{extra}",
              flush=True)
    return art


def save_artifact(art: dict, out_dir: str) -> str:
    d = os.path.join(out_dir, art["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{art['arch']}__{art['shape']}.json")
    slim = {k: v for k, v in art.items() if k != "traceback"}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1, default=str)
    if art.get("traceback"):
        with open(path + ".err", "w") as f:
            f.write(art["traceback"])
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-mode", default="tp", choices=["tp", "a2a"])
    ap.add_argument("--chip", default="h100-sxm",
                    help="registry name of the chip the memory must fit")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_kind in meshes:
        check_mesh(mesh_kind, args.moe_mode)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = 0
    for arch in archs:
        for shape in shapes:
            art = run_cell(arch, shape, "single", moe_mode=args.moe_mode,
                           chip=args.chip)
            save_artifact(art, args.out)
            if art["status"] == "error":
                failures += 1
                print(art["error"], flush=True)
    print(f"dryrun complete; {failures} failures", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
