"""Dry run: each (arch × shape) cell's step traced on ``meta`` tensors, on
one device or as one rank of a mesh, its bytes, FLOPs, collectives and
memory reckoned before anything is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-moe-235b-a22b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-moe-235b-a22b --shape train_4k --mesh multi \\
        --moe-mode a2a
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Artifacts: artifacts/dryrun/<mesh>[-a2a][-ssm_sp]/<arch>__<shape>.json

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
* ``collective_wire_bytes_per_device``: 0 on one device.  As one rank of
  a mesh, the wire bytes of the collectives its step runs, with the
  reference's ring factors, and ``collectives`` their calls, operand
  bytes and wire bytes by kind (``dist.collectives``' counting mode).

A train cell with more microbatches than :data:`FULL_TRACE_MAX` traces the
step at 2 and at 3 microbatches and extrapolates: every microbatch after
the first does the same work, so the totals at ``grad_accum`` = A are
T(2) + (A - 2)·(T(3) - T(2)) exactly, and the peak is that of any step of
two or more (``traced_microbatches`` in the artifact says which ran).

``--mesh single`` is one device with no mesh: one device computes every
expert and the whole sequence, so ``--moe-mode a2a`` and ``--ssm-sp``
are refused there (and with ``both``, which runs ``single`` too).  ``--mesh multi`` traces one rank of the reference's
multi-pod production mesh, (pod 2, data 16, model 16)
(``launch.mesh.production_counting_mesh``, rank 0's coordinate), and
``both`` runs ``single`` then ``multi``; ``run_cell(..., mesh=...)`` takes
any ``CountingMesh``, as the reference's ``mesh=`` argument takes any
mesh.  On a mesh the parameters are this rank's blocks
(``dist.sharding.shard_params`` on ``meta``); a train cell runs the
``fsdp_tp`` step (``train_plan(..., meshed=True)``'s ``shard_mode``, the
reference's plan) on this rank's rows, in as many of the plan's
microbatches as its rows divide into (``plan["grad_accum"]``;
``grad_accum_plan`` keeps the plan's when it differs); a prefill or
decode cell runs ``prefill``/``decode_step`` under the meshed ``ShardCfg``
with this rank's blocks of the caches (``dist.sharding.local_caches``).
``--moe-mode`` (``tp`` or ``a2a``) and ``ssm_sp`` reach the ``ShardCfg``.
A cell the posture cannot run ends ``status: error`` with the reason (for
example ``a2a`` at decode: one token does not split over ``model``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core.rooflinemodel import resolve_chip, terms_from_counts
from repro_torch.dist import collectives, sharding
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import mesh_extents, production_counting_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.config import LOCAL, ModelConfig
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
def train_plan(cfg: ModelConfig, meshed: bool = False) -> dict:
    """The reference's plan: 16 microbatches and bf16 AdamW moments for a
    big model (d_model >= 4096 or >= 128 experts), else 4 and float32.
    The layout posture is the reference's ``fsdp_tp`` over a mesh, and
    ``local`` on one device."""
    big = cfg.d_model >= 4096 or cfg.num_experts >= 128
    return {
        "grad_accum": 16 if big else 4,
        "m_dtype": torch.bfloat16 if big else torch.float32,
        "v_dtype": torch.bfloat16 if big else torch.float32,
        "shard_mode": "fsdp_tp" if meshed else "local",
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
    shard: object = LOCAL


MESHES = ("single", "multi")
MOE_MODES = ("tp", "a2a")


def check_mesh(mesh, moe_mode: str, ssm_sp: bool = False) -> None:
    """Raise ``ValueError`` for a mesh kind or an MoE mode the dry run does
    not know, and for ``a2a`` or ``ssm_sp`` without a mesh: one device
    splits no sequence, so it would trace neither posture (a mesh object
    passes: :func:`resolve_mesh` checks it)."""
    if isinstance(mesh, str) and mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r} (one of {MESHES}, or "
                         "'both' on the command line)")
    if moe_mode not in MOE_MODES:
        raise ValueError(f"unknown moe mode {moe_mode!r} (one of "
                         f"{MOE_MODES})")
    if (moe_mode == "a2a" or ssm_sp) and mesh in (None, "single"):
        posture = "moe_mode='a2a'" if moe_mode == "a2a" else "ssm_sp"
        raise ValueError(f"{posture} splits the sequence over the model "
                         "axis and needs a mesh: give mesh 'multi' or a "
                         "CountingMesh, not one device")


def resolve_mesh(mesh):
    """None for ``"single"``; the multi-pod production layout as a
    ``CountingMesh`` for ``"multi"``; a counting mesh as it is."""
    if mesh == "single" or mesh is None:
        return None
    if mesh == "multi":
        return production_counting_mesh(multi_pod=True)
    if not collectives.counting(mesh):
        raise ValueError("the dry run traces one rank on meta tensors and "
                         "runs no collective: give it a CountingMesh "
                         f"(launch.mesh), not {mesh!r}")
    return mesh


def mesh_label(mesh) -> str:
    """The artifact's ``mesh``: the kind's name, or ``AxB...`` of a mesh
    object."""
    if isinstance(mesh, str):
        return mesh
    return "x".join(str(n) for n in mesh.shape)


def _divisor_at_most(rows: int, most: int) -> int:
    return max(a for a in range(1, min(rows, most) + 1) if rows % a == 0)


def build_cell(arch: str, shape_name: str, *, cfg_overrides=None,
               plan_overrides=None, shape_overrides=None,
               mesh="single", moe_mode: str = "tp",
               ssm_sp: bool = False) -> Cell:
    """The cell's step and its ``meta`` arguments.

    ``cfg_overrides``/``plan_overrides`` are the reference's knobs (remat
    policy, chunk sizes, depth; grad_accum, optimizer dtypes,
    cache_dtype, shard_mode); ``shape_overrides`` replaces fields of the
    shape (``seq_len``, ``global_batch``), so that a drive's exact
    configuration can be reckoned.  ``mesh``: ``"single"``, ``"multi"`` or
    a ``CountingMesh``; on a mesh the arguments are one rank's blocks (the
    module's text)."""
    check_mesh(mesh, moe_mode, ssm_sp)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    counting_mesh = resolve_mesh(mesh)
    lm = model_lib.init_params(cfg, device=META)
    batch = input_specs(cfg, shape)
    plan = (train_plan(cfg, meshed=counting_mesh is not None)
            if shape.kind == "train" else {"cache_dtype": torch.bfloat16})
    plan.update({k: getattr(torch, v) if k.endswith("_dtype")
                 and isinstance(v, str) else v
                 for k, v in (plan_overrides or {}).items()})
    shard = LOCAL
    if counting_mesh is not None:
        shard = sharding.make_shard_cfg(
            counting_mesh, cfg, shape.global_batch,
            mode=plan.get("shard_mode", "fsdp_tp"),
            moe_mode=moe_mode if cfg.num_experts else None, ssm_sp=ssm_sp)
        lm = sharding.shard_params(lm, cfg, shard)
    memory = {"params": nbytes(list(lm.parameters()))}

    if shape.kind == "train":
        accum = plan["grad_accum"]
        if counting_mesh is not None:
            rows = shape.global_batch // (
                shard.dp_size() if shard.batch_sharded else 1)
            accum = _divisor_at_most(rows, accum)
            if accum != plan["grad_accum"]:
                plan["grad_accum_plan"] = plan["grad_accum"]
                plan["grad_accum"] = accum
            batch = sharding.local_batch(batch, counting_mesh, shard, accum)
        memory["batch"] = nbytes(batch)
        opt = AdamW(m_dtype=plan["m_dtype"], v_dtype=plan["v_dtype"])
        state = opt.init(lm)
        memory["optimizer"] = nbytes(state)
        fn = step_lib.make_train_step(cfg, shard, opt, grad_accum=accum)
        return Cell(fn, (lm, state, batch), cfg, shape, plan, memory, shard)

    # serving cells: cache max length = shape.seq_len
    if counting_mesh is None:
        caches, kvb = model_lib.init_caches(
            cfg, shape.global_batch, shape.seq_len, plan["cache_dtype"],
            META), None
    else:
        rows = sharding.local_rows(shape.global_batch, shard)
        batch = {k: v[rows] for k, v in batch.items()}
        caches, kvb = sharding.local_caches(
            cfg, shape.global_batch, shape.seq_len, shard,
            plan["cache_dtype"], META)
    memory["batch"] = nbytes(batch)
    memory["caches"] = nbytes(caches)
    if shape.kind == "prefill":
        fn = step_lib.make_prefill_step(cfg, shard, kv_block=kvb)
        return Cell(fn, (lm, batch, caches), cfg, shape, plan, memory, shard)
    if shape.kind == "decode":
        serve = step_lib.make_serve_step(cfg, shard, kv_block=kvb)
        # the cache holds seq_len - 1 positions; the step writes the last
        fn = lambda lm, token, caches: serve(lm, token, caches,
                                             shape.seq_len - 1)
        return Cell(fn, (lm, batch["token"], caches), cfg, shape, plan,
                    memory, shard)
    raise ValueError(shape.kind)


@dataclasses.dataclass
class Trace:
    """A cell's counts: totals by op class and by op, the peak of the live
    bytes its step allocated, and its collectives by kind (calls, operand
    bytes, wire bytes; none on one device)."""
    classes: dict
    ops: dict
    peak_bytes: int
    traced_microbatches: list
    collectives: dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return sum(r["flops"] for r in self.classes.values())

    @property
    def hbm_bytes(self) -> float:
        return sum(r["bytes"] for r in self.classes.values())

    @property
    def wire_bytes(self) -> float:
        return sum(r["wire_bytes"] for r in self.collectives.values())


def _extrapolate(t2: dict, t3: dict, a: int) -> dict:
    """T(2) + (a - 2)·(T(3) - T(2)), row by row."""
    out = {}
    for key in t2.keys() | t3.keys():
        zero = dict.fromkeys((t2.get(key) or t3[key]), 0)
        r2, r3 = t2.get(key, zero), t3.get(key, zero)
        out[key] = {f: r2[f] + (a - 2) * (r3[f] - r2[f]) for f in r2}
    return out


def _counted(fn, *args, grad: bool) -> tuple:
    """(counter, collectives by kind) of one trace of ``fn(*args)``."""
    collectives.reset_stats()
    if grad:
        c = op_cost.count(fn, *args, grad=True)
    else:
        # once, under no_grad: the LM path keeps no constant tables for a
        # warm-up run to fill (op_cost.count's first run)
        with torch.no_grad(), op_cost.OpCounter() as c:
            fn(*args)
    booked = {k: dict(v) for k, v in collectives.STATS["by_kind"].items()}
    collectives.reset_stats()
    return c, booked


def trace_cell(arch: str, shape_name: str, **kw) -> tuple[Cell, Trace]:
    """Build the cell (:func:`build_cell`'s arguments) and count its step;
    a train cell with more than :data:`FULL_TRACE_MAX` microbatches is
    counted at 2 and 3 and extrapolated."""
    cell = build_cell(arch, shape_name, **kw)
    accum = cell.plan.get("grad_accum", 1)
    if cell.shape.kind != "train":
        c, coll = _counted(cell.fn, *cell.args, grad=False)
        return cell, Trace(c.classes, c.ops, c.peak_bytes, [], coll)
    if accum <= FULL_TRACE_MAX:
        c, coll = _counted(cell.fn, *cell.args, grad=True)
        return cell, Trace(c.classes, c.ops, c.peak_bytes, [accum], coll)
    micro = cell.shape.global_batch // accum
    counts = []
    for n in (2, 3):
        shape = dict(kw.get("shape_overrides") or {}, global_batch=micro * n)
        plan = dict(kw.get("plan_overrides") or {}, grad_accum=n)
        part = build_cell(arch, shape_name, **dict(
            kw, shape_overrides=shape, plan_overrides=plan))
        counts.append(_counted(part.fn, *part.args, grad=True))
    (c2, k2), (c3, k3) = counts
    return cell, Trace(_extrapolate(c2.classes, c3.classes, accum),
                       _extrapolate(c2.ops, c3.ops, accum),
                       max(c2.peak_bytes, c3.peak_bytes), [2, 3],
                       _extrapolate(k2, k3, accum))


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", *,
             moe_mode: str = "tp", ssm_sp: bool = False, mesh=None,
             verbose: bool = True, cfg_overrides=None, plan_overrides=None,
             shape_overrides=None, chip: str = "h100-sxm") -> dict:
    """One cell's artifact: the reference's keys where they keep their
    meaning, ``status`` ok, skipped (``long_500k`` on a full-attention
    arch) or error.  ``mesh`` (a ``CountingMesh``), when given, replaces
    ``mesh_kind``'s layout, as the reference's ``mesh=`` does."""
    check_mesh(mesh_kind, moe_mode)
    where = mesh if mesh is not None else mesh_kind
    check_mesh(where, moe_mode, ssm_sp)
    counting_mesh = resolve_mesh(where)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    hw = resolve_chip(chip)
    ext = mesh_extents(counting_mesh) if counting_mesh is not None else None
    art = {"arch": arch, "shape": shape_name, "mesh": mesh_label(where),
           "mesh_shape": ext, "devices": math.prod(ext.values())
           if ext else 1, "kind": shape.kind, "chip": hw.name}
    if counting_mesh is None:
        art["moe_mode"] = "local" if cfg.num_experts else None
    else:
        art["moe_mode"] = moe_mode
        art["coordinate"] = dict(counting_mesh.coordinate)
        if ssm_sp:
            art["ssm_sp"] = True
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
                              shape_overrides=shape_overrides, mesh=where,
                              moe_mode=moe_mode, ssm_sp=ssm_sp)
        shape = cell.shape
        art["trace_s"] = round(time.time() - t0, 2)
        art["seq_len"], art["global_batch"] = shape.seq_len, shape.global_batch
        art["plan"] = {k: str(v) for k, v in cell.plan.items()}
        if shape.kind == "train":
            art["traced_microbatches"] = tr.traced_microbatches
        art["flops_per_device"] = tr.flops
        art["hbm_bytes_per_device"] = tr.hbm_bytes
        art["collective_wire_bytes_per_device"] = tr.wire_bytes
        art["collective_counts"] = {k: r["calls"] for k, r in
                                    sorted(tr.collectives.items())}
        art["collectives"] = {k: tr.collectives[k]
                              for k in sorted(tr.collectives)}
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
        art["model_flops_per_device"] = float(model_flops) / art["devices"]
        art["useful_flops_ratio"] = (art["model_flops_per_device"] / tr.flops
                                     if tr.flops else None)
        art["roofline"] = terms_from_counts(tr.flops, tr.hbm_bytes,
                                            tr.wire_bytes, chip=hw).as_dict()
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
                     f" wire="
                     f"{art['collective_wire_bytes_per_device'] / 1e9:.2f}GB"
                     f" fits_hbm={art['fits_hbm']} trace={art['trace_s']}s")
        print(f"[dryrun {art['mesh']}] {arch} × {shape_name}: {tag}{extra}",
              flush=True)
    return art


def artifact_path(out_dir: str, mesh: str, arch: str, shape: str,
                  moe_mode: str = "tp", ssm_sp: bool = False) -> str:
    """``<out>/<mesh>[-a2a][-ssm_sp]/<arch>__<shape>.json``: a posture's
    cells lie apart from the same mesh's ``tp`` cells."""
    d = mesh + ("-a2a" if moe_mode == "a2a" else "") + (
        "-ssm_sp" if ssm_sp else "")
    return os.path.join(out_dir, d, f"{arch}__{shape}.json")


def save_artifact(art: dict, out_dir: str) -> str:
    path = artifact_path(out_dir, art["mesh"], art["arch"], art["shape"],
                         art.get("moe_mode"), art.get("ssm_sp", False))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    slim = {k: v for k, v in art.items() if k != "traceback"}
    with open(path, "w") as f:
        json.dump(slim, f, indent=1, default=str)
    if art.get("traceback"):
        with open(path + ".err", "w") as f:
            f.write(art["traceback"])
    return path


def check_posture(ap, meshes, moe_mode: str, ssm_sp: bool) -> None:
    """A command line's refusal (exit 2) of ``--moe-mode a2a`` or
    ``--ssm-sp`` with a ``single`` mesh (``--mesh single`` or ``both``)."""
    for kind in meshes:
        try:
            check_mesh(kind, moe_mode, ssm_sp)
        except ValueError as e:
            ap.error(f"--mesh {kind}: {e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-mode", default="tp", choices=list(MOE_MODES))
    ap.add_argument("--ssm-sp", action="store_true",
                    help="sequence-parallel Mamba2 over the model axis")
    ap.add_argument("--chip", default="h100-sxm",
                    help="registry name of the chip the memory must fit")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    check_posture(ap, meshes, args.moe_mode, args.ssm_sp)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                art = run_cell(arch, shape, mesh_kind,
                               moe_mode=args.moe_mode, ssm_sp=args.ssm_sp,
                               chip=args.chip)
                save_artifact(art, args.out)
                if art["status"] == "error":
                    failures += 1
                    print(art["error"], flush=True)
    print(f"dryrun complete; {failures} failures", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
