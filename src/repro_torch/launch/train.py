"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 256

The port's copy of ``repro.launch.train``, with its flags and log lines:
config registry -> data pipeline -> model and optimizer -> train step ->
watchdog -> async checkpointing -> restart-resume.  ``--smoke`` shrinks the
arch to its CPU-runnable config; without it the model runs at its
published widths.  ``--device`` defaults to ``cuda``, where the step runs
the hand-written kernels; on ``cpu`` it runs their plain versions.

``--mesh DxM`` trains over a (data D, model M) mesh of D·M ranks, one
process each, started by ``launch.mesh.spawn``: the ``fsdp_tp`` step
(``train.step``), each rank holding its blocks of the parameters and of
the optimizer state and its rows of each batch.  The backend is NCCL when
every rank has a card of its own, gloo otherwise (ranks that share one
card, or the CPU).  ``--mesh auto`` (the default) is one process, or a
(cards, 1) mesh where more than one card is visible.  Rank 0 prints the
log lines and writes the checkpoints, which hold whole tensors (the same
files as a run on one device) and restore at any mesh; under a mesh a
checkpoint is written on the ``--ckpt-every`` schedule only.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --device cpu --mesh 2x2 --steps 8 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import time


def mesh_shape(mesh: str, device) -> tuple | None:
    """(data, model) of ``--mesh``, or None for one process."""
    import torch

    if mesh == "auto":
        n = torch.cuda.device_count() if device.type == "cuda" else 0
        return (n, 1) if n > 1 else None
    try:
        d, m = (int(v) for v in mesh.split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes 'auto' or 'DxM', got {mesh!r}")
    return (d, m)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (one device, or (cards, 1)) or 'DxM'")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import spawn

    dev = resolve_device(args.device)
    shape = mesh_shape(args.mesh, dev)
    if shape is None:
        return train(args, None)
    import torch

    import importlib

    world = shape[0] * shape[1]
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= world
    rank_fn = importlib.import_module(__name__.replace(
        "__main__", "repro_torch.launch.train"))._rank
    return spawn(rank_fn, world, backend="nccl" if nccl else "gloo",
                 device=None if nccl or dev.type != "cuda" else "cuda:0",
                 args=(args, shape, nccl), timeout_s=24 * 3600.0)[0]


def _rank(args, shape, nccl: bool):
    import torch
    import torch.distributed as dist

    if nccl:
        torch.cuda.set_device(dist.get_rank())
    return train(args, shape)


def train(args, shape):
    """The run, in one process (``shape`` None) or in each rank of a
    (data, model) mesh of that shape."""
    import torch

    from repro_torch.configs.registry import get_config, smoke
    from repro_torch.data.pipeline import DataConfig, PackedLMDataset, Prefetcher
    from repro_torch.device import resolve_device
    from repro_torch.ft.watchdog import StepWatchdog
    from repro_torch.dist import sharding
    from repro_torch.models import model
    from repro_torch.models.config import LOCAL
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import step as step_lib

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = resolve_device(args.device)
    if shape is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    # ---- mesh / sharding ----------------------------------------------------
    mesh, shard, rank0, shardings = None, LOCAL, True, None
    if shape is not None:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh(shape, ("data", "model"),
                         "cuda" if dist.get_backend() == "nccl" else "cpu")
        shard = sharding.make_shard_cfg(mesh, cfg, global_batch=args.batch)
        rank0 = dist.get_rank() == 0

    # ---- data -----------------------------------------------------------------
    data_cfg = DataConfig(seed=args.seed, vocab_size=cfg.vocab_size,
                          seq_len=args.seq, global_batch=args.batch)
    ds = PackedLMDataset(data_cfg, cfg)

    # ---- params / optimizer ---------------------------------------------------
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10 + 1, args.steps))
    lm = model.init_params(cfg, args.seed, device=dev)
    if mesh is not None:
        lm = sharding.shard_params(lm, cfg, shard)
        shardings = sharding.named({"params": lm.placement, "opt": AdamWState(
            step=(), m=lm.placement, v=lm.placement)}, mesh)
    opt_state = opt.init(lm)
    train_step = step_lib.make_train_step(cfg, shard, opt,
                                          grad_accum=args.grad_accum)
    say = print if rank0 else (lambda *a, **k: None)

    # ---- checkpointing / restart ----------------------------------------------
    ckpt = None
    start_step = 0
    params = dict(lm.named_parameters())
    if args.ckpt_dir:
        from repro_torch.ckpt.checkpointer import Checkpointer

        ckpt = Checkpointer(args.ckpt_dir)
        if rank0:
            ckpt.cleanup()
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, {"params": params, "opt": opt_state},
                                 shardings=shardings)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = state["opt"]
            start_step = latest
            say(f"[train] resumed from step {latest}", flush=True)

    wd = StepWatchdog()
    it = Prefetcher(ds.iterate(start_step), depth=2)
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        if mesh is not None:
            batch = sharding.local_batch(batch, mesh, shard,
                                         args.grad_accum)
        wd.start_step()
        lm, opt_state, metrics = train_step(lm, opt_state, batch)
        loss = float(metrics["loss"])
        events = wd.end_step(step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"[train] step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"lr {float(metrics['lr']):.2e}", flush=True)
        for e in events:
            say(f"[watchdog] {e.kind} at step {e.step}: "
                f"{e.step_time:.2f}s (thr {e.threshold:.2f}s)", flush=True)
        # under a mesh every rank must join a save: the schedule only
        if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                 or (wd.should_checkpoint and mesh is None)):
            ckpt.save_async(step + 1, {"params": params, "opt": opt_state},
                            shardings)
            wd.events = [e for e in wd.events
                         if e.kind != "checkpoint_requested"]
    it.close()
    if ckpt is not None:
        ckpt.wait()
    dt = time.time() - t_start
    say(f"[train] done: {args.steps - start_step} steps in {dt:.1f}s; "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
    return losses


if __name__ == "__main__":
    main()
