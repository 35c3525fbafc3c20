"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 256

The port's copy of ``repro.launch.train``, with its flags and log lines:
config registry -> data pipeline -> model and optimizer -> train step ->
watchdog -> async checkpointing -> restart-resume.  ``--smoke`` shrinks the
arch to its CPU-runnable config; without it the model runs at its
published widths.  ``--device`` defaults to ``cuda``, where the step runs
the hand-written kernels; on ``cpu`` it runs their plain versions.
``--mesh DxM`` (a device mesh) is ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
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
                    help="'auto' (one device); 'DxM' is not ported")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config, smoke
    from repro_torch.data.pipeline import DataConfig, PackedLMDataset, Prefetcher
    from repro_torch.device import resolve_device
    from repro_torch.ft.watchdog import StepWatchdog
    from repro_torch.models import model
    from repro_torch.models.config import LOCAL, not_ported
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import step as step_lib

    if args.mesh != "auto":
        raise not_ported(f"--mesh {args.mesh}", 9)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = resolve_device(args.device)

    # ---- data -----------------------------------------------------------------
    data_cfg = DataConfig(seed=args.seed, vocab_size=cfg.vocab_size,
                          seq_len=args.seq, global_batch=args.batch)
    ds = PackedLMDataset(data_cfg, cfg)

    # ---- params / optimizer ---------------------------------------------------
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10 + 1, args.steps))
    lm = model.init_params(cfg, args.seed, device=dev)
    opt_state = opt.init(lm)
    train_step = step_lib.make_train_step(cfg, LOCAL, opt,
                                          grad_accum=args.grad_accum)

    # ---- checkpointing / restart ----------------------------------------------
    ckpt = None
    start_step = 0
    params = dict(lm.named_parameters())
    if args.ckpt_dir:
        from repro_torch.ckpt.checkpointer import Checkpointer

        ckpt = Checkpointer(args.ckpt_dir)
        ckpt.cleanup()
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, {"params": params, "opt": opt_state})
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = state["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    wd = StepWatchdog()
    it = Prefetcher(ds.iterate(start_step), depth=2)
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        wd.start_step()
        lm, opt_state, metrics = train_step(lm, opt_state, batch)
        loss = float(metrics["loss"])
        events = wd.end_step(step)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        for e in events:
            print(f"[watchdog] {e.kind} at step {e.step}: "
                  f"{e.step_time:.2f}s (thr {e.threshold:.2f}s)", flush=True)
        if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                 or wd.should_checkpoint):
            ckpt.save_async(step + 1, {"params": params, "opt": opt_state})
            wd.events = [e for e in wd.events
                         if e.kind != "checkpoint_requested"]
    it.close()
    if ckpt is not None:
        ckpt.wait()
    dt = time.time() - t_start
    print(f"[train] done: {args.steps - start_step} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
    return losses


if __name__ == "__main__":
    main()
