"""Serving launcher: batched requests through the continuous-batching
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --smoke --device cpu --requests 8 --slots 4 --max-new 16

Without ``--smoke`` the model runs at its published widths and depth.
``--device`` defaults to ``cuda``, where the engine runs the hand-written
kernels; on ``cpu`` it runs their plain versions.  ``--arch xlstm-125m``
serves the ``ssm`` family (its mLSTM prefills launch SSD_INTRA, its sLSTM
layers loop over the prompt's tokens in eager ops).  The published moe
configs do not fit one 80 GB card: ``--arch qwen3-moe-235b-a22b`` holds
94 layers, 470 GB of bf16 weights, and ``kimi-k2-1t-a32b`` 2.1 TB, so
without ``--smoke`` both stop with CUDA's out-of-memory error while the
weights are drawn.  ``chip_smoke.py`` serves them at their published widths
with the depth cut (``dataclasses.replace(cfg, num_layers=...)``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=160)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.registry import get_config, smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import model
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = resolve_device(args.device)
    params = model.init_params(cfg, args.seed, device=dev)
    eng = ServingEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                        device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        plen = int(rng.integers(4, 48))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int64)
        eng.submit(Request(rid, prompt, max_new_tokens=args.max_new))
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens, "
          f"{eng.steps} engine steps, {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s) on {dev} ({eng.template})",
          flush=True)
    for r in done[:3]:
        print(f"  req {r.rid}: {r.output[:8]}...", flush=True)
    return done


if __name__ == "__main__":
    main()
