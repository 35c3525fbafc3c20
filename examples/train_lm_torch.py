"""End-to-end LM training on the PyTorch port: the run of
``examples/train_lm.py`` (a smoke-sized llama-family model trained for a
few hundred steps on the deterministic synthetic corpus, with async
checkpointing, watchdog and restart-resume) through
``repro_torch.launch.train``.

On the card (``--device cuda``, the default) the step runs the
hand-written kernels; on ``--device cpu`` their plain versions.  The loss
should drop by more than 0.5 nats over 200 steps.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
      [--steps 200] [--ckpt-dir DIR]
"""
import argparse
import sys
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and checkpoint to DIR (default: a "
                         "fresh temporary directory)")
    args = ap.parse_args(argv)

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as tmp:
        losses = train.main([
            "--arch", "llama3-8b", "--smoke", "--device", args.device,
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "256",
            "--lr", "3e-3", "--ckpt-dir", args.ckpt_dir or tmp,
            "--ckpt-every", "100", "--log-every", "20",
        ])
    drop = losses[0] - losses[-1]
    print(f"loss drop over {args.steps} steps: {drop:.3f} nats")
    if drop < 0.5:
        print("WARNING: expected >0.5 nats of improvement")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
