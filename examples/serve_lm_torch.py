"""Batched serving with continuous batching on the PyTorch port: the run
of ``examples/serve_lm.py`` through ``repro_torch.launch.serve`` —
requests stream through a fixed-slot engine (prefill on admission,
per-slot decode positions, slot reuse on completion).

The default is zamba2-1.2b at its published widths and depth, on the card
(``--device cuda``), where its prefills launch the hand-written
FLASH_ATTENTION and SSD_INTRA kernels and its decode steps
FLASH_ATTENTION; ``--smoke`` takes the arch's smoke config and ``cpu``
runs the plain versions.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch llama3-8b]
      [--smoke] [--requests 8] [--device cpu]
"""
import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config, not its published widths")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch import serve

    serve.main(["--arch", args.arch, *(["--smoke"] if args.smoke else []),
                "--requests", str(args.requests),
                "--slots", "4", "--max-new", "12", "--device", args.device])
    return 0


if __name__ == "__main__":
    sys.exit(main())
