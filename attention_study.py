#!/usr/bin/env python3
"""Design study of FLASH_ATTENTION (``csrc/attention.cu``) on one NVIDIA card.

    python3 attention_study.py [--parent DIR]

1. variants: the committed source and variants of it made by replacing one
   design choice, each built with nvcc beside the committed library:

   p_bf16_once        P rounded once to bf16 for P.V (FlashAttention-2),
                      in place of the bf16 hi + lo split;
   decode_no_cap      the split-K decode without its blocks-per-SM launch
                      bounds;
   decode_split_256   256-key decode splits for every block, also those
                      serving 4 or more rows (GQA);
   prefill_d256_64_keys  64-key K/V tiles for the tensor-core prefill at
                      head dim 256 too, in place of 32.

   Each library's ptxas report (registers, spills) of its head-dim-256
   instantiations is printed.

   Each variant runs the tensor-core and split-K cases of
   ``chip_smoke.ATTN_CASES`` and ``MM_ATTN_CASES`` against the plain
   version (the largest share of the per-row tolerance, as chip_smoke
   holds it) and is timed on the device (CUDA events, the stream given a
   head start), the variants taken in turn forward and then backward.  p_bf16_once also runs chip_smoke's
   lm parity (zamba2-1.2b, cuda vs torch logits).
2. decode step (with ``--parent DIR``, a checkout of another commit): a
   zamba2-1.2b decode step with four slots resident, profiled on DIR's
   ``src`` and on this tree in turns (parent, this, this, parent), each in
   its own process: device time, FLASH_ATTENTION's share of it, wall time.

Prints JSON lines; the card's name and power limit first.  Needs a CUDA
card and the repository around it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (name, [(text in csrc/attention.cu, its replacement), ...])
VARIANTS = [
    ("p_bf16_once", [("        mma_bf16(o[i], pl, vf[0], vf[1]);\n", ""),
                     ("        mma_bf16(o[i + 1], pl, vf[2], vf[3]);\n", "")]),
    ("decode_no_cap", [("__launch_bounds__(kThreads,\n"
                        "                                  RB == 1 && D <= 64"
                        "        ? 3\n"
                        "                                  : RB <= 4 && D <= "
                        "128 ? 2\n"
                        "                                                    "
                        "    : 1)",
                        "__launch_bounds__(kThreads)")]),
    ("decode_split_256", [("return RB >= 4 ? 128 : 256;", "return 256;")]),
    ("prefill_d256_64_keys", [("return D > 128 ? 32 : 64;", "return 64;")]),
]
REPS = 30

# a zamba2-1.2b decode step with four slots resident, profiled three times
STEP = r'''
import json, time, numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.configs.registry import get_config
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServingEngine
cfg, dev = get_config("zamba2-1.2b"), torch.device("cuda")
lm = model.init_params(cfg, 0, device=dev)
eng = ServingEngine(cfg, lm, slots=4, max_seq=4096, device=dev, backend="cuda")
rng = np.random.default_rng(0)
for i, n in enumerate(rng.integers(256, 2001, size=4)):
    eng.submit(Request(i, rng.integers(0, cfg.vocab_size, size=int(n)),
                       max_new_tokens=1000))
for _ in range(6):
    eng.step()
torch.cuda.synchronize()
runs = []
for _ in range(3):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    attn = [e for e in ev if any(k in e.key for k in
            ("prefill_kernel", "decode_kernel", "flash_kernel"))]
    runs.append({"wall_ms": wall,
                 "device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
                 "flash_attention_ms":
                     sum(e.self_device_time_total for e in attn) / 1e3,
                 "flash_attention_launches": sum(e.count for e in attn)})
print(json.dumps(runs))
'''


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def d256_ptxas(log: str) -> dict:
    """Each head-dim-256 kernel's ptxas lines (spills, registers) in a
    build log, by the kernel's mangled name from its template on."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name[name.find("kernelI"):] if "Li256E" in name else None
        elif entry and ("spill" in line or "registers" in line):
            out.setdefault(entry, []).append(line.strip())
    return out


def build_variants():
    """The committed library and one library a variant, built at once."""
    from repro_torch.kernels import _build, attention_cuda as ac

    src = _build.SOURCES["attention"].read_text()
    out_dir = _build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS:
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {"design": ac._lib()}
    emit({"phase": "ptxas", "variant": "design",
          "d256": d256_ptxas(_build.build_info["attention"]["log"])})
    load = _build.load
    try:
        for name, (proc, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{log}")
            emit({"phase": "ptxas", "variant": name, "d256": d256_ptxas(log)})
            _build.load = lambda _name, so=so: ctypes.CDLL(str(so))
            libs[name] = ac._lib.__wrapped__()   # the wrapper's argtypes
    finally:
        _build.load = load
    return libs


def study_variants(libs):
    import torch
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import attention_cuda as ac
    from repro_torch.models import model
    from repro_torch.models.attention import MaskSpec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = {}
    for (case, b, sq, sk, h, kh, d, qdt, kvdt, (causal, off, pre),
         valid) in cs.ATTN_CASES + cs.MM_ATTN_CASES:   # chip_smoke's inputs
        qdt_, kvdt_ = getattr(torch, qdt), getattr(torch, kvdt)
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(qdt_)
        k, v = (torch.randn(b, sk, kh, d, generator=gen, device=dev)
                .to(kvdt_) for _ in range(2))
        vt = None if valid is None else torch.tensor(valid, device=dev)
        spec = MaskSpec(causal=causal, q_offset=off, prefix_len=pre)
        if ac.route(qdt_, kvdt_, sq) != "cuda_core":
            cases[case] = (q, k, v, spec, vt, qdt,
                           ac.flash_attention_plain(q, k, v, spec, vt))
    lib = ac._lib
    try:
        order = list(libs) + list(libs)[::-1]
        for name in order:
            ac._lib = lambda name=name: libs[name]
            line = {"phase": "variant", "variant": name}
            for case, (q, k, v, spec, vt, qdt, want) in cases.items():
                fn = lambda: ac.flash_attention(q, k, v, spec, vt)
                got = fn()
                torch.cuda.synchronize()
                _, share = cs.attention_diff(got, want, qdt)
                line[case] = {"share_of_row_tolerance": share,
                              "kernel_ms": cs.cuda_ms(fn, REPS,
                                                      head_start=True)}
            emit(line)
        cfg = get_config(cs.LM_ARCH)
        lm = model.init_params(cfg, cs.SEED, device=dev)
        for name in ("design", "p_bf16_once"):
            ac._lib = lambda name=name: libs[name]
            rows = cs.lm_parity(cfg, lm, dev)
            emit({"phase": "lm_parity", "variant": name, "rows": [
                {k: r[k] for k in ("max_abs_diff", "tolerance", "rel_l2",
                                   "argmax_equal")} for r in rows]})
    finally:
        ac._lib = lib


def study_decode_step(parent: str):
    for name in ("parent", "this", "this", "parent"):
        src = os.path.join(parent if name == "parent" else ROOT, "src")
        out = subprocess.run([sys.executable, "-c", STEP], capture_output=True,
                             text=True, timeout=900,
                             env=dict(os.environ, PYTHONPATH=src))
        if out.returncode:
            raise SystemExit(f"decode step on {src} failed:\n{out.stderr}")
        emit({"phase": "decode_step", "tree": name, "src": src,
              "runs": json.loads(out.stdout.strip().splitlines()[-1])})


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit, for the "
                                     "decode-step comparison")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_study: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip(), flush=True)
    study_variants(build_variants())
    if args.parent:
        study_decode_step(os.path.abspath(args.parent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
