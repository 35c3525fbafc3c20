#!/usr/bin/env python3
"""Design study of JACOBI_FUSED (``csrc/jacobi.cu``), SSD_INTRA
(``csrc/ssd.cu``) and the four stencils (``csrc/stencil3d.cu``) on one
NVIDIA card.

    python3 kernel_study.py [--parent DIR]
                            [--only jacobi,ssd,stencil,tiles,farm]

1. jacobi: the committed source and variants of it made by replacing one
   design constant, each built with nvcc beside the committed library:

   seg32, seg128        x segments of 32 or 128 output planes (design: 64);
   tile16x32, tile32x64 (y, z) output tiles of 16 x 32 or 32 x 64 cells
                        (design: 16 x 64);
   ahead2               2 planes of p and rhs in flight (design: 1);
   threads512           blocks of 512 threads (design: 256);
   mul_sixth            the division by 6 replaced by a product with
                        RN(1/6): not the plain version's arithmetic (its
                        output is not bitwise the design's), it prices the
                        true division.

   Each runs chip_smoke's two JACOBI_FUSED shapes at k = 2, the serial
   256^3 call (S = 1) and the fused farm's (S = 4); its output must equal
   the design's bit for bit (the arithmetic of a cell does not depend on
   the tiling).  Device times (CUDA events, the stream given a head start),
   the variants taken in turn forward and then backward.
2. ssd: heads per block fixed at 2, 4 and 8 (design: chosen per launch,
   ``ssd_cuda.heads_per_block``), tf32_once, one TF32 product in place
   of the 3xTF32 split, and tail_mmas, every warp's MMAs run over all its
   n-tiles (design: a warp skips the 8-column tiles past P, which only a
   column tile at P's end has).  Each runs the zamba2-1.2b and xlstm-125m
   prefill shapes of ``chip_smoke.SSD_CASES`` (512, 1024 and 2048 tokens):
   device time and the largest share of the SSD_RTOL check.  With
   ``--parent DIR``, also the zamba2 prefill shapes on DIR's tree and on
   this one in turns (parent, this, this, parent), each in its own process
   (``chip_smoke.SSD_CASES`` inputs, ``chip_smoke.cuda_ms`` of that tree).
3. stencil: the four stencil kernels as committed (every operation
   rounded as written, the (slot, x) row split by a 32-bit division) and
   ``contract``, the source as it was before both (plain operators that
   nvcc may contract into FMAs, a 64-bit row split), at chip_smoke's
   serial 256^3 call and the farm's 4-slot call: device time and whether
   the output equals the plain version bit for bit.  Also ``div_op``
   (``/`` in place of ``__fdiv_rn`` in JACOBI_PRESSURE: the same IEEE
   division) and ``div64`` (only the row split back to 64 bits).
4. tiles: the four stencils as committed under launch tiles ``(tx, ty,
   tz)`` (a block of tz x ty threads walking tx x planes): the wrapper's
   default ``block_for``, the (8, 32) block walking 2..32 planes, other
   block shapes, and the autotuner's choice for 1, 2, 4 and 8 waves
   (``autotune.choose_tile(waves=...)``), at chip_smoke's serial 256^3 call
   and the farm's 4-slot call: device time, taken in turn forward and then
   backward, and whether the output equals block_for's bit for bit.  The
   tiles that walk also run on ``walk_unroll2`` and ``walk_unroll4``, the
   source with the walk's loop unrolled by 2 or 4.
5. farm (with ``--parent DIR``, a checkout of another commit): the 256^3
   4-slot farm's batched step, unfused and with ``fused_sweeps=2``, on
   DIR's tree and on this one in turns (parent, this, this, parent), each
   in its own process (``chip_smoke.batched_step_ms`` of that tree).

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

# (source, variant, [(text in the source, its replacement), ...])
VARIANTS = [
    ("jacobi", "seg32", [("constexpr int kSeg = 64;", "constexpr int kSeg = 32;")]),
    ("jacobi", "seg128", [("constexpr int kSeg = 64;", "constexpr int kSeg = 128;")]),
    ("jacobi", "tile16x32", [("kTZ = 64;", "kTZ = 32;")]),
    ("jacobi", "tile32x64", [("constexpr int kTY = 16,", "constexpr int kTY = 32,")]),
    ("jacobi", "ahead2", [("constexpr int kAhead = 1;", "constexpr int kAhead = 2;")]),
    ("jacobi", "threads512", [("constexpr int kThreads = 256;",
                               "constexpr int kThreads = 512;")]),
    ("jacobi", "mul_sixth", [("__fdiv_rn(num, 6.0f)",
                              "__fmul_rn(num, 1.0f / 6.0f)")]),
    ("ssd", "heads2", [("constexpr int kHeads = 0;", "constexpr int kHeads = 2;")]),
    ("ssd", "heads4", [("constexpr int kHeads = 0;", "constexpr int kHeads = 4;")]),
    ("ssd", "heads8", [("constexpr int kHeads = 0;", "constexpr int kHeads = 8;")]),
    ("ssd", "tf32_once", [("constexpr bool kSplit = true;",
                           "constexpr bool kSplit = false;")]),
    ("ssd", "tail_mmas", [
        ("if (j < jn) mma(acc[j], al, bh[j][0], bh[j][1]);",
         "mma(acc[j], al, bh[j][0], bh[j][1]);"),
        ("if (j < jn) mma(acc[j], ah, bl[j][0], bl[j][1]);",
         "mma(acc[j], ah, bl[j][0], bl[j][1]);"),
        ("if (j < jn) mma(acc[j], ah, bh[j][0], bh[j][1]);",
         "mma(acc[j], ah, bh[j][0], bh[j][1]);")]),
    ("stencil3d", "contract", [
        ("""  const unsigned q = (unsigned)r / (unsigned)nx;
  s = q;
  i = r - (int64_t)q * nx;""", """  s = r / nx;
  i = r - s * nx;"""),
        ("{ return __fadd_rn(a, b); }", "{ return a + b; }"),
        ("{ return __fsub_rn(a, b); }", "{ return a - b; }"),
        ("{ return __fmul_rn(a, b); }", "{ return a * b; }"),
        ("__fdiv_rn(sub(nbr, mul(h2, rhs[o])), 6.0f)",
         "sub(nbr, mul(h2, rhs[o])) / 6.0f"),
        ("__fdiv_rn(table[s * 2], table[s * 2 + 1])",
         "table[s * 2] / table[s * 2 + 1]")]),
    ("stencil3d", "div_op", [
        ("__fdiv_rn(sub(nbr, mul(h2, rhs[o])), 6.0f)",
         "sub(nbr, mul(h2, rhs[o])) / 6.0f")]),
    ("stencil3d", "walk_unroll2", [
        ("""    for (int64_t r = r##0,  """,
         """    _Pragma("unroll 2") for (int64_t r = r##0,  """)]),
    ("stencil3d", "walk_unroll4", [
        ("""    for (int64_t r = r##0,  """,
         """    _Pragma("unroll 4") for (int64_t r = r##0,  """)]),
    ("stencil3d", "div64", [
        ("""  const unsigned q = (unsigned)r / (unsigned)nx;
  s = q;
  i = r - (int64_t)q * nx;""", """  s = r / nx;
  i = r - s * nx;""")]),
]
SECTIONS = ("jacobi", "ssd", "stencil", "tiles", "farm")
# launch tiles (tx, ty, tz) of the tiles section, block_for's first
TILES = [(1, 8, 32), (2, 8, 32), (4, 8, 32), (8, 8, 32), (16, 8, 32),
         (32, 8, 32), (1, 4, 64), (4, 4, 64), (1, 2, 128), (1, 1, 256)]
TILE_WAVES = (1, 2, 4, 8)
REPS = 30

# one tree's batched farm step, unfused and fused, twice each
FARM = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
dev = torch.device("cuda")
out = {name: [cs.batched_step_ms(dev, **kw) for _ in range(2)]
       for name, kw in (("farm", {}), ("farm_fused", {"fused_sweeps": cs.FUSED_K}))}
print(json.dumps(out))
'''

# one tree's SSD_INTRA at the zamba2 prefill shapes (its wrapper, its
# build), the stream given a head start
SSD_TREE = r'''
import json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/src")
import chip_smoke as cs
from repro_torch.kernels import ssd_cuda as sc
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(cs.SEED)
out = {}
for case, (bsz, nc, l, g, r, p, n) in (("prefill_512", (1, 4, 128, 1, 64, 64, 64)),
                                       ("prefill", (1, 8, 128, 1, 64, 64, 64)),
                                       ("prefill_2048", (1, 16, 128, 1, 64, 64, 64))):
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    args = (rnd(bsz, nc, l, g, r, p), -F.softplus(rnd(bsz, nc, l, g, r)),
            F.softplus(rnd(bsz, nc, l, g, r)), rnd(bsz, nc, l, g, n),
            rnd(bsz, nc, l, g, n), rnd(bsz, nc, g, r, n, p) * 0.3)
    out[case] = [cs.cuda_ms(lambda: sc.ssd_intra(*args), 30, head_start=True)
                 for _ in range(3)]
print(json.dumps(out))
'''


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_variants(sources):
    """The committed libraries and one library a variant of ``sources``,
    built at once; returns {source: {variant: the wrapper's ctypes
    library}}."""
    from repro_torch.kernels import _build, jacobi_cuda as jc, ssd_cuda as sc
    from repro_torch.kernels import stencil3d_cuda

    out_dir = _build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, name, edits in VARIANTS:
        if source not in sources:
            continue
        text = _build.SOURCES[source].read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs.append((source, name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    wrappers = {"jacobi": jc, "ssd": sc, "stencil3d": stencil3d_cuda}
    libs = {source: {"design": w._lib()} for source, w in wrappers.items()
            if source in sources}
    load, segment = _build.load, jc.SEGMENT
    try:
        for source, name, so, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{log}")
            emit({"phase": "build", "variant": name,
                  "ptxas": [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln]})
            _build.load = lambda _name, so=so: ctypes.CDLL(str(so))
            if name.startswith("seg"):     # the wrapper checks the segment
                jc.SEGMENT = int(name[3:])
            libs[source][name] = wrappers[source]._lib.__wrapped__()
            jc.SEGMENT = segment
    finally:
        _build.load, jc.SEGMENT = load, segment
    return libs


def turns(names):
    return list(names) + list(names)[::-1]


def study_jacobi(libs):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import jacobi_cuda as jc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    k, h = cs.FUSED_K, 1.0 / cs.N
    cases = {}
    for case, lead in (("main", ()), ("farm", (cs.FARM_SLOTS,))):
        shape = lead + (cs.N + 2 * k,) * 3
        cases[case] = tuple(torch.rand(shape, generator=gen, device=dev) * 2 - 1
                            for _ in range(2))
    lib = jc._lib
    try:
        want = {}
        for name in turns(libs):
            jc._lib = lambda name=name: libs[name]
            line = {"phase": "jacobi", "variant": name,
                    "blocks_per_sm": jc.blocks_per_sm(k)}
            for case, (p, rhs) in cases.items():
                fn = lambda: jc.jacobi_fused(p, rhs, h=h, omega=1.0, sweeps=k)
                got = fn()
                torch.cuda.synchronize()
                want.setdefault(case, got)
                line[case] = {"kernel_ms": cs.cuda_ms(fn, REPS, head_start=True),
                              "bitwise_vs_design": bool(torch.equal(got, want[case]))}
                del got
            emit(line)
    finally:
        jc._lib = lib


def study_ssd(libs):
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import ssd_cuda as sc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    cases = {}
    for case, (bsz, nc, l, g, r, p, n) in cs.SSD_CASES:
        if not case.startswith("prefill"):
            continue
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
        args = (rnd(bsz, nc, l, g, r, p), -F.softplus(rnd(bsz, nc, l, g, r)),
                F.softplus(rnd(bsz, nc, l, g, r)), rnd(bsz, nc, l, g, n),
                rnd(bsz, nc, l, g, n), rnd(bsz, nc, g, r, n, p) * 0.3)
        cases[case] = (args, sc.ssd_intra_plain(*args))
    lib = sc._lib
    try:
        for name in turns(libs):
            sc._lib = lambda name=name: libs[name]
            line = {"phase": "ssd", "variant": name}
            for case, (args, want) in cases.items():
                fn = lambda: sc.ssd_intra(*args)
                got = fn()
                torch.cuda.synchronize()
                tol = cs.SSD_RTOL * max(1.0, float(want.abs().max()))
                line[case] = {"kernel_ms": cs.cuda_ms(fn, REPS, head_start=True),
                              "heads_per_block": sc.heads_per_block(args[0]),
                              "share_of_tolerance":
                                  float((got - want).abs().max()) / tol}
            emit(line)
    finally:
        sc._lib = lib


def study_stencil(libs):
    import torch
    import chip_smoke as cs
    from repro_torch.cfd import cavity
    from repro_torch.kernels import stencil3d_cuda as st

    dev = torch.device("cuda")
    lib = st._lib
    try:
        for kname in cs.STENCILS:
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            cases = {}
            for case, slots in (("main", None), ("farm", cs.FARM_SLOTS)):
                cfgs = [cavity.config(cs.N, nz=cs.N, re=re)
                        for re in cs.FARM_RES[:slots or 1]]
                inputs = cs.kernel_inputs(kname, slots, (cs.N,) * 3, gen, dev)
                table = cs.param_rows(kname, cfgs, dev)
                table = table if slots else table[0]
                want = st.PLAIN[kname](*inputs, table)
                cases[case] = (inputs, table,
                               want if isinstance(want, tuple) else (want,))
            for name in turns(libs):
                st._lib = lambda name=name: libs[name]
                line = {"phase": "stencil", "kernel": kname, "variant": name}
                for case, (inputs, table, want) in cases.items():
                    fn = lambda: st.KERNELS[kname](*inputs, table)
                    got = fn()
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    line[case] = {
                        "kernel_ms": cs.cuda_ms(fn, REPS, head_start=True),
                        "bitwise_vs_plain": all(torch.equal(g, w)
                                                for g, w in zip(got, want))}
                    del got
                emit(line)
            del cases
            torch.cuda.empty_cache()
    finally:
        st._lib = lib


def study_tiles(libs):
    import torch
    import chip_smoke as cs
    from repro_torch.cfd import cavity
    from repro_torch.core import autotune
    from repro_torch.kernels import stencil3d, stencil3d_cuda as st

    dev = torch.device("cuda")
    lib = st._lib
    walks = [name for name in libs if name.startswith("walk_")]
    try:
        for kname in cs.STENCILS:
            desc = stencil3d.DESCRIPTORS[kname]
            tuned = {w: autotune.choose_tile(desc, (cs.N,) * 3, waves=w).tile
                     for w in TILE_WAVES}
            tiles = list(dict.fromkeys(TILES + list(tuned.values())))
            runs = [("design", t) for t in tiles] + [
                (v, t) for v in walks for t in tiles if t[0] > 1]
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            times = {r: {} for r in runs}
            same = {r: {} for r in runs}
            for case, slots in (("main", None), ("farm", cs.FARM_SLOTS)):
                cfgs = [cavity.config(cs.N, nz=cs.N, re=re)
                        for re in cs.FARM_RES[:slots or 1]]
                inputs = cs.kernel_inputs(kname, slots, (cs.N,) * 3, gen, dev)
                table = cs.param_rows(kname, cfgs, dev)
                table = table if slots else table[0]
                st._lib = lambda: libs["design"]
                want = st.KERNELS[kname](*inputs, table)
                want = want if isinstance(want, tuple) else (want,)
                for run in turns(runs):
                    variant, tile = run
                    st._lib = lambda variant=variant: libs[variant]
                    fn = lambda: st.KERNELS[kname](*inputs, table, tile=tile)
                    got = fn()
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    same[run][case] = all(torch.equal(g, w)
                                          for g, w in zip(got, want))
                    times[run].setdefault(case, []).append(
                        cs.cuda_ms(fn, REPS, head_start=True))
                    del got
                del inputs, want
                torch.cuda.empty_cache()
            for variant, tile in runs:
                emit({"phase": "tiles", "kernel": kname, "variant": variant,
                      "tile": list(tile),
                      "tuned_for_waves": [w for w, t in tuned.items()
                                          if t == tile],
                      "kernel_ms": times[(variant, tile)],
                      "bitwise_vs_block_for": same[(variant, tile)]})
    finally:
        st._lib = lib


def study_ssd_parent(parent: str):
    for name in ("parent", "this", "this", "parent"):
        tree = parent if name == "parent" else ROOT
        out = subprocess.run([sys.executable, "-c", SSD_TREE, tree],
                             capture_output=True, text=True, timeout=900,
                             cwd=tree)
        if out.returncode:
            raise SystemExit(f"SSD_INTRA on {tree} failed:\n{out.stderr}")
        emit({"phase": "ssd_parent", "tree": name, "root": tree,
              "kernel_ms": json.loads(out.stdout.strip().splitlines()[-1])})


def study_farm(parent: str):
    for name in ("parent", "this", "this", "parent"):
        tree = parent if name == "parent" else ROOT
        out = subprocess.run([sys.executable, "-c", FARM, tree],
                             capture_output=True, text=True, timeout=900,
                             cwd=tree)
        if out.returncode:
            raise SystemExit(f"farm step on {tree} failed:\n{out.stderr}")
        emit({"phase": "farm", "tree": name, "root": tree,
              "batched_step_ms": json.loads(out.stdout.strip().splitlines()[-1])})


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit, for the "
                                     "farm-step and SSD_INTRA comparisons")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections to run "
                         f"(default: {','.join(SECTIONS)})")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if only - set(SECTIONS):
        ap.error(f"unknown sections {sorted(only - set(SECTIONS))}")
    if not torch.cuda.is_available():
        print("kernel_study: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip(), flush=True)
    sources = {"jacobi": "jacobi", "ssd": "ssd", "stencil": "stencil3d",
               "tiles": "stencil3d"}
    libs = build_variants({sources[s] for s in only if s in sources})
    if "jacobi" in only:
        study_jacobi(libs["jacobi"])
    if "ssd" in only:
        study_ssd(libs["ssd"])
    if args.parent and "ssd" in only:
        study_ssd_parent(os.path.abspath(args.parent))
    if "stencil" in only:
        study_stencil({k: v for k, v in libs["stencil3d"].items()
                       if not k.startswith("walk_")})
    if "tiles" in only:
        study_tiles({k: v for k, v in libs["stencil3d"].items()
                     if k == "design" or k.startswith("walk_")})
    if args.parent and "farm" in only:
        study_farm(os.path.abspath(args.parent))
    return 0


if __name__ == "__main__":
    sys.exit(main())
