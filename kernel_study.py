#!/usr/bin/env python3
"""Design study of JACOBI_FUSED (``csrc/jacobi.cu``), SSD_INTRA
(``csrc/ssd.cu``) and the four stencils (``csrc/stencil3d.cu``) on one
NVIDIA card.

    python3 kernel_study.py [--parent DIR] [--tree NAME=DIR ...]
                            [--only jacobi,ssd,stencil,tiles,farm,routes,
                                    pressure]
                            [--kernels JACOBI_PRESSURE,UPDATE_VELOCITY]

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
   source with the walk's loop unrolled by 2 or 4.  The GHOSTED kernels,
   JACOBI_PRESSURE and UPDATE_VELOCITY, run in their ghosted load too
   (the main path's: unpadded fields with the cavity's faces,
   ``chip_smoke.ghosted_inputs``), as variant ``ghosted:<library>``: the
   committed source at every tile, and at block_for's and the tuned tiles
   ``ghost_jacobi4``, ``ghost_jacobi2``, ``ghost_update6`` and
   ``ghost_unbounded``, the ghosted instantiations' launch bounds at 4 and
   2 blocks an SM for JACOBI_PRESSURE (design: 3), 6 for UPDATE_VELOCITY
   (design: 4), and 1 for both.  (JACOBI_PRESSURE's ghosted load sets its
   own launch: every tile runs the same grid there.)
5. farm (with ``--parent DIR``, a checkout of another commit): the 256^3
   4-slot farm's batched step, unfused and with ``fused_sweeps=2``, on
   DIR's tree and on this one in turns (parent, this, this, parent), each
   in its own process (``chip_smoke.batched_step_ms`` of that tree).
6. routes (with ``--tree NAME=DIR``, checkouts of other commits; the
   ``--parent`` checkout is tree ``parent``): each tree's JACOBI_PRESSURE
   and UPDATE_VELOCITY at the 256^3 serial call, the farm's 4 slots and a
   decomposed rank's (128, 256, 256) block, and the cavity's steps, each
   tree in its own process, in turns (the others, this, this, the others
   backward).  Per kernel and call: ``pad_ms``, the cached fields padded
   (``exchange_pad`` by the cavity's specs); ``padded_ms``, the padded
   load on the padded fields; ``route_ms``, the two in turn (the main
   path's route before the ghosted load); and, in a tree that has it,
   ``ghosted_ms``, the ghosted load on the unpadded fields with the
   cavity's faces (the block's x faces random strips); each at the tile
   the tree's autotuner gives its main path.  Per tree: the serial 256^3
   step (host clock, and its device split from the profiler), the farm's
   4-slot batched step and the step of each of two ranks that split x
   (gloo, the card shared), and the stencil build's ptxas register lines.
7. pressure (``--parent DIR`` optional): JACOBI_PRESSURE's ghosted load at
   the benchmark's shapes, one 512^3 run and 8 slots of 256^3, and a
   decomposed rank's (128, 256, 256) block (both x faces received strips),
   with the cavity's faces: this tree's kernel and its ``PRESSURE_VARIANTS``
   (the march's launch bounds at 4 and 2 blocks an SM, 8 and 32 waves in
   place of 16, streaming stores), DIR's kernel and ``PARENT_VARIANTS``
   (its face cells' reads left out), each bitwise against the plain
   version; both trees' padded loads on the same cells padded; and two
   streaming probes that move the same three fields with no stencil
   (scalar and float4 reads), the bandwidth a launch can reach.  In turns
   forward and backward, beside the bound; the ptxas lines of each build.

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
    ("stencil3d", "ghost_jacobi4", [
        ("constexpr int kJacobiGhostBlocks = 3;",
         "constexpr int kJacobiGhostBlocks = 4;")]),
    ("stencil3d", "ghost_jacobi2", [
        ("constexpr int kJacobiGhostBlocks = 3;",
         "constexpr int kJacobiGhostBlocks = 2;")]),
    ("stencil3d", "ghost_update6", [
        ("constexpr int kUpdateGhostBlocks = 4;",
         "constexpr int kUpdateGhostBlocks = 6;")]),
    ("stencil3d", "ghost_unbounded", [
        ("constexpr int kJacobiGhostBlocks = 3;",
         "constexpr int kJacobiGhostBlocks = 1;"),
        ("constexpr int kUpdateGhostBlocks = 4;",
         "constexpr int kUpdateGhostBlocks = 1;")]),
    ("stencil3d", "march_waves8", [
        ("constexpr int kMarchWaves = 16;", "constexpr int kMarchWaves = 8;")]),
    ("stencil3d", "march_waves32", [
        ("constexpr int kMarchWaves = 16;", "constexpr int kMarchWaves = 32;")]),
    ("stencil3d", "march_stcs", [
        ("*reinterpret_cast<float4*>(oc) = make_float4(o[0], o[1], o[2], o[3]);",
         "__stcs(reinterpret_cast<float4*>(oc), "
         "make_float4(o[0], o[1], o[2], o[3]));")]),
    ("stencil3d", "div64", [
        ("""  const unsigned q = (unsigned)r / (unsigned)nx;
  s = q;
  i = r - (int64_t)q * nx;""", """  s = r / nx;
  i = r - s * nx;""")]),
]
# the pressure section's variants of the --parent checkout's stencil3d.cu
PARENT_VARIANTS = [
    # its ghosted JACOBI_PRESSURE with the face cells' Ghosted reads left
    # out (face cells not written): what carrying that branch costs
    ("parent_noghost", [
        ("""      body(Cells{p, at.c, at.xm, at.xp, at.ym, at.yp, at.zm, at.zp});
    } else if constexpr (kGhost) {
      body(Ghosted{p, g.f[0], pack_kinds(g.f[0]), btab + s * kFaces, s,
                   (int)i, (int)j, (int)k, (int)nx, (int)ny, (int)nz});
    }""", """      body(Cells{p, at.c, at.xm, at.xp, at.ym, at.yp, at.zm, at.zp});
    }""")]),
]
SECTIONS = ("jacobi", "ssd", "stencil", "tiles", "farm", "routes", "pressure")
# launch tiles (tx, ty, tz) of the tiles section, block_for's first
TILES = [(1, 8, 32), (2, 8, 32), (4, 8, 32), (8, 8, 32), (16, 8, 32),
         (32, 8, 32), (64, 8, 32), (1, 4, 64), (4, 4, 64), (16, 4, 64),
         (1, 2, 128), (1, 1, 256), (16, 16, 16), (32, 16, 16)]
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


# one tree's routes and steps (section 6), run as a file: its ranks
# (spawn start method) import it by path
ROUTES = r'''
import json, os, sys, time


def rank_step(reps):
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", torch.cuda.current_device())
    pr = cs._decomposed_runtime(dev, (2,), ("shard",)).prepare("cavity",
                                                              re=100.0)
    state = pr.state
    for _ in range(2):
        state = pr.step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = pr.step(state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main(root):
    import torch
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.cfd import cavity
    from repro_torch.core import autotune, halo
    from repro_torch.core.halo import exchange_pad
    from repro_torch.kernels import _build, stencil3d, stencil3d_cuda as sc
    from repro_torch.launch.mesh import spawn

    dev = torch.device("cuda")
    sc._lib()
    log = _build.build_info.get("stencil3d", {}).get("log") or ""
    out = {"ptxas": [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "Compiling entry" in ln]}
    ghosted = hasattr(cs, "ghosted_inputs")
    pr = api.runtime(n=cs.N, nz=cs.N, backend="cuda",
                     device=dev).prepare("cavity", re=100.0)
    specs = {f: pr.solver._specs(f) for f in ("vx", "vy", "vz", "p")}
    link = halo.AxisLink(name="shard", size=3, index=1,
                         transport=halo.CountTransport()) if ghosted else None
    kernels = {}
    for name in ("JACOBI_PRESSURE", "UPDATE_VELOCITY"):
        desc = stencil3d.DESCRIPTORS[name]
        fields = ("p",) if name == "JACOBI_PRESSURE" else ("vx", "vy", "vz")
        cached = [i for i, v in enumerate(desc.inputs)
                  if v in desc.cached_inputs]
        kern = sc.KERNELS[name]
        for case, S, interior in (("serial", None, (cs.N,) * 3),
                                  ("farm", cs.FARM_SLOTS, (cs.N,) * 3),
                                  ("block", None, (cs.N // 2, cs.N, cs.N))):
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            cfgs = [cavity.config(cs.N, nz=cs.N, re=re)
                    for re in cs.FARM_RES[:S or 1]]
            table = cs.param_rows(name, cfgs, dev)
            table = table if S else table[0]
            batch = () if S is None else (S,)
            inputs = [torch.rand(batch + interior, generator=gen,
                                 device=dev) * 2 - 1 for _ in desc.inputs]
            tile = autotune.tile_for(desc, interior).tile

            def pad():
                ins = list(inputs)
                for i, f in zip(cached, fields):
                    ins[i] = exchange_pad(ins[i], (1, 1, 1), specs[f])
                return ins

            padded = pad()
            row = {"tile": list(tile),
                   "pad_ms": cs.cuda_ms(pad, 20, head_start=True),
                   "padded_ms": cs.cuda_ms(
                       lambda: kern(*padded, table, tile=tile), 30,
                       head_start=True),
                   "route_ms": cs.cuda_ms(
                       lambda: kern(*pad(), table, tile=tile), 20,
                       head_start=True)}
            del padded
            if ghosted:
                unpadded, ghosts = cs.ghosted_inputs(
                    name, S, interior, gen, dev,
                    link if case == "block" else None)
                row["ghosted_ms"] = cs.cuda_ms(
                    lambda: kern(*unpadded, table, tile=tile, ghosts=ghosts),
                    30, head_start=True)
                del unpadded, ghosts
            kernels[f"{name}/{case}"] = row
            del inputs
            torch.cuda.empty_cache()
    out["kernels"] = kernels
    state = pr.state
    for _ in range(2):
        state = pr.step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state = pr.step(state)
    torch.cuda.synchronize()
    out["serial_step_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    out["serial_split_ms"] = cs.profile_step(pr, state)
    del pr, state
    torch.cuda.empty_cache()
    out["farm_step_ms"] = cs.batched_step_ms(dev)
    torch.cuda.empty_cache()
    out["decomposed_step_ms"] = spawn(rank_step, 2, backend="gloo",
                                      device="cuda:0", args=(5,),
                                      timeout_s=300.0)
    print(json.dumps(out))


if __name__ == "__main__":
    root = os.path.abspath(sys.argv[1])
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    main(root)
'''


# this tree's variants the pressure section times (names of VARIANTS)
PRESSURE_VARIANTS = ("ghost_jacobi4", "ghost_jacobi2", "march_waves8",
                     "march_waves32", "march_stcs")
# the pressure section's shapes: (slots, interior, x decomposed)
PRESSURE_SHAPES = {"512": (None, (512, 512, 512), False),
                   "256x8": (8, (256, 256, 256), False),
                   "block": (None, (128, 256, 256), True)}
# the parent's model of JACOBI_PRESSURE's ghosted load, for the tile its
# autotuner gives the parent's kernel (stencil3d_cuda.REGISTERS there)
PARENT_REGISTERS = (40, 40)

# streaming probes for the pressure section: out = p + rhs over the same
# three fields JACOBI_PRESSURE moves, one float (scalar) or four (vec4) a
# thread, a grid-stride loop over 8 waves of 256-thread blocks: the
# bandwidth the card gives a launch that moves JACOBI_PRESSURE's bytes
# with no stencil, no index arithmetic and no neighbour reads
PROBE_CU = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) probe_scalar(
    const float* __restrict__ p, const float* __restrict__ rhs,
    float* __restrict__ out, int64_t n) {
  for (int64_t c = (int64_t)blockIdx.x * 256 + threadIdx.x; c < n;
       c += (int64_t)gridDim.x * 256)
    out[c] = __fadd_rn(p[c], rhs[c]);
}
__global__ void __launch_bounds__(256) probe_vec4(
    const float4* __restrict__ p, const float4* __restrict__ rhs,
    float4* __restrict__ out, int64_t n4) {
  for (int64_t c = (int64_t)blockIdx.x * 256 + threadIdx.x; c < n4;
       c += (int64_t)gridDim.x * 256) {
    const float4 a = p[c], b = rhs[c];
    out[c] = make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                         __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
}
extern "C" int probe_stream(const float* p, const float* rhs, float* out,
                            int64_t n, int vec, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(sms * 8 * 8);
  if (vec)
    probe_vec4<<<grid, 256, 0, st>>>((const float4*)p, (const float4*)rhs,
                                     (float4*)out, n / 4);
  else
    probe_scalar<<<grid, 256, 0, st>>>(p, rhs, out, n);
  return (int)cudaGetLastError();
}
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
            if kname in st.GHOSTED:
                runs += [("ghosted:design", t) for t in tiles] + [
                    (f"ghosted:{v}", t) for v in libs
                    if v.startswith("ghost_")
                    for t in dict.fromkeys([TILES[0], *tuned.values()])]
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
                unpadded = ghosts = None
                if kname in st.GHOSTED:
                    unpadded, ghosts = cs.ghosted_inputs(
                        kname, slots, (cs.N,) * 3, gen, dev)
                    gwant = st.KERNELS[kname](*unpadded, table, ghosts=ghosts)
                    gwant = gwant if isinstance(gwant, tuple) else (gwant,)
                for run in turns(runs):
                    variant, tile = run
                    if variant.startswith("ghosted:"):
                        lib_name = variant.split(":")[1]
                        st._lib = lambda lib_name=lib_name: libs[lib_name]
                        fn = lambda: st.KERNELS[kname](
                            *unpadded, table, tile=tile, ghosts=ghosts)
                        got = fn()
                        torch.cuda.synchronize()
                        got = got if isinstance(got, tuple) else (got,)
                        same[run][case] = all(torch.equal(g, w)
                                              for g, w in zip(got, gwant))
                        times[run].setdefault(case, []).append(
                            cs.cuda_ms(fn, REPS, head_start=True))
                        del got
                        continue
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
                del inputs, want, unpadded, ghosts
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


def study_routes(trees: dict):
    """Section 6 on ``trees`` (name: checkout) and this tree, in turns."""
    import pathlib

    from repro_torch.kernels import _build

    script = pathlib.Path(_build.BUILD_DIR) / "study" / "routes.py"
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text(ROUTES)
    names = list(trees)
    for name in names + ["this", "this"] + names[::-1]:
        tree = trees.get(name, ROOT)
        out = subprocess.run([sys.executable, str(script), tree],
                             capture_output=True, text=True, timeout=900,
                             cwd=tree)
        if out.returncode:
            raise SystemExit(f"routes on {tree} failed:\n{out.stderr}")
        emit({"phase": "routes", "tree": name, "root": tree,
              **json.loads(out.stdout.strip().splitlines()[-1])})


def build_pressure_libs(parent: str | None) -> dict:
    """The libraries of the pressure section, built at once: this tree's
    PRESSURE_VARIANTS, the parent's stencil3d.cu and its PARENT_VARIANTS
    (with ``parent``), and the streaming probes; returns {name: (ctypes
    library, nvcc's output)}."""
    import pathlib

    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {"probe": PROBE_CU}
    committed = _build.SOURCES["stencil3d"].read_text()
    for source, name, edits in VARIANTS:
        if source == "stencil3d" and name in PRESSURE_VARIANTS:
            v = committed
            for old, new in edits:
                if v.count(old) != 1:
                    raise SystemExit(f"{name}: {old!r} is not in the source "
                                     "once")
                v = v.replace(old, new)
            texts[name] = v
    if parent:
        text = (pathlib.Path(parent) / "src/repro_torch/kernels/csrc/"
                "stencil3d.cu").read_text()
        texts["parent"] = text
        for name, edits in PARENT_VARIANTS:
            if any(text.count(old) != 1 for old, _ in edits):
                emit({"phase": "pressure_build", "lib": name,
                      "skipped": "its edit is not in the parent's source once"})
                continue
            v = text
            for old, new in edits:
                v = v.replace(old, new)
            texts[name] = v
    procs = {}
    for name, text in texts.items():
        cu, so = out_dir / f"pressure_{name}.cu", out_dir / f"pressure_{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), log)
    return libs


def _ptxas_of(log: str, symbol: str) -> list:
    """The ptxas lines of the functions whose mangled name holds ``symbol``."""
    lines, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry" in ln or "Function properties" in ln:
            keep = symbol in ln
        if keep and ("registers" in ln or "spill" in ln or "Compiling" in ln):
            lines.append(ln.strip())
    return lines


def study_pressure(parent: str | None):
    """JACOBI_PRESSURE's ghosted load at the benchmark's shapes (one 512^3
    run, 8 slots of 256^3) and a decomposed rank's (128, 256, 256) block
    (both x faces received strips), on the cavity's faces: this tree's
    kernel, and with ``parent`` the parent's and its PARENT_VARIANTS, each
    bitwise against the plain version; the parent's padded load on the
    same cells padded; the streaming probes (``PROBE_CU``) on the same
    three fields.  Libraries in turns, forward then backward; device times
    (CUDA events, the stream given a head start) beside the bound (p and
    rhs read, p written, at 3.35 TB/s)."""
    import torch
    import chip_smoke as cs
    from repro_torch.cfd import cavity
    from repro_torch.core import autotune, halo
    from repro_torch.kernels import _build, stencil3d, stencil3d_cuda as st

    dev = torch.device("cuda")
    name, symbol = "JACOBI_PRESSURE", "jacobi_pressure_kernel"
    built = build_pressure_libs(parent)
    probe = built.pop("probe")[0]
    probe.probe_stream.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_void_p])
    probe.probe_stream.restype = ctypes.c_int
    this = st._lib()
    libs = {"this": this}
    emit({"phase": "pressure_build", "lib": "this",
          "ptxas": _ptxas_of(_build.build_info["stencil3d"]["log"], symbol)})
    load = _build.load
    try:
        for lib_name, (cdll, log) in built.items():
            _build.load = lambda _name, cdll=cdll: cdll
            libs[lib_name] = st._lib.__wrapped__()
            emit({"phase": "pressure_build", "lib": lib_name,
                  "ptxas": _ptxas_of(log, symbol)})
    finally:
        _build.load = load
    desc = stencil3d.DESCRIPTORS[name]
    regs = st.REGISTERS[name]
    lib = st._lib
    try:
        for shape, (S, interior, cut) in PRESSURE_SHAPES.items():
            st.REGISTERS[name] = PARENT_REGISTERS
            try:
                tile = autotune.choose_tile(desc, interior).tile
            finally:
                st.REGISTERS[name] = regs
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            link = (halo.AxisLink(name="shard", size=3, index=1,
                                  transport=halo.CountTransport())
                    if cut else None)
            (p, rhs), ghosts = cs.ghosted_inputs(name, S, interior, gen, dev,
                                                 link)
            cfgs = [cavity.config(interior[1], nz=interior[2], re=re)
                    for re in (cs.FARM_RES * 2)[:S or 1]]
            table = cs.param_rows(name, cfgs, dev)
            table = table if S else table[0]
            bound = st.bind_ghosts(name, ghosts, p)
            want = st.jacobi_pressure_plain(p, rhs, table, ghosts=bound)
            g = bound.ghosts[0]
            lead = p if S else p.unsqueeze(0)
            padded = halo.pad_with_strips(lead, (1, 1, 1), g.specs, g.strips)
            padded = padded if S else padded[0]
            cells = p.numel()
            bound_ms = 3 * 4 * cells / cs.HBM_BYTES_PER_S * 1e3
            runs = [(n, "ghosted") for n in libs] + [
                (n, "padded") for n in libs if n in ("this", "parent")] + [
                ("probe", "scalar"), ("probe", "vec4")]
            times = {r: [] for r in runs}
            same = {}
            for run in turns(runs):
                lib_name, load_mode = run
                if lib_name == "probe":
                    out = torch.empty_like(p)
                    vec = int(load_mode == "vec4")

                    def fn(out=out, vec=vec):
                        err = probe.probe_stream(
                            p.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                            cells, vec, torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise SystemExit(f"probe failed: CUDA error {err}")
                        return out
                else:
                    st._lib = lambda lib_name=lib_name: libs[lib_name]
                    if load_mode == "ghosted":
                        fn = lambda: st.jacobi_pressure(p, rhs, table,
                                                        tile=tile,
                                                        ghosts=bound)
                    else:
                        fn = lambda: st.jacobi_pressure(padded, rhs, table,
                                                        tile=tile)
                got = fn()
                torch.cuda.synchronize()
                if lib_name != "probe":
                    same[run] = bool(torch.equal(got, want))
                del got
                times[run].append(cs.cuda_ms(fn, REPS, head_start=True))
            for run in runs:
                ms = times[run]
                emit({"phase": "pressure", "shape": shape, "slots": S or 1,
                      "interior": list(interior), "lib": run[0],
                      "load": run[1], "parent_tile": list(tile),
                      "kernel_ms": ms, "bound_ms": bound_ms,
                      "share_of_bound": bound_ms / min(ms),
                      "bitwise_vs_plain": same.get(run)})
            del p, rhs, ghosts, bound, want, padded, lead
            torch.cuda.empty_cache()
    finally:
        st._lib = lib


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of another commit, for the "
                                     "farm-step and SSD_INTRA comparisons")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout for the "
                    "routes section (repeatable)")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections to run "
                         f"(default: {','.join(SECTIONS)})")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated stencils of the stencil and tiles "
                         "sections (default: all four)")
    args = ap.parse_args()
    if args.kernels:
        import chip_smoke as cs

        cs.STENCILS = tuple(args.kernels.split(","))
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
                       if not k.startswith(("walk_", "ghost_"))})
    if "tiles" in only:
        study_tiles({k: v for k, v in libs["stencil3d"].items()
                     if k == "design" or k.startswith(("walk_", "ghost_"))})
    if args.parent and "farm" in only:
        study_farm(os.path.abspath(args.parent))
    trees = dict(t.split("=", 1) for t in args.tree)
    if args.parent:
        trees = {"parent": args.parent, **trees}
    if trees and "routes" in only:
        study_routes({k: os.path.abspath(v) for k, v in trees.items()})
    if "pressure" in only:
        study_pressure(os.path.abspath(args.parent) if args.parent else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
