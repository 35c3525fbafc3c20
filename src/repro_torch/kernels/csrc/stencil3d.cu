// The four CFD stencil kernels of the Navier-Stokes projection step,
// hand-written for Hopper (sm_90a).
//
// Each kernel computes what one instance of the reference's descriptor-
// generated 3DBLOCK Pallas template computes (src/repro/core/generator.py,
// GeneratedKernel._apply_pallas, with the bodies of
// src/repro/kernels/stencil3d.py: UPDATE_VELOCITY :74, DIVERGENCE :148,
// JACOBI_PRESSURE :159, PROJECT_VELOCITY :171).  The TPU template staged
// halo-expanded tiles in VMEM, which its caller had padded, and read
// per-slot scalars through scalar prefetch.  Here per-slot parameters come
// from an (S, n_params) float32 table on the device, one row per slot (the
// twin of the generator's scalar table), in the column order of
// repro_torch.kernels.stencil3d.TABLES: the terms the reference bakes as
// literals from h and omega (1/h, 1/h^2, h^2, 1 - omega) arrive computed in
// double and rounded once.  Admitting another parameter set never rebuilds
// anything, and no scalar crosses from the host.
//
// All four are memory-bound on an H100 (3.35 TB/s against 67 TFLOP/s of
// float32): the bytes per interior cell, counting each input byte read once
// and each output byte written once, are UPDATE_VELOCITY 24,
// DIVERGENCE ~16 (12 read, 4 written), JACOBI_PRESSURE 12,
// PROJECT_VELOCITY 28, against about 150, 6, 13 and 10 float operations.
//
// Each kernel is one thread per output cell, threadIdx.x along the
// contiguous z axis so that every load and store of a warp is coalesced; a
// block of (tz, ty) threads walks tx consecutive (slot, x) rows, blockIdx.z
// striding over the groups of rows, relying on L1/L2 for the reuse of
// neighbour values.
//
// JACOBI_PRESSURE and UPDATE_VELOCITY also have a ghosted load (see "The
// ghosted load" below): they read their fields unpadded and make each
// ghost value a face cell needs themselves, from the faces' rules as data
// and the strips the neighbour ranks sent.  The padded copy of a whole
// field that their callers made before every launch (three volume copies a
// pad; 43 pads a step for these two) is gone from their path; the padded
// load stays as the other mode of the same body, for the thin shells of
// the interior/shell split and for rules that declare no form.  Bounds:
// JACOBI_PRESSURE reads p and rhs and writes p, UPDATE_VELOCITY reads and
// writes three fields, each once, plus the strips and the faces' table of
// b.  DIVERGENCE and PROJECT_VELOCITY (and the generated template at the
// end) still read padded fields.
//
// The launch tile (tx, ty, tz) comes from the caller: the wrapper's
// block_for default or the autotuner's choice
// (repro_torch.core.autotune.tile_for).  Which thread computes a cell
// changes nothing in its arithmetic, so every tile gives the same bits.
//
// Every float operation is rounded as written, in the order of the plain
// body (repro_torch/kernels/stencil3d.py, whose order the reference's
// template fixes): add/sub/mul below are __fadd_rn/__fsub_rn/__fmul_rn,
// which nvcc may not contract into FMAs, and the two divisions are
// __fdiv_rn.  Eager PyTorch rounds every operation too, so each kernel
// equals its plain version bitwise (left to itself nvcc would fuse
// a * b + c, and the results would part by an ulp or so).
//
// Each extern "C" launcher enqueues its kernel on the given stream, does
// not synchronise, and returns cudaGetLastError() so the caller can raise.
//
// Built with -DSTENCIL3D_GENERATED this file holds the template alone, for
// any other descriptor: the generic 3DBLOCK kernel at the end, around a
// body that repro_torch.kernels.stencil3d_cuda traces from the descriptor's
// Python body (every field read, parameter, constant and operation one
// line, rounded as written) and writes to stencil3d_generated_body.cuh,
// which the build finds on its include path.  The four kernels above are
// left out of that build.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the most threads a block may have (__launch_bounds__ below); the wrapper
// holds the same number (stencil3d_cuda.MAX_THREADS)
constexpr int kThreads = 256;
constexpr int64_t kMaxGridZ = 65535;

dim3 grid_for(dim3 block, int tx, int64_t S, int64_t nx, int64_t ny,
              int64_t nz) {
  const int64_t groups = (S * nx + tx - 1) / tx;
  return dim3((unsigned)((nz + block.x - 1) / block.x),
              (unsigned)((ny + block.y - 1) / block.y),
              (unsigned)(groups < kMaxGridZ ? groups : kMaxGridZ));
}

// A grid.y above its limit of 65535 is refused by the launch itself, and
// cudaGetLastError() reports it.  The (slot, x) rows are numbered in 32 bits
// (row_of).  The wrapper checks the tile against the interior as well.
bool bad_launch(int64_t S, int64_t nx, int64_t ny, int64_t nz, int tx,
                int ty, int tz) {
  return S <= 0 || nx <= 0 || ny <= 0 || nz <= 0 || S * nx > INT32_MAX ||
         tx <= 0 || ty <= 0 || tz <= 0 || ty * tz > kThreads;
}

// Slot s and x index i of row r = s * nx + i, by a 32-bit division: a 64-bit
// one is a call of several dozen instructions, more than the stencil's own
// arithmetic in the three small kernels.
__device__ __forceinline__ void row_of(int64_t r, int64_t nx, int64_t& s,
                                       int64_t& i) {
  const unsigned q = (unsigned)r / (unsigned)nx;
  s = q;
  i = r - (int64_t)q * nx;
}

// The rows a block computes: groups of tx consecutive (slot, x) rows, the
// group index striding over blockIdx.z.  Each kernel comes in two
// instantiations: kWalk = false is for tx = 1, where the walk reduces to the
// one-row loop r = blockIdx.z, blockIdx.z + gridDim.z, ... with nothing
// around it (a loop with a bound known only at run time around the body
// cost the three small kernels 2-42% at tx = 1, whose blocks then walk
// nothing); kWalk = true walks tx rows.
#define ROWS(r)                                                            \
  for (int64_t r##0 = (int64_t)blockIdx.z * (kWalk ? tx : 1); r##0 < S * nx; \
       r##0 += (int64_t)gridDim.z * (kWalk ? tx : 1))                      \
    for (int64_t r = r##0,                                                 \
                 r##1 = kWalk && r##0 + tx < S * nx ? r##0 + tx            \
                        : kWalk ? S * nx : r##0 + 1;                       \
         r < r##1; ++r)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

#ifndef STENCIL3D_GENERATED
// ---------------------------------------------------------------------------
// The ghosted load of JACOBI_PRESSURE and UPDATE_VELOCITY.  Each of the two
// kernels comes in two load modes of one body (kGhost):
//   * padded (kGhost = false): the cached fields arrive padded by 1 on every
//     side, (S, nx+2, ny+2, nz+2), and every neighbour is a read at a fixed
//     offset, as in the other kernels;
//   * ghosted (kGhost = true): the cached fields arrive unpadded,
//     (S, nx, ny, nz), with their six faces (struct Ghosts): a rule as data,
//     ghost = a m + b of the mirrored interior cell m (its kind says which
//     terms it has, so that each is rounded as the rule's call rounds it),
//     the periodic wrap, or the strip the neighbour rank sent.  A cell whose
//     neighbours all lie in the grid (all but the faces' cells) reads them
//     at fixed offsets; a face cell reads a neighbour past the grid through
//     ghost_value, out of line: the value exchange_pad's padded array holds
//     there.  The axes are resolved z, y, x and their rules applied x, then
//     y, then z, as the padding pads x first and each later axis over the
//     earlier ones (an edge cell composes the rules; a strip of a later axis
//     carries the ghost ends of the earlier ones).
// No copy of a field is made: a ghost cell costs a face thread one more
// read of a cell the block reads anyway, or of a strip.
// ---------------------------------------------------------------------------
enum : int { kConst = 0, kLinear = 1, kAffine = 2, kWrap = 3, kStrip = 4 };
constexpr int kFaces = 6;   // x lo, x hi, y lo, y hi, z lo, z hi
constexpr int kMaxFields = 3;

// one face of one field (repro_torch.kernels.stencil3d_cuda._Face)
struct Face {
  const float* strip;   // kStrip: the received strip, C-order
  float a;              // kLinear, kAffine
  int kind;
};
struct Ghosts {
  Face f[kMaxFields][kFaces];
};

// the face's rule on the mirrored cell m, b the slot's value of its b
__device__ __forceinline__ float rule(const Face& f, float b, float m) {
  if (f.kind == kConst) return b;
  if (f.kind == kLinear) return mul(f.a, m);
  return add(mul(f.a, m), b);
}

// A field's six face kinds, 3 bits a face (face q at bit 3 q): one register
// that a thread keeps instead of the faces.
__device__ __forceinline__ int pack_kinds(const Face* f) {
  int kinds = 0;
#pragma unroll
  for (int q = 0; q < kFaces; ++q) kinds |= f[q].kind << (3 * q);
  return kinds;
}
__device__ __forceinline__ int kind_of(int kinds, int q) {
  return (kinds >> (3 * q)) & 7;
}

// The index, j < 0 or j >= n, of the cell whose value a ghost cell takes
// across a face of this kind (a rule: the mirrored edge cell; a wrap: the
// far side's).
__device__ __forceinline__ int fold(int j, int n, int kind) {
  return (j < 0) != (kind == kWrap) ? 0 : n - 1;
}

// The rules that make padded cell (i, j, k)'s value from the value its
// position folds to, applied to v: x, then y, then z, each where its axis
// is crossed across a rule.  A strip carries the ghost ends of the axes
// before it: past a z strip no rule applies, past a y strip only z's.
__device__ __forceinline__ float apply_rules(float v, const Face* f,
                                             int kinds,
                                             const float* __restrict__ b,
                                             int i, int j, int k, int nx,
                                             int ny, int nz) {
  int fx = -1, fy = -1, fz = -1;
  if (k < 0 || k >= nz) {
    const int q = 4 + (k >= 0), kd = kind_of(kinds, q);
    if (kd == kStrip) return v;
    if (kd <= kAffine) fz = q;
  }
  bool ystrip = false;
  if (j < 0 || j >= ny) {
    const int q = 2 + (j >= 0), kd = kind_of(kinds, q);
    ystrip = kd == kStrip;
    if (kd <= kAffine) fy = q;
  }
  if (!ystrip && (i < 0 || i >= nx)) {
    const int q = i >= 0, kd = kind_of(kinds, q);
    if (kd <= kAffine) fx = q;
  }
  if (fx >= 0) v = rule(f[fx], b[fx], v);
  if (fy >= 0) v = rule(f[fy], b[fy], v);
  if (fz >= 0) v = rule(f[fz], b[fz], v);
  return v;
}

// The value padded cell (i, j, k), -1 <= i <= nx etc., of slot s of field
// u holds, one of i, j, k past the grid: the cell its position folds to
// (the plane u's, or for a ghost plane the plane its position folds to or
// the x strip, (S, 1, ny, nz), laid out alike), or where a y or z strip is
// crossed the strip's cell, with the rules applied.  b: the slot's six
// values of b.  Out of line: only the face cells call it.
__device__ __noinline__ float ghost_value(const float* __restrict__ u,
                                          const Face* f, int kinds,
                                          const float* __restrict__ b,
                                          int64_t s, int i, int j, int k,
                                          int nx, int ny, int nz) {
  const int64_t plane = (int64_t)ny * nz;
  const float* src;
  if (i >= 0 && i < nx) {
    src = u + (s * nx + i) * plane;
  } else {
    const int q = i >= 0, kd = kind_of(kinds, q);
    src = kd == kStrip ? f[q].strip + s * plane
                       : u + (s * nx + fold(i, nx, kd)) * plane;
  }
  int jj = j, kk = k;
  float v;
  if (k < 0 || k >= nz) {
    const int q = 4 + (k >= 0), kd = kind_of(kinds, q);
    if (kd == kStrip) {   // (S, nx+2, ny+2, 1)
      v = f[q].strip[(s * (nx + 2) + i + 1) * (int64_t)(ny + 2) + j + 1];
      return apply_rules(v, f, kinds, b, i, j, k, nx, ny, nz);
    }
    kk = fold(k, nz, kd);
  }
  if (j < 0 || j >= ny) {
    const int q = 2 + (j >= 0), kd = kind_of(kinds, q);
    if (kd == kStrip) {   // (S, nx+2, 1, nz)
      v = f[q].strip[(s * (nx + 2) + i + 1) * (int64_t)nz + kk];
      return apply_rules(v, f, kinds, b, i, j, k, nx, ny, nz);
    }
    jj = fold(j, ny, kd);
  }
  v = src[(int64_t)jj * nz + kk];
  return apply_rules(v, f, kinds, b, i, j, k, nx, ny, nz);
}

// The reads of one field about the cell a thread computes, F(a, b, d) the
// neighbour at offset (a, b, d), |a|, |b|, |d| <= 1.  Cells: at c plus each
// axis's offset of a step down (xm, ym, zm) or up (xp, yp, zp), a Place's.
// Ghosted: a cell of the ghosted load that some neighbour reaches across a
// rule or a strip, through ghost_value past the grid.
struct Cells {
  const float* __restrict__ u;
  int64_t c, xm, xp, ym, yp, zm, zp;
  __device__ __forceinline__ float operator()(int a, int b, int d) const {
    return u[c + (a < 0 ? xm : a > 0 ? xp : 0) + (b < 0 ? ym : b > 0 ? yp : 0) +
             (d < 0 ? zm : d > 0 ? zp : 0)];
  }
};
struct Ghosted {
  const float* __restrict__ u;
  const Face* f;
  int kinds;
  const float* __restrict__ b;
  int64_t s;
  int i, j, k, nx, ny, nz;
  __device__ __forceinline__ float operator()(int a, int bb, int d) const {
    const int x = i + a, y = j + bb, z = k + d;
    if (x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz)
      return u[((s * nx + x) * ny + y) * (int64_t)nz + z];
    return ghost_value(u, f, kinds, b, s, x, y, z, nx, ny, nz);
  }
};

// The faces that wrap in every field of F, one bit a face (face q at bit q).
template <int F>
__device__ __forceinline__ int wrapping(const Ghosts& g) {
  int wraps = (1 << kFaces) - 1;
#pragma unroll
  for (int m = 0; m < F; ++m)
#pragma unroll
    for (int q = 0; q < kFaces; ++q)
      if (g.f[m][q].kind != kWrap) wraps &= ~(1 << q);
  return wraps;
}

// Cell (i, j, k) of slot s in a cached field: its index c, padded by 1 on
// every side (kGhost = false) or unpadded, and the offsets of its
// neighbours a step down or up each axis.  In the ghosted load a step past
// a face that wraps (wraps: wrapping) lands on the far side, so the
// neighbours are still reads at offsets from c, and folds says whether
// every neighbour is such a read: false where a step crosses a rule or a
// strip.  (A warp runs along z: in a grid whose z faces wrap, as the
// cavity's do, only the warps of the x and y faces' rows take the Ghosted
// reads.)
template <bool kGhost>
struct Place {
  int64_t c, xm, xp, ym, yp, zm, zp;
  bool folds;
  __device__ __forceinline__ Place(int64_t s, int64_t i, int64_t j,
                                   int64_t k, int64_t nx, int64_t ny,
                                   int64_t nz, int wraps) {
    const int64_t pad = kGhost ? 0 : 2, sy = nz + pad, sx = (ny + pad) * sy;
    c = ((s * (nx + pad) + i) * (ny + pad) + j) * sy + k;
    if (!kGhost) c += sx + sy + 1;
    xm = -sx, xp = sx, ym = -sy, yp = sy, zm = -1, zp = 1;
    folds = true;
    if (kGhost) {
      auto wrap = [&](int64_t at, int64_t n, int64_t st, int q,
                      int64_t& down, int64_t& up) {
        if (at == 0) {
          down = (n - 1) * st;
          folds = folds && (wraps >> q & 1);
        }
        if (at == n - 1) {
          up = -(n - 1) * st;
          folds = folds && (wraps >> (q + 1) & 1);
        }
      };
      wrap(i, nx, sx, 0, xm, xp);
      wrap(j, ny, sy, 2, ym, yp);
      wrap(k, nz, 1, 4, zm, zp);
    }
  }
};

// The blocks an SM must hold of each instantiation: the register limit of
// its __launch_bounds__ (kernel_study.py's tiles section times the others).
// JACOBI_PRESSURE's ghosted load at 6 (40 registers, a few spilled in the
// face rows' Ghosted reads) ran 0.147 ms at 256^3 against 0.168 at 4 (64);
// UPDATE_VELOCITY's at 4 (64 registers) 0.431 against 0.616 at 6, where
// ~500 bytes spill.  The padded load at 6 holds the 32-40 registers it
// took with no limit.
constexpr int kJacobiGhostBlocks = 6;
constexpr int kUpdateGhostBlocks = 4;
constexpr int kPaddedBlocks = 6;

// A launch of the ghosted load indexes a cell in 32 bits along each axis.
bool bad_ghosted(int64_t nx, int64_t ny, int64_t nz) {
  return nx + 2 >= ((int64_t)1 << 31) || ny + 2 >= ((int64_t)1 << 31) ||
         nz + 2 >= ((int64_t)1 << 31);
}
// ---------------------------------------------------------------------------
// UPDATE_VELOCITY  (replaces the 3DBLOCK instance of descriptor
// UPDATE_VELOCITY, src/repro/kernels/stencil3d.py, body update_velocity_body)
// u* = u + dt (-(MAC central flux-form advection) + nu lap(u) + f)
// in: vx, vy, vz unpadded (S, nx, ny, nz) with their faces (ghosted), or
// padded by 1 on every side (padded); out: three (S, nx, ny, nz); table dt,
// 1/h, 1/h^2, nu, fx, fy, fz; btab (ghosted): the (S, 3 x 6) values of b
// ---------------------------------------------------------------------------
template <bool kGhost, bool kWalk>
__global__ void __launch_bounds__(kThreads,
                                  kGhost ? kUpdateGhostBlocks : kPaddedBlocks)
    update_velocity_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oz,
    const float* __restrict__ table, const __grid_constant__ Ghosts g,
    const float* __restrict__ btab, int64_t S, int64_t nx, int64_t ny,
    int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  const int wraps = kGhost ? wrapping<3>(g) : 0;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    const float* prm = table + s * 7;
    const float dt = prm[0], ih = prm[1], ih2 = prm[2], nu = prm[3];
    const float fx = prm[4], fy = prm[5], fz = prm[6];
    const int64_t o = (r * ny + j) * nz + k;
    // the body on the three fields' reads (Cells or Ghosted)
    auto body = [&](const auto& fu, const auto& fv, const auto& fw) {
#define U(a, b, d) fu(a, b, d)
#define V(a, b, d) fv(a, b, d)
#define W(a, b, d) fw(a, b, d)
// the body's lap(f): ((((((f+x + f-x) + f+y) + f-y) + f+z) + f-z) - 6 f) / h^2
#define LAP(F)                                                          \
  mul(sub(add(add(add(add(add(F(1, 0, 0), F(-1, 0, 0)), F(0, 1, 0)),    \
                          F(0, -1, 0)),                                 \
                      F(0, 0, 1)),                                      \
                  F(0, 0, -1)),                                         \
          mul(6.0f, F(0, 0, 0))),                                       \
      ih2)
#define AVG(F, a1, b1, d1, a2, b2, d2) \
  mul(0.5f, add(F(a1, b1, d1), F(a2, b2, d2)))
// (a * b - c * d) / h, a flux difference
#define FLUX(a, b, c, d) mul(sub(mul(a, b), mul(c, d)), ih)
// u + dt (-(d1 + d2 + d3) + nu lap(u) + f)
#define ADVANCE(F, d1, d2, d3, f) \
  add(F(0, 0, 0),                 \
      mul(dt, add(add(-add(add(d1, d2), d3), mul(nu, LAP(F))), f)))

      // x-momentum at the x-face
      const float uc_r = AVG(U, 0, 0, 0, 1, 0, 0);
      const float uc_l = AVG(U, -1, 0, 0, 0, 0, 0);
      const float duu = FLUX(uc_r, uc_r, uc_l, uc_l);
      const float u_yh = AVG(U, 0, 0, 0, 0, 1, 0);
      const float u_yl = AVG(U, 0, -1, 0, 0, 0, 0);
      const float v_yh = AVG(V, 0, 0, 0, 1, 0, 0);
      const float v_yl = AVG(V, 0, -1, 0, 1, -1, 0);
      const float duv = FLUX(u_yh, v_yh, u_yl, v_yl);
      const float u_zh = AVG(U, 0, 0, 0, 0, 0, 1);
      const float u_zl = AVG(U, 0, 0, -1, 0, 0, 0);
      const float w_zh = AVG(W, 0, 0, 0, 1, 0, 0);
      const float w_zl = AVG(W, 0, 0, -1, 1, 0, -1);
      const float duw = FLUX(u_zh, w_zh, u_zl, w_zl);
      const float new_vx = ADVANCE(U, duu, duv, duw, fx);

      // y-momentum at the y-face
      const float vc_r = AVG(V, 0, 0, 0, 0, 1, 0);
      const float vc_l = AVG(V, 0, -1, 0, 0, 0, 0);
      const float dvv = FLUX(vc_r, vc_r, vc_l, vc_l);
      const float v_xh = AVG(V, 0, 0, 0, 1, 0, 0);
      const float v_xl = AVG(V, -1, 0, 0, 0, 0, 0);
      const float u_xh = AVG(U, 0, 0, 0, 0, 1, 0);
      const float u_xl = AVG(U, -1, 0, 0, -1, 1, 0);
      const float dvu = FLUX(v_xh, u_xh, v_xl, u_xl);
      const float v_zh = AVG(V, 0, 0, 0, 0, 0, 1);
      const float v_zl = AVG(V, 0, 0, -1, 0, 0, 0);
      const float w_zh_y = AVG(W, 0, 0, 0, 0, 1, 0);
      const float w_zl_y = AVG(W, 0, 0, -1, 0, 1, -1);
      const float dvw = FLUX(v_zh, w_zh_y, v_zl, w_zl_y);
      const float new_vy = ADVANCE(V, dvu, dvv, dvw, fy);

      // z-momentum at the z-face
      const float wc_r = AVG(W, 0, 0, 0, 0, 0, 1);
      const float wc_l = AVG(W, 0, 0, -1, 0, 0, 0);
      const float dww = FLUX(wc_r, wc_r, wc_l, wc_l);
      const float w_xh = AVG(W, 0, 0, 0, 1, 0, 0);
      const float w_xl = AVG(W, -1, 0, 0, 0, 0, 0);
      const float u_xh_z = AVG(U, 0, 0, 0, 0, 0, 1);
      const float u_xl_z = AVG(U, -1, 0, 0, -1, 0, 1);
      const float dwu = FLUX(w_xh, u_xh_z, w_xl, u_xl_z);
      const float w_yh = AVG(W, 0, 0, 0, 0, 1, 0);
      const float w_yl = AVG(W, 0, -1, 0, 0, 0, 0);
      const float v_yh_z = AVG(V, 0, 0, 0, 0, 0, 1);
      const float v_yl_z = AVG(V, 0, -1, 0, 0, -1, 1);
      const float dwv = FLUX(w_yh, v_yh_z, w_yl, v_yl_z);
      const float new_vz = ADVANCE(W, dwu, dwv, dww, fz);
#undef ADVANCE
#undef FLUX
#undef AVG
#undef LAP
#undef W
#undef V
#undef U
      ox[o] = new_vx;
      oy[o] = new_vy;
      oz[o] = new_vz;
    };
    const Place<kGhost> at(s, i, j, k, nx, ny, nz, wraps);
    if (!kGhost || at.folds) {
      body(Cells{vx, at.c, at.xm, at.xp, at.ym, at.yp, at.zm, at.zp},
           Cells{vy, at.c, at.xm, at.xp, at.ym, at.yp, at.zm, at.zp},
           Cells{vz, at.c, at.xm, at.xp, at.ym, at.yp, at.zm, at.zp});
    } else if constexpr (kGhost) {
      const float* b = btab + s * 3 * kFaces;
      const int ii = (int)i, jj = (int)j, kk = (int)k;
      const int n0 = (int)nx, n1 = (int)ny, n2 = (int)nz;
      body(Ghosted{vx, g.f[0], pack_kinds(g.f[0]), b, s, ii, jj, kk, n0, n1,
                   n2},
           Ghosted{vy, g.f[1], pack_kinds(g.f[1]), b + kFaces, s, ii, jj, kk,
                   n0, n1, n2},
           Ghosted{vz, g.f[2], pack_kinds(g.f[2]), b + 2 * kFaces, s, ii, jj,
                   kk, n0, n1, n2});
    }
  }
}
// ---------------------------------------------------------------------------
// DIVERGENCE  (replaces the 3DBLOCK instance of descriptor DIVERGENCE,
// body divergence_body): backward-difference cell divergence / h
// in: vx, vy, vz padded by 1 on the lo side, (S, nx+1, ny+1, nz+1)
// out: (S, nx, ny, nz); table 1/h
// ---------------------------------------------------------------------------
template <bool kWalk>
__global__ void __launch_bounds__(kThreads) divergence_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, float* __restrict__ out,
    const float* __restrict__ table, int64_t S, int64_t nx, int64_t ny,
    int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  const int64_t sy = nz + 1, sx = (ny + 1) * sy, ss = (nx + 1) * sx;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    const float ih = table[s];
    const int64_t c = s * ss + (i + 1) * sx + (j + 1) * sy + (k + 1);
    out[(r * ny + j) * nz + k] =
        mul(add(add(sub(vx[c], vx[c - sx]), sub(vy[c], vy[c - sy])),
                sub(vz[c], vz[c - 1])),
            ih);
  }
}

// ---------------------------------------------------------------------------
// JACOBI_PRESSURE  (replaces the 3DBLOCK instance of descriptor
// JACOBI_PRESSURE, body jacobi_pressure_body), launched jacobi_iters times
// per step: p' = (1 - omega) p + omega (sum of 6 neighbours - h^2 rhs) / 6
// in: p unpadded (S, nx, ny, nz) with its faces (ghosted), or padded by 1
// on every side (padded); rhs (S, nx, ny, nz); out: (S, nx, ny, nz); table
// h^2, omega, 1 - omega; btab (ghosted): the (S, 6) values of b
// ---------------------------------------------------------------------------
template <bool kGhost, bool kWalk>
__global__ void __launch_bounds__(kThreads,
                                  kGhost ? kJacobiGhostBlocks : kPaddedBlocks)
    jacobi_pressure_kernel(
    const float* __restrict__ p, const float* __restrict__ rhs,
    float* __restrict__ out, const float* __restrict__ table,
    const __grid_constant__ Ghosts g, const float* __restrict__ btab,
    int64_t S, int64_t nx, int64_t ny, int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  const int wraps = kGhost ? wrapping<1>(g) : 0;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    const float h2 = table[s * 3], omega = table[s * 3 + 1],
                omc = table[s * 3 + 2];
    const int64_t o = (r * ny + j) * nz + k;
    auto body = [&](const auto& P) {
      const float nbr = add(add(add(add(add(P(1, 0, 0), P(-1, 0, 0)),
                                            P(0, 1, 0)),
                                        P(0, -1, 0)),
                                    P(0, 0, 1)),
                                P(0, 0, -1));
      const float jac = __fdiv_rn(sub(nbr, mul(h2, rhs[o])), 6.0f);
      out[o] = add(mul(omc, P(0, 0, 0)), mul(omega, jac));
    };
    const Place<kGhost> at(s, i, j, k, nx, ny, nz, wraps);
    if (!kGhost || at.folds) {
      body(Cells{p, at.c, at.xm, at.xp, at.ym, at.yp, at.zm, at.zp});
    } else if constexpr (kGhost) {
      body(Ghosted{p, g.f[0], pack_kinds(g.f[0]), btab + s * kFaces, s,
                   (int)i, (int)j, (int)k, (int)nx, (int)ny, (int)nz});
    }
  }
}
// ---------------------------------------------------------------------------
// PROJECT_VELOCITY  (replaces the 3DBLOCK instance of descriptor
// PROJECT_VELOCITY, body project_velocity_body):
// u <- u - (dt / h) forward-difference grad p
// in: vx, vy, vz (S, nx, ny, nz), p padded by 1 on the hi side
// (S, nx+1, ny+1, nz+1); out: three (S, nx, ny, nz); table dt, h
// ---------------------------------------------------------------------------
template <bool kWalk>
__global__ void __launch_bounds__(kThreads) project_velocity_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const float* __restrict__ p,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
    const float* __restrict__ table, int64_t S, int64_t nx, int64_t ny,
    int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  const int64_t sy = nz + 1, sx = (ny + 1) * sy, ss = (nx + 1) * sx;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    const float sc = __fdiv_rn(table[s * 2], table[s * 2 + 1]);
    const int64_t c = s * ss + i * sx + j * sy + k;
    const int64_t o = (r * ny + j) * nz + k;
    const float pc = p[c];
    ox[o] = sub(vx[o], mul(sc, sub(p[c + sx], pc)));
    oy[o] = sub(vy[o], mul(sc, sub(p[c + sy], pc)));
    oz[o] = sub(vz[o], mul(sc, sub(p[c + 1], pc)));
  }
}

#else  // STENCIL3D_GENERATED
// ---------------------------------------------------------------------------
// The generated 3DBLOCK template (replaces GeneratedKernel._apply_pallas for
// a descriptor that has no hand-written kernel above): one thread a cell as
// in the four kernels, the body gen_body(...) generated from the
// descriptor's Python body.  It reads its inputs through pointers to cell
// (s, i, j, k) of each padded field and the slot's row of the parameter
// table, and writes each output at o, the cell's index in the
// (S, nx, ny, nz) outputs.
// ---------------------------------------------------------------------------
constexpr int kGenMaxFields = 16;
struct GenArgs {
  const float* in[kGenMaxFields];
  float* out[kGenMaxFields];
};

#include "stencil3d_generated_body.cuh"

static_assert(kGenInputs <= kGenMaxFields && kGenOutputs <= kGenMaxFields,
              "more fields than the template takes");

template <bool kWalk>
__global__ void __launch_bounds__(kThreads) generated_kernel(
    const GenArgs a, const float* __restrict__ table, int64_t S, int64_t nx,
    int64_t ny, int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    gen_body(a, table + s * kGenParams, s, i, j, k, nx, ny, nz,
             (r * ny + j) * nz + k);
  }
}
#endif  // STENCIL3D_GENERATED

}  // namespace

extern "C" {

#ifndef STENCIL3D_GENERATED

// ghosts: the fields' faces (struct Ghosts) for the ghosted load (vx, vy,
// vz unpadded), with btab, the (S, 3 * 6) table of their values of b; null
// for the padded load.  (A pointer to a type of the unnamed namespace
// would give the function internal linkage: it takes void.)
cudaError_t stencil3d_update_velocity(const float* vx, const float* vy,
                                      const float* vz, float* ox, float* oy,
                                      float* oz, const float* table,
                                      const void* ghosts, const float* btab,
                                      int64_t S, int64_t nx, int64_t ny,
                                      int64_t nz, int tx, int ty, int tz,
                                      void* stream) {
  const Ghosts* g = static_cast<const Ghosts*>(ghosts);
  if (bad_launch(S, nx, ny, nz, tx, ty, tz) || (g && bad_ghosted(nx, ny, nz)))
    return cudaErrorInvalidValue;
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const Ghosts none = {};
  auto kernel = g ? (tx == 1 ? update_velocity_kernel<true, false>
                             : update_velocity_kernel<true, true>)
                  : (tx == 1 ? update_velocity_kernel<false, false>
                             : update_velocity_kernel<false, true>);
  kernel<<<grid, block, 0, st>>>(vx, vy, vz, ox, oy, oz, table,
                                 g ? *g : none, btab, S, nx, ny, nz, tx);
  return cudaGetLastError();
}

cudaError_t stencil3d_divergence(const float* vx, const float* vy,
                                 const float* vz, float* out,
                                 const float* table, int64_t S, int64_t nx,
                                 int64_t ny, int64_t nz, int tx, int ty,
                                 int tz, void* stream) {
  if (bad_launch(S, nx, ny, nz, tx, ty, tz)) return cudaErrorInvalidValue;
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tx == 1)
    divergence_kernel<false><<<grid, block, 0, st>>>(
        vx, vy, vz, out, table, S, nx, ny, nz, tx);
  else
    divergence_kernel<true><<<grid, block, 0, st>>>(
        vx, vy, vz, out, table, S, nx, ny, nz, tx);
  return cudaGetLastError();
}

// ghosts: p's faces (struct Ghosts) for the ghosted load (p unpadded),
// with btab, the (S, 6) table of their values of b; null for the padded
// load
cudaError_t stencil3d_jacobi_pressure(const float* p, const float* rhs,
                                      float* out, const float* table,
                                      const void* ghosts, const float* btab,
                                      int64_t S, int64_t nx, int64_t ny,
                                      int64_t nz, int tx, int ty, int tz,
                                      void* stream) {
  const Ghosts* g = static_cast<const Ghosts*>(ghosts);
  if (bad_launch(S, nx, ny, nz, tx, ty, tz) || (g && bad_ghosted(nx, ny, nz)))
    return cudaErrorInvalidValue;
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  const Ghosts none = {};
  auto kernel = g ? (tx == 1 ? jacobi_pressure_kernel<true, false>
                             : jacobi_pressure_kernel<true, true>)
                  : (tx == 1 ? jacobi_pressure_kernel<false, false>
                             : jacobi_pressure_kernel<false, true>);
  kernel<<<grid, block, 0, st>>>(p, rhs, out, table, g ? *g : none, btab, S,
                                 nx, ny, nz, tx);
  return cudaGetLastError();
}

cudaError_t stencil3d_project_velocity(const float* vx, const float* vy,
                                       const float* vz, const float* p,
                                       float* ox, float* oy, float* oz,
                                       const float* table, int64_t S,
                                       int64_t nx, int64_t ny, int64_t nz,
                                       int tx, int ty, int tz, void* stream) {
  if (bad_launch(S, nx, ny, nz, tx, ty, tz)) return cudaErrorInvalidValue;
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tx == 1)
    project_velocity_kernel<false><<<grid, block, 0, st>>>(
        vx, vy, vz, p, ox, oy, oz, table, S, nx, ny, nz, tx);
  else
    project_velocity_kernel<true><<<grid, block, 0, st>>>(
        vx, vy, vz, p, ox, oy, oz, table, S, nx, ny, nz, tx);
  return cudaGetLastError();
}

#else  // STENCIL3D_GENERATED
// ins/outs: host arrays of the n_in padded inputs and n_out outputs in the
// descriptor's order; table: the (S, n_params) parameter table
cudaError_t stencil3d_generated(const float* const* ins, int n_in,
                                float* const* outs, int n_out,
                                const float* table, int n_params, int64_t S,
                                int64_t nx, int64_t ny, int64_t nz, int tx,
                                int ty, int tz, void* stream) {
  if (bad_launch(S, nx, ny, nz, tx, ty, tz) || n_in != kGenInputs ||
      n_out != kGenOutputs || n_params != kGenParams)
    return cudaErrorInvalidValue;
  GenArgs a = {};
  for (int m = 0; m < n_in; ++m) a.in[m] = ins[m];
  for (int m = 0; m < n_out; ++m) a.out[m] = outs[m];
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tx == 1)
    generated_kernel<false><<<grid, block, 0, st>>>(a, table, S, nx, ny, nz,
                                                    tx);
  else
    generated_kernel<true><<<grid, block, 0, st>>>(a, table, S, nx, ny, nz,
                                                   tx);
  return cudaGetLastError();
}
#endif  // STENCIL3D_GENERATED

const char* stencil3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
