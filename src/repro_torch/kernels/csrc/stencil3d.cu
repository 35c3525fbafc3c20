// The four CFD stencil kernels of the Navier-Stokes projection step,
// hand-written for Hopper (sm_90a).
//
// Each kernel computes what one instance of the reference's descriptor-
// generated 3DBLOCK Pallas template computes (src/repro/core/generator.py,
// GeneratedKernel._apply_pallas, with the bodies of
// src/repro/kernels/stencil3d.py).  The TPU template staged halo-expanded
// tiles in VMEM and read per-slot scalars through scalar prefetch; here:
//
//   * one thread per output cell, threadIdx.x along the contiguous z axis
//     so that every load and store of a warp is coalesced (fields are
//     C-order (S, X, Y, Z) float32, S the slot axis);
//   * a block of (tz, ty) threads covers tz cells along z and ty rows along
//     y, and walks tx consecutive (slot, x) rows; blockIdx.z strides over
//     the groups of tx rows, so any interior shape and any slot count
//     launch, with bounds checks and no tile divisibility.  The launcher
//     takes the tile (tx, ty, tz) from its caller: the wrapper's block_for
//     default (tx = 1) or the autotuner's choice
//     (repro_torch.core.autotune.tile_for).  Which thread computes a cell
//     changes nothing in its arithmetic, so every tile gives the same bits;
//   * per-slot parameters come from an (S, n_params) float32 table on the
//     device, one row per slot (the twin of the generator's scalar table),
//     in the column order of repro_torch.kernels.stencil3d.TABLES: the
//     terms the reference bakes as literals from h and omega (1/h, 1/h^2,
//     h^2, 1 - omega) arrive computed in double and rounded once, never
//     recomputed here in float32.  Admitting another parameter set never
//     rebuilds anything, and no scalar crosses from the host.
//
// All four are memory-bound on an H100 (3.35 TB/s against 67 TFLOP/s of
// float32): the bytes per interior cell, counting each input byte read once
// and each output byte written once, are UPDATE_VELOCITY 24,
// DIVERGENCE ~16 (12 read, 4 written), JACOBI_PRESSURE 12,
// PROJECT_VELOCITY 28.  Against that, the arithmetic per cell (about 150,
// 6, 13 and 10 float operations) is far below the card's balance point.
// The design relies on L1/L2 for the reuse of neighbour values between
// adjacent threads; a block that walks x planes (tx > 1) finds the planes
// it read for the previous row in its SM's L1 rather than in L2.
// Shared-memory tiles and TMA staging of the halo-expanded block are later
// work.
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

// ---------------------------------------------------------------------------
// UPDATE_VELOCITY  (replaces the 3DBLOCK instance of descriptor
// UPDATE_VELOCITY, src/repro/kernels/stencil3d.py, body update_velocity_body)
// u* = u + dt (-(MAC central flux-form advection) + nu lap(u) + f)
// in: vx, vy, vz padded by 1 on every side, (S, nx+2, ny+2, nz+2)
// out: three (S, nx, ny, nz); table dt, 1/h, 1/h^2, nu, fx, fy, fz
// ---------------------------------------------------------------------------
template <bool kWalk>
__global__ void __launch_bounds__(kThreads) update_velocity_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oz,
    const float* __restrict__ table, int64_t S, int64_t nx, int64_t ny,
    int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  const int64_t sy = nz + 2, sx = (ny + 2) * sy, ss = (nx + 2) * sx;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    const float* prm = table + s * 7;
    const float dt = prm[0], ih = prm[1], ih2 = prm[2], nu = prm[3];
    const float fx = prm[4], fy = prm[5], fz = prm[6];
    const int64_t c = s * ss + (i + 1) * sx + (j + 1) * sy + (k + 1);
#define U(a, b, d) vx[c + (a) * sx + (b) * sy + (d)]
#define V(a, b, d) vy[c + (a) * sx + (b) * sy + (d)]
#define W(a, b, d) vz[c + (a) * sx + (b) * sy + (d)]
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

    const int64_t o = (r * ny + j) * nz + k;
    ox[o] = new_vx;
    oy[o] = new_vy;
    oz[o] = new_vz;
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
// in: p padded by 1 on every side (S, nx+2, ny+2, nz+2), rhs (S, nx, ny, nz)
// out: (S, nx, ny, nz); table h^2, omega, 1 - omega
// ---------------------------------------------------------------------------
template <bool kWalk>
__global__ void __launch_bounds__(kThreads) jacobi_pressure_kernel(
    const float* __restrict__ p, const float* __restrict__ rhs,
    float* __restrict__ out, const float* __restrict__ table, int64_t S,
    int64_t nx, int64_t ny, int64_t nz, int tx) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t j = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= ny || k >= nz) return;
  const int64_t sy = nz + 2, sx = (ny + 2) * sy, ss = (nx + 2) * sx;
  ROWS(r) {
    int64_t s, i;
    row_of(r, nx, s, i);
    const float h2 = table[s * 3], omega = table[s * 3 + 1],
                omc = table[s * 3 + 2];
    const int64_t c = s * ss + (i + 1) * sx + (j + 1) * sy + (k + 1);
    const int64_t o = (r * ny + j) * nz + k;
    const float nbr = add(add(add(add(add(p[c + sx], p[c - sx]), p[c + sy]),
                                      p[c - sy]),
                                  p[c + 1]),
                              p[c - 1]);
    const float jac = __fdiv_rn(sub(nbr, mul(h2, rhs[o])), 6.0f);
    out[o] = add(mul(omc, p[c]), mul(omega, jac));
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

}  // namespace

extern "C" {

cudaError_t stencil3d_update_velocity(const float* vx, const float* vy,
                                      const float* vz, float* ox, float* oy,
                                      float* oz, const float* table,
                                      int64_t S, int64_t nx, int64_t ny,
                                      int64_t nz, int tx, int ty, int tz,
                                      void* stream) {
  if (bad_launch(S, nx, ny, nz, tx, ty, tz)) return cudaErrorInvalidValue;
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tx == 1)
    update_velocity_kernel<false><<<grid, block, 0, st>>>(
        vx, vy, vz, ox, oy, oz, table, S, nx, ny, nz, tx);
  else
    update_velocity_kernel<true><<<grid, block, 0, st>>>(
        vx, vy, vz, ox, oy, oz, table, S, nx, ny, nz, tx);
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

cudaError_t stencil3d_jacobi_pressure(const float* p, const float* rhs,
                                      float* out, const float* table,
                                      int64_t S, int64_t nx, int64_t ny,
                                      int64_t nz, int tx, int ty, int tz,
                                      void* stream) {
  if (bad_launch(S, nx, ny, nz, tx, ty, tz)) return cudaErrorInvalidValue;
  const dim3 block(tz, ty, 1);
  const dim3 grid = grid_for(block, tx, S, nx, ny, nz);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tx == 1)
    jacobi_pressure_kernel<false><<<grid, block, 0, st>>>(
        p, rhs, out, table, S, nx, ny, nz, tx);
  else
    jacobi_pressure_kernel<true><<<grid, block, 0, st>>>(
        p, rhs, out, table, S, nx, ny, nz, tx);
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

const char* stencil3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
