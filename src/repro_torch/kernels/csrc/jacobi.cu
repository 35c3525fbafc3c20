// JACOBI_FUSED: k weighted-Jacobi sweeps of the pressure Poisson equation
// in one launch, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/jacobi.py:jacobi_fused (its _fused_body), the
// TPU's communication-avoiding smoother: p and rhs arrive padded by k ghost
// cells, each sweep consumes one ghost ring, and one padding feeds k
// sweeps.  The TPU kernel kept a halo-expanded tile in VMEM across all k
// sweeps so that the intermediate sweeps never touched HBM.  Here:
//
//   * each block stages the halo-expanded (TX+2k) x (TY+2k) x 32 tile of p
//     and of rhs in shared memory, once: the output tile is TX x TY x
//     (32-2k), so that one warp holds one full z-row of the expanded tile,
//     lane = z;
//   * it runs the k sweeps there, ping-ponging between two p buffers; sweep
//     s updates the tile shrunk by s rings, with __syncthreads() between
//     sweeps, and the last sweep writes only the central tile to device
//     memory;
//   * the warps walk the tile's (x, y) rows, one row of 32 lanes at a time,
//     so a thread pays one integer division per row, not per cell; staging
//     issues the loads of kUnroll rows of p and rhs before it stores any,
//     so that enough loads are in flight to cover the memory's latency;
//   * the ragged edge is bounds-checked, so any interior shape launches:
//     there is no divisibility rule, unlike the Pallas kernel (jacobi.py:70);
//   * blockIdx.z strides over (slot, x-tile) rows, so a leading slot axis S
//     batches simulations in one launch; h^2, omega and 1 - omega are
//     scalars shared by every slot (the grid and the solver are static).
//
// What bounds it on an H100: bytes.  Each launch must read p and rhs
// ((n+2k)^3 each) and write p (n^3): at 256^3 and k = 2 that is 207.7 MB,
// 0.062 ms at 3.35 TB/s, against about 11 float operations per cell and
// sweep.  Two launches of the single-sweep kernel move 406 MB; the fused
// kernel reads the tiles' overlapping halos from L2 and keeps the
// intermediate sweep in shared memory, at the price of recomputing the
// tile's outer rings (the redundant work of the communication-avoiding
// trade: 12 x 12 x 32 staged and 10 x 10 x 30 + 8 x 8 x 28 updated per
// 8 x 8 x 28 outputs at k = 2).  Shared memory per block is
// 3 (TX+2k)(TY+2k) 32 floats: 54 KB at k = 2, 96 KB at k = 4 (dynamic).
//
// The arithmetic is that of the plain version (kernels/jacobi.py, _sweep):
// the neighbour sum in the order x+, x-, y+, y-, z+, z-, then
// (nbr - h^2 rhs) / 6 as a division, then (1 - omega) p + omega jac.
//
// The extern "C" launcher enqueues the kernel on the given stream, does not
// synchronise, and returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 8, kTY = 8;     // output tile in x and y
constexpr int kEZ = 32;             // expanded tile in z: one warp, lane = z
constexpr int kWarps = 8;
constexpr int kThreads = kEZ * kWarps;      // 256
constexpr int kMaxSweeps = 4;
constexpr int kUnroll = 4;          // staged rows a warp loads before storing
constexpr int64_t kMaxGridZ = 65535;

inline size_t smem_bytes(int k) {
  return 3 * sizeof(float) * (size_t)(kTX + 2 * k) * (kTY + 2 * k) * kEZ;
}

__global__ void __launch_bounds__(kThreads) jacobi_fused_kernel(
    const float* __restrict__ p, const float* __restrict__ rhs,
    float* __restrict__ out, float h2, float omega, float omc, int k,
    int64_t S, int64_t nx, int64_t ny, int64_t nz, int64_t x_tiles) {
  extern __shared__ float smem[];
  const int ex = kTX + 2 * k, ey = kTY + 2 * k, tz = kEZ - 2 * k;
  const int plane = ey * kEZ, nrows = ex * ey;
  float* const buf0 = smem;
  float* const buf1 = smem + ex * plane;
  float* const rs = smem + 2 * ex * plane;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int64_t PX = nx + 2 * k, PY = ny + 2 * k, PZ = nz + 2 * k;
  const int64_t y0 = (int64_t)blockIdx.y * kTY;
  const int64_t z0 = (int64_t)blockIdx.x * tz;
  const int64_t gz = z0 + lane;                 // this lane's padded z
  for (int64_t r = blockIdx.z; r < S * x_tiles; r += gridDim.z) {
    const int64_t s = r / x_tiles, x0 = (r - s * x_tiles) * kTX;
    const int64_t base = s * PX * PY * PZ;
    // Stage padded cells [x0, x0+ex) x [y0, y0+ey) x [z0, z0+32).  Cells
    // past the array's ragged edge read 0: they only ever feed cells whose
    // output lies outside the interior and is not written.
    for (int row0 = warp; row0 < nrows; row0 += kWarps * kUnroll) {
      float pv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = row0 + u * kWarps;
        const int a = row / ey, b = row - a * ey;
        const int64_t gx = x0 + a, gy = y0 + b;
        pv[u] = rv[u] = 0.0f;
        if (row < nrows && gx < PX && gy < PY && gz < PZ) {
          const int64_t g = base + (gx * PY + gy) * PZ + gz;
          pv[u] = p[g];
          rv[u] = rhs[g];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = row0 + u * kWarps;
        if (row < nrows) {
          buf0[row * kEZ + lane] = pv[u];
          rs[row * kEZ + lane] = rv[u];
        }
      }
    }
    __syncthreads();
    for (int sw = 1; sw <= k; ++sw) {
      const float* src = (sw & 1) ? buf0 : buf1;
      float* dst = (sw & 1) ? buf1 : buf0;
      // sweep sw updates the tile shrunk by sw rings on every side
      const int ry = ey - 2 * sw, rows = (ex - 2 * sw) * ry;
      const bool live = lane >= sw && lane < kEZ - sw;
      for (int row = warp; row < rows; row += kWarps) {
        const int a = sw + row / ry, b = sw + row % ry;
        const int q = (a * ey + b) * kEZ + lane;
        if (!live) continue;
        const float nbr = src[q + plane] + src[q - plane] + src[q + kEZ] +
                          src[q - kEZ] + src[q + 1] + src[q - 1];
        const float jac = (nbr - h2 * rs[q]) / 6.0f;
        const float v = omc * src[q] + omega * jac;
        if (sw < k) {
          dst[q] = v;
        } else {  // the last sweep's region is the central output tile
          const int64_t ox = x0 + a - k, oy = y0 + b - k, oz = gz - k;
          if (ox < nx && oy < ny && oz < nz)
            out[((s * nx + ox) * ny + oy) * nz + oz] = v;
        }
      }
      __syncthreads();
    }
  }
}

// Above 48 KB a block's shared memory must be opted in to.  The attribute
// belongs to the current device, so it is set at every call.
cudaError_t configure(int k) {
  const size_t bytes = smem_bytes(k);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      jacobi_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
}

}  // namespace

extern "C" {

// p, rhs: (S, nx+2k, ny+2k, nz+2k); out: (S, nx, ny, nz); all float32,
// C-contiguous, on the current device.
cudaError_t jacobi_fused(const float* p, const float* rhs, float* out,
                         float h2, float omega, float omc, int k, int64_t S,
                         int64_t nx, int64_t ny, int64_t nz, void* stream) {
  if (k < 1 || k > kMaxSweeps || S <= 0 || nx <= 0 || ny <= 0 || nz <= 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = configure(k);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes(k);
  const int64_t x_tiles = (nx + kTX - 1) / kTX;
  const int64_t rows = S * x_tiles;
  const int tz = kEZ - 2 * k;
  const dim3 grid((unsigned)((nz + tz - 1) / tz),
                  (unsigned)((ny + kTY - 1) / kTY),
                  (unsigned)(rows < kMaxGridZ ? rows : kMaxGridZ));
  jacobi_fused_kernel<<<grid, dim3(kEZ, kWarps), bytes,
                        (cudaStream_t)stream>>>(
      p, rhs, out, h2, omega, omc, k, S, nx, ny, nz, x_tiles);
  return cudaGetLastError();
}

int jacobi_max_sweeps() { return kMaxSweeps; }

// Resident blocks per SM for k sweeps (the occupancy the launch gets), or a
// negative CUDA error.
int jacobi_blocks_per_sm(int k) {
  if (k < 1 || k > kMaxSweeps) return -(int)cudaErrorInvalidValue;
  cudaError_t err = configure(k);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, jacobi_fused_kernel, kThreads, smem_bytes(k));
  return err == cudaSuccess ? blocks : -(int)err;
}

const char* jacobi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
