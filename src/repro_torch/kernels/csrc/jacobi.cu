// JACOBI_FUSED: k weighted-Jacobi sweeps of the pressure Poisson equation
// in one launch, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/jacobi.py:jacobi_fused (its _fused_body), the
// TPU's communication-avoiding smoother: p and rhs arrive padded by k ghost
// cells, each sweep consumes one ghost ring, and one padding feeds k
// sweeps.  The TPU kernel kept a halo-expanded tile in VMEM across all k
// sweeps so that the intermediate sweeps never touched HBM.
//
// What bounds it on an H100: bytes.  A launch must read p and rhs
// ((n+2k)^3 each) and write p (n^3): at 256^3 and k = 2 that is 207.7 MB,
// 0.062 ms at 3.35 TB/s, against about 11 float operations per cell and
// sweep.  The design is the 2.5D wavefront of a temporally blocked 7-point
// stencil, so that each input cell is read from device memory about once
// and no sweep but the last leaves shared memory:
//
//   * a block owns a (y, z) column of kTY x kTZ = 16 x 64 output cells and
//     a segment of kSeg = 64 planes in x; its expanded plane is
//     (kTY+2k) x (kTZ+2k) cells;
//   * it marches in x.  At step j it waits for padded plane j of p and rhs
//     (cp.async into shared-memory rings, zero-filled off the array) and
//     starts the copy of plane j+kAhead, which overlaps the step's
//     arithmetic.  The copies are 16 bytes where the padded rows are
//     16-byte aligned (nz + 2k a multiple of 4, as at 256^3 and k = 2),
//     else 4 bytes (a copy per float costs about a third of a step's
//     instructions);
//   * sweep s updates plane j-2s+1 from planes j-2s .. j-2s+2 of sweep s-1.
//     The lag of two planes a sweep makes the k sweeps of a step
//     independent of each other, so one __syncthreads() a step suffices.
//     p keeps a ring of 3+kAhead planes, each intermediate sweep one of 4,
//     rhs one of 2k+kAhead; sweep k writes its plane straight to device
//     memory.  Shared memory: 71 KB at k = 2 (3 blocks an SM), 173 KB at
//     k = 4;
//   * sweep s updates the plane shrunk by s rings, so the redundant loads
//     in y and z are (20 x 68) / (16 x 64) = 1.33x at k = 2; in x there are
//     none but the k planes before each segment, re-read to prime its
//     pipeline (2k / kSeg of the loads);
//   * the grid is (z tiles, y tiles, slots x segments): x is cut into
//     segments so that one 256^3 grid fills the card's 132 SMs, and
//     blockIdx.z strides over (slot, segment) past 65,535; offsets within
//     a padded plane are 32-bit;
//   * the ragged edge needs no branch in the arithmetic: cells off the
//     array read 0 and feed only outputs that are not written, so any
//     interior shape and k = 1..4 launch;
//   * each thread updates the same cells of the plane at every step; their
//     indices are computed once, and a sweep first forms all its cells'
//     numerators (branch-free loads and sums) before the divisions, so the
//     loads of several cells are in flight together.
//
// Exactness: every cell of every sweep is computed by one expression
// (numerator, then update), with every operation rounded as written
// (__fadd_rn etc.: nvcc may not contract it into FMAs), whatever its
// position in a tile or a segment and whatever the slot count.  A cell
// recomputed in a neighbouring tile's halo or before a segment's start is
// therefore equal bit for bit to the same cell computed by its owner, and
// a slot of a batched launch equals a launch of that slot alone bitwise
// (the farm's slot == serial rule).  The arithmetic is that of the plain
// version (kernels/jacobi.py, _sweep): the neighbour sum in the order x+,
// x-, y+, y-, z+, z-, then (nbr - h^2 rhs) / 6 as a true division, then
// (1 - omega) p + omega jac.
//
// The extern "C" launcher enqueues the kernel on the given stream, does not
// synchronise, and returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTY = 16, kTZ = 64;   // output tile in y and z
constexpr int kSeg = 64;            // output planes in x a block marches over
constexpr int kAhead = 1;           // planes of p and rhs in flight ahead
constexpr int kThreads = 256;
constexpr int kMaxSweeps = 4;
constexpr int64_t kMaxGridZ = 65535;

// K sweeps; V floats a copy (4: rows of the padded array 16-byte aligned)
template <int K, int V>
struct Geom {
  static constexpr int EY = kTY + 2 * K, EZ = kTZ + 2 * K;   // expanded plane
  static constexpr int EZS = (EZ + 3) / 4 * 4;    // its row stride in smem
  static constexpr int PLANE = EY * EZS;
  static constexpr int RING0 = 3 + kAhead;  // planes of p (sweep 0)
  static constexpr int RING = 4;            // planes of sweeps 1..K-1 each
  static constexpr int RHS = 2 * K + kAhead;  // planes of rhs
  static constexpr int LOADS = (PLANE / V + kThreads - 1) / kThreads;
  // passes of the block's threads over the cells sweep s updates
  __host__ __device__ static constexpr int iters(int s) {
    return ((EY - 2 * s) * (EZ - 2 * s) + kThreads - 1) / kThreads;
  }
  static constexpr int ITERS = iters(1);
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)PLANE * (RING0 + (K - 1) * RING + RHS);
  // the ring of sweep s (0 .. K-1), in planes from the start
  __host__ __device__ static constexpr int ring_at(int s) {
    return s == 0 ? 0 : RING0 + (s - 1) * RING;
  }
};

// V floats from src to dst, or V zeros where !valid
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of one cell's sweep: lo, mid, hi are planes x-1, x, x+1
// of the previous sweep, r is plane x of rhs, q the cell's index in the
// expanded plane, ez its row stride.  The numerator (nbr - h^2 rhs) ...
__device__ __forceinline__ float numerator(const float* lo, const float* mid,
                                           const float* hi, const float* r,
                                           int q, int ez, float h2) {
  float nbr = __fadd_rn(hi[q], lo[q]);
  nbr = __fadd_rn(nbr, mid[q + ez]);
  nbr = __fadd_rn(nbr, mid[q - ez]);
  nbr = __fadd_rn(nbr, mid[q + 1]);
  nbr = __fadd_rn(nbr, mid[q - 1]);
  return __fsub_rn(nbr, __fmul_rn(h2, r[q]));
}

// ... and the update (1 - omega) p + omega (numerator / 6).
__device__ __forceinline__ float update(float num, float centre, float omega,
                                        float omc) {
  return __fadd_rn(__fmul_rn(omc, centre),
                   __fmul_rn(omega, __fdiv_rn(num, 6.0f)));
}

template <int K, int V>
__global__ void __launch_bounds__(kThreads) jacobi_fused_kernel(
    const float* __restrict__ p, const float* __restrict__ rhs,
    float* __restrict__ out, float h2, float omega, float omc, int64_t S,
    int nx, int ny, int nz, int segs) {
  using G = Geom<K, V>;
  extern __shared__ __align__(16) float smem[];
  float* const lvl = smem;                            // the K sweep rings
  float* const rs = smem + G::ring_at(K) * G::PLANE;  // [RHS][PLANE]
  const int PY = ny + 2 * K, PZ = nz + 2 * K;
  const int64_t pstride = (int64_t)PY * PZ;           // one padded plane
  const int64_t slot_in = (int64_t)(nx + 2 * K) * pstride;
  const int64_t oplane = (int64_t)ny * nz;            // one output plane
  // the expanded plane's origin in padded coordinates is the output tile's
  // origin in interior coordinates
  const int y0 = blockIdx.y * kTY, z0 = blockIdx.x * kTZ;

  // this thread's copies, the same in every plane: V floats at offset
  // off (32-bit, within a padded plane) to e in the expanded plane, or
  // zeros where they lie off the array (PZ % V == 0: all V or none)
  int off[G::LOADS];
  bool on[G::LOADS];
#pragma unroll
  for (int i = 0; i < G::LOADS; ++i) {
    const int e = (threadIdx.x + i * kThreads) * V;
    const int yy = e / G::EZS, zz = e - yy * G::EZS;
    on[i] = e < G::PLANE && y0 + yy < PY && z0 + zz < PZ;
    off[i] = on[i] ? (y0 + yy) * PZ + z0 + zz : 0;
  }
  // the cells this thread updates in each sweep, the same at every step:
  // the index in the expanded plane (-1: none), and for the last sweep the
  // offset within an output plane (-1: off the interior)
  int cell[K][G::ITERS], dst_off[G::ITERS];
#pragma unroll
  for (int sw = 1; sw <= K; ++sw) {
    const int ry = G::EY - 2 * sw, rz = G::EZ - 2 * sw;
#pragma unroll
    for (int i = 0; i < G::ITERS; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int a = c / rz, yy = sw + a, zz = sw + (c - a * rz);
      cell[sw - 1][i] = c < ry * rz ? yy * G::EZS + zz : -1;
      if (sw == K) {
        const int oy = y0 + yy - K, oz = z0 + zz - K;
        dst_off[i] = c < ry * rz && oy < ny && oz < nz ? oy * nz + oz : -1;
      }
    }
  }

  for (int64_t row = blockIdx.z; row < S * segs; row += gridDim.z) {
    const int64_t s = row / segs;
    const int x0 = (int)(row - s * segs) * kSeg;   // first output plane
    const int xlast = min(x0 + kSeg, nx) - 1;      // last output plane
    const int loads = xlast - x0 + 2 * K + 1;      // padded planes x0..
    const int steps = xlast - x0 + 3 * K;
    const float* const ps = p + s * slot_in + (int64_t)x0 * pstride;
    const float* const rg = rhs + s * slot_in + (int64_t)x0 * pstride;
    float* const os = out + s * nx * oplane;

    // padded plane x0 + j (j relative to the segment) into the rings
    auto load = [&](int j) {
      float* const dp = lvl + (j % G::RING0) * G::PLANE;
      float* const dr = rs + (j % G::RHS) * G::PLANE;
      const float* const pj = ps + j * pstride;
      const float* const rj = rg + j * pstride;
#pragma unroll
      for (int i = 0; i < G::LOADS; ++i) {
        const int e = (threadIdx.x + i * kThreads) * V;
        if ((i + 1) * kThreads * V <= G::PLANE || e < G::PLANE) {
          cp_async<V>(dp + e, pj + off[i], on[i]);
          cp_async<V>(dr + e, rj + off[i], on[i]);
        }
      }
    };

    __syncthreads();          // the previous segment's readers are done
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {   // one copy group a plane
      if (a < loads) load(a);
      cp_async_commit();
    }
    for (int j = 0; j < steps; ++j) {
      cp_async_wait<kAhead - 1>();   // plane j has landed ...
      __syncthreads();        // ... for every thread, and plane j-3 is free
      if (j + kAhead < loads) load(j + kAhead);
      cp_async_commit();
#pragma unroll
      for (int sw = 1; sw <= K; ++sw) {
        const int q = j - 2 * sw + 1;     // the plane sweep sw updates
        const float* const src = lvl + G::ring_at(sw - 1) * G::PLANE;
        const int rn = sw == 1 ? G::RING0 : G::RING;   // q - 1 >= -2K
        const float* const lo = src + ((q - 1 + 2 * rn * K) % rn) * G::PLANE;
        const float* const mid = src + ((q + 2 * rn * K) % rn) * G::PLANE;
        const float* const hi = src + ((q + 1 + 2 * rn * K) % rn) * G::PLANE;
        const float* const r = rs + ((q + G::RHS) % G::RHS) * G::PLANE;
        const int its = G::iters(sw);
        // first every cell's numerator (loads and sums, no branch; a
        // thread without a cell reads a cell of the plane and drops it),
        // then the divisions and the stores
        float num[G::ITERS], centre[G::ITERS];
#pragma unroll
        for (int i = 0; i < G::ITERS; ++i) {
          if (i >= its) continue;
          const int c = cell[sw - 1][i] >= 0 ? cell[sw - 1][i] : G::EZS + 1;
          num[i] = numerator(lo, mid, hi, r, c, G::EZS, h2);
          centre[i] = mid[c];
        }
        const int ox = x0 + q - K;        // output plane of the last sweep
        float* const dst = lvl + G::ring_at(sw) * G::PLANE + (q & 3) * G::PLANE;
        float* const orow = os + (int64_t)ox * oplane;
#pragma unroll
        for (int i = 0; i < G::ITERS; ++i) {
          if (i >= its || cell[sw - 1][i] < 0) continue;
          const float v = update(num[i], centre[i], omega, omc);
          if (sw < K)
            dst[cell[sw - 1][i]] = v;
          else if (ox >= x0 && dst_off[i] >= 0)
            orow[dst_off[i]] = v;
        }
      }
    }
    cp_async_wait<0>();
  }
}

// Above 48 KB a block's shared memory must be opted in to.  The attribute
// belongs to the current device, so it is set at every call.
template <int K, int V>
cudaError_t configure() {
  if (Geom<K, V>::kBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(jacobi_fused_kernel<K, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Geom<K, V>::kBytes);
}

template <int K, int V>
cudaError_t launch(const float* p, const float* rhs, float* out, float h2,
                   float omega, float omc, int64_t S, int nx, int ny, int nz,
                   cudaStream_t stream) {
  const cudaError_t err = configure<K, V>();
  if (err != cudaSuccess) return err;
  const int segs = (nx + kSeg - 1) / kSeg;
  const int64_t rows = S * segs;
  const dim3 grid((unsigned)((nz + kTZ - 1) / kTZ),
                  (unsigned)((ny + kTY - 1) / kTY),
                  (unsigned)(rows < kMaxGridZ ? rows : kMaxGridZ));
  jacobi_fused_kernel<K, V><<<grid, kThreads, Geom<K, V>::kBytes, stream>>>(
      p, rhs, out, h2, omega, omc, S, nx, ny, nz, segs);
  return cudaGetLastError();
}

// 16-byte copies where every row of the padded arrays starts 16-byte
// aligned: both pointers aligned and the padded z extent a multiple of 4
template <int K>
cudaError_t launch_k(const float* p, const float* rhs, float* out, float h2,
                     float omega, float omc, int64_t S, int nx, int ny,
                     int nz, cudaStream_t stream) {
  const bool vec = ((uintptr_t)p | (uintptr_t)rhs) % 16 == 0 &&
                   (nz + 2 * K) % 4 == 0;
  return vec ? launch<K, 4>(p, rhs, out, h2, omega, omc, S, nx, ny, nz, stream)
             : launch<K, 1>(p, rhs, out, h2, omega, omc, S, nx, ny, nz, stream);
}

template <int K>
int blocks_per_sm() {   // of the 16-byte-copy kernel
  cudaError_t err = configure<K, 4>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, jacobi_fused_kernel<K, 4>, kThreads, Geom<K, 4>::kBytes);
  return err == cudaSuccess ? blocks : -(int)err;
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
  // a padded plane is indexed in 32 bits; the grid's y extent is 16 bits
  if ((ny + 2 * k) * (nz + 2 * k) >= ((int64_t)1 << 31) ||
      nx + 2 * k >= ((int64_t)1 << 31) || (ny + kTY - 1) / kTY > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int x = (int)nx, y = (int)ny, z = (int)nz;
  switch (k) {
    case 1: return launch_k<1>(p, rhs, out, h2, omega, omc, S, x, y, z, st);
    case 2: return launch_k<2>(p, rhs, out, h2, omega, omc, S, x, y, z, st);
    case 3: return launch_k<3>(p, rhs, out, h2, omega, omc, S, x, y, z, st);
    default: return launch_k<4>(p, rhs, out, h2, omega, omc, S, x, y, z, st);
  }
}

int jacobi_max_sweeps() { return kMaxSweeps; }

// Resident blocks per SM for k sweeps (the occupancy the launch gets), or a
// negative CUDA error.
int jacobi_blocks_per_sm(int k) {
  switch (k) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The segment length in x (study and tests read it).
int jacobi_segment() { return kSeg; }

const char* jacobi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
