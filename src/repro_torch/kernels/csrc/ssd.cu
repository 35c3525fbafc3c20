// SSD_INTRA: the intra-chunk part of the chunked SSD (Mamba2) in one
// launch, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py:ssd_intra_pallas (its
// _ssd_intra_kernel), which the reference's ssd_core region
// __kernel__ssd (src/repro/models/mamba2.py:150) ships as on the TPU.  For
// each (batch, chunk) tile of L steps, group g and head r (all float32):
//
//   cum[l]   = sum_{i <= l} log_decay[i]                  (the head's column)
//   S[l, m]  = sum_n C[l, n] B[m, n]                      (group's scores)
//   y[l, p]  = sum_{m <= l} (S[l, m] exp(cum[l] - cum[m])) dt[m] x[m, p]
//            + exp(cum[l]) sum_n C[l, n] s_in[n, p]
//
// The TPU kernel ran one grid step per (batch·chunk, group) and looped over
// the R heads inside, keeping the (L, L) temporaries in VMEM.  On the H100
// that is only B·nc·G blocks (8 for a 1024-token prompt) for 132 SMs, so
// this kernel parallelises over heads and over 64-row tiles of the chunk as
// well: one block of 256 threads per (64-row l tile, head, batch·chunk and
// group).  Each block
//
//   * loads its head's log-decay and dt for rows [0, l0 + 64) and scans the
//     decay with warp shuffles (cum stays in shared memory);
//   * stages its C rows and the head's (N, P) incoming state s_in, computes
//     the inter-chunk term first;
//   * walks the 64-row m tiles up to its own: stages B and the head's x
//     tile, recomputes the 64 x 64 tile of C.B^T (cheap: 2·64·64·N flops),
//     forms the masked decay-weighted tile W in shared memory and adds W.x;
//   * never writes an (L, L) matrix to device memory.
//
// Threads hold 4 x 4 (scores) and 4 x ceil(P/16) (output) micro-tiles; all
// arithmetic is float32 FMAs on the CUDA cores.  Shared-memory strides of
// C, B and W are padded by one float, so the rows a warp reads fall in
// distinct banks.  Any L <= 256, N <= 128, P <= 128 and any R, G launch.
//
// What bounds it on an H100: at the zamba2-1.2b prefill shape (B 1, nc 8,
// L 128, G 1, R 64, P 64, N 64) the function moves ~42 MB and does ~1.6
// GFLOP (float32), so bytes bound it (~0.012 ms at 3.35 TB/s) and the
// float32 peak nearly does (~0.024 ms at 67 TFLOP/s); the per-head
// recompute of C.B^T adds ~0.5 GFLOP on top.
//
// The extern "C" launcher enqueues the kernel on the given stream, does not
// synchronise, and returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;              // rows of an l tile and of an m tile
constexpr int kMaxL = 256, kMaxN = 128, kMaxP = 128;
constexpr int kPJ = kMaxP / 16;     // output columns per thread, at most

struct Params {
  const float* x;     // (BC, L, G, R, P)
  const float* ld;    // (BC, L, G, R)
  const float* dt;    // (BC, L, G, R)
  const float* b;     // (BC, L, G, N)
  const float* c;     // (BC, L, G, N)
  const float* s_in;  // (BC, G, R, N, P)
  float* y;           // (BC, L, G, R, P)
  int64_t BC;
  int L, G, R, N, P;
};

inline size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) * ((size_t)2 * L + (size_t)2 * kT * (N + 1) +
                          (size_t)kT * P + (size_t)kT * (kT + 1) +
                          (size_t)N * P);
}

__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.L, G = p.G, R = p.R, N = p.N, P = p.P;
  const int NS = N + 1, WS = kT + 1;
  const int lt = blockIdx.x, r = blockIdx.y;
  const int64_t bc = blockIdx.z / G, g = blockIdx.z % G;
  const int l0 = lt * kT;
  const int lend = (l0 + kT < L) ? l0 + kT : L;   // rows [0, lend) are needed

  float* const cum = smem;                    // L
  float* const dtv = cum + L;                 // L
  float* const sC = dtv + L;                  // kT x (N+1)
  float* const sB = sC + kT * NS;             // kT x (N+1)
  float* const sX = sB + kT * NS;             // kT x P
  float* const sW = sX + kT * P;              // kT x (kT+1)
  float* const sS = sW + kT * WS;             // N x P

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;     // 16 x 16 thread grid

  // the head's log-decay and dt columns, then cum = cumsum(log-decay)
  const int64_t gate0 = (bc * L * G + g) * R + r;   // row 0 of (l, g, r)
  for (int i = tid; i < lend; i += kThreads) {
    cum[i] = p.ld[gate0 + (int64_t)i * G * R];
    dtv[i] = p.dt[gate0 + (int64_t)i * G * R];
  }
  __syncthreads();
  if (tid < 32) {
    float carry = 0.0f;
    for (int base = 0; base < lend; base += 32) {
      const int i = base + tid;
      float v = i < lend ? cum[i] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      if (i < lend) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  // C rows of this l tile, and the head's incoming state
  for (int i = tid; i < kT * N; i += kThreads) {
    const int a = i / N, n = i % N;
    const int l = l0 + a;
    sC[a * NS + n] = l < L ? p.c[((bc * L + l) * G + g) * N + n] : 0.0f;
  }
  const float* s_head = p.s_in + ((bc * G + g) * R + r) * (int64_t)N * P;
  for (int i = tid; i < N * P; i += kThreads) sS[i] = s_head[i];
  __syncthreads();

  // inter-chunk term: exp(cum[l]) (C[l] . s_in)
  const int pj_n = (P + 15) / 16;
  float acc[4][kPJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = sC[(tr + 16 * i) * NS + n];
#pragma unroll
    for (int j = 0; j < kPJ; ++j) {
      const int pp = tc + 16 * j;
      if (j < pj_n && pp < P) {
        const float sv = sS[n * P + pp];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(cv[i], sv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + tr + 16 * i;
    const float e = l < L ? expf(cum[l]) : 0.0f;
#pragma unroll
    for (int j = 0; j < kPJ; ++j) acc[i][j] *= e;
  }

  // intra-chunk term, one 64-row m tile at a time up to the diagonal
  for (int m0 = 0; m0 <= l0; m0 += kT) {
    __syncthreads();                // the previous tile's readers are done
    for (int i = tid; i < kT * N; i += kThreads) {
      const int a = i / N, n = i % N;
      const int m = m0 + a;
      sB[a * NS + n] = m < L ? p.b[((bc * L + m) * G + g) * N + n] : 0.0f;
    }
    for (int i = tid; i < kT * P; i += kThreads) {
      const int a = i / P, pp = i % P;
      const int m = m0 + a;
      sX[i] = m < L ? p.x[(((bc * L + m) * G + g) * R + r) * (int64_t)P + pp]
                    : 0.0f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = sC[(tr + 16 * i) * NS + n];
        bv[i] = sB[(tc + 16 * i) * NS + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = tr + 16 * i, l = l0 + a;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = tc + 16 * j, m = m0 + e;
        float w = 0.0f;
        if (m <= l && l < L) w = (s[i][j] * expf(cum[l] - cum[m])) * dtv[m];
        sW[a * WS + e] = w;
      }
    }
    __syncthreads();
    for (int e = 0; e < kT; ++e) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = sW[(tr + 16 * i) * WS + e];
#pragma unroll
      for (int j = 0; j < kPJ; ++j) {
        const int pp = tc + 16 * j;
        if (j < pj_n && pp < P) {
          const float xv = sX[e * P + pp];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + tr + 16 * i;
    if (l >= L) continue;
    float* yrow = p.y + (((bc * L + l) * G + g) * R + r) * (int64_t)P;
#pragma unroll
    for (int j = 0; j < kPJ; ++j) {
      const int pp = tc + 16 * j;
      if (j < pj_n && pp < P) yrow[pp] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// All float32, C-contiguous, on the current device.
cudaError_t ssd_intra(const float* x, const float* ld, const float* dt,
                      const float* b, const float* c, const float* s_in,
                      float* y, int64_t BC, int L, int G, int R, int N, int P,
                      void* stream) {
  if (BC <= 0 || L <= 0 || L > kMaxL || G <= 0 || R <= 0 || N <= 0 ||
      N > kMaxN || P <= 0 || P > kMaxP || R > 65535 || BC * G > 65535)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(L, N, P);
  // above 48 KB the size is opted in to; the attribute belongs to the
  // current device, so it is set at every launch (a host-side call)
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const Params p{x, ld, dt, b, c, s_in, y, BC, L, G, R, N, P};
  const dim3 grid((unsigned)((L + kT - 1) / kT), (unsigned)R,
                  (unsigned)(BC * G));
  ssd_intra_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

int ssd_max_dims(int which) {   // 0: L, 1: N, 2: P
  return which == 0 ? kMaxL : which == 1 ? kMaxN : kMaxP;
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
