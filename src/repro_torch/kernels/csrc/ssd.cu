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
// the R heads inside, keeping the (L, L) temporaries in VMEM.  Here one
// block of eight warps takes a 64-row l tile of one (batch·chunk, group),
// H of its heads and one tile of at most 128 output columns; each warp owns
// 16 rows of the tile and half of the tile's columns.
//
//   * The block computes the group's scores S = C.B^T for its rows against
//     every m up to its last row once, keeps them in shared memory and
//     reuses them for all its heads (S does not depend on the head).  Each
//     column tile of the output recomputes them: they cost L^2 N / 2, the
//     C.s_in product L N P.
//   * Both products that contract over N (the scores and C.s_in) take N in
//     slices of at most 128 columns, so shared memory does not grow with
//     N: at N <= 128 the C tile is staged once and stays; above, each
//     slice of C is staged beside the operand tiles it meets, into one of
//     two C buffers by turns, and the scores add up slice by slice in
//     shared memory.
//   * Per head it forms the decay-weighted W = S * exp(cum_l - cum_m) *
//     dt_m directly as the MMA's A fragments, with the causal mask applied
//     before the exponential (no m > l reaches it), and accumulates
//     y = exp(cum_l) (C.s_in) + W.X in registers.
//   * All three products run on the tensor cores: mma.sync m16n8k8 TF32 in
//     the 3xTF32 split.  Each operand a becomes hi = tf32(a) (rounded to
//     nearest as cvt.rna rounds) and lo = tf32(a - hi); a product adds
//     a_lo.b_hi and a_hi.b_lo, then a_hi.b_hi, into float32.  One TF32
//     product keeps ~11 bits (5e-4 relative), more than SSD_RTOL = 1e-4
//     allows; the split restores float32 accuracy for three MMAs a
//     product.
//   * The operand tiles (B for the scores, then per head s_in and X) stream
//     through two shared-memory buffers with cp.async: the next tile loads
//     while the current one is multiplied.  Rows and columns past L, N and
//     P are zero-filled up to the MMA's multiples of 8.
//   * The grid is (head groups, batch·chunk·group, l tiles), the l tiles
//     heaviest (last) first.
//
// Any L <= 256, N <= 512, P <= 512 and any R, G launch.  Shared-memory
// strides are padded so that the fragment loads of a warp fall in 32
// distinct banks.  The grid is (head groups x column tiles, batch·chunk·
// group, l tiles); a column tile's warps skip the MMAs of 8-column tiles
// past P (the mLSTM's P = 385 leaves a last tile of 8 columns).
//
// What bounds it on an H100: at the zamba2-1.2b prefill shape (B 1, nc 8,
// L 128, G 1, R 64, P 64, N 64) the function moves 43 MB (0.0128 ms at
// 3.35 TB/s) and does 1.1 GFLOP, 0.0022 ms at the 495 TFLOP/s of dense
// TF32 (x3 for the split: 0.0067 ms), so bytes bound it.  At the
// xlstm-125m prefill of 1,024 tokens (nc 8, L 128, G 4, R 1, N 384,
// P 385): 44 MB (0.0132 ms) and 1.6 GFLOP (0.0033 ms, x3: 0.0098 ms).
//
// The extern "C" launcher enqueues the kernel on the given stream, does not
// synchronise, and returns cudaGetLastError() so the caller can raise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // 4 row groups x 2 column halves
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 64;              // rows of an l, m or s_in tile
constexpr int kNS = 128;            // columns of an N slice (C and B tiles)
constexpr int kHeads = 0;           // heads a block takes; 0: heads_for()
constexpr bool kSplit = true;       // 3xTF32 products (false: one TF32)
constexpr int kMaxL = 256, kMaxN = 512, kMaxP = 512;

struct Params {
  const float* x;     // (BC, L, G, R, P)
  const float* ld;    // (BC, L, G, R)
  const float* dt;    // (BC, L, G, R)
  const float* b;     // (BC, L, G, N)
  const float* c;     // (BC, L, G, N)
  const float* s_in;  // (BC, G, R, N, P)
  float* y;           // (BC, L, G, R, P)
  int L, G, R, N, P;
  int np8, pp8;       // N and P rounded up to 8 (the MMA's k and n)
  int nsl;            // N slices of at most kNS columns
  int nj;             // n-tiles of 8 output columns a warp computes (of 2 nj)
  int npt;            // column tiles of 16 nj columns (the grid's x)
  int cs, ss, xs;     // strides of C and B tiles, of S, of X and s_in tiles
  int nc_buf;         // C buffers: 1 (one slice, staged once) or 2
  int buf;            // floats in one operand buffer
  int heads;          // heads a block takes
  bool vec;           // 16-byte copies: N, P and the pointers allow them
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// n-tiles of 8 columns a warp takes for P padded to pp8, and the column
// tiles of 16 of them that cover it
inline int nj_for(int pp8) {
  return pp8 <= 16 ? 1 : pp8 <= 32 ? 2 : pp8 <= 64 ? 4 : 8;
}
inline int column_tiles(int pp8) {
  return (pp8 + 16 * nj_for(pp8) - 1) / (16 * nj_for(pp8));
}

inline Params make_params(const float* x, const float* ld, const float* dt,
                          const float* b, const float* c, const float* s_in,
                          float* y, int L, int G, int R, int N, int P) {
  Params p{x, ld, dt, b, c, s_in, y, L, G, R, N, P};
  p.np8 = round_up(N, 8);
  p.pp8 = round_up(P, 8);
  p.nsl = (p.np8 + kNS - 1) / kNS;
  p.nc_buf = p.nsl > 1 ? 2 : 1;
  p.cs = round_up(N < kNS ? N : kNS, 32) + 4;   // A-fragment rows: 4 banks
  p.ss = round_up(L, kT) + 4;        // a score tile stores 64 columns
  p.nj = nj_for(p.pp8);
  p.npt = column_tiles(p.pp8);
  p.xs = 16 * p.nj + 8;             // B-fragment rows: 8 banks apart
  p.buf = kT * (p.xs > p.cs ? p.xs : p.cs);
  const bool aligned = ((uintptr_t)x | (uintptr_t)b | (uintptr_t)c |
                        (uintptr_t)s_in) % 16 == 0;
  p.vec = aligned && N % 4 == 0 && P % 4 == 0;
  return p;
}

// Heads a block takes: the most of 8, 4, 2 that still gives the grid
// 1.5 blocks an SM (each block shares its C.B^T among more heads, but
// fewer blocks leave SMs idle): at the zamba2 prefills of 512, 1024 and
// 2048 tokens that is 2, 4 and 8 (kernel_study.py measures each).
inline int heads_for(int64_t BC, int L, int G, int R, int npt) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t tiles = BC * G * ((L + kT - 1) / kT) * npt;
  for (int h = 8; h > 2; h /= 2)
    if (2 * tiles * ((R + h - 1) / h) >= 3 * (int64_t)sms) return h;
  return 2;
}

inline size_t smem_floats(const Params& p) {
  return (size_t)p.nc_buf * kT * p.cs + (size_t)kT * p.ss +
         2 * (size_t)p.buf +
         2 * (size_t)p.heads * round_up(p.L, 4);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows x cols floats (row stride rstride in device memory) into
// shared memory at dstride; rows >= vrows and columns >= vcols read 0.
__device__ __forceinline__ void stage(float* dst, int dstride,
                                      const float* src, int64_t rstride,
                                      int rows, int vrows, int cols, int vcols,
                                      bool vec) {
  const int v = vec ? 4 : 1;
  const int chunks = cols / v;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int a = i / chunks, cc = (i - a * chunks) * v;
    const bool ok = a < vrows && cc < vcols;
    cp_async(dst + a * dstride + cc, ok ? src + a * rstride + cc : src, ok,
             4 * v);
  }
}

// tf32(v) rounded to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds a finite value: add half of the 13 dropped bits, clear them (two
// integer instructions; sm_90 has no native cvt.rna.tf32, and nvcc's
// emulation of it also tests for infinities)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = kSplit ? tf32(v - __uint_as_float(hi)) : 0u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += a.b[j] for the first jn (<= J) n-tiles in the 3xTF32 split:
// the two small cross terms first, then the product of the high parts.
// Each pass runs over the tiles, so consecutive MMAs into one accumulator
// are jn apart.  jn is the same across a warp.
template <int J, int JA>
__device__ __forceinline__ void mma3_row(float (&acc)[JA][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float (&b)[J][2], int jn) {
  uint32_t bh[J][2], bl[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    split(b[j][0], bh[j][0], bl[j][0]);
    split(b[j][1], bh[j][1], bl[j][1]);
  }
  if (kSplit) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn) mma(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn) mma(acc[j], ah, bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < jn) mma(acc[j], ah, bh[j][0], bh[j][1]);
}

// the A fragment of rows (ra, ra + 8) and columns (k + tig, k + tig + 4)
// of a row-major shared-memory tile, split
__device__ __forceinline__ void a_frag(const float* t, int stride, int ra,
                                       int k, int tig, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(t[ra * stride + k + tig], ah[0], al[0]);
  split(t[(ra + 8) * stride + k + tig], ah[1], al[1]);
  split(t[ra * stride + k + tig + 4], ah[2], al[2]);
  split(t[(ra + 8) * stride + k + tig + 4], ah[3], al[3]);
}

// NJ: n-tiles of 8 columns a warp's accumulator holds; the two column
// halves of the block's warps cover a column tile of 16 NJ.  kTail: the
// last column tile is narrower (P padded to 8 is not a multiple of 16 NJ),
// and a warp skips its n-tiles past it; without a tail every warp runs all
// NJ (a run-time bound there would cost the zamba2 shapes 7% and 50
// registers, kernel_study.py's tail_mmas).  Columns past P are never
// written.
template <int NJ, bool kTail>
__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.L, G = p.G, R = p.R, N = p.N, P = p.P;
  const int nlt = (L + kT - 1) / kT;
  const int lt = nlt - 1 - (int)blockIdx.z;       // heaviest tiles first
  const int l0 = lt * kT, lend = min(l0 + kT, L);
  const int hg = blockIdx.x / p.npt, pt = blockIdx.x - hg * p.npt;
  const int r0 = hg * p.heads, hv = min(p.heads, R - r0);
  const int pbase = pt * 16 * NJ;                 // the tile's first column
  const int pcols = min(16 * NJ, p.pp8 - pbase);  // its columns, padded
  const int pvalid = min(pcols, P - pbase);       // ... and those below P
  const int64_t bc = blockIdx.y / G;
  const int g = blockIdx.y - (int)bc * G;

  float* const sC = smem;                         // nc_buf x kT x cs
  float* const sS = sC + p.nc_buf * kT * p.cs;    // kT x ss
  float* const bufs = sS + kT * p.ss;             // 2 x buf
  float* const cum = bufs + 2 * p.buf;            // heads x L4
  const int L4 = (L + 3) / 4 * 4;
  float* const dtv = cum + p.heads * L4;          // heads x L4

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rw = warp % 4, cw = warp / 4;         // row group, column half
  const int ra = 16 * rw + gid;                   // the warp's local rows
  const int la = l0 + ra, lb = la + 8;
  const int lastrow = l0 + 16 * rw + 15;
  const int c0 = cw * 8 * NJ;                     // its first tile column
  const int jn = kTail ? max(0, min(NJ, (pcols - c0) / 8)) : NJ;  // live

  // the heads' log-decay and dt columns, then cum = cumsum(log-decay)
  const int64_t gate0 = (bc * L * G + g) * R + r0;
  for (int i = threadIdx.x; i < hv * lend; i += kThreads) {
    const int h = i / lend, l = i - h * lend;
    cum[h * L4 + l] = p.ld[gate0 + (int64_t)l * G * R + h];
    dtv[h * L4 + l] = p.dt[gate0 + (int64_t)l * G * R + h];
  }
  __syncthreads();
  for (int h = warp; h < hv; h += kWarps) {
    float carry = 0.0f;
    for (int base = 0; base < lend; base += 32) {
      const int i = base + lane;
      float v = i < lend ? cum[h * L4 + i] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (i < lend) cum[h * L4 + i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }

  // The tile sequence: nsl x (lt+1) score tiles (B rows of N slice ks),
  // then per head ns s_in tiles (64 rows of N each) and lt+1 X tiles.  With
  // more than one N slice, the first tile of each slice (a score tile of
  // m tile 0, an s_in tile starting a slice) also stages that slice of C,
  // into C buffer (stage number & 1): stages ks for the scores, then
  // nsl + h nsl + ks for head h.
  const int n_mt = lt + 1, n_score = p.nsl * n_mt;
  const int ns = (p.np8 + kT - 1) / kT;
  const int per_head = ns + n_mt;
  const int tiles = n_score + hv * per_head;
  const int64_t cg = (bc * L + l0) * G + g;       // C's row l0, group g
  auto slice_cols = [&](int ks) { return min(kNS, p.np8 - ks * kNS); };
  auto c_buf = [&](int stage) {
    return sC + (p.nc_buf > 1 ? (stage & 1) : 0) * kT * p.cs;
  };
  auto stage_c = [&](int q, int ks) {
    stage(c_buf(q), p.cs, p.c + cg * N + ks * kNS, (int64_t)G * N, kT,
          L - l0, slice_cols(ks), N - ks * kNS, p.vec);
  };
  auto fetch = [&](int t) {
    float* const dst = bufs + (t & 1) * p.buf;
    if (t < n_score) {
      const int ks = t / n_mt, m0 = (t - ks * n_mt) * kT;
      if (p.nsl > 1 && m0 == 0) stage_c(ks, ks);
      stage(dst, p.cs, p.b + ((bc * L + m0) * G + g) * (int64_t)N + ks * kNS,
            (int64_t)G * N, kT, L - m0, slice_cols(ks), N - ks * kNS, p.vec);
      return;
    }
    const int h = (t - n_score) / per_head, k = (t - n_score) % per_head;
    const int64_t r = r0 + h;
    if (k < ns) {
      const int n0 = k * kT, ks = n0 / kNS;
      if (p.nsl > 1 && n0 == ks * kNS) stage_c(p.nsl * (1 + h) + ks, ks);
      stage(dst, p.xs,
            p.s_in + (((bc * G + g) * R + r) * N + n0) * P + pbase, P,
            min(kT, p.np8 - n0), N - n0, pcols, pvalid, p.vec);
    } else {
      const int m0 = (k - ns) * kT;
      stage(dst, p.xs, p.x + (((bc * L + m0) * G + g) * R + r) * P + pbase,
            (int64_t)G * R * P, kT, L - m0, pcols, pvalid, p.vec);
    }
  };

  // with one N slice, C's rows of this l tile travel with the first tile
  if (p.nsl == 1) stage_c(0, 0);
  fetch(0);
  cp_async_commit();

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();    // tile t has landed ...
    __syncthreads();        // ... for all, and tile t-1's buffer is free
    if (t + 1 < tiles) fetch(t + 1);
    cp_async_commit();
    const float* const bt = bufs + (t & 1) * p.buf;

    if (t < n_score) {
      // scores S[l, m] for the warp's 16 rows and its half of the tile's
      // 64 m columns, SG n-tiles at a time in the first SG accumulators,
      // over N slice ks (added to the earlier slices' sums)
      constexpr int SG = NJ < kT / 16 ? NJ : kT / 16;
      const int ks = t / n_mt, m0 = (t - ks * n_mt) * kT;
      const int kw = slice_cols(ks);
      const float* const sc = c_buf(ks);
      for (int jg = cw * kT / 16; jg < (cw + 1) * kT / 16; jg += SG) {
        for (int kk = 0; kk < kw; kk += 8) {
          uint32_t ah[4], al[4];
          a_frag(sc, p.cs, ra, kk, tig, ah, al);
          float bv[SG][2];
#pragma unroll
          for (int j = 0; j < SG; ++j) {
            const float* const bj = bt + (8 * (jg + j) + gid) * p.cs + kk + tig;
            bv[j][0] = bj[0];
            bv[j][1] = bj[4];
          }
          mma3_row(acc, ah, al, bv, SG);
        }
#pragma unroll
        for (int j = 0; j < SG; ++j) {
          const int m = m0 + 8 * (jg + j) + 2 * tig;
          float* const s0 = sS + ra * p.ss + m;
          float* const s1 = sS + (ra + 8) * p.ss + m;
          if (ks == 0) {
            s0[0] = acc[j][0];
            s0[1] = acc[j][1];
            s1[0] = acc[j][2];
            s1[1] = acc[j][3];
          } else {
            s0[0] += acc[j][0];
            s0[1] += acc[j][1];
            s1[0] += acc[j][2];
            s1[1] += acc[j][3];
          }
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        }
      }
      continue;
    }

    const int h = (t - n_score) / per_head, k = (t - n_score) % per_head;
    const float* const ch = cum + h * L4;
    const float* const dh = dtv + h * L4;
    if (k < ns) {
      // acc += C[l, n0 + .] . s_in[n0 + ., :], C from its slice's buffer
      const int n0 = k * kT, kr = min(kT, p.np8 - n0), ks = n0 / kNS;
      const float* const sc = c_buf(p.nsl * (1 + h) + ks);
      for (int kk = 0; kk < kr; kk += 8) {
        uint32_t ah[4], al[4];
        a_frag(sc, p.cs, ra, n0 - ks * kNS + kk, tig, ah, al);
        float bv[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* const bj = bt + (kk + tig) * p.xs + c0 + 8 * j + gid;
          bv[j][0] = bj[0];
          bv[j][1] = bj[4 * p.xs];
        }
        mma3_row(acc, ah, al, bv, jn);
      }
      if (k == ns - 1) {    // the inter-chunk term is scaled by exp(cum[l])
        const float ea = la < L ? expf(ch[min(la, lend - 1)]) : 0.0f;
        const float eb = lb < L ? expf(ch[min(lb, lend - 1)]) : 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[j][0] *= ea;
          acc[j][1] *= ea;
          acc[j][2] *= eb;
          acc[j][3] *= eb;
        }
      }
      continue;
    }

    // acc += W[l, m0 + .] . X[m0 + ., :], W masked before the exponential
    const int mt = k - ns, m0 = mt * kT;
    const float ca = ch[min(la, lend - 1)], cb = ch[min(lb, lend - 1)];
    // W[l, m] = S[l, m] exp(cum[l] - cum[m]) dt[m] for m <= l < L, else 0;
    // indices clamped into the staged rows, the masked difference never
    // reaches the exponential.  __expf (ex2.approx of x log2 e) errs by
    // ~6e-8 |x| relative, under 1e-5 for the |cum| of a 256-step chunk
    auto weight = [&](int row, int l, float cl, int m) {
      const bool ok = m <= l && l < L;
      const int mc = min(m, lend - 1);   // every load in range: no branch
      const float e = __expf(ok ? cl - ch[mc] : 0.0f);
      const float w = sS[row * p.ss + mc] * e * dh[mc];
      return ok ? w : 0.0f;
    };
    for (int kk = 0; kk < kT; kk += 8) {
      const int mk = m0 + kk;
      if (mk > lastrow) break;
      const int m1 = mk + tig, m2 = m1 + 4;
      const float w[4] = {weight(ra, la, ca, m1), weight(ra + 8, lb, cb, m1),
                          weight(ra, la, ca, m2), weight(ra + 8, lb, cb, m2)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(w[i], ah[i], al[i]);
      float bv[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* const bj = bt + (kk + tig) * p.xs + c0 + 8 * j + gid;
        bv[j][0] = bj[0];
        bv[j][1] = bj[4 * p.xs];
      }
      mma3_row(acc, ah, al, bv, jn);
    }
    if (mt == lt) {         // the head is done: write its rows
      const int64_t r = r0 + h;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pc = pbase + c0 + 8 * j + 2 * tig;
        if (la < L) {
          float* const ya = p.y + (((bc * L + la) * G + g) * R + r) * P;
          if (pc < P) ya[pc] = acc[j][0];
          if (pc + 1 < P) ya[pc + 1] = acc[j][1];
        }
        if (lb < L) {
          float* const yb = p.y + (((bc * L + lb) * G + g) * R + r) * P;
          if (pc < P) yb[pc] = acc[j][2];
          if (pc + 1 < P) yb[pc + 1] = acc[j][3];
        }
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      }
    }
  }
  cp_async_wait_all();
}

template <int NJ, bool kTail>
cudaError_t launch(const Params& p, int64_t BC, cudaStream_t stream) {
  const size_t bytes = smem_floats(p) * sizeof(float);
  // above 48 KB the size is opted in to; the attribute belongs to the
  // current device, so it is set at every launch (a host-side call)
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_kernel<NJ, kTail>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((p.R + p.heads - 1) / p.heads * p.npt),
                  (unsigned)(BC * p.G), (unsigned)((p.L + kT - 1) / kT));
  ssd_intra_kernel<NJ, kTail><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_nj(const Params& p, int64_t BC, cudaStream_t stream) {
  return p.pp8 % (16 * NJ) ? launch<NJ, true>(p, BC, stream)
                           : launch<NJ, false>(p, BC, stream);
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
  Params p = make_params(x, ld, dt, b, c, s_in, y, L, G, R, N, P);
  p.heads = kHeads ? kHeads : heads_for(BC, L, G, R, p.npt);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p.nj) {
    case 1: return launch_nj<1>(p, BC, st);
    case 2: return launch_nj<2>(p, BC, st);
    case 4: return launch_nj<4>(p, BC, st);
    default: return launch_nj<8>(p, BC, st);
  }
}

int ssd_max_dims(int which) {   // 0: L, 1: N, 2: P
  return which == 0 ? kMaxL : which == 1 ? kMaxN : kMaxP;
}

// Heads a block takes at this shape (chip_smoke.py and the study print it).
int ssd_heads_per_block(int64_t BC, int L, int G, int R, int P) {
  return kHeads ? kHeads
                : heads_for(BC, L, G, R, column_tiles(round_up(P, 8)));
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
