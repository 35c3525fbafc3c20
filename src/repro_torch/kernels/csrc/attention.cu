// FLASH_ATTENTION: online-softmax attention, hand-written for Hopper
// (sm_90a), in three routes.
//
// Replaces src/repro/kernels/attention.py:flash_attention (its _flash_body),
// the TPU kernel that kept a q block, its f32 accumulator and its running
// max and sum in VMEM while K/V blocks streamed past.  It computes what the
// reference's two __kernel__attention regions compute
// (src/repro/models/attention.py: full_mha and chunked_mha), in their BSHD
// layout, so the model needs no transpose:
//
//   q (B, Sq, H, D), k/v (B, Sk, KH, D), GQA through h / (H / KH);
//   logits = (q . k) * scale in float32; masked logits are -1e30, not -inf,
//   so that a row whose every key is masked is the mean of v, as in the
//   reference; keys past Sk do not exist (weight 0);
//   mask = (!causal || kpos <= qpos + q_offset || kpos < prefix_len)
//          && kpos < valid[b]      (valid: one length per batch row, or one
//                                   for all of them);
//   k and v are read in q's dtype (a float32 cache is rounded to bf16 on
//   load when q is bf16, as the reference casts the cache before attending);
//   softmax, accumulator and the final division in float32, the output in
//   q's dtype.
//
// Every route takes D in {32, 64, 112, 128, 256} (112: kimi-k2's 7168 / 64;
// 256: paligemma-3b's heads), with the same 1 / sqrt(D) scale the wrapper
// passes.  Routing table (the
// wrapper, kernels/attention_cuda.py:route, picks the route; each entry
// point below takes only its own inputs):
//
//   q dtype   k/v dtype        Sq     route
//   bf16      bf16             > 8    A  tensor-core prefill
//   bf16      bf16 or float32  <= 8   B  split-K decode
//   bf16      float32          > 8    C  CUDA-core kernel
//   float32   any              any    C  CUDA-core kernel
//
// Every block of every route finds the keys its rows can see as [0, end):
// the causal limit of its last row (or prefix_len), the valid length; the
// keys after `end` would add exactly 0.  Only when a row sees no key at all
// (valid 0, or q_offset < 0 with no prefix) does it walk every key, since
// such a row averages v over all Sk keys.
//
// A. Tensor-core prefill (bf16 q, bf16 k/v, Sq > 8; chunked_mha and the
//    zamba2 prefill).  What bounds it on an H100: at B 1, S 1024, 32 heads,
//    D 64, causal the work is ~4.3 GFLOP against ~12.6 MB, so the bf16
//    tensor cores (989 TFLOP/s) set the bound.  The design (FlashAttention-2's
//    layout on mma.sync):
//    * one block of 4 warps per (batch.head, 64-row q tile); q tiles go
//      heaviest first (the last tile, which sees the most keys, is in the
//      first wave), so the causal tail does not leave SMs idle;
//    * K and V tiles of 64 keys (32 at D 256) are staged in a two-stage
//      shared-memory ring by cp.async (commit/wait_group): tile t + 1 is in
//      flight while tile t is computed; rows are padded by 16 bytes so that ldmatrix reads hit
//      eight distinct bank groups (a padded row is an odd number of 16-byte
//      groups at every D taken: 5, 9, 15, 17 and 33 at D 32, 64, 112, 128,
//      256);
//    * each warp owns 16 q rows; Q.K^T runs as mma.sync.m16n8k16 bf16 with
//      f32 accumulation (the bf16 products are exact in f32, as in the
//      reference's f32 einsum), fragments loaded with ldmatrix; Q's
//      fragments stay in registers up to D 128; at D 256, where the O
//      accumulator alone takes 128 registers a thread, each k-step re-reads
//      its Q fragment from shared memory and K/V tiles are 32 keys, so that
//      nothing spills (101,376 bytes of shared memory a block: two blocks
//      an SM);
//    * the online softmax runs in registers (a quad of lanes shares a row:
//      two shuffles per reduction), in base 2 with scale * log2(e) folded in;
//    * only the tiles that cross the causal diagonal, the valid length or Sk
//      evaluate the mask; the others only scale;
//    * P.V: P must enter the tensor cores in 16 bits, where the reference
//      keeps it in f32.  P is split into bf16 hi + lo (lo = P - hi, rounded)
//      and both go through the MMA with the same V fragments (ldmatrix
//      .trans), so P carries ~16 significant bits and the error stays far
//      below one bf16 ulp of the output; the cost is a third more MMAs;
//    * the output goes from registers to memory as bf16 pairs.
//
// B. Split-K decode (bf16 q, f32 or bf16 k/v, Sq <= 8; decode_mha with the
//    float32 cache).  What bounds it: the bytes of the cache rows it must
//    read (B 4, 4,096-row f32 cache, 37..4,000 valid: 116.5 MB, 35 us at
//    3.35 TB/s); the few query rows make it 2 FLOP per byte, so tensor
//    cores buy nothing.  The design (flash-decoding):
//    * the grid is sized from Sk, never from `valid` (a device tensor; reading
//      it back would synchronise the host): 256-key splits (128 where a
//      block serves 4 or more rows, as at llama3's GQA, whose kv heads are
//      fewer) x B.KH x row groups; a block whose split starts at or past
//      its rows' visible end writes an empty partial (m = -inf, l = 0) and
//      takes its ticket;
//    * one block serves all H/KH query heads of its kv head (and the Sq <= 8
//      rows; up to 8 rows a block), so each cache row is read once;
//    * the rows are read with 16-byte vector loads, a few lanes a row (f32
//      D 64: 16 lanes, two keys a warp instruction; D 112, whose rows are
//      not a power of two of chunks: 32 lanes for f32, 16 for bf16, the
//      last few idle; f32 D 256, 64 chunks: the warp, two chunks a lane),
//      rounded to bf16 on load;
//      the logits go to shared memory, each row's max and sum are taken by
//      one warp, then P.V in f32 FMAs, reduced across warps in shared memory;
//    * the combine runs in the same launch: each block writes its partial
//      (m, l, acc), the last block of a (batch, kv head, row group) to take
//      a ticket (atomicAdd on a counter, which it re-arms to 0) merges them:
//      M = max m_s, O = sum acc_s 2^(m_s - M) / sum l_s 2^(m_s - M).  A split
//      whose keys are all masked for a row has m = -1e30 and weight 0 once
//      any split is real; a row that sees no key has every split at -1e30,
//      and the merge is the mean of v over all Sk keys, as in the reference.
//
// C. CUDA-core kernel (float32 q: its 2e-5 tolerance rules out bf16 or tf32
//    products; bf16 q with a float32 k/v at Sq > 8).  Bound as A or by
//    bytes; it runs on the float32 CUDA cores (67 TFLOP/s) and is further
//    limited by shared-memory loads (about one per FMA):
//    * one block of 256 threads per (batch, head, BQ-row q tile); the q tile
//      is staged in shared memory once, as float32;
//    * the block walks 64-key tiles of K and V, staged in shared memory as
//      float32 (strides padded by one float so that the rows a warp reads
//      fall in distinct banks);
//    * TPR threads share a q row: each computes the logits of 64/TPR keys
//      and owns D/TPR output columns; the row's max and sum are reduced with
//      warp shuffles and its probabilities go through shared memory to the
//      P.V product, all float32 FMAs;
//    * Sq > 8 uses BQ = 64 rows and TPR = 4; Sq <= 8 uses BQ = 8 and
//      TPR = 32, so that a single query row keeps a whole warp busy (D 112,
//      not a multiple of 32: BQ = 16 and TPR = 16, half a warp a row).
//
// Each extern "C" launcher enqueues its kernel on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMasked = -1e30f;     // the reference's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t B, Sq, Sk, H, KH;
  int64_t q_sb, q_ss, q_sh;           // strides in elements; last dim is 1
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale;
  int causal;
  int64_t q_offset, prefix_len;
  const int64_t* valid;               // (B,) or null
  int64_t valid_all;                  // used when valid is null
};

// The keys rows q_first..q_last of batch row b can see: [0, end); kv_valid
// is min(valid[b], Sk).  A row that sees no key walks all Sk of them.
struct KeyRange {
  int64_t kv_valid, end;
};

__device__ __forceinline__ KeyRange key_range(const Params& p, int64_t b,
                                              int64_t q_first,
                                              int64_t q_last) {
  const int64_t valid = p.valid ? p.valid[b] : p.valid_all;
  const int64_t kv_valid = valid < p.Sk ? valid : p.Sk;
  int64_t end = kv_valid;
  bool blind_row = kv_valid <= 0;
  if (p.causal) {
    int64_t hi = q_last + p.q_offset + 1;
    if (hi < p.prefix_len) hi = p.prefix_len;
    if (hi < end) end = hi;
    if (q_first + p.q_offset < 0 && p.prefix_len <= 0) blind_row = true;
  }
  if (blind_row) end = p.Sk;
  return {kv_valid, end};
}

__device__ __forceinline__ bool sees(const Params& p, int64_t kv_valid,
                                     int64_t qpos, int64_t kpos) {
  return kpos < kv_valid &&
         (!p.causal || kpos <= qpos + p.q_offset || kpos < p.prefix_len);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// a k/v element read in q's dtype, as float32
template <typename Tq, typename Tkv>
__device__ __forceinline__ float kv_load(const Tkv* p) {
  float x = to_f32(*p);
  if constexpr (std::is_same<Tq, __nv_bfloat16>::value &&
                std::is_same<Tkv, float>::value)
    x = round_bf16(x);
  return x;
}

// ===========================================================================
// C. The CUDA-core kernel
// ===========================================================================
namespace cores {

constexpr int kThreads = 256;
constexpr int kBK = 64;               // keys per staged tile

template <int D, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)BQ * (kBK + 1);
}

template <typename Tq, typename Tkv, int D, int BQ, int TPR>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  static_assert(BQ * TPR == kThreads, "BQ x TPR must be the block");
  static_assert(kBK % TPR == 0 && D % TPR == 0, "TPR divides keys and D");
  constexpr int KPT = kBK / TPR;      // keys per thread
  constexpr int DPT = D / TPR;        // output columns per thread
  constexpr int QS = D + 1, KS = D + 1, PS = kBK + 1;
  extern __shared__ float smem[];
  float* const sQ = smem;
  float* const sK = sQ + BQ * QS;
  float* const sV = sK + kBK * KS;
  float* const sP = sV + kBK * D;

  const int tid = threadIdx.x;
  const int r = tid / TPR, t = tid % TPR;
  const int64_t b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int64_t kvh = h / (p.H / p.KH);
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const Tq* qb = (const Tq*)p.q + b * p.q_sb + h * p.q_sh;
  const Tkv* kb = (const Tkv*)p.k + b * p.k_sb + kvh * p.k_sh;
  const Tkv* vb = (const Tkv*)p.v + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    const int64_t qi = q0 + rr;
    sQ[rr * QS + dd] = qi < p.Sq ? to_f32(qb[qi * p.q_ss + dd]) : 0.0f;
  }

  const int64_t last_q = (q0 + BQ < p.Sq ? q0 + BQ : p.Sq) - 1;
  const KeyRange kr = key_range(p, b, q0, last_q);
  const int64_t qpos = q0 + r;
  // warp-uniform: does this warp hold any row of the output?
  const bool warp_live = q0 + (tid / 32) * (32 / TPR) < p.Sq;
  float m = kMasked, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.0f;

  for (int64_t k0 = 0; k0 < kr.end; k0 += kBK) {
    __syncthreads();                  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, dd = i % D;
      const int64_t kj = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kj < p.Sk) {
        kx = kv_load<Tq>(kb + kj * p.k_ss + dd);
        vx = kv_load<Tq>(vb + kj * p.v_ss + dd);
      }
      sK[j * KS + dd] = kx;
      sV[j * D + dd] = vx;
    }
    __syncthreads();
    if (!warp_live) continue;

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float qv = sQ[r * QS + dd];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj)
        s[jj] = fmaf(qv, sK[(t + jj * TPR) * KS + dd], s[jj]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int64_t kpos = k0 + t + jj * TPR;
      s[jj] = kpos >= p.Sk ? -INFINITY
              : sees(p, kr.kv_valid, qpos, kpos) ? s[jj] * p.scale
                                                  : kMasked;
      tile_max = fmaxf(tile_max, s[jj]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float pv = expf(s[jj] - m_new);
      psum += pv;
      sP[r * PS + t + jj * TPR] = pv;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                     // a row's P is written by its own warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float pj = sP[r * PS + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(pj, sV[j * D + t + i * TPR], acc[i]);
    }
  }

  if (qpos < p.Sq) {
    const float denom = fmaxf(l, 1e-30f);
    Tq* o = (Tq*)p.out + ((b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[t + i * TPR] = from_f32<Tq>(acc[i] / denom);
  }
}

template <typename Tq, typename Tkv, int D, int BQ, int TPR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = flash_kernel<Tq, Tkv, D, BQ, TPR>;
  const size_t bytes = smem_floats<D, BQ>() * sizeof(float);
  // above 48 KB the size is opted in to; the attribute belongs to the
  // current device, so it is set at every launch (a host-side call)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)(p.B * p.H));
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv, int D>
cudaError_t by_rows(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<Tq, float>::value) {  // bf16 q: Sq > 8 only
    if (p.Sq <= 8) {
      if constexpr (D % 32 == 0) return launch<Tq, Tkv, D, 8, 32>(p, stream);
      else return launch<Tq, Tkv, D, 16, 16>(p, stream);   // D 112
    }
  }
  return launch<Tq, Tkv, D, 64, 4>(p, stream);
}

template <typename Tq, typename Tkv>
cudaError_t by_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return by_rows<Tq, Tkv, 32>(p, stream);
    case 64: return by_rows<Tq, Tkv, 64>(p, stream);
    case 112: return by_rows<Tq, Tkv, 112>(p, stream);
    case 128: return by_rows<Tq, Tkv, 128>(p, stream);
    case 256: return by_rows<Tq, Tkv, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cores

// ===========================================================================
// A. The tensor-core prefill
// ===========================================================================
namespace tc {

constexpr int kBQ = 64;               // q rows a block (16 a warp)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

using bf16 = __nv_bfloat16;

// bf16 elements per staged row: D plus 16 bytes, so the eight rows an
// ldmatrix reads start in eight distinct 16-byte bank groups
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// Up to D 128 a staged tile is 64 keys and Q's fragments stay in registers
// for the whole kernel.  At D 256 a warp's O accumulator alone is 16 x 256
// f32, 128 registers a thread; Q's 16 k-steps would add 64 more and S's 8
// tiles of a 64-key tile 32, past the 255 a thread may hold.  There each
// k-step re-reads its Q fragment from shared memory (Q stays staged there
// for the whole kernel: one more ldmatrix for every two MMAs of Q.K^T),
// and a tile is 32 keys (S in 4 tiles, 16 registers): with 64-key tiles
// the kernel still spills (attention_study.py, variant
// prefill_d256_64_keys), with 32 it does not.
template <int D>
__host__ __device__ constexpr int block_keys() { return D > 128 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr bool q_in_registers() { return D <= 128; }

template <int D>
constexpr size_t smem_bytes() {   // Q, then K and V in two stages each
  return (size_t)(kBQ + 4 * block_keys<D>()) * row_stride<D>() * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8, f32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix with the given row
// stride into shared memory; rows at or past n_rows are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int64_t stride, int64_t row0,
                                           int64_t n_rows, int tid) {
  constexpr int kChunks = D / 8;      // 16-byte chunks a row
  constexpr int S = row_stride<D>();
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int64_t g = row0 + r;
    const bool ok = g < n_rows;
    cp_async16(smem_addr(dst + r * S + c * 8),
               ok ? src + g * stride + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) prefill_kernel(Params p) {
  constexpr int S = row_stride<D>();
  constexpr int kBK = block_keys<D>();
  constexpr bool kQRegs = q_in_registers<D>();
  constexpr int KD = D / 16;          // k-steps of Q.K^T
  constexpr int NT = kBK / 8;         // 8-key column tiles of S
  constexpr int ND = D / 8;           // 8-column tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* const sK = sQ + kBQ * S;      // two stages
  bf16* const sV = sK + 2 * kBK * S;  // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int64_t kvh = h / (p.H / p.KH);
  // heaviest first: blockIdx.y 0 is the last q tile
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const bf16* qb = (const bf16*)p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = (const bf16*)p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = (const bf16*)p.v + b * p.v_sb + kvh * p.v_sh;

  const int64_t last_q = (q0 + kBQ < p.Sq ? q0 + kBQ : p.Sq) - 1;
  const KeyRange kr = key_range(p, b, q0, last_q);
  const int n_tiles = (int)((kr.end + kBK - 1) / kBK);
  // keys every row of the tile sees, whatever the mask: [0, full_end)
  int64_t full_end = kr.kv_valid;
  if (p.causal) {
    int64_t lim = q0 + p.q_offset + 1;
    if (lim < p.prefix_len) lim = p.prefix_len;
    if (lim < full_end) full_end = lim;
  }

  stage_rows<D, kBQ>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  stage_rows<D, kBK>(sK, kb, p.k_ss, 0, p.Sk, tid);
  stage_rows<D, kBK>(sV, vb, p.v_ss, 0, p.Sk, tid);
  cp_async_commit();

  // this thread's two rows (groupID and groupID + 8 of the warp's 16) and
  // the two columns of each 8-wide tile it holds
  const int64_t row_a = q0 + warp * 16 + lane / 4, row_b = row_a + 8;
  const int col = (lane % 4) * 2;
  const float sl2 = p.scale * kLog2e;

  // this warp's Q fragment of k-step kk is at q_frag + 32 kk bytes
  const uint32_t q_frag =
      smem_addr(sQ + (warp * 16 + lane % 16) * S + (lane / 16) * 8);
  uint32_t qf[kQRegs ? KD : 1][4];
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.0f, l_b = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {            // the next tile into the other stage
      const int64_t k1 = (int64_t)(t + 1) * kBK;
      stage_rows<D, kBK>(sK + (st ^ 1) * kBK * S, kb, p.k_ss, k1, p.Sk, tid);
      stage_rows<D, kBK>(sV + (st ^ 1) * kBK * S, vb, p.v_ss, k1, p.Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile t (and at t = 0, Q) has landed
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 32);
      }
    }
    const bf16* sKt = sK + st * kBK * S;
    const bf16* sVt = sV + st * kBK * S;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_frag + kk * 32);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4];               // key tiles j, j + 1; d halves lo, hi
        ldmatrix_x4(kf, smem_addr(sKt + ((j + lane / 16) * 8 + lane % 8) * S +
                                  kk * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[j], a, kf[0], kf[1]);
        mma_bf16(s[j + 1], a, kf[2], kf[3]);
      }
    }

    const int64_t k0 = (int64_t)t * kBK;
    if (k0 + kBK <= full_end) {       // no key of this tile is masked
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t kpos = k0 + j * 8 + col + (e & 1);
          const int64_t qpos = e < 2 ? row_a : row_b;
          s[j][e] = kpos >= p.Sk ? -INFINITY
                    : sees(p, kr.kv_valid, qpos, kpos) ? s[j][e] * sl2
                                                        : kMasked;
        }
    }

    // online softmax, base 2; a row lives on a quad of lanes
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mx_a);
      s[j][1] = exp2f(s[j][1] - mx_a);
      s[j][2] = exp2f(s[j][2] - mx_b);
      s[j][3] = exp2f(s[j][3] - mx_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + sum_a;      // this lane's share; reduced at the end
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      o[i][0] *= alpha_a;
      o[i][1] *= alpha_a;
      o[i][2] *= alpha_b;
      o[i][3] *= alpha_b;
    }

    // O += P V, P as bf16 hi + lo: the accumulator layout of S tiles
    // (2kt, 2kt + 1) is the A layout of keys 16kt..16kt + 15
#pragma unroll
    for (int kt = 0; kt < kBK / 16; ++kt) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
      split_pair(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
      split_pair(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int i = 0; i < ND; i += 2) {
        uint32_t vf[4];               // d tiles i, i + 1; keys lo, hi
        ldmatrix_x4_trans(vf, smem_addr(sVt + (kt * 16 + ((lane / 8) % 2) * 8 +
                                               lane % 8) * S +
                                        (i + lane / 16) * 8));
        mma_bf16(o[i], ph, vf[0], vf[1]);
        mma_bf16(o[i + 1], ph, vf[2], vf[3]);
        mma_bf16(o[i], pl, vf[0], vf[1]);
        mma_bf16(o[i + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                  // stage st is free for tile t + 2
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  bf16* const out = (bf16*)p.out;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    if (row_a < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((b * p.Sq + row_a) * p.H + h) * D + i * 8 + col) =
          __floats2bfloat162_rn(o[i][0] * inv_a, o[i][1] * inv_a);
    if (row_b < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((b * p.Sq + row_b) * p.H + h) * D + i * 8 + col) =
          __floats2bfloat162_rn(o[i][2] * inv_b, o[i][3] * inv_b);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = prefill_kernel<D>;
  const size_t bytes = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ===========================================================================
// B. The split-K decode
// ===========================================================================
namespace dec {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// keys a block: 256; 128 where a block serves 4 or more query rows (GQA),
// whose kv heads are fewer, so that the grid still fills the card
template <int RB>
__host__ __device__ constexpr int split_keys() { return RB >= 4 ? 128 : 256; }

// the least power of two >= n: the lanes a key row takes
__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// 16 bytes of k/v as float32, rounded to bf16 (q is bf16 on this route)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = round_bf16(__uint_as_float(u.x));
  f[1] = round_bf16(__uint_as_float(u.y));
  f[2] = round_bf16(__uint_as_float(u.z));
  f[3] = round_bf16(__uint_as_float(u.w));
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Block (split, batch.kv head, row group): rows r of the group are the
// query rows g * RB + r of the (Sq x rep) rows of its kv head, numbered
// qi * rep + head-in-group.  Partials: acc (.., RB, D), (m, l) (.., RB).
// A key row is CPR 16-byte chunks over LPR lanes, the power of two at or
// above CPR, so that the shuffle reductions stay butterflies: at D 112 a
// float32 row is 28 chunks on 32 lanes and a bf16 row 14 on 16; the lanes
// past CPR load nothing and add zeros.  A row of more than 32 chunks
// (float32 at D 256: 1,024 bytes, 64 chunks) takes the whole warp, CPL
// chunks a lane, chunk c of a lane at c * 32 + lane, so that each warp
// load still reads 512 contiguous bytes.
// Blocks an SM, so that enough loads are in flight: one row of D <= 64
// fits 85 registers a thread (three blocks), up to four rows of D <= 128
// fit 128 (two); tighter caps spill, and so does D 256 at 128 (its q
// and acc columns are twice D 128's), which takes one block.  The
// cross-warp sum of P.V goes through kWarps x RB x D floats of dynamic
// shared memory: at D 256 and 8 rows that is 64 KB, past the 48 KB of
// static shared memory.

template <typename Tkv, int D, int RB>
__global__ void __launch_bounds__(kThreads,
                                  RB == 1 && D <= 64        ? 3
                                  : RB <= 4 && D <= 128 ? 2
                                                        : 1)
    decode_kernel(Params p, float* part_acc, float2* part_ml, int* tickets) {
  constexpr int kSplit = split_keys<RB>();
  constexpr int E = 16 / (int)sizeof(Tkv);   // elements a 16-byte load
  constexpr int CPR = D / E;                 // 16-byte chunks a key row
  constexpr int CPL = CPR > 32 ? CPR / 32 : 1;           // chunks a lane
  constexpr int LPR = CPR > 32 ? 32 : pow2_at_least(CPR);  // lanes a row
  constexpr int KPI = 32 / LPR;              // keys a warp instruction
  constexpr int STEPS = kSplit / (kWarps * KPI);
  constexpr int CH = STEPS < 8 / CPL ? STEPS : 8 / CPL;  // keys in flight
  static_assert(D % E == 0 && (CPR <= 32 || CPR % 32 == 0) &&
                    STEPS % CH == 0,
                "row must fit a warp");
  // the loops over a split's keys are unrolled whole, but where a row takes
  // two chunks a lane and a block serves one or two rows (256-key splits):
  // there the whole unrolled loop's loads, hoisted, would not fit 255
  // registers
  constexpr int kUnroll = CPL > 1 && RB <= 2 ? 1 : STEPS / CH;
  __shared__ float s_p[RB][kSplit];          // logits, then probabilities
  extern __shared__ float s_red[];           // [kWarps][RB][D]
  __shared__ float s_m[RB], s_l[RB];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  const bool live = sub < CPR;               // this lane holds a chunk
  const int64_t b = blockIdx.y / p.KH, kvh = blockIdx.y % p.KH;
  const int64_t rep = p.H / p.KH, rows = p.Sq * rep;
  const int64_t g0 = (int64_t)blockIdx.z * RB;
  const int64_t ticket = (int64_t)blockIdx.y * gridDim.z + blockIdx.z;
  const int n_split = gridDim.x, split = blockIdx.x;
  const int64_t part = (ticket * n_split + split) * RB;   // first partial row
  const Tkv* kb = (const Tkv*)p.k + b * p.k_sb + kvh * p.k_sh;
  const Tkv* vb = (const Tkv*)p.v + b * p.v_sb + kvh * p.v_sh;

  const int64_t g_last = (g0 + RB < rows ? g0 + RB : rows) - 1;
  const KeyRange kr = key_range(p, b, g0 / rep, g_last / rep);
  const int64_t k0 = (int64_t)split * kSplit;
  const float sl2 = p.scale * kLog2e;

  if (k0 >= kr.end) {                 // nothing of this split is seen
    if (tid < RB) part_ml[part + tid] = make_float2(-INFINITY, 0.0f);
  } else {
    const int64_t kend = kr.end < k0 + kSplit ? kr.end : k0 + kSplit;
    // this lane's CPL x E columns of each row's q
    float qv[RB][CPL][E];
    int64_t qpos[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int64_t g = g0 + r;
      qpos[r] = g / rep;
      const int64_t h = kvh * rep + g % rep;
      const __nv_bfloat16* qr = (const __nv_bfloat16*)p.q + b * p.q_sb +
                                qpos[r] * p.q_ss + h * p.q_sh + sub * E;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < E; ++e)
          qv[r][c][e] =
              live && g < rows ? to_f32(qr[c * LPR * E + e]) : 0.0f;
    }

    // logits: a warp takes kSplit / 8 consecutive keys, KPI at a time
#pragma unroll(kUnroll)
    for (int s0 = 0; s0 < STEPS; s0 += CH) {
      uint4 raw[CH][CPL];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int64_t j = k0 + (int64_t)(warp * STEPS + s0 + c) * KPI + grp;
#pragma unroll
        for (int u = 0; u < CPL; ++u)
          raw[c][u] =
              live && j < kend
                  ? __ldg(reinterpret_cast<const uint4*>(kb + j * p.k_ss) +
                          u * LPR + sub)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int jj = (warp * STEPS + s0 + c) * KPI + grp;
        const int64_t j = k0 + jj;
        float kf[CPL][E];
#pragma unroll
        for (int u = 0; u < CPL; ++u) unpack(raw[c][u], kf[u]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float d = 0.0f;
#pragma unroll
          for (int u = 0; u < CPL; ++u)
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qv[r][u][e], kf[u][e], d);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          if (sub == 0)
            s_p[r][jj] = j >= p.Sk ? -INFINITY
                         : j < kend && sees(p, kr.kv_valid, qpos[r], j)
                             ? d * sl2
                             : kMasked;
        }
      }
    }
    __syncthreads();

    // each row's max and sum over the split, one warp a row
    if (warp < RB) {
      float v[kSplit / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kSplit / 32; ++i) {
        v[i] = s_p[warp][lane + 32 * i];
        mx = fmaxf(mx, v[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kSplit / 32; ++i) {
        v[i] = exp2f(v[i] - mx);
        sum += v[i];
        s_p[warp][lane + 32 * i] = v[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        s_m[warp] = mx;
        s_l[warp] = sum;
      }
    }
    __syncthreads();

    // acc = P V over the split's keys
    float acc[RB][CPL][E];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][u][e] = 0.0f;
#pragma unroll(kUnroll)
    for (int s0 = 0; s0 < STEPS; s0 += CH) {
      uint4 raw[CH][CPL];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int64_t j = k0 + (int64_t)(warp * STEPS + s0 + c) * KPI + grp;
#pragma unroll
        for (int u = 0; u < CPL; ++u)
          raw[c][u] =
              live && j < kend
                  ? __ldg(reinterpret_cast<const uint4*>(vb + j * p.v_ss) +
                          u * LPR + sub)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int jj = (warp * STEPS + s0 + c) * KPI + grp;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          float vf[E];
          unpack(raw[c][u], vf);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float pr = s_p[r][jj];
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][u][e] = fmaf(pr, vf[e], acc[r][u][e]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int u = 0; u < CPL; ++u)
#pragma unroll
        for (int e = 0; e < E; ++e) {
#pragma unroll
          for (int off = 16; off >= LPR; off >>= 1)
            acc[r][u][e] += __shfl_xor_sync(0xffffffffu, acc[r][u][e], off);
          if (grp == 0 && live)
            s_red[(warp * RB + r) * D + (u * LPR + sub) * E + e] =
                acc[r][u][e];
        }
    __syncthreads();
    for (int i = tid; i < RB * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_red[(w * RB + r) * D + d];
      part_acc[(part + r) * D + d] = sum;
    }
    if (tid < RB) part_ml[part + tid] = make_float2(s_m[tid], s_l[tid]);
  }

  // the last block of this (batch, kv head, row group) merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(&tickets[ticket], 1);
    s_last = t == n_split - 1;
    if (s_last) atomicExch(&tickets[ticket], 0);   // re-armed for the next
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int64_t first = ticket * n_split * RB;
  for (int i = tid; i < RB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int64_t g = g0 + r;
    if (g >= rows) continue;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(&part_ml[first + (int64_t)s * RB + r]).x);
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float2 ml = __ldcg(&part_ml[first + (int64_t)s * RB + r]);
      if (ml.x == -INFINITY) continue;       // an empty split
      const float w = exp2f(ml.x - mx);
      den = fmaf(ml.y, w, den);
      num = fmaf(__ldcg(&part_acc[(first + (int64_t)s * RB + r) * D + d]), w,
                 num);
    }
    const int64_t qi = g / rep, h = kvh * rep + g % rep;
    ((__nv_bfloat16*)p.out)[((b * p.Sq + qi) * p.H + h) * D + d] =
        __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <typename Tkv, int D, int RB>
cudaError_t launch(const Params& p, int groups, float* part_acc,
                   float2* part_ml, int* tickets, cudaStream_t stream) {
  constexpr int kSplit = split_keys<RB>();
  auto kernel = decode_kernel<Tkv, D, RB>;
  const size_t bytes = (size_t)kWarps * RB * D * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sk + kSplit - 1) / kSplit),
                  (unsigned)(p.B * p.KH), (unsigned)groups);
  kernel<<<grid, kThreads, bytes, stream>>>(p, part_acc, part_ml, tickets);
  return cudaGetLastError();
}

template <typename Tkv, int D>
cudaError_t by_rows(const Params& p, int rb, int groups, float* part_acc,
                    float2* part_ml, int* tickets, cudaStream_t stream) {
  switch (rb) {
    case 1: return launch<Tkv, D, 1>(p, groups, part_acc, part_ml, tickets,
                                     stream);
    case 2: return launch<Tkv, D, 2>(p, groups, part_acc, part_ml, tickets,
                                     stream);
    case 4: return launch<Tkv, D, 4>(p, groups, part_acc, part_ml, tickets,
                                     stream);
    case 8: return launch<Tkv, D, 8>(p, groups, part_acc, part_ml, tickets,
                                     stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Tkv>
cudaError_t by_dim(const Params& p, int D, int rb, int groups,
                   float* part_acc, float2* part_ml, int* tickets,
                   cudaStream_t stream) {
  switch (D) {
    case 32: return by_rows<Tkv, 32>(p, rb, groups, part_acc, part_ml,
                                     tickets, stream);
    case 64: return by_rows<Tkv, 64>(p, rb, groups, part_acc, part_ml,
                                     tickets, stream);
    case 112: return by_rows<Tkv, 112>(p, rb, groups, part_acc, part_ml,
                                       tickets, stream);
    case 128: return by_rows<Tkv, 128>(p, rb, groups, part_acc, part_ml,
                                       tickets, stream);
    case 256: return by_rows<Tkv, 256>(p, rb, groups, part_acc, part_ml,
                                       tickets, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dec

bool bad_shape(int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KH) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 ||
         B * H > 65535;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  q/k/v: BSHD with the strides
// given (elements; the last dimension contiguous); out: contiguous
// (B, Sq, H, D) in q's dtype.  valid: (B,) int64 on the device, or null to
// use valid_all for every row.  Route C: float32 q, or bf16 q with a float32
// k/v at Sq > 8.
cudaError_t flash_attention(
    const void* q, const void* k, const void* v, void* out, int q_dtype,
    int kv_dtype, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KH,
    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int64_t q_offset, int64_t prefix_len,
    const int64_t* valid, int64_t valid_all, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH)) return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    out,  B,     Sq,     Sk,
                 H,    KH,   q_sb, q_ss, q_sh,  k_sb,   k_ss,
                 k_sh, v_sb, v_ss, v_sh, scale, causal, q_offset,
                 prefix_len, valid, valid_all};
  const cudaStream_t s = (cudaStream_t)stream;
  using cores::by_dim;
  if (q_dtype == 1 && kv_dtype == 0 && Sq > 8)
    return by_dim<__nv_bfloat16, float>(p, D, s);
  if (q_dtype == 0 && kv_dtype == 0) return by_dim<float, float>(p, D, s);
  if (q_dtype == 0 && kv_dtype == 1) return by_dim<float, __nv_bfloat16>(p, D, s);
  return cudaErrorInvalidValue;
}

// Route A: bf16 q, k, v; q/k/v rows 16-byte aligned (strides multiples of
// 8 elements).  Same arguments as flash_attention.
cudaError_t flash_attention_prefill(
    const void* q, const void* k, const void* v, void* out, int q_dtype,
    int kv_dtype, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KH,
    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int64_t q_offset, int64_t prefix_len,
    const int64_t* valid, int64_t valid_all, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH) || q_dtype != 1 || kv_dtype != 1 ||
      (Sq + tc::kBQ - 1) / tc::kBQ > 65535)
    return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    out,  B,     Sq,     Sk,
                 H,    KH,   q_sb, q_ss, q_sh,  k_sb,   k_ss,
                 k_sh, v_sb, v_ss, v_sh, scale, causal, q_offset,
                 prefix_len, valid, valid_all};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return tc::launch<32>(p, s);
    case 64: return tc::launch<64>(p, s);
    case 112: return tc::launch<112>(p, s);
    case 128: return tc::launch<128>(p, s);
    case 256: return tc::launch<256>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// Route B: bf16 q, float32 or bf16 k/v, Sq <= 8; k/v rows 16-byte aligned.
// rows_per_block (1, 2, 4 or 8) x groups >= Sq * H / KH rows a kv head.
// Workspace: part_acc (B*KH*groups*n_split*rows_per_block*D float32),
// part_ml (the same without D, as float2), tickets (B*KH*groups int32, all
// 0; the kernel leaves them 0), n_split = ceil(Sk / split), split 256
// keys, 128 for 4 or more rows a block.
cudaError_t flash_attention_decode(
    const void* q, const void* k, const void* v, void* out, int q_dtype,
    int kv_dtype, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KH,
    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int64_t q_offset, int64_t prefix_len,
    const int64_t* valid, int64_t valid_all, int rows_per_block, int groups,
    void* part_acc, void* part_ml, void* tickets, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH) || q_dtype != 1 || Sq > 8 || groups < 1 ||
      groups > 65535 || (int64_t)rows_per_block * groups < Sq * (H / KH))
    return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    out,  B,     Sq,     Sk,
                 H,    KH,   q_sb, q_ss, q_sh,  k_sb,   k_ss,
                 k_sh, v_sb, v_ss, v_sh, scale, causal, q_offset,
                 prefix_len, valid, valid_all};
  const cudaStream_t s = (cudaStream_t)stream;
  float* acc = (float*)part_acc;
  float2* ml = (float2*)part_ml;
  int* t = (int*)tickets;
  if (kv_dtype == 0)
    return dec::by_dim<float>(p, D, rows_per_block, groups, acc, ml, t, s);
  if (kv_dtype == 1)
    return dec::by_dim<__nv_bfloat16>(p, D, rows_per_block, groups, acc, ml,
                                      t, s);
  return cudaErrorInvalidValue;
}

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
