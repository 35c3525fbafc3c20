// FLASH_ATTENTION: online-softmax attention in one launch, hand-written for
// Hopper (sm_90a).
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
// Design, the simple one first (no tensor cores, no TMA):
//
//   * one block of 256 threads per (batch, head, BQ-row q tile); the q tile
//     is staged in shared memory once, as float32;
//   * the block walks 64-key tiles of K and V, staged in shared memory as
//     float32 (strides padded by one float so that the rows a warp reads
//     fall in distinct banks);
//   * TPR threads share a q row: each computes the logits of 64/TPR keys
//     and owns D/TPR output columns; the row's max and sum are reduced with
//     warp shuffles and its probabilities go through shared memory to the
//     P.V product, all float32 FMAs on the CUDA cores;
//   * prefill (Sq > 8) uses BQ = 64 rows and TPR = 4; decode (Sq <= 8) uses
//     BQ = 8 and TPR = 32, so that a single query row keeps a whole warp
//     busy;
//   * the block stops at the last key any of its rows can see (causal
//     limit, valid length): the keys after it would add exactly 0.  Only
//     when a row of the tile sees no key at all does it walk every key,
//     since such a row averages v over all Sk keys.
//
// What bounds it on an H100: at the prefill shape (B 1, S 1024, 32 heads,
// D 64, bf16, causal) the work is ~4.3 GFLOP against ~12.6 MB, so the
// bf16 tensor-core peak (989 TFLOP/s) sets the bound (~0.004 ms); this
// kernel runs on the float32 CUDA cores (67 TFLOP/s, ~0.064 ms for the
// same work) and is further limited by shared-memory loads (about one per
// FMA).  wgmma, TMA and warp specialisation are later work.  At the decode
// shape the bound is the bytes of the cache rows it must read.
//
// The extern "C" launcher enqueues the kernel on the given stream, does not
// synchronise, and returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;               // keys per staged tile
constexpr float kMasked = -1e30f;     // the reference's _NEG_INF

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
    x = __bfloat162float(__float2bfloat16(x));
  return x;
}

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

  // the keys this tile's rows can see: [0, end)
  const int64_t valid = p.valid ? p.valid[b] : p.valid_all;
  const int64_t kv_valid = valid < p.Sk ? valid : p.Sk;
  int64_t end = kv_valid;
  bool blind_row = kv_valid <= 0;
  if (p.causal) {
    const int64_t last_q = (q0 + BQ < p.Sq ? q0 + BQ : p.Sq) - 1;
    int64_t hi = last_q + p.q_offset + 1;
    if (hi < p.prefix_len) hi = p.prefix_len;
    if (hi < end) end = hi;
    if (q0 + p.q_offset < 0 && p.prefix_len <= 0) blind_row = true;
  }
  if (blind_row) end = p.Sk;

  const int64_t qpos = q0 + r;
  // warp-uniform: does this warp hold any row of the output?
  const bool warp_live = q0 + (tid / 32) * (32 / TPR) < p.Sq;
  float m = kMasked, l = 0.0f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.0f;

  for (int64_t k0 = 0; k0 < end; k0 += kBK) {
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
      const bool seen =
          kpos < kv_valid &&
          (!p.causal || kpos <= qpos + p.q_offset || kpos < p.prefix_len);
      s[jj] = kpos >= p.Sk ? -INFINITY : (seen ? s[jj] * p.scale : kMasked);
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
  if (p.Sq <= 8) return launch<Tq, Tkv, D, 8, 32>(p, stream);
  return launch<Tq, Tkv, D, 64, 4>(p, stream);
}

template <typename Tq, typename Tkv>
cudaError_t by_dim(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return by_rows<Tq, Tkv, 32>(p, stream);
    case 64: return by_rows<Tq, Tkv, 64>(p, stream);
    case 128: return by_rows<Tq, Tkv, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  q/k/v: BSHD with the strides
// given (elements; the last dimension contiguous); out: contiguous
// (B, Sq, H, D) in q's dtype.  valid: (B,) int64 on the device, or null to
// use valid_all for every row.
cudaError_t flash_attention(
    const void* q, const void* k, const void* v, void* out, int q_dtype,
    int kv_dtype, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KH,
    int D, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, int causal, int64_t q_offset, int64_t prefix_len,
    const int64_t* valid, int64_t valid_all, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  const Params p{q,    k,    v,    out,  B,     Sq,     Sk,
                 H,    KH,   q_sb, q_ss, q_sh,  k_sb,   k_ss,
                 k_sh, v_sb, v_ss, v_sh, scale, causal, q_offset,
                 prefix_len, valid, valid_all};
  const cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == 1 && kv_dtype == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(p, D, s);
  if (q_dtype == 1 && kv_dtype == 0) return by_dim<__nv_bfloat16, float>(p, D, s);
  if (q_dtype == 0 && kv_dtype == 0) return by_dim<float, float>(p, D, s);
  if (q_dtype == 0 && kv_dtype == 1) return by_dim<float, __nv_bfloat16>(p, D, s);
  return cudaErrorInvalidValue;
}

const char* attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
