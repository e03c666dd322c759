// Flash attention forward for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel `_attn_kernel` / `flash_attention_pallas` of
// src/repro/kernels/flash_attention.py. Semantics follow the JAX package's
// reference (`ref.attention_ref`) and blocked path (`ops._flash_fwd_blocked`),
// not the Pallas kernel: masks are end-aligned (q row i sits at absolute position
// i + Skv - Sq), ragged Sq/Skv are masked here, and the softmax scale is
// 1/sqrt(D) of the true head dim (no padding of D to 128).
//
//   q [B, Sq, H, D], k/v [B, Skv, K, D] (contiguous, f32 or bf16), H % K == 0
//   o [B, Sq, H, D] in q's dtype; accumulation in f32.
//
// Design. One block per (q tile of 64 rows, head, batch). The TPU kernel carries
// its online-softmax state (acc, m, l) in VMEM scratch across a sequential kv grid
// dimension; blocks on Hopper run in no order, so here a loop inside the block
// walks the kv tiles and the state stays in registers. Each kv tile (64 rows of k
// and v) is staged in shared memory as f32. Query head h reads kv head h / (H/K)
// straight from k/v: the GQA repeat is never materialised. kv tiles that the
// causal or sliding-window mask hides from every row of the q tile are never
// loaded. 256 threads: a group of 16 threads owns 4 query rows; each thread
// computes a 4x4 piece of the 64x64 score tile and a 4 x D/16 piece of the
// output, and the row max/sum go across the 16 threads by warp shuffles.
//
// What bounds it on the H100. Causal attention does ~2*S*S*H*D flops on
// ~6*S*H*D bytes of bf16 in and out (GQA with K = H/2): S/3 flops per byte. On
// the bf16 tensor cores (989 TFLOP/s, 3.35 TB/s: ~295 flops/byte) the least time
// is set by bytes below S ~ 900 and by operations above (the serving prompt,
// S = 512, sits just below). This first version does the arithmetic with f32 FMAs
// on the CUDA cores (67 TFLOP/s, ~20 flops/byte), so it is bound by its own
// arithmetic at every serving shape: simple and exact in f32, with the tile loop
// already shaped for a later mma/wgmma inner product. Scores never leave the
// block: each q tile is read once and written once, and each kv tile is read
// once per q tile that sees it (mostly from the 50 MB L2). Shared-memory rows are
// padded by one float so the per-row and per-column reads of the score loops hit
// distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = 4;        // query rows per thread  (BQ / 16)
constexpr int CPT = 4;        // score columns per thread (BKV / 16)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BKV][D+1], sV [BKV][D], sP [BQ][BKV+1], all f32
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) +
                          (size_t)BKV * D + (size_t)BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int K, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;     // padded row stride of sQ and sK
  constexpr int PP = BKV + 1;   // padded row stride of sP
  constexpr int DPT = D / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BKV * DP;
  float* sP = sV + BKV * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column lane
  const int ty = tid / 16;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int offset = Skv - Sq;

  const size_t q_stride = (size_t)H * D;   // between consecutive q/o rows
  const size_t kv_stride = (size_t)K * D;  // between consecutive k/v rows
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  T* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    sQ[r * DP + d] = qi < Sq ? to_f32(qb[(size_t)qi * q_stride + d]) * scale : 0.f;
  }

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // kv positions [kv_lo, kv_hi) are visible to at least one row of this q tile
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + offset;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int k0 = (kv_lo / BKV) * BKV; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // sQ is written / the previous tile's sK, sV, sP are read
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const int kj = k0 + c;
      const bool ok = kj < Skv;
      sK[c * DP + d] = ok ? to_f32(kb[(size_t)kj * kv_stride + d]) : 0.f;
      sV[c * D + d] = ok ? to_f32(vb[(size_t)kj * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*RPT+i against columns tx + 16*j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qa = q0 + ty * RPT + i + offset;  // absolute position of the row
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < Skv && (!causal || kj <= qa) && (window <= 0 || qa - kj < window);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * RPT + i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * PP + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) vv[e] = sV[c * D + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      ob[(size_t)qi * q_stride + tx + 16 * e] = from_f32<T>(acc[i][e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int K, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, K, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v, void* o,
                           int B, int Sq, int Skv, int H, int K, int D, int causal,
                           int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = f32, 1 = bf16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H, int K,
                                   int D, int causal, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      dtype == 1 ? launch_for_dim<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, K, D, causal,
                                                 window, scale, s)
      : dtype == 0 ? launch_for_dim<float>(q, k, v, o, B, Sq, Skv, H, K, D, causal, window,
                                           scale, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
