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
//   o [B, Sq, H, D] in q's dtype; softmax state and accumulation in f32.
//
// Both designs share the TPU kernel's plan with its sequential kv grid axis
// turned into a loop inside the block: one block per (64-row q tile, head,
// batch) walks the 64-row kv tiles with the online-softmax state (m, l, acc) in
// registers. Query head h reads kv head h / (H/K) in place (the GQA repeat is
// never materialised), and kv tiles that the causal or sliding-window mask hides
// from every row of the q tile are never loaded.
//
// What bounds it on the H100. Causal attention does ~2*S*S*H*D flops on
// ~6*S*H*D bytes of bf16 in and out (GQA with K = H/2): S/3 flops per byte. On
// the bf16 tensor cores (989 TFLOP/s, 3.35 TB/s: ~295 flops/byte) the least time
// is set by bytes below S ~ 900 and by operations above. At the serving prompt
// (B=1, S=512, H=16, K=8, D=128) that is 6.3 MB and 1.08 GFLOP: 0.0019 ms.
//
// bf16 (dtype 1), the serving path: tensor cores, FlashAttention-2 style.
//   4 warps; each owns 16 query rows. Q is loaded once into mma fragments
//   (ldmatrix). K and V tiles stream in with 16-byte cp.async (zero-filled past
//   Skv), two stages deep, so the next tile's load overlaps this tile's math.
//   S = Q.K^T and O += P.V are mma.sync.m16n8k16 bf16 -> f32. The online softmax
//   runs on the S accumulators (row max and sum over the 4-thread quad, exp2 with
//   log2(e) folded into the scale). P is fed from registers as the A operand of
//   P.V, never through shared memory, as a bf16 hi + lo pair: the reference
//   keeps P in f32, and one rounding of P to bf16 raised the bf16 drift of
//   qwen3-0.6b's decode against forward at 4 layers from 0.047 to 0.070 (of
//   the 0.08 gate; chip_smoke.py on an H100) for ~10% less time. V's B fragments come from ldmatrix.trans. Only tiles
//   that cross the diagonal, the window edge or the ragged end are masked.
//   Shared-memory rows are padded by 16 bytes, which
//   makes every ldmatrix conflict-free for D in {32, 64, 80, 128}: Q plus two
//   stages of K and V is 85 KB at D = 128, so two blocks fit on an SM. The q
//   tiles are launched heaviest first (the last causal tile sees every kv tile),
//   so the last wave is the shortest. At the serving prompt (S = 512) the 128
//   blocks are one wave of 4 warps an SM, bound by the latency of the heaviest
//   tile's loop; at S = 2048, by the mma.sync rate and the softmax between the
//   two products. `wgmma` with TMA and warp specialisation (FlashAttention-3)
//   is the next step.
// f32 (dtype 0), the check path: the exact CUDA-core design. 256 threads; K and V
//   tiles staged in shared memory as f32; a group of 16 threads owns 4 query
//   rows, each thread a 4x4 piece of the 64x64 score tile and a 4 x D/16 piece of
//   the output; f32 FMAs (67 TFLOP/s) keep f32 inputs within 2e-5 of the
//   reference, which TF32 tensor cores would not. Shared-memory rows are padded
//   by one float so the per-row and per-column reads hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // kv rows per tile
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------ f32: CUDA cores
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = 4;        // query rows per thread  (BQ / 16)
constexpr int CPT = 4;        // score columns per thread (BKV / 16)

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D+1], sK [BKV][D+1], sV [BKV][D], sP [BQ][BKV+1], all f32
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) +
                          (size_t)BKV * D + (size_t)BQ * (BKV + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
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
  const float* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const float* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  float* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    sQ[r * DP + d] = qi < Sq ? qb[(size_t)qi * q_stride + d] * scale : 0.f;
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
      sK[c * DP + d] = ok ? kb[(size_t)kj * kv_stride + d] : 0.f;
      sV[c * D + d] = ok ? vb[(size_t)kj * kv_stride + d] : 0.f;
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
    for (int e = 0; e < DPT; ++e) ob[(size_t)qi * q_stride + tx + 16 * e] = acc[i][e] / denom;
  }
}

// ------------------------------------------------------------ bf16: tensor cores
constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
constexpr size_t tc_smem_bytes() {
  // sQ [BQ][D+8], sK [2][BKV][D+8], sV [2][BKV][D+8], all bf16
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BKV) * (D + 8);
}

// Rows r0 .. r0+63 of a [rows, D] bf16 matrix with row stride `stride` into a
// [64][D+8] tile; rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t stride, int r0, int limit, int tid) {
  constexpr int CH = D / 8;  // 16-byte pieces per row
  static_assert(BKV * CH % TC_THREADS == 0, "whole pieces per thread");
#pragma unroll
  for (int j = 0; j < BKV * CH / TC_THREADS; ++j) {
    const int i = tid + j * TC_THREADS;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit;
    tc::cp_async16(dst + r * (D + 8) + c * 8, src + (size_t)(ok ? r0 + r : 0) * stride + c * 8,
                   ok);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int Sq, int Skv, int H, int K, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int RS = D + 8;   // padded smem row, bf16 elements
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NT = D / 8;   // n-tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * RS;    // [2][BKV][RS]
  __nv_bfloat16* sV = sK + 2 * BKV * RS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int kvh = h / (H / K);
  const int offset = Skv - Sq;
  const float sl2 = scale * 1.4426950408889634f;   // scale * log2(e)

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;

  // kv tiles t_lo .. t_lo + n_tiles - 1 hold every position some row can see
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + offset;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_lo = kv_lo / BKV;
  const int n_tiles = kv_hi > 0 ? (kv_hi + BKV - 1) / BKV - t_lo : 0;

  tile_async<D>(sQ, qb, q_stride, q0, Sq, tid);
  if (n_tiles > 0) {
    tile_async<D>(sK, kb, kv_stride, t_lo * BKV, Skv, tid);
    tile_async<D>(sV, vb, kv_stride, t_lo * BKV, Skv, tid);
  }
  tc::cp_async_commit();
  if (n_tiles > 1) {
    tile_async<D>(sK + BKV * RS, kb, kv_stride, (t_lo + 1) * BKV, Skv, tid);
    tile_async<D>(sV + BKV * RS, vb, kv_stride, (t_lo + 1) * BKV, Skv, tid);
  }
  tc::cp_async_commit();

  uint32_t qf[KS][4];
  float acc[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile (and on the first pass Q) has landed for every thread
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        tc::ldsm_x4(qf[ks], sQ + (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * RS +
                                16 * ks + 8 * (lane / 16));
    }
    const int buf = it & 1;
    const int k0 = (t_lo + it) * BKV;
    const __nv_bfloat16* cK = sK + buf * BKV * RS;
    const __nv_bfloat16* cV = sV + buf * BKV * RS;

    // S = Q K^T: 16 rows x 64 kv columns per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, cK + (16 * np + (lane % 8) + 8 * (lane / 16)) * RS + 16 * ks +
                            8 * ((lane / 8) % 2));
        tc::mma(s[2 * np], qf[ks], kf[0], kf[1]);
        tc::mma(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    const bool need_mask = k0 + BKV > Skv || (causal && k0 + BKV - 1 > q_first) ||
                           (window > 0 && k0 <= q_last - window);
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * n + 2 * t + (e & 1);
          const int qa = q0 + 16 * warp + g + 8 * (e >> 1) + offset;
          const bool ok =
              kj < Skv && (!causal || kj <= qa) && (window <= 0 || qa - kj < window);
          if (!ok) s[n][e] = -INFINITY;
        }
    }

    // online softmax on the accumulators; row r of this thread is g + 8r
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
      const float alpha = exp2f((m[r] - m_use) * sl2);
      const float shift = m_use * sl2;
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f(fmaf(s[n][e], sl2, -shift));
          rs += s[n][e];
        }
      l[r] = l[r] * alpha + rs;  // this thread's share; the quad is summed at the end
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P from the S accumulators as bf16 hi + lo A fragments
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t phi[4], plo[4];
      tc::split(s[2 * ks][0], s[2 * ks][1], phi[0], plo[0]);
      tc::split(s[2 * ks][2], s[2 * ks][3], phi[1], plo[1]);
      tc::split(s[2 * ks + 1][0], s[2 * ks + 1][1], phi[2], plo[2]);
      tc::split(s[2 * ks + 1][2], s[2 * ks + 1][3], phi[3], plo[3]);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vf[4];
        tc::ldsm_x4_t(vf, cV + (16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * RS + 16 * dp +
                              8 * (lane / 16));
        tc::mma(acc[2 * dp], phi, vf[0], vf[1]);
        tc::mma(acc[2 * dp + 1], phi, vf[2], vf[3]);
        tc::mma(acc[2 * dp], plo, vf[0], vf[1]);
        tc::mma(acc[2 * dp + 1], plo, vf[2], vf[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage before it is refilled
    if (it + 2 < n_tiles) {
      tile_async<D>(sK + buf * BKV * RS, kb, kv_stride, (t_lo + it + 2) * BKV, Skv, tid);
      tile_async<D>(sV + buf * BKV * RS, vb, kv_stride, (t_lo + it + 2) * BKV, Skv, tid);
    }
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int qi = q0 + 16 * warp + g + 8 * r;
    if (qi >= Sq) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + (size_t)qi * q_stride + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) row[4 * n] = tc::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int K, int causal, int window, float scale, int dtype,
                   cudaStream_t stream) {
  const int n_q = (Sq + BQ - 1) / BQ;
  cudaError_t err;
  if (dtype == 1) {
    constexpr size_t smem = tc_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<D><<<dim3(H, B, n_q), TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, K,
        causal, window, scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<dim3(n_q, H, B), THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, K, causal, window,
        scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = f32 (the
// CUDA-core design), 1 = bf16 (the tensor-core design).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H, int K,
                                   int D, int causal, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 64: return (int)launch<64>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 80: return (int)launch<80>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 128: return (int)launch<128>(q, k, v, o, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
