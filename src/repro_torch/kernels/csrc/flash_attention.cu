// Flash attention forward and backward for Hopper (sm_90a), with a plain C
// interface for ctypes. The backward's design is at its section below.
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
// (B=1, S=512, H=16, K=8, D=128) that is 6.3 MB and 1.08 GFLOP: 0.0019 ms. At
// gemma3-12b's (D=256) 12.6 MB: 0.0038 ms; its prefill of 2,048 tokens is 34.4
// GFLOP in a global layer (0.035 ms) and 25.8 in a local one, whose 1,024-token
// window hides about half the causal pairs (0.026 ms), both bound by operations.
// zamba2-7b's shared attention block (H = K = 32, D = 112) moves 14.7 MB at S = 512
// (0.0044 ms, bound by bytes) and does 30.1 GFLOP at S = 2,048 (0.030 ms).
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
//   makes every ldmatrix conflict-free for D in {32, 64, 80, 112, 128, 256}: Q plus two
//   stages of K and V is 85 KB at D = 128, so two blocks fit on an SM. At D = 256
//   (gemma3) the plan changes to 32-row kv tiles with Q's fragments read from
//   shared memory at each k-step (`TcPlan`, below, says why). The q
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
//   by one float so the per-row and per-column reads hit distinct banks. At
//   D = 256 the staged tiles take 213,760 bytes (one block an SM, under the
//   232,448 a block may have) and a thread's accumulator is 4 x 16 floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <type_traits>
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
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int H, int K, int causal, int window, float scale) {
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
    // unrolled 2 deep at D = 112 (here and over P V): ptxas holds this kernel at 80
    // registers, and 4 deep it spilled 16 bytes there (the build gate refuses a spill)
#pragma unroll (D == 112 ? 2 : 4)
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
#pragma unroll (D == 112 ? 2 : 4)
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
    // m is in units of the scaled scores here (q was scaled on load)
    if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(denom);
  }
}

// ------------------------------------------------------------ bf16: tensor cores
constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

// The bf16 forward's plan for a head dim: BN kv rows a tile, and whether Q's mma
// fragments are held in registers for the whole kv loop (QREG) or read from sQ
// at each k-step. D <= 128: 64-row tiles, Q held (the plan described above).
// D = 256 (gemma3): a warp's O accumulator alone is 128 f32 registers a thread,
// and holding Q's fragments would add 64 more, with the S tile (32 at BN = 64)
// and P's hi + lo pair on top: past the 255-register limit before any
// addressing, so it would spill. And Q plus two stages of 64-row K and V tiles
// is 168,960 bytes of shared memory: one 4-warp block an SM. So at D = 256 Q's
// fragments come from sQ by ldmatrix at each k-step (one ldmatrix.x4 beside
// the two for K's fragments of a 16 x 32 S slab), and the kv tiles are 32 rows:
// S is 16 registers a thread, the O accumulator 128, ~200 in all under the
// 255 cap that two blocks an SM allow; Q plus two stages of 32-row K and V is
// 101,376 bytes, so two blocks (8 warps) share an SM and one block's loads
// overlap the other's math, as at D <= 128. Twice the tiles mean twice the
// barriers and online-softmax rescales of O per kv row, against the one
// block an SM the 64-row tiles would leave.
// D = 112 (zamba2-7b) is built as it is, not padded to 128 as the TPU route pads it
// (src/repro/kernels/ops.py:148-171): Q . K^T takes 7 k-steps of 16, the output 14
// n-tiles of 8 (P . V 7 pairs of them), and a bf16 row of 224 bytes is 14 16-byte
// cp.async pieces, 7 a thread for a 64-row tile. Its 240-byte padded rows keep
// ldmatrix conflict-free, and it takes the D <= 128 plan: Q in 28 registers, O in 56.
template <int D> struct TcPlan {
  static constexpr int BN = D > 128 ? 32 : 64;
  static constexpr bool QREG = D <= 128;
};

template <int D>
constexpr size_t tc_smem_bytes() {
  // sQ [BQ][D+8], sK [2][BN][D+8], sV [2][BN][D+8], all bf16
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * TcPlan<D>::BN) * (D + 8);
}

// Rows r0 .. r0+ROWS-1 of a [rows, D] bf16 matrix with row stride `stride` into a
// [ROWS][D+8] tile; rows at or past `limit` are zero-filled.
template <int D, int ROWS = 64, int NTHREADS = TC_THREADS>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t stride, int r0, int limit, int tid) {
  constexpr int CH = D / 8;  // 16-byte pieces per row
  static_assert(ROWS * CH % NTHREADS == 0, "whole pieces per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / NTHREADS; ++j) {
    const int i = tid + j * NTHREADS;
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
                      float* __restrict__ lse, int Sq, int Skv, int H, int K, int causal,
                      int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BN = TcPlan<D>::BN;   // kv rows a tile
  constexpr bool QREG = TcPlan<D>::QREG;
  constexpr int RS = D + 8;   // padded smem row, bf16 elements
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NT = D / 8;   // n-tiles of the output
  constexpr int SN = BN / 8;  // n-tiles of S

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * RS;    // [2][BN][RS]
  __nv_bfloat16* sV = sK + 2 * BN * RS;

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
  const int t_lo = kv_lo / BN;
  const int n_tiles = kv_hi > 0 ? (kv_hi + BN - 1) / BN - t_lo : 0;

  tile_async<D, BQ>(sQ, qb, q_stride, q0, Sq, tid);
  if (n_tiles > 0) {
    tile_async<D, BN>(sK, kb, kv_stride, t_lo * BN, Skv, tid);
    tile_async<D, BN>(sV, vb, kv_stride, t_lo * BN, Skv, tid);
  }
  tc::cp_async_commit();
  if (n_tiles > 1) {
    tile_async<D, BN>(sK + BN * RS, kb, kv_stride, (t_lo + 1) * BN, Skv, tid);
    tile_async<D, BN>(sV + BN * RS, vb, kv_stride, (t_lo + 1) * BN, Skv, tid);
  }
  tc::cp_async_commit();

  // this warp's 16 rows of sQ, at k-step ks, as ldmatrix row addresses
  const __nv_bfloat16* q_frag = sQ + (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * RS +
                                8 * (lane / 16);
  uint32_t qf[QREG ? KS : 1][4];
  float acc[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile (and on the first pass Q) has landed for every thread
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) tc::ldsm_x4(qf[ks], q_frag + 16 * ks);
      }
    }
    const int buf = it & 1;
    const int k0 = (t_lo + it) * BN;
    const __nv_bfloat16* cK = sK + buf * BN * RS;
    const __nv_bfloat16* cV = sV + buf * BN * RS;

    // S = Q K^T: 16 rows x BN kv columns per warp
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (QREG) {
        a[0] = qf[ks][0]; a[1] = qf[ks][1]; a[2] = qf[ks][2]; a[3] = qf[ks][3];
      } else {
        tc::ldsm_x4(a, q_frag + 16 * ks);
      }
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kf[4];
        tc::ldsm_x4(kf, cK + (16 * np + (lane % 8) + 8 * (lane / 16)) * RS + 16 * ks +
                            8 * ((lane / 8) % 2));
        tc::mma(s[2 * np], a, kf[0], kf[1]);
        tc::mma(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    const bool need_mask = k0 + BN > Skv || (causal && k0 + BN - 1 > q_first) ||
                           (window > 0 && k0 <= q_last - window);
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
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
      for (int n = 0; n < SN; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
      const float alpha = exp2f((m[r] - m_use) * sl2);
      const float shift = m_use * sl2;
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < SN; ++n)
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
    for (int ks = 0; ks < BN / 16; ++ks) {
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
      tile_async<D, BN>(sK + buf * BN * RS, kb, kv_stride, (t_lo + it + 2) * BN, Skv, tid);
      tile_async<D, BN>(sV + buf * BN * RS, vb, kv_stride, (t_lo + it + 2) * BN, Skv, tid);
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
    // m is the row max of the unscaled scores and l sums exp2((s - m) * scale *
    // log2 e) = exp((s - m) * scale): in natural-log units the LSE is
    // m * scale + log(l), as `_flash_fwd_blocked` returns it
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Sq + qi] =
          m[r] == -INFINITY ? NEG_INF : fmaf(m[r], scale, logf(fmaxf(sum, 1e-30f)));
    uint32_t* row = reinterpret_cast<uint32_t*>(ob + (size_t)qi * q_stride + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) row[4 * n] = tc::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int K, int causal, int window, float scale,
                   int dtype, cudaStream_t stream) {
  const int n_q = (Sq + BQ - 1) / BQ;
  cudaError_t err;
  if (dtype == 1) {
    constexpr size_t smem = tc_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_kernel<D><<<dim3(H, B, n_q), TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H,
        K, causal, window, scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<dim3(n_q, H, B), THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, H, K, causal,
        window, scale);
  }
  return cudaGetLastError();
}


// ------------------------------------------------------------------- backward
// dq, dk, dv of the forward above from its saved (q, k, v, o, lse) and dO: the
// function of the JAX package's custom VJP `_flash_bwd_blocked` (ops.py:90), with
// P = exp(S * scale - lse) recomputed tile by tile and dS = P o (dP - delta) * scale,
// delta = rowsum(dO o O). Three launches, all deterministic (no atomics), in both
// designs:
//   bwd_delta_kernel  delta [B,H,Sq] f32, one warp a (b, q row, h) row;
//   dK/dV pass        one block per (64-row kv tile, kv head, batch): it loops over
//                     the group's q heads and the q tiles the mask lets see this kv
//                     tile, and keeps dK and dV of its tile in registers, so the GQA
//                     fold (`ops.py:121-123`) is a sum inside the block;
//   dQ pass           one block per (64-row q tile, q head, batch): it loops over
//                     the kv tiles the forward visits and keeps dQ in registers.
// Each pass recomputes S and dP, so the backward runs 7 tile products: S and dP
// twice, dV += P^T dO, dK += dS^T Q, dQ += dS K.
//
// What bounds it on the H100. The bound counts 5 of those products, 10*D flops
// per visible (q, k) pair and head: 2.5x the forward's flops on ~2x its bytes, so
// from S ~ 1000 it is bound by operations. At the training shape (B=4, S=2048,
// H=16, K=8, D=128, causal) that is 172 GFLOP: 0.174 ms on the bf16 tensor cores
// (989 TFLOP/s); at B=1, 43 GFLOP: 0.043 ms. gemma3-12b's (B=1, S=2048, H=16,
// K=8, D=256) is 85.9 GFLOP causal (0.0869 ms) and 64.4 with the 1,024-token window
// (0.0652 ms) on ~101 MB (0.030 ms): bound by operations too.
//
// bf16 (dtype 1), the training path: tensor cores (bwd_dkdv_bf16_kernel, at
//   D = 256 bwd_dkdv_split_bf16_kernel, and bwd_dq_bf16_kernel). Every tile
//   product is mma.sync.m16n8k16 bf16 -> f32.
//   Tiles sit in shared memory as bf16, rows padded by 16 bytes (conflict-free
//   ldmatrix, as the forward), loaded by 16-byte cp.async with zero fill past Sq
//   or Skv, two stages deep over the loop axis (q tiles in the dK/dV pass, kv
//   tiles in the dQ pass) so the next tile's load overlaps this tile's products.
//   4 warps a block, 2 blocks an SM; each warp owns 16 rows of the block's tile.
//   - dK/dV pass: it computes S^T = K Q^T and dP^T = V dO^T with kv rows as M, so
//     P^T and dS^T land in the accumulator layout and feed dV += P^T dO and
//     dK += dS^T Q straight from registers as A fragments: no tile of P or dS goes
//     through shared memory. K and V are the A operands (ldmatrix), Q and dO the
//     B operands, plain for S^T and dP^T and through ldmatrix.trans for dV and dK.
//     The q tile is taken in two halves of 32 columns to fit the registers: at
//     D = 128 the dK and dV accumulators of a warp's 16 rows are 128 f32
//     registers a thread, S^T and dP^T of a half 16 + 16, P and dS as bf16
//     fragments 8 + 8; ptxas gives the kernel 255 registers at D = 128 with no
//     spill (chip_smoke.py's build phase checks that none of these kernels
//     spills). Shared memory: K, V and two stages of Q and dO, 6 x 64 x (D+8)
//     bf16, and two stages of the q rows' lse and delta, 1 KB: 105,472 bytes at
//     D = 128.
//   - dQ pass: the forward's layout. S = Q K^T and dP = dO V^T with q rows as M,
//     dS from the accumulators as the A fragment of dQ += dS K, K's B fragments
//     through ldmatrix.trans. dQ is 64 registers a thread at D = 128, S and dP
//     32 + 32 (ptxas: 242 in all). Shared memory: Q, dO and two stages of K and
//     V, 104,448 bytes.
//   - Rounding: P and dS are computed in f32 (dS from the f32 P) and rounded to
//     bf16 once, as the A operands of their products, as FlashAttention-2 and
//     PyTorch's SDPA backward do. A CPU emulation of these rounding points at the
//     training shape stayed well inside the bf16 gate (2e-2 atol + rtol against
//     the plain f32 math): its largest errors were single bf16 steps of the
//     rounded outputs, so the forward's hi + lo split of P would buy nothing here.
//   - Blocks are launched heaviest first: under the causal mask the first kv
//     tiles see the most q tiles, the last q tiles the most kv tiles.
//   - D = 256 (gemma3-12b's training) takes the plan of `BwdPlan` below: dK and
//     dV on separate warps of an 8-warp block, and 32-row kv tiles in the dQ pass.
//   `wgmma` with TMA and warp specialisation (FlashAttention-3) is the next step.
// f32 (dtype 0), the check path: the exact CUDA-core design (bwd_dkdv_kernel,
//   bwd_dq_kernel). Every product and sum is an f32 FMA (67 TFLOP/s f32 peak),
//   which keeps the f32 gradients within 1e-3 of the reference and the card's
//   f32 train steps on the CPU's. 256 threads as 16 row groups x 16 column
//   lanes, as the f32 forward; every staged tile is f32 with rows padded by one
//   float, so the per-row and per-column reads of the products hit distinct banks.
//   At D = 256 the loop's tiles are 32 rows (`F32BwdPlan`).
constexpr int BWD_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// the CUDA-core dK/dV and dQ kernels write f32 only: bf16 has the tensor-core design
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// rows r0 .. r0+ROWS-1 of a [rows, D] matrix with row stride `stride` into a
// [ROWS][D+1] f32 tile; rows at or past `limit` are zero
template <typename T, int D, int ROWS = 64>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t stride, int r0,
                                      int limit, int tid) {
  for (int i = tid; i < ROWS * D; i += BWD_THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < limit ? to_f32(src[(size_t)(r0 + r) * stride + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 long long rows, int Sq, int H, int D) {
  const long long row = (long long)blockIdx.x * (BWD_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(o[row * D + d]), to_f32(dout[row * D + d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {   // row = (b * Sq + i) * H + h  ->  delta[b, h, i]
    const int h = (int)(row % H);
    const long long bi = row / H;
    const long long b = bi / Sq, i = bi % Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// The f32 backward's tiles: the dK/dV pass stages QR q rows at a time beside its 64
// kv rows, the dQ pass KR kv rows beside its 64 q rows. D <= 128: 64 and 64. At
// D = 256, 64-row tiles of Q, dO, K and V alone would take 263,168 bytes, past the
// 232,448 a block may have, so the loop's tiles are 32 rows: 214,272 bytes for the
// dK/dV pass and 206,336 for the dQ pass, one block an SM. A thread then scores 2 x 4
// (dK/dV) or 4 x 2 (dQ) pairs of a tile instead of 4 x 4.
template <int D> struct F32BwdPlan {
  static constexpr int QR = D > 128 ? 32 : 64;
  static constexpr int KR = D > 128 ? 32 : 64;
};

// s = scale * Q.K^T and dp = dO.V^T of the QR x KR tile, rows ty*RQ+i (q) and
// columns tx+16j (kv); then P and dS into sP / sS [QR][KR+1] (sP may be null: the
// dq pass needs only dS)
template <int D, int QR = 64, int KR = 64>
__device__ __forceinline__ void bwd_tile_scores(const float* sQ, const float* sO,
                                                const float* sK, const float* sV,
                                                const float* sL, const float* sD, float* sP,
                                                float* sS, int q0, int k0, int Sq, int Skv,
                                                int offset, int causal, int window,
                                                float scale, int tx, int ty) {
  constexpr int DP = D + 1, PP = KR + 1;
  constexpr int RQ = QR / 16, CK = KR / 16;   // q rows and kv columns a thread scores
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = sQ[(ty * RQ + i) * DP + d];
      ov[i] = sO[(ty * RQ + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const int qi = q0 + r;
    const int qa = qi + offset;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = tx + 16 * j;
      const int kj = k0 + c;
      const bool ok = qi < Sq && kj < Skv && (!causal || kj <= qa) &&
                      (window <= 0 || qa - kj < window);
      const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
      if (sP != nullptr) sP[r * PP + c] = p;
      sS[r * PP + c] = p * (dp[i][j] - sD[r]) * scale;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // sK, sV [64][D+1]; sQ, sO [QR][D+1]; sP, sS [QR][65]; sL, sD [QR]
  constexpr size_t QR = F32BwdPlan<D>::QR;
  return sizeof(float) * (2 * 64 * (size_t)(D + 1) + 2 * QR * (D + 1) + 2 * QR * (BKV + 1) +
                          2 * QR);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int Sq, int Skv, int H, int K, int causal, int window, float scale) {
  constexpr int QR = F32BwdPlan<D>::QR;   // q rows a staged tile
  constexpr int DP = D + 1, PP = BKV + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + 64 * DP;
  float* sQ = sV + 64 * DP;
  float* sO = sQ + QR * DP;
  float* sP = sO + QR * DP;
  float* sS = sP + QR * PP;
  float* sL = sS + QR * PP;
  float* sD = sL + QR;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / K, offset = Skv - Sq;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  stage<T, D>(sK, k + (size_t)b * Skv * kv_stride + (size_t)kvh * D, kv_stride, k0, Skv, tid);
  stage<T, D>(sV, v + (size_t)b * Skv * kv_stride + (size_t)kvh * D, kv_stride, k0, Skv, tid);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  // q rows that see at least one kv row of this tile: [qi_lo, qi_hi]
  const int k_last = min(k0 + BKV, Skv) - 1;
  const int qi_lo = causal ? max(0, k0 - offset) : 0;
  const int qi_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;

  for (int h = kvh * group; h < (kvh + 1) * group; ++h) {
    const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
    const T* ob = dout + (size_t)b * Sq * q_stride + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = (qi_lo / QR) * QR; q0 <= qi_hi; q0 += QR) {
      __syncthreads();   // the previous tile's sQ, sO, sP, sS are read
      stage<T, D, QR>(sQ, qb, q_stride, q0, Sq, tid);
      stage<T, D, QR>(sO, ob, q_stride, q0, Sq, tid);
      if (tid < QR) {
        sL[tid] = q0 + tid < Sq ? lb[q0 + tid] : 0.f;
        sD[tid] = q0 + tid < Sq ? db[q0 + tid] : 0.f;
      }
      __syncthreads();
      bwd_tile_scores<D, QR, BKV>(sQ, sO, sK, sV, sL, sD, sP, sS, q0, k0, Sq, Skv, offset,
                                  causal, window, scale, tx, ty);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's QR q rows; this thread owns
      // kv rows ty*4+a and columns tx+16e
#pragma unroll 4
      for (int r = 0; r < QR; ++r) {
        float pv[RPT], sv[RPT], ov[DPT], qv[DPT];
#pragma unroll
        for (int a = 0; a < RPT; ++a) {
          pv[a] = sP[r * PP + ty * RPT + a];
          sv[a] = sS[r * PP + ty * RPT + a];
        }
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          ov[e] = sO[r * DP + tx + 16 * e];
          qv[e] = sQ[r * DP + tx + 16 * e];
        }
#pragma unroll
        for (int a = 0; a < RPT; ++a)
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            dv_acc[a][e] = fmaf(pv[a], ov[e], dv_acc[a][e]);
            dk_acc[a][e] = fmaf(sv[a], qv[e], dk_acc[a][e]);
          }
      }
    }
  }

  T* dkb = dk + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  T* dvb = dv + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int kj = k0 + ty * RPT + a;
    if (kj >= Skv) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      dkb[(size_t)kj * kv_stride + tx + 16 * e] = from_f32<T>(dk_acc[a][e]);
      dvb[(size_t)kj * kv_stride + tx + 16 * e] = from_f32<T>(dv_acc[a][e]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sO [64][D+1]; sK, sV [KR][D+1]; sS [64][KR+1]; sL, sD [64]
  constexpr size_t KR = F32BwdPlan<D>::KR;
  return sizeof(float) * (2 * 64 * (size_t)(D + 1) + 2 * KR * (D + 1) + 64 * (KR + 1) + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int H,
              int K, int causal, int window, float scale) {
  constexpr int KR = F32BwdPlan<D>::KR;   // kv rows a staged tile
  constexpr int DP = D + 1, PP = KR + 1, DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + 64 * DP;
  float* sK = sO + 64 * DP;
  float* sV = sK + KR * DP;
  float* sS = sV + KR * DP;
  float* sL = sS + 64 * PP;
  float* sD = sL + 64;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K), offset = Skv - Sq;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  stage<T, D>(sQ, q + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0, Sq, tid);
  stage<T, D>(sO, dout + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0, Sq, tid);
  if (tid < 64) {
    const size_t row = ((size_t)b * H + h) * Sq + q0 + tid;
    sL[tid] = q0 + tid < Sq ? lse[row] : 0.f;
    sD[tid] = q0 + tid < Sq ? delta[row] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  // the kv tiles the forward visits for this q tile
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + offset;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int k0 = (kv_lo / KR) * KR; k0 < kv_hi; k0 += KR) {
    __syncthreads();   // sQ, sO are written / the previous tile's sK, sS are read
    stage<T, D, KR>(sK, kb, kv_stride, k0, Skv, tid);
    stage<T, D, KR>(sV, vb, kv_stride, k0, Skv, tid);
    __syncthreads();
    bwd_tile_scores<D, BQ, KR>(sQ, sO, sK, sV, sL, sD, nullptr, sS, q0, k0, Sq, Skv, offset,
                               causal, window, scale, tx, ty);
    __syncthreads();
    // dQ += dS K over the tile's KR kv rows; rows ty*4+i, columns tx+16e
#pragma unroll 4
    for (int c = 0; c < KR; ++c) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sS[(ty * RPT + i) * PP + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) kv[e] = sK[c * DP + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(sv[i], kv[e], acc[i][e]);
    }
  }

  T* dqb = dq + (size_t)b * Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e) dqb[(size_t)qi * q_stride + tx + 16 * e] = from_f32<T>(acc[i][e]);
  }
}

// ------------------------------------------------------- backward, bf16: tensor cores
constexpr float LOG2E = 1.4426950408889634f;

// The bf16 backward's plan for a head dim. D <= 128: the plan described above; at
// D = 112 (zamba2-7b) a warp's dK and dV accumulators are 112 registers a thread,
// 16 fewer than at 128, and the dQ pass keeps 64-row kv tiles.
// D = 256 (gemma3): a warp's dK and dV accumulators for its 16 kv rows would be 256
// f32 registers a thread, past the 255-register limit before any other value, so
// - dK/dV pass (SPLIT, bwd_dkdv_split_bf16_kernel): 8 warps a block, the 64-row kv
//   tile cut into the same four 16-row strips; warps 0-3 accumulate dK of theirs
//   and warps 4-7 dV, each in one 128-register accumulator. A dK warp computes S^T
//   and dP^T, a dV warp S^T again: 5 tile products in the pass instead of 4 (8 in
//   the backward instead of 7, 14% more mma work), against the 6 that splitting
//   dK's and dV's columns between warps would take (S^T and dP^T in each half) and
//   the shared-memory exchange of partial S^T and dP^T that splitting the
//   contraction would need. The eight warps share the block's K, V and two stages
//   of Q, dO, lse and delta (203,776 bytes at D = 256): each tile is read from
//   device memory once for both accumulators, one block (8 warps) an SM. Each
//   warp runs a body compiled for its role, so a dV warp holds no dP^T or dS^T:
//   with one body for both roles, ptxas spilled 136 bytes at 255 registers; with
//   the two, 255 and no spill. Taking the q tile 16 columns a pass instead of 32
//   also fits, but ran 7-9% slower (0.708 against 0.660 ms at B=1, S=2048, H=16,
//   K=8, causal; 0.658 against 0.606 with the window: `chip_smoke.py
//   --k1-bwd-against` on an H100 80GB HBM3 at 700 W). It is a kernel of its own:
//   the D <= 128 kernel, given the roles as a template parameter, grew by 336
//   instructions at D = 128 and ran 3% slower; kept apart, its code is as it was.
// - dQ pass: the forward's answer (`TcPlan`): 32-row kv tiles, so S and dP are 16 +
//   16 registers beside dQ's 128 (ptxas: 244, no spill); Q's and dO's fragments are
//   read from shared memory at each k-step, as at every D. Q, dO and two stages of
//   32-row K and V take 135,168 bytes, one 4-warp block an SM (the launch bound's
//   2 blocks hold for D <= 128 only; at 128 threads it caps no register). 16-row
//   kv tiles (101,376 bytes, two blocks an SM; ptxas: 239, no spill) ran 4% faster
//   causal but 2.5% slower with the window (0.627 against 0.656 ms and 0.617
//   against 0.602 at B=1, S=2048, H=16, K=8, the whole backward: `chip_smoke.py
//   --k1-bwd-against` on an H100 80GB HBM3 at 700 W); gemma3 runs five windowed
//   layers to one causal, so 32 rows stay.
// At gemma3-12b's training shape both passes together take 0.657 ms causal and
// 0.608 with the window (7.6x and 9.3x the bound; SDPA's backward on cuDNN 0.362
// without a mask, 0.947 with the band mask); in the training step the dK/dV pass
// takes 375 us, the dQ pass 227 (an H100 80GB HBM3 at 700 W, chip_smoke.py).
template <int D> struct BwdPlan {
  static constexpr bool SPLIT = D > 128;          // dK/dV pass: bwd_dkdv_split_bf16_kernel
  static constexpr int BN = D > 128 ? 32 : 64;    // dQ pass: kv rows a tile
};

template <int D>
constexpr size_t dkdv_tc_smem_bytes() {
  // sK, sV [BKV][D+8], sQ, sO [2][BQ][D+8] bf16; sL, sDl [2][BQ] f32
  return sizeof(__nv_bfloat16) * 6 * 64 * (size_t)(D + 8) + sizeof(float) * 4 * BQ;
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // sQ, sO [BQ][D+8], sK, sV [2][BN][D+8] bf16
  return sizeof(__nv_bfloat16) * (2 * BQ + 4 * BwdPlan<D>::BN) * (size_t)(D + 8);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                     int Skv, int H, int K, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int RS = D + 8;   // padded smem row, bf16 elements
  constexpr int KS = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int NT = D / 8;   // n-tiles of dK and dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BKV * RS;
  __nv_bfloat16* sQ = sV + BKV * RS;       // [2][BQ][RS]
  __nv_bfloat16* sO = sQ + 2 * BQ * RS;    // dO, [2][BQ][RS]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * RS);   // lse [2][BQ]
  float* sDl = sL + 2 * BQ;                                  // delta [2][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;   // the first kv tiles see the most causal q tiles
  const int group = H / K, offset = Skv - Sq;
  const float sl2 = scale * LOG2E;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;

  // q rows that see at least one kv row of this tile: [qi_lo, qi_hi]; the loop
  // walks (q head of the group, q tile) pairs, head-major
  const int k_last = min(k0 + BKV, Skv) - 1;
  const int qi_lo = causal ? max(0, k0 - offset) : 0;
  const int qi_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;
  const int qt_lo = qi_lo / BQ;
  const int n_qt = qi_hi >= qi_lo ? qi_hi / BQ - qt_lo + 1 : 0;
  const int n_it = group * n_qt;

  // Q, dO, lse and delta of step `it` into stage `buf`; rows past Sq are zero
  auto load_q = [&](int it, int buf) {
    const int h = kvh * group + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    tile_async<D>(sQ + buf * BQ * RS, q + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride,
                  q0, Sq, tid);
    tile_async<D>(sO + buf * BQ * RS, dout + (size_t)b * Sq * q_stride + (size_t)h * D,
                  q_stride, q0, Sq, tid);
    const int r = tid % BQ;            // threads 0..63 load lse, 64..127 delta
    const bool ok = q0 + r < Sq;
    const float* src = (tid < BQ ? lse : delta) + ((size_t)b * H + h) * Sq;
    tc::cp_async4((tid < BQ ? sL : sDl) + buf * BQ + r, src + (ok ? q0 + r : 0), ok);
  };

  tile_async<D>(sK, kb, kv_stride, k0, Skv, tid);
  tile_async<D>(sV, vb, kv_stride, k0, Skv, tid);
  if (n_it > 0) load_q(0, 0);
  tc::cp_async_commit();
  if (n_it > 1) load_q(1, 1);
  tc::cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<1>();
    __syncthreads();  // this step's Q, dO, lse, delta (and on the first, K and V) have landed
    const int buf = it & 1;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const __nv_bfloat16* cQ = sQ + buf * BQ * RS;
    const __nv_bfloat16* cO = sO + buf * BQ * RS;
    const float* cL = sL + buf * BQ;
    const float* cD = sDl + buf * BQ;
    const bool need_mask = q0 + BQ > Sq || k0 + BKV > Skv ||
                           (causal && k0 + BKV - 1 > q0 + offset) ||
                           (window > 0 && q0 + BQ - 1 + offset - k0 >= window);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;   // q columns c0 .. c0+31 of the tile
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x 32 q columns
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4], vf[4];
        const int a_off = (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * RS + 16 * ks +
                          8 * (lane / 16);
        tc::ldsm_x4(kf, sK + a_off);
        tc::ldsm_x4(vf, sV + a_off);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qf[4], of[4];
          const int b_off = (c0 + 16 * np + (lane % 8) + 8 * (lane / 16)) * RS + 16 * ks +
                            8 * ((lane / 8) % 2);
          tc::ldsm_x4(qf, cQ + b_off);
          tc::ldsm_x4(of, cO + b_off);
          tc::mma(s[2 * np], kf, qf[0], qf[1]);
          tc::mma(s[2 * np + 1], kf, qf[2], qf[3]);
          tc::mma(dp[2 * np], vf, of[0], of[1]);
          tc::mma(dp[2 * np + 1], vf, of[2], of[3]);
        }
      }

      // P^T and dS^T on the accumulators (kv row 16w + g + 8(e/2), q column
      // c0 + 8n + 2t + e%2), rounded once to bf16 A fragments over the q columns
      uint32_t pf[2][4], df[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = c0 + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(cL + c);
        const float2 d2 = *reinterpret_cast<const float2*>(cD + c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (need_mask) {
            const int kj = k0 + 16 * warp + g + 8 * (e >> 1);
            const int qi = q0 + c + (e & 1);
            const int qa = qi + offset;
            ok = qi < Sq && kj < Skv && (!causal || kj <= qa) && (window <= 0 || qa - kj < window);
          }
          const float l = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          p[e] = ok ? exp2f(fmaf(s[n][e], sl2, -l * LOG2E)) : 0.f;
          ds[e] = p[e] * (dp[n][e] - dl) * scale;
        }
        pf[n / 2][2 * (n % 2)] = tc::pack(p[0], p[1]);
        pf[n / 2][2 * (n % 2) + 1] = tc::pack(p[2], p[3]);
        df[n / 2][2 * (n % 2)] = tc::pack(ds[0], ds[1]);
        df[n / 2][2 * (n % 2) + 1] = tc::pack(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q over the half's 32 q rows
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int nd = 0; nd < NT / 2; ++nd) {
          uint32_t of[4], qf[4];
          const int t_off = (c0 + 16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * RS + 16 * nd +
                            8 * (lane / 16);
          tc::ldsm_x4_t(of, cO + t_off);
          tc::ldsm_x4_t(qf, cQ + t_off);
          tc::mma(dv_acc[2 * nd], pf[ks], of[0], of[1]);
          tc::mma(dv_acc[2 * nd + 1], pf[ks], of[2], of[3]);
          tc::mma(dk_acc[2 * nd], df[ks], qf[0], qf[1]);
          tc::mma(dk_acc[2 * nd + 1], df[ks], qf[2], qf[3]);
        }
      }
    }

    __syncthreads();  // every warp is done with this stage before it is refilled
    if (it + 2 < n_it) load_q(it + 2, buf);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();

  __nv_bfloat16* dkb = dk + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  __nv_bfloat16* dvb = dv + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + 16 * warp + g + 8 * r;
    if (kj >= Skv) continue;
    uint32_t* rk = reinterpret_cast<uint32_t*>(dkb + (size_t)kj * kv_stride + 2 * t);
    uint32_t* rv = reinterpret_cast<uint32_t*>(dvb + (size_t)kj * kv_stride + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      rk[4 * n] = tc::pack(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      rv[4 * n] = tc::pack(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// The dK/dV pass of the SPLIT plan (`BwdPlan`): 8 warps a block over one 64-row kv
// tile; warps 0-3 accumulate dK of the four 16-row strips and warps 4-7 dV, each in
// one accumulator. Loads, masks and roundings are those of bwd_dkdv_bf16_kernel;
// each warp runs the half of its q-tile loop that its accumulator needs.
template <int D>
__global__ void __launch_bounds__(2 * TC_THREADS, 1)
bwd_dkdv_split_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Skv, int H, int K, int causal, int window,
                           float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int NTHREADS = 2 * TC_THREADS;
  constexpr int RS = D + 8;   // padded smem row, bf16 elements
  constexpr int KS = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int NT = D / 8;   // n-tiles of dK and dV
  constexpr int QC = 32;      // q columns of a tile a pass

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BKV * RS;
  __nv_bfloat16* sQ = sV + BKV * RS;       // [2][BQ][RS]
  __nv_bfloat16* sO = sQ + 2 * BQ * RS;    // dO, [2][BQ][RS]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * RS);   // lse [2][BQ]
  float* sDl = sL + 2 * BQ;                                  // delta [2][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp % 4;          // this warp's 16 kv rows of the tile
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;     // the first kv tiles see the most causal q tiles
  const int group = H / K, offset = Skv - Sq;
  const float sl2 = scale * LOG2E;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;

  // q rows that see at least one kv row of this tile: [qi_lo, qi_hi]; the loop
  // walks (q head of the group, q tile) pairs, head-major
  const int k_last = min(k0 + BKV, Skv) - 1;
  const int qi_lo = causal ? max(0, k0 - offset) : 0;
  const int qi_hi = window > 0 ? min(Sq - 1, k_last + window - 1 - offset) : Sq - 1;
  const int qt_lo = qi_lo / BQ;
  const int n_qt = qi_hi >= qi_lo ? qi_hi / BQ - qt_lo + 1 : 0;
  const int n_it = group * n_qt;

  // Q, dO, lse and delta of step `it` into stage `buf`; rows past Sq are zero
  auto load_q = [&](int it, int buf) {
    const int h = kvh * group + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    tile_async<D, BQ, NTHREADS>(sQ + buf * BQ * RS,
                                q + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0,
                                Sq, tid);
    tile_async<D, BQ, NTHREADS>(sO + buf * BQ * RS,
                                dout + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride,
                                q0, Sq, tid);
    if (tid < 2 * BQ) {                // threads 0..63 load lse, 64..127 delta
      const int r = tid % BQ;
      const bool ok = q0 + r < Sq;
      const float* src = (tid < BQ ? lse : delta) + ((size_t)b * H + h) * Sq;
      tc::cp_async4((tid < BQ ? sL : sDl) + buf * BQ + r, src + (ok ? q0 + r : 0), ok);
    }
  };

  tile_async<D, BKV, NTHREADS>(sK, kb, kv_stride, k0, Skv, tid);
  tile_async<D, BKV, NTHREADS>(sV, vb, kv_stride, k0, Skv, tid);
  if (n_it > 0) load_q(0, 0);
  tc::cp_async_commit();
  if (n_it > 1) load_q(1, 1);
  tc::cp_async_commit();

  // dK (warps 0-3) or dV (warps 4-7) of this warp's strip
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // One q tile for this warp: DK, S^T and dP^T, then acc += dS^T Q; else S^T, then
  // acc += P^T dO. The q tile is taken QC columns at a time to fit the registers.
  auto tile = [&](auto role, const __nv_bfloat16* cQ, const __nv_bfloat16* cO,
                  const float* cL, const float* cD, int q0, bool need_mask) {
    constexpr bool DK = decltype(role)::value;
    constexpr int SN = QC / 8;    // n-tiles of S^T and dP^T
#pragma unroll
    for (int part = 0; part < BQ / QC; ++part) {
      const int c0 = QC * part;   // q columns c0 .. c0+QC-1 of the tile
      // S^T = K Q^T (and dP^T = V dO^T): this warp's 16 kv rows x QC q columns
      float s[SN][4], dp[DK ? SN : 1][4];
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = 0.f;
          if constexpr (DK) dp[n][e] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4], vf[4];
        const int a_off = (16 * strip + (lane % 8) + 8 * ((lane / 8) % 2)) * RS + 16 * ks +
                          8 * (lane / 16);
        tc::ldsm_x4(kf, sK + a_off);
        if constexpr (DK) tc::ldsm_x4(vf, sV + a_off);
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t qf[4], of[4];
          const int b_off = (c0 + 16 * np + (lane % 8) + 8 * (lane / 16)) * RS + 16 * ks +
                            8 * ((lane / 8) % 2);
          tc::ldsm_x4(qf, cQ + b_off);
          if constexpr (DK) tc::ldsm_x4(of, cO + b_off);
          tc::mma(s[2 * np], kf, qf[0], qf[1]);
          tc::mma(s[2 * np + 1], kf, qf[2], qf[3]);
          if constexpr (DK) {
            tc::mma(dp[2 * np], vf, of[0], of[1]);
            tc::mma(dp[2 * np + 1], vf, of[2], of[3]);
          }
        }
      }

      // P^T (dS^T) on the accumulators (kv row 16 strip + g + 8(e/2), q column
      // c0 + 8n + 2t + e%2), rounded once to bf16 A fragments over the q columns
      uint32_t af[SN / 2][4];
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const int c = c0 + 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(cL + c);
        const float2 d2 = *reinterpret_cast<const float2*>(cD + c);
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (need_mask) {
            const int kj = k0 + 16 * strip + g + 8 * (e >> 1);
            const int qi = q0 + c + (e & 1);
            const int qa = qi + offset;
            ok = qi < Sq && kj < Skv && (!causal || kj <= qa) && (window <= 0 || qa - kj < window);
          }
          const float l = (e & 1) ? l2.y : l2.x;
          const float p = ok ? exp2f(fmaf(s[n][e], sl2, -l * LOG2E)) : 0.f;
          if constexpr (DK) {
            x[e] = p * (dp[n][e] - ((e & 1) ? d2.y : d2.x)) * scale;
          } else {
            x[e] = p;
          }
        }
        af[n / 2][2 * (n % 2)] = tc::pack(x[0], x[1]);
        af[n / 2][2 * (n % 2) + 1] = tc::pack(x[2], x[3]);
      }

      // acc += dS^T Q (DK) or P^T dO over the part's QC q rows
      const __nv_bfloat16* cB = DK ? cQ : cO;
#pragma unroll
      for (int ks = 0; ks < QC / 16; ++ks) {
#pragma unroll
        for (int nd = 0; nd < NT / 2; ++nd) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, cB + (c0 + 16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * RS +
                                16 * nd + 8 * (lane / 16));
          tc::mma(acc[2 * nd], af[ks], bf[0], bf[1]);
          tc::mma(acc[2 * nd + 1], af[ks], bf[2], bf[3]);
        }
      }
    }
  };

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<1>();
    __syncthreads();  // this step's Q, dO, lse, delta (and on the first, K and V) have landed
    const int buf = it & 1;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const bool need_mask = q0 + BQ > Sq || k0 + BKV > Skv ||
                           (causal && k0 + BKV - 1 > q0 + offset) ||
                           (window > 0 && q0 + BQ - 1 + offset - k0 >= window);
    const __nv_bfloat16* cQ = sQ + buf * BQ * RS;
    const __nv_bfloat16* cO = sO + buf * BQ * RS;
    if (warp < 4)
      tile(std::true_type{}, cQ, cO, sL + buf * BQ, sDl + buf * BQ, q0, need_mask);
    else
      tile(std::false_type{}, cQ, cO, sL + buf * BQ, sDl + buf * BQ, q0, need_mask);

    __syncthreads();  // every warp is done with this stage before it is refilled
    if (it + 2 < n_it) load_q(it + 2, buf);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();

  __nv_bfloat16* out = (warp < 4 ? dk : dv) + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + 16 * strip + g + 8 * r;
    if (kj >= Skv) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(out + (size_t)kj * kv_stride + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) row[4 * n] = tc::pack(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int K, int causal,
                   int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BN = BwdPlan<D>::BN;   // kv rows a tile
  constexpr int RS = D + 8;   // padded smem row, bf16 elements
  constexpr int KS = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int NT = D / 8;   // n-tiles of dQ
  constexpr int SN = BN / 8;  // n-tiles of S and dP

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + BQ * RS;        // dO
  __nv_bfloat16* sK = sO + BQ * RS;        // [2][BN][RS]
  __nv_bfloat16* sV = sK + 2 * BN * RS;    // [2][BN][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
  const int kvh = h / (H / K);
  const int offset = Skv - Sq;
  const float sl2 = scale * LOG2E;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)K * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;

  // the kv tiles the forward visits for this q tile
  const int q_first = q0 + offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + offset;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_lo = kv_lo / BN;
  const int n_tiles = kv_hi > 0 ? (kv_hi + BN - 1) / BN - t_lo : 0;

  tile_async<D>(sQ, q + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0, Sq, tid);
  tile_async<D>(sO, dout + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0, Sq, tid);
  if (n_tiles > 0) {
    tile_async<D, BN>(sK, kb, kv_stride, t_lo * BN, Skv, tid);
    tile_async<D, BN>(sV, vb, kv_stride, t_lo * BN, Skv, tid);
  }
  tc::cp_async_commit();
  if (n_tiles > 1) {
    tile_async<D, BN>(sK + BN * RS, kb, kv_stride, (t_lo + 1) * BN, Skv, tid);
    tile_async<D, BN>(sV + BN * RS, vb, kv_stride, (t_lo + 1) * BN, Skv, tid);
  }
  tc::cp_async_commit();

  // lse (in log2 units) and delta of this thread's rows 16w + g and 16w + g + 8
  float l2r[2], dlr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    const size_t row = ((size_t)b * H + h) * Sq + qi;
    l2r[r] = qi < Sq ? lse[row] * LOG2E : 0.f;
    dlr[r] = qi < Sq ? delta[row] : 0.f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<1>();
    __syncthreads();  // this tile (and on the first pass Q and dO) has landed
    const int buf = it & 1;
    const int k0 = (t_lo + it) * BN;
    const __nv_bfloat16* cK = sK + buf * BN * RS;
    const __nv_bfloat16* cV = sV + buf * BN * RS;

    // S = Q K^T and dP = dO V^T: 16 q rows x BN kv columns per warp
    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qf[4], of[4];
      const int a_off = (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * RS + 16 * ks +
                        8 * (lane / 16);
      tc::ldsm_x4(qf, sQ + a_off);
      tc::ldsm_x4(of, sO + a_off);
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kf[4], vf[4];
        const int b_off = (16 * np + (lane % 8) + 8 * (lane / 16)) * RS + 16 * ks +
                          8 * ((lane / 8) % 2);
        tc::ldsm_x4(kf, cK + b_off);
        tc::ldsm_x4(vf, cV + b_off);
        tc::mma(s[2 * np], qf, kf[0], kf[1]);
        tc::mma(s[2 * np + 1], qf, kf[2], kf[3]);
        tc::mma(dp[2 * np], of, vf[0], vf[1]);
        tc::mma(dp[2 * np + 1], of, vf[2], vf[3]);
      }
    }

    // dS on the accumulators (q row 16w + g + 8(e/2), kv column k0 + 8n + 2t + e%2),
    // rounded once to bf16 A fragments over the kv columns
    const bool need_mask = k0 + BN > Skv || (causal && k0 + BN - 1 > q_first) ||
                           (window > 0 && k0 <= q_last - window);
    uint32_t df[SN / 2][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (need_mask) {
          const int kj = k0 + 8 * n + 2 * t + (e & 1);
          const int qa = q0 + 16 * warp + g + 8 * (e >> 1) + offset;
          ok = kj < Skv && (!causal || kj <= qa) && (window <= 0 || qa - kj < window);
        }
        const float p = ok ? exp2f(fmaf(s[n][e], sl2, -l2r[e >> 1])) : 0.f;
        ds[e] = p * (dp[n][e] - dlr[e >> 1]) * scale;
      }
      df[n / 2][2 * (n % 2)] = tc::pack(ds[0], ds[1]);
      df[n / 2][2 * (n % 2) + 1] = tc::pack(ds[2], ds[3]);
    }

    // dQ += dS K, K's B fragments through ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
#pragma unroll
      for (int nd = 0; nd < NT / 2; ++nd) {
        uint32_t kf[4];
        tc::ldsm_x4_t(kf, cK + (16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * RS + 16 * nd +
                              8 * (lane / 16));
        tc::mma(acc[2 * nd], df[ks], kf[0], kf[1]);
        tc::mma(acc[2 * nd + 1], df[ks], kf[2], kf[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage before it is refilled
    if (it + 2 < n_tiles) {
      tile_async<D, BN>(sK + buf * BN * RS, kb, kv_stride, (t_lo + it + 2) * BN, Skv, tid);
      tile_async<D, BN>(sV + buf * BN * RS, vb, kv_stride, (t_lo + it + 2) * BN, Skv, tid);
    }
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + (size_t)b * Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    if (qi >= Sq) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(dqb + (size_t)qi * q_stride + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) row[4 * n] = tc::pack(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// delta = rowsum(dO o O) [B,H,Sq]: the first launch of both designs
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int Sq, int H,
                         int D, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  constexpr int RPB = BWD_THREADS / 32;
  bwd_delta_kernel<T><<<(unsigned)((rows + RPB - 1) / RPB), BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq, H, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* delta, void* dq,
                            void* dk, void* dv, int B, int Sq, int Skv, int H, int K,
                            int causal, int window, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  cudaError_t err = launch_delta<bf16>(o, dout, delta, B, Sq, H, D, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = dq_tc_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  bwd_dq_bf16_kernel<D><<<dim3(H, B, (Sq + BQ - 1) / BQ), TC_THREADS, dq_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dq), Sq, Skv, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t kv_smem = dkdv_tc_smem_bytes<D>();
  const dim3 kv_grid(K, B, (Skv + BKV - 1) / BKV);
  if constexpr (BwdPlan<D>::SPLIT) {
    err = cudaFuncSetAttribute(bwd_dkdv_split_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
    if (err != cudaSuccess) return err;
    bwd_dkdv_split_bf16_kernel<D><<<kv_grid, 2 * TC_THREADS, kv_smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv,
        H, K, causal, window, scale);
  } else {
    err = cudaFuncSetAttribute(bwd_dkdv_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
    if (err != cudaSuccess) return err;
    bwd_dkdv_bf16_kernel<D><<<kv_grid, TC_THREADS, kv_smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv,
        H, K, causal, window, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq,
                           void* dk, void* dv, int B, int Sq, int Skv, int H, int K,
                           int causal, int window, float scale, cudaStream_t stream) {
  using T = float;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  cudaError_t err = launch_delta<T>(o, dout, delta, B, Sq, H, D, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t dq_smem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<dim3((Sq + BQ - 1) / BQ, H, B), BWD_THREADS, dq_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), Sq, Skv, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t kv_smem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, D><<<dim3((Skv + BKV - 1) / BKV, K, B), BWD_THREADS, kv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, K,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dtype(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int B, int Sq, int Skv, int H, int K,
                             int causal, int window, float scale, int dtype,
                             cudaStream_t stream) {
  if (dtype == 1)
    return launch_bwd_bf16<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, K,
                              causal, window, scale, stream);
  return launch_bwd_f32<D>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, K,
                           causal, window, scale, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = f32 (the
// CUDA-core design), 1 = bf16 (the tensor-core design). `lse` is null (serving:
// nothing extra is written) or an f32 [B, H, Sq] that receives each row's
// log-sum-exp of the scaled scores, the residual the backward needs.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int H, int K,
                                   int D, int causal, int window, float scale,
                                   int dtype, void* stream, void* lse) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 64: return (int)launch<64>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 80: return (int)launch<80>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 112: return (int)launch<112>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 128: return (int)launch<128>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 256: return (int)launch<256>(q, k, v, o, l, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq [B,Sq,H,D], dk / dv [B,Skv,K,D] (the inputs' dtype) from q, k, v, o, dO (one
// dtype, contiguous) and the forward's f32 lse [B,H,Sq]; `delta` is f32 [B,H,Sq]
// scratch. Three launches on `stream`; returns the first cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                   int Skv, int H, int K, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || H % K != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch_bwd_dtype<32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 64: return (int)launch_bwd_dtype<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 80: return (int)launch_bwd_dtype<80>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 112: return (int)launch_bwd_dtype<112>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 128: return (int)launch_bwd_dtype<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    case 256: return (int)launch_bwd_dtype<256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Skv, H, K, causal, window, scale, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
