// Mamba-2 SSD chunked scan for Hopper (sm_90a), forward and backward, with a plain
// C interface for ctypes. The backward's design is in its own note, below.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas` of
// src/repro/kernels/ssd_scan.py. It computes what the JAX package's model path
// computes, the jnp `_ssd_blocked` of src/repro/kernels/ops.py: y and the final
// state, from an optional initial state, for any S. Single B/C group (G = 1).
//
//   x [B, S, H, P], bm/cm [B, S, N] (f32 or bf16, one dtype; any batch and row
//     strides, the last dim contiguous, x's heads P apart)
//   dt [B, S, H] f32 (> 0), A [H] f32 (< 0), init_state [B, H, N, P] f32 or null
//   y [B, S, H, P] (contiguous) in x's dtype, final_state [B, H, N, P] f32.
//
// Per chunk of Q rows, with cum = cumsum(dt * A) from the chunk's start:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i . h
//   h'    = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// The SSD math does not depend on the chunk length except through rounding, so
// the kernel walks its own tiles of Q = 64 rows whatever the model's chunk is.
// Rows at or past S act as dt = 0, x = B = C = 0 and are not written: exactly
// the zero padding of `_ssd_blocked`, without a padded copy. x, B and C are read
// in place through their strides, so the model's conv output needs no copies.
//
// Both designs share one plan. The TPU kernel carries the [N, P] state in VMEM
// across a sequential chunk grid axis; Hopper blocks run in no order, so each
// block loops over the chunks itself with its state on chip. One block per
// (32-column tile of P, head, batch): y[:, p] needs only state[:, p] and
// x[:, p], while C.B^T and the decay are shared by the columns, so the P tiles
// are independent and the grid has P/32 * H * B blocks (160 for mamba2-2.7b at
// B = 1, more than the 132 SMs). C.B^T is recomputed by each P tile and head;
// one pass keeps the state out of device memory and costs one launch a layer.
// Overflow: L[i,j] = exp(cum_i - cum_j) is formed from the difference, never as
// exp(cum_i) * exp(-cum_j), and only for j <= i, so the positive upper triangle
// never becomes inf (and inf * 0 never becomes NaN).
//
// What bounds it on the H100. At the serving shape (B=1, S=512, H=80, P=64,
// N=128, bf16) it moves 13.5 MB (0.004 ms at 3.35 TB/s) and needs 2.0 GFLOP with
// C.B^T counted once per chunk (0.002 ms on the bf16 tensor cores): bytes.
//
// bf16 (dtype 1), the serving path: tensor cores. 4 warps. The next chunk's B, C
//   (bf16 [64, N]), x ([64, 32]) and dt are copied in with cp.async while this
//   chunk computes (two stages; rows padded by 16 bytes, so every ldmatrix is
//   conflict-free). All four products are mma.sync.m16n8k16 bf16 -> f32:
//     1. G = C.B^T, one 16-column block at a time, only at or left of the
//        diagonal; each warp owns 16 rows of the chunk for 1-3;
//     2. the block's score G * exp(cum_i - cum_j) * dt_j, formed in f32 on the
//        accumulators, times raw bf16 x, right after its G: the exponentials
//        of one block overlap the products of the next;
//     3. the readout C.h of the carried state;
//     4. the state update B^T.(w x), w_j = exp(cum_last - cum_j) dt_j, with each
//        warp owning 8 columns of the [N, 32] f32 state, kept in registers as
//        the accumulator across chunks (B^T's fragments come from ldmatrix.trans).
//   Per row, cum, w, exp(cum) and the decay to its 16-row block's end are formed
//   once per warp by the cumsum's lanes; left of the diagonal the score's decay
//   is a product of two such factors, so only the diagonal block takes an
//   exponential per element.
//   Operands that are not bf16 inputs (the score, the state, w x) enter as a
//   bf16 hi + lo pair, two products instead of one rounding, so the bf16 design
//   keeps ~16 bits of their mantissa and stays near the f32 result at the
//   64-layer check. The state is published to shared memory as hi + lo after
//   each chunk for every warp's readout. ~103 KB of shared memory at N = 128:
//   two blocks an SM. Bound by the latency of the chunk loop (8 dependent
//   chunks at S = 512, each a chain of products, exponentials and two
//   barriers run by one warp per scheduler), not by the mma rate or bytes.
// f32 (dtype 0), the check path: the exact CUDA-core design. 256 threads; B, C,
//   x*dt, the [64, 64] score tile and the [N, 32] state staged in shared memory
//   as f32 (~108 KB); f32 FMAs (67 TFLOP/s) keep f32 inputs within 2e-4 of the
//   reference, which TF32 tensor cores would not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>


#include "tensor_core.cuh"

namespace {

constexpr int Q = 64;         // rows per chunk tile
constexpr int PT = 32;        // columns of P per block

// ------------------------------------------------------------ f32: CUDA cores
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = 4;        // score / y rows per thread (Q / 16)
constexpr int CPT = 4;        // score columns per thread (Q / 16)
constexpr int YPT = 2;        // y / state columns per thread (PT / 16)

template <int N>
constexpr size_t smem_floats() {
  // sB, sC [Q][N+1]; sXdt [Q][PT]; sS [Q][Q+1]; sH [N][PT]; sCum, sDt, sOut, sIn [Q]
  return 2 * (size_t)Q * (N + 1) + (size_t)Q * PT + (size_t)Q * (Q + 1) +
         (size_t)N * PT + 4 * (size_t)Q;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ init_state,
                float* __restrict__ y, float* __restrict__ final_state, int S, int H,
                int P, long long sxb, long long sxs, long long sbb, long long sbs,
                long long scb, long long scs) {
  static_assert(N % 16 == 0, "state dim must be a multiple of 16");
  constexpr int NP = N + 1;     // padded row stride of sB and sC
  constexpr int QP = Q + 1;     // padded row stride of sS
  constexpr int NPT = N / 16;   // state rows per thread in the update

  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = sB + Q * NP;
  float* sXdt = sC + Q * NP;
  float* sS = sXdt + Q * PT;
  float* sH = sS + Q * QP;
  float* sCum = sH + N * PT;
  float* sDt = sCum + Q;
  float* sOut = sDt + Q;   // exp(cum_last - cum_j): decay from row j to the chunk's end
  float* sIn = sOut + Q;   // exp(cum_i): decay of the carried state up to row i

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float a = A[h];

  const size_t yrow = (size_t)H * P;   // between consecutive y rows
  const float* xb = x + b * sxb + (size_t)h * P + p0;
  float* yb = y + (size_t)b * S * yrow + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)b * S * H + h;
  const float* bb = bm + b * sbb;
  const float* cb = cm + b * scb;
  const size_t st = ((size_t)b * H + h) * N * P + p0;   // state [B,H,N,P] at p0

  for (int i = tid; i < N * PT; i += THREADS) {
    const int n = i / PT, p = i % PT;
    sH[i] = init_state ? init_state[st + (size_t)n * P + p] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();  // the previous chunk's reads of sB, sXdt, sOut are done
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, n = i % N;
      const bool ok = r < rows;
      sB[r * NP + n] = ok ? bb[(c0 + r) * sbs + n] : 0.f;
      sC[r * NP + n] = ok ? cb[(c0 + r) * scs + n] : 0.f;
    }
    if (tid < Q) sDt[tid] = tid < rows ? dtb[(size_t)(c0 + tid) * H] : 0.f;
    __syncthreads();

    for (int i = tid; i < Q * PT; i += THREADS) {
      const int r = i / PT, p = i % PT;
      sXdt[i] = r < rows ? xb[(c0 + r) * sxs + p] * sDt[r] : 0.f;
    }
    if (tid < 32) {  // inclusive cumsum of dt * A over the Q = 64 rows, by warp 0
      const float v0 = sDt[2 * tid] * a, v1 = sDt[2 * tid + 1] * a;
      float s = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += t;
      }
      const float before = __shfl_up_sync(0xffffffffu, s, 1);  // sum of the lanes below
      sCum[2 * tid] = tid ? before + v0 : v0;
      sCum[2 * tid + 1] = tid ? before + v0 + v1 : v0 + v1;
    }
    __syncthreads();
    if (tid < Q) {
      sOut[tid] = expf(sCum[Q - 1] - sCum[tid]);
      sIn[tid] = expf(sCum[tid]);
    }

    // scores: (C_i . B_j) exp(cum_i - cum_j) for j <= i, rows ty*RPT+i, columns tx+16*j
    {
      float s[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RPT], bv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cv[i] = sC[(ty * RPT + i) * NP + n];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bv[j] = sB[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 16 * j;
          sS[r * QP + c] = c <= r ? s[i][j] * expf(sCum[r] - sCum[c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y: the intra-chunk product plus the carried state's readout
    {
      float yi[RPT][YPT], yh[RPT][YPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < YPT; ++e) yi[i][e] = yh[i][e] = 0.f;
      const int jmax = ty * RPT + RPT;  // columns past the last row are masked
      for (int j = 0; j < jmax; ++j) {
        float sv[RPT], xv[YPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) sv[i] = sS[(ty * RPT + i) * QP + j];
#pragma unroll
        for (int e = 0; e < YPT; ++e) xv[e] = sXdt[j * PT + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < YPT; ++e) yi[i][e] = fmaf(sv[i], xv[e], yi[i][e]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RPT], hv[YPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cv[i] = sC[(ty * RPT + i) * NP + n];
#pragma unroll
        for (int e = 0; e < YPT; ++e) hv[e] = sH[n * PT + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < YPT; ++e) yh[i][e] = fmaf(cv[i], hv[e], yh[i][e]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
        if (r >= rows) continue;
#pragma unroll
        for (int e = 0; e < YPT; ++e)
          yb[(size_t)(c0 + r) * yrow + tx + 16 * e] = yi[i][e] + sIn[r] * yh[i][e];
      }
    }
    __syncthreads();  // every read of sH for this chunk's y is done

    // state update: h = exp(cum_last) h + sum_j (B_j exp(cum_last - cum_j)) (x_j dt_j)^T
    {
      const float seg = expf(sCum[Q - 1]);
      float u[NPT][YPT];
#pragma unroll
      for (int k = 0; k < NPT; ++k)
#pragma unroll
        for (int e = 0; e < YPT; ++e) u[k][e] = 0.f;
      for (int j = 0; j < rows; ++j) {
        const float w = sOut[j];
        float bv[NPT], xv[YPT];
#pragma unroll
        for (int k = 0; k < NPT; ++k) bv[k] = sB[j * NP + ty * NPT + k] * w;
#pragma unroll
        for (int e = 0; e < YPT; ++e) xv[e] = sXdt[j * PT + tx + 16 * e];
#pragma unroll
        for (int k = 0; k < NPT; ++k)
#pragma unroll
          for (int e = 0; e < YPT; ++e) u[k][e] = fmaf(bv[k], xv[e], u[k][e]);
      }
#pragma unroll
      for (int k = 0; k < NPT; ++k)
#pragma unroll
        for (int e = 0; e < YPT; ++e) {
          const int idx = (ty * NPT + k) * PT + tx + 16 * e;
          sH[idx] = fmaf(seg, sH[idx], u[k][e]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * PT; i += THREADS) {
    const int n = i / PT, p = i % PT;
    final_state[st + (size_t)n * P + p] = sH[i];
  }
}

// ------------------------------------------------------------ bf16: tensor cores
constexpr int TC_THREADS = 128;  // 4 warps

template <int N>
struct TcSmem {
  static constexpr int BR = N + 8;    // padded row of the B and C tiles, bf16 elements
  static constexpr int XR = PT + 8;   // padded row of the x tile and of the state copies
  static constexpr int B_TILE = Q * BR, X_TILE = Q * XR, H_TILE = N * XR;  // elements
  // a stage: B, C, x (bf16) and dt (f32); two stages, then the state's hi and lo
  // copies (bf16), then per warp four per-row factors (f32, see the kernel)
  static constexpr size_t STAGE = (2 * (size_t)B_TILE + X_TILE) * 2 + Q * 4;
  static constexpr size_t bytes = 2 * STAGE + 2 * (size_t)H_TILE * 2 + 4 * 4 * Q * 4;
};

template <int N>
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_scan_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const __nv_bfloat16* __restrict__ bm,
                     const __nv_bfloat16* __restrict__ cm,
                     const float* __restrict__ init_state, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ final_state, int S, int H, int P, long long sxb,
                     long long sxs, long long sbb, long long sbs, long long scb,
                     long long scs) {
  static_assert(N % 16 == 0, "state dim must be a multiple of 16");
  using L = TcSmem<N>;
  using bf16 = __nv_bfloat16;
  constexpr int NK = N / 16;  // k-steps over the state dim, and m-tiles of the state
  constexpr float LOG2E = 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sHhi = reinterpret_cast<bf16*>(smem_raw + 2 * L::STAGE);
  bf16* sHlo = sHhi + L::H_TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this warp's copy of, per row r of the chunk: cum_r, w_r = exp(cum_last - cum_r) dt_r,
  // exp(cum_r), and v_r = exp(cum_e - cum_r) dt_r with e the last row of r's 16-row block
  float* cw = reinterpret_cast<float*>(sHlo + L::H_TILE) + warp * 4 * Q;
  float* ww = cw + Q;
  float* win = ww + Q;
  float* vw = win + Q;

  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const float a = A[h];
  const bf16* xb = x + b * sxb + (size_t)h * P + p0;
  const bf16* bb = bm + b * sbb;
  const bf16* cb = cm + b * scb;
  const float* dtb = dt + (size_t)b * S * H + h;
  const size_t yrow = (size_t)H * P;
  bf16* yb = y + (size_t)b * S * yrow + (size_t)h * P + p0;
  const size_t st = ((size_t)b * H + h) * N * P + p0;   // state [B,H,N,P] at p0
  const int n_chunks = (S + Q - 1) / Q;

  auto stage_b = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * L::STAGE); };
  auto stage_dt = [&](int s) {
    return reinterpret_cast<float*>(stage_b(s) + 2 * L::B_TILE + L::X_TILE);
  };

  auto load_chunk = [&](int c, int s) {
    bf16* dB = stage_b(s);
    bf16* dC = dB + L::B_TILE;
    bf16* dX = dC + L::B_TILE;
    const int r0 = c * Q;
    constexpr int CH = N / 8;  // 16-byte pieces per row of B and C
    static_assert(Q * CH % TC_THREADS == 0, "whole pieces per thread");
#pragma unroll
    for (int j = 0; j < Q * CH / TC_THREADS; ++j) {
      const int i = tid + j * TC_THREADS;
      const int r = i / CH, k = i % CH;
      const bool ok = r0 + r < S;
      const long long row = ok ? r0 + r : 0;
      tc::cp_async16(dB + r * L::BR + 8 * k, bb + row * sbs + 8 * k, ok);
      tc::cp_async16(dC + r * L::BR + 8 * k, cb + row * scs + 8 * k, ok);
    }
#pragma unroll
    for (int j = 0; j < Q * (PT / 8) / TC_THREADS; ++j) {
      const int i = tid + j * TC_THREADS;
      const int r = i / (PT / 8), k = i % (PT / 8);
      const bool ok = r0 + r < S;
      tc::cp_async16(dX + r * L::XR + 8 * k, xb + (ok ? r0 + r : 0) * sxs + 8 * k, ok);
    }
    if (tid < Q) {
      const bool ok = r0 + tid < S;
      tc::cp_async4(stage_dt(s) + tid, dtb + (size_t)(ok ? r0 + tid : 0) * H, ok);
    }
  };

  // the state: this warp owns columns 8*warp .. 8*warp+7 of the block's 32 and
  // all N rows, as mma accumulators: hs[m][.] holds rows 16m + g (+ 8), columns
  // 8*warp + 2t (+ 1)
  float hs[NK][4];
#pragma unroll
  for (int mt = 0; mt < NK; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 16 * mt + g + 8 * half, p = 8 * warp + 2 * t;
      const float2 v = init_state
                           ? *reinterpret_cast<const float2*>(init_state + st + (size_t)n * P + p)
                           : make_float2(0.f, 0.f);
      hs[mt][2 * half] = v.x;
      hs[mt][2 * half + 1] = v.y;
    }
  auto publish_state = [&]() {  // the carried state as bf16 hi + lo, for every warp's readout
#pragma unroll
    for (int mt = 0; mt < NK; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int idx = (16 * mt + g + 8 * half) * L::XR + 8 * warp + 2 * t;
        uint32_t hi, lo;
        tc::split(hs[mt][2 * half], hs[mt][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sHhi + idx) = hi;
        *reinterpret_cast<uint32_t*>(sHlo + idx) = lo;
      }
  };

  load_chunk(0, 0);
  tc::cp_async_commit();
  publish_state();

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk c and the carried state's copy are visible to every thread,
                      // and every warp is done with the other stage
    if (c + 1 < n_chunks) load_chunk(c + 1, s ^ 1);  // lands while this chunk computes
    tc::cp_async_commit();
    const bf16* cB = stage_b(s);
    const bf16* cC = cB + L::B_TILE;
    const bf16* cX = cC + L::B_TILE;
    const float* cDt = stage_dt(s);

    {  // inclusive cumsum of dt * A over the 64 rows (lane l: rows 2l, 2l+1), per warp
      const float2 d = *reinterpret_cast<const float2*>(cDt + 2 * lane);
      const float v0 = d.x * a, v1 = d.y * a;
      float sum = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) sum += u;
      }
      const float before = __shfl_up_sync(0xffffffffu, sum, 1);  // sum of the lanes below
      const float last = __shfl_sync(0xffffffffu, sum, 31);
      const float c0 = lane ? before + v0 : v0;
      const float c1 = lane ? before + v0 + v1 : v0 + v1;
      *reinterpret_cast<float2*>(cw + 2 * lane) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(ww + 2 * lane) =
          make_float2(exp2f((last - c0) * LOG2E) * d.x, exp2f((last - c1) * LOG2E) * d.y);
      *reinterpret_cast<float2*>(win + 2 * lane) =
          make_float2(exp2f(c0 * LOG2E), exp2f(c1 * LOG2E));
      const float ce = __shfl_sync(0xffffffffu, c1, 8 * (lane / 8) + 7);  // block's last row
      *reinterpret_cast<float2*>(vw + 2 * lane) =
          make_float2(exp2f((ce - c0) * LOG2E) * d.x, exp2f((ce - c1) * LOG2E) * d.y);
      __syncwarp();
    }
    const int i0 = 16 * warp + g;  // this thread's rows of the chunk: i0 and i0 + 8
    const float ci[2] = {cw[i0], cw[i0 + 8]};

    // C fragments of this warp's 16 rows: the A operand of C.h and of C.B^T
    uint32_t cf[NK][4];
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      tc::ldsm_x4(cf[ks], cC + (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * L::BR +
                              16 * ks + 8 * (lane / 16));

    // 3. the readout C.h of the carried state, h entering as bf16 hi + lo (none
    // while the state is the zero initial state)
    float yh[4][4], yi[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[n][e] = yh[n][e] = 0.f;
    if (c > 0 || init_state) {
#pragma unroll
      for (int ks = 0; ks < NK; ++ks)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int off = (16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR + 16 * pp +
                          8 * (lane / 16);
          uint32_t hf[4];
          tc::ldsm_x4_t(hf, sHhi + off);
          tc::mma(yh[2 * pp], cf[ks], hf[0], hf[1]);
          tc::mma(yh[2 * pp + 1], cf[ks], hf[2], hf[3]);
          tc::ldsm_x4_t(hf, sHlo + off);
          tc::mma(yh[2 * pp], cf[ks], hf[0], hf[1]);
          tc::mma(yh[2 * pp + 1], cf[ks], hf[2], hf[3]);
        }
    }

    // 1. and 2., one 16-column block of the chunk at a time, left of or on the
    // diagonal: G = C.B^T, the score G exp(cum_i - cum_j) dt_j (j <= i, in f32),
    // and y += score . x with the score entering as bf16 hi + lo
    for (int jb = 0; jb <= warp; ++jb) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, cB + (16 * jb + (lane % 8) + 8 * (lane / 16)) * L::BR + 16 * ks +
                            8 * ((lane / 8) % 2));
        tc::mma(sc[0], cf[ks], bf[0], bf[1]);
        tc::mma(sc[1], cf[ks], bf[2], bf[3]);
      }
      // left of the diagonal every j < i, and exp(cum_i - cum_j) splits at the
      // block's last row e into exp(cum_i - cum_e) exp(cum_e - cum_j), both <= 1
      float u[2];
      if (jb < warp) {
        const float ce = cw[16 * jb + 15];
        u[0] = exp2f((ci[0] - ce) * LOG2E);
        u[1] = exp2f((ci[1] - ce) * LOG2E);
      }
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 16 * jb + 8 * n + 2 * t, i = i0 + 8 * r;
          float s0, s1;
          if (jb < warp) {
            const float2 vj = *reinterpret_cast<const float2*>(vw + j);
            s0 = sc[n][2 * r] * u[r] * vj.x;
            s1 = sc[n][2 * r + 1] * u[r] * vj.y;
          } else {
            const float2 cj = *reinterpret_cast<const float2*>(cw + j);
            const float2 dj = *reinterpret_cast<const float2*>(cDt + j);
            s0 = j <= i ? sc[n][2 * r] * exp2f((ci[r] - cj.x) * LOG2E) * dj.x : 0.f;
            s1 = j + 1 <= i ? sc[n][2 * r + 1] * exp2f((ci[r] - cj.y) * LOG2E) * dj.y : 0.f;
          }
          tc::split(s0, s1, ahi[2 * n + r], alo[2 * n + r]);
        }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t xf[4];
        tc::ldsm_x4_t(xf, cX + (16 * jb + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR +
                              16 * pp + 8 * (lane / 16));
        tc::mma(yi[2 * pp], ahi, xf[0], xf[1]);
        tc::mma(yi[2 * pp], alo, xf[0], xf[1]);
        tc::mma(yi[2 * pp + 1], ahi, xf[2], xf[3]);
        tc::mma(yi[2 * pp + 1], alo, xf[2], xf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c * Q + i0 + 8 * r;
      if (row >= S) continue;
      const float decay_in = win[i0 + 8 * r];
      uint32_t* out = reinterpret_cast<uint32_t*>(yb + row * yrow + 2 * t);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        out[4 * n] = tc::pack(fmaf(decay_in, yh[n][2 * r], yi[n][2 * r]),
                              fmaf(decay_in, yh[n][2 * r + 1], yi[n][2 * r + 1]));
    }

    // 4. h = exp(cum_last) h + B^T (w x), w x entering as bf16 hi + lo
    const float seg = win[Q - 1];
#pragma unroll
    for (int mt = 0; mt < NK; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[mt][e] *= seg;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      // x rows 32kp .. 32kp+31 at this warp's 8 columns: B fragments of two k-steps
      uint32_t xr[4], xhi[4], xlo[4];
      tc::ldsm_x4_t(xr, cX + (32 * kp + lane) * L::XR + 8 * warp);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xv = tc::unpack(xr[q]);
        const float2 w = *reinterpret_cast<const float2*>(ww + 32 * kp + 8 * q + 2 * t);
        tc::split(xv.x * w.x, xv.y * w.y, xhi[q], xlo[q]);
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int ks = 2 * kp + kk;
#pragma unroll
        for (int mt = 0; mt < NK; ++mt) {
          uint32_t bt[4];
          tc::ldsm_x4_t(bt, cB + (16 * ks + (lane % 8) + 8 * (lane / 16)) * L::BR + 16 * mt +
                                8 * ((lane / 8) % 2));
          tc::mma(hs[mt], bt, xhi[2 * kk], xhi[2 * kk + 1]);
          tc::mma(hs[mt], bt, xlo[2 * kk], xlo[2 * kk + 1]);
        }
      }
    }

    __syncthreads();  // every warp's readout of the old state is done
    publish_state();
  }

#pragma unroll
  for (int mt = 0; mt < NK; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 16 * mt + g + 8 * half, p = 8 * warp + 2 * t;
      *reinterpret_cast<float2*>(final_state + st + (size_t)n * P + p) =
          make_float2(hs[mt][2 * half], hs[mt][2 * half + 1]);
    }
}

// ------------------------------------------------------------ backward
// The gradient of the scan for the cotangents dy of y and d_final of the final
// state. Per chunk c of Q = 64 rows, with h_c the state entering it, dh_c the
// cotangent of the state leaving it, G = C B^T, L_ij = exp(cum_i - cum_j) for
// j <= i, S' = G o L, W'_ij = L_ij (dy_i . x_j), W_ij = W'_ij dt_j and
// w_j = exp(seg - cum_j) dt_j:
//   h_{c+1}  = exp(seg) h_c + B^T diag(w) X                  (forward walk)
//   dh_{c-1} = exp(seg) dh_c + C^T diag(exp(cum)) dY         (reverse walk)
//   dxs_j  = sum_i S'_ij dy_i + exp(seg - cum_j) B_j dh_c,   dx_j = dt_j dxs_j
//   dC_i   = sum_j W_ij B_j + exp(cum_i) h_c dy_i
//   dB_j   = sum_i W_ij C_i + w_j dh_c x_j
//   dcum_i = dy_i . y_i - dt_i x_i . dxs_i  (+ <h_{c+1}, dh_c> on the last row)
//   ddt = x . dxs + A rc (rc: the reverse cumsum of dcum in the chunk), dA = sum dt rc
// dx and d(init_state) are per head; dB, dC and dA sum over heads (dB, dC) or
// rows (dA), which cross blocks. Why the states are recomputed and not kept by
// the forward: the forward kernels stay as serving runs them, and the training
// step keeps no [B, nc, H, N, P] f32 state per layer through the step (84 MB a
// layer at mamba2-2.7b's 2,048 tokens, 5.4 GB over 64 layers, on a step that
// fills most of the card). Overflow: exp(cum_i - cum_j) is formed only for
// j <= i, and every other factor (exp(cum_i), exp(seg - cum_j)) is <= 1. Rows at
// or past S are staged as zeros with dt = 0 (the forward's padding) and get
// nothing written; the chunk's d(seg) goes on its last row, whose rc every row
// inside S includes. No atomics: two runs give the same bits.
//
// What bounds it on the H100: at the training shape (B=1, S=2048, H=80, P=64,
// N=128, bf16) the gradient reads ~30 MB and writes ~30 MB (~0.02 ms at 3.35
// TB/s) for ~16 GFLOP counted once (~0.02 ms on the bf16 tensor cores). A design
// that parallelises over chunks must also keep h_c and dh_c for every chunk and
// head between its passes: 84 MB each in f32, written once and read once
// (~0.1 ms), and with the f32 operands split into bf16 hi + lo pairs its
// products come to ~50 GFLOP on mma.sync. Measured on an H100 SXM at 700 W, at
// that shape: the walk takes ~0.11 ms, set by its 168 MB of plane stores; the
// gradients ~0.20 ms, set by instruction issue and latency at one 8-warp block
// an SM (a variant without any mma.sync ran as fast), not by the tensor cores.
//
// bf16 (dtype 1), the training path: three launches, all products
// mma.sync.m16n8k16 bf16 -> f32, with B, C, x and dy entering as they are and
// every f32 operand (S', W, h_c, dh_c, w x, exp(cum) dy) as a bf16 hi + lo pair
// (~16 bits of mantissa, two products instead of one rounding).
//   1. ssd_scan_bwd_states, (a) and (b) fused: one block per (64-row tile of N,
//      head, batch, direction) walks the chunks, forward from init_state with B
//      and w x, or in reverse from d_final with C and exp(cum) dy, the [64, P]
//      f32 state in registers as mma accumulators (the forward's state update,
//      a warp per P/4 columns), and writes the state at each chunk boundary as
//      bf16 hi and lo planes (h_c and dh_c, 84 MB each at the training shape;
//      the reverse walk's last state is d(init_state)), staged in shared memory
//      so that each thread stores 16 bytes (a warp's 4-byte pieces over 8 rows
//      wrote at ~0.75 TB/s). The local terms of a chunk do not depend on the
//      state, so each step is one accumulate; 2 * N/64 * H * B blocks (320).
//   2. ssd_scan_bwd_grad, (c): one block per (chunk, group of 10 heads, batch),
//      256 threads. C.B^T is formed once per block and kept in registers; per
//      head, with x, dy (two stages) and the planes of h_c and dh_c (one each,
//      each refilled for the next head as soon as its last reader is done) copied
//      in by cp.async: D = dY X^T on the chunk's lower triangle, S' and W to
//      shared memory as hi + lo; dC += exp(cum) (dY h_c^T) + W B and
//      dB += w (X dh_c^T) + W^T C in registers across the block's heads (a warp
//      per 16 rows and half of N: W B and W^T C take i >= j and j <= i blocks,
//      which balance across a warp's two products); dxs = exp(seg - cum)
//      (B dh_c) + S'^T dY and dx. dcum needs no y or dxs products:
//      dy_i . y_i = sum_j G_ij W_ij + exp(cum_i) C_i . (dY h_c^T)_i and
//      x_j . dxs_j = sum_i G_ij W'_ij + exp(seg - cum_j) B_j . (X dh_c^T)_j, and
//      <h_{c+1}, dh_c> = exp(seg) <h_c, dh_c> + sum_j w_j B_j . (X dh_c^T)_j, so
//      the block owns all of dcum, its reverse cumsum and ddt (one warp closes a
//      head while the others start the next), and writes dA's part of the chunk.
//      ~186 KB of shared memory at N = 128, P = 64: one block an SM; 10 heads a
//      block give 256 blocks at the training shape, two waves of 132 SMs.
//   3. ssd_scan_bwd_bf16_finish sums dB and dC over the ceil(H/10) groups' f32
//      rows (21 MB at the training shape) and dA over the (batch, chunk) parts,
//      in a fixed order.
// f32 (dtype 0), the check path: the exact CUDA-core design (TF32 would break
//   the f32 gates). Two launches:
//   1. ssd_scan_bwd_kernel, one block per (32-column tile of P, head, batch), as
//      the forward. It first walks the chunks forward and writes the state
//      entering each chunk, h_c (its [N, 32] slice), to a scratch buffer, then
//      walks them in reverse carrying dh on chip and reads h_c back, forming y
//      and dxs in f32 for dcum (the d(seg) term as
//      exp(seg) <h_c, dh> + sum_j dt_j x_j . (exp(seg - cum_j) B_j dh)).
//      dx and d(init_state) are complete per tile; dB, dC, dcum and x . dxs are
//      sums over the P tiles and (dB, dC) the heads, so each block writes its
//      own f32 partial rows of them.
//   2. ssd_scan_bwd_finish sums the partials in a fixed order: dB and dC over
//      the P/32 * H (tile, head) rows, one element a thread; and, one block a
//      head, the reverse cumsum of dcum within each 64-row chunk (a warp a
//      chunk), ddt = x . dxs + A rc, and dA = sum over B*S of dt rc, the warps'
//      sums added in warp order.
constexpr int XP = PT + 1;   // padded row of the x, dy and state tiles (floats)

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* A;
  const float* bm;
  const float* cm;
  const float* init_state;   // null: a zero initial state
  const float* dy;           // [B, S, H, P]
  const float* d_final;      // null: zero
  float* dx;                 // [B, S, H, P]
  float* ddt;                // [B, S, H]
  float* dA;                 // [H]
  float* dbm;                // [B, S, N]
  float* dcm;
  float* d_init;             // null: not wanted
  float* states;             // scratch [B, H, nc, N, P]: the state entering each chunk
  float* part_b;             // scratch [P/PT * H, B, S, N]: each (tile, head)'s dB rows
  float* part_c;             // the same for dC
  float* part_t;             // scratch [2, P/PT, B, S, H]: dcum and x . dxs per tile
  int B, S, H, P;
  long long sxb, sxs, sbb, sbs, scb, scs;
};

template <int N>
constexpr size_t bwd_smem_floats() {
  // sB, sC [Q][N+1]; sX, sDY [Q][XP]; sS, sW [Q][Q+1]; sH, sDH [N][XP];
  // sDt, sCum, sIn, sOut, sR1, sR2, sR3 [Q]; sRed [16]
  return 2 * (size_t)Q * (N + 1) + 2 * (size_t)Q * XP + 2 * (size_t)Q * (Q + 1) +
         2 * (size_t)N * XP + 7 * (size_t)Q + 16;
}

// inclusive cumsum of dt * a over the Q = 64 rows of sDt into sCum, by warp 0
__device__ __forceinline__ void chunk_cumsum(const float* sDt, float* sCum, float a) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const float v0 = sDt[2 * lane] * a, v1 = sDt[2 * lane + 1] * a;
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  const float before = __shfl_up_sync(0xffffffffu, s, 1);
  sCum[2 * lane] = lane ? before + v0 : v0;
  sCum[2 * lane + 1] = lane ? before + v0 + v1 : v0 + v1;
}

template <int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_bwd_kernel(BwdArgs g) {
  static_assert(N % 16 == 0, "state dim must be a multiple of 16");
  constexpr int NP = N + 1, QP = Q + 1, NPT = N / 16;
  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = sB + Q * NP;
  float* sX = sC + Q * NP;
  float* sDY = sX + Q * XP;
  float* sS = sDY + Q * XP;
  float* sW = sS + Q * QP;
  float* sH = sW + Q * QP;
  float* sDH = sH + N * XP;
  float* sDt = sDH + N * XP;
  float* sCum = sDt + Q;
  float* sIn = sCum + Q;    // exp(cum_i)
  float* sOut = sIn + Q;    // exp(cum_last - cum_j)
  float* sR1 = sOut + Q;    // dy_i . y_i over the tile
  float* sR2 = sR1 + Q;     // x_i . dxs_i
  float* sR3 = sR2 + Q;     // x_i . (the state part of dxs_i)
  float* sRed = sR3 + Q;    // the warps' partial sums of <h_c, dh>

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, p0 = tile * PT, h = blockIdx.y, b = blockIdx.z;
  const int S = g.S, H = g.H, P = g.P, NT = P / PT;
  const int nc = (S + Q - 1) / Q;
  const float a = g.A[h];
  const size_t yrow = (size_t)H * P;
  const float* xb = g.x + b * g.sxb + (size_t)h * P + p0;
  const float* bb = g.bm + b * g.sbb;
  const float* cb = g.cm + b * g.scb;
  const float* dyb = g.dy + (size_t)b * S * yrow + (size_t)h * P + p0;
  float* dxb = g.dx + (size_t)b * S * yrow + (size_t)h * P + p0;
  const float* dtb = g.dt + (size_t)b * S * H + h;
  const size_t st = ((size_t)b * H + h) * N * P + p0;            // [B,H,N,P] at p0
  float* hs = g.states + ((size_t)b * H + h) * nc * N * P + p0;  // [nc][N][P] at p0
  const size_t prow = ((size_t)(tile * H + h) * g.B + b) * S;    // partial rows [slot][b][.]
  const size_t bsh = (size_t)g.B * S * H;

  // stage chunk rows [c0, c0 + rows) of B (and C, dy), x and dt, zeros past S
  auto stage = [&](int c0, int rows, bool all) {
    for (int i = tid; i < Q * N; i += THREADS) {
      const int r = i / N, n = i % N;
      const bool ok = r < rows;
      sB[r * NP + n] = ok ? *(bb + (c0 + r) * g.sbs + n) : 0.f;
      if (all) sC[r * NP + n] = ok ? *(cb + (c0 + r) * g.scs + n) : 0.f;
    }
    for (int i = tid; i < Q * PT; i += THREADS) {
      const int r = i / PT, p = i % PT;
      const bool ok = r < rows;
      sX[r * XP + p] = ok ? *(xb + (c0 + r) * g.sxs + p) : 0.f;
      if (all) sDY[r * XP + p] = ok ? *(dyb + (size_t)(c0 + r) * yrow + p) : 0.f;
    }
    if (tid < Q) sDt[tid] = tid < rows ? dtb[(size_t)(c0 + tid) * H] : 0.f;
  };

  // ---- forward walk: h_c of every chunk into the scratch
  for (int i = tid; i < N * PT; i += THREADS) {
    const int n = i / PT, p = i % PT;
    sH[n * XP + p] = g.init_state ? g.init_state[st + (size_t)n * P + p] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q, rows = min(Q, S - c0);
    __syncthreads();   // the last update of sH and every read of the stage are done
    for (int i = tid; i < N * PT; i += THREADS) {
      const int n = i / PT, p = i % PT;
      hs[(size_t)c * N * P + (size_t)n * P + p] = sH[n * XP + p];
    }
    stage(c0, rows, false);
    __syncthreads();
    chunk_cumsum(sDt, sCum, a);
    __syncthreads();
    const float last = sCum[Q - 1], seg = expf(last);
    float u[NPT][2];
#pragma unroll
    for (int k = 0; k < NPT; ++k) u[k][0] = u[k][1] = 0.f;
    for (int j = 0; j < rows; ++j) {
      const float w = expf(last - sCum[j]) * sDt[j];
      const float x0 = sX[j * XP + tx] * w, x1 = sX[j * XP + tx + 16] * w;
#pragma unroll
      for (int k = 0; k < NPT; ++k) {
        const float bv = sB[j * NP + ty * NPT + k];
        u[k][0] = fmaf(bv, x0, u[k][0]);
        u[k][1] = fmaf(bv, x1, u[k][1]);
      }
    }
#pragma unroll
    for (int k = 0; k < NPT; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* hp = sH + (ty * NPT + k) * XP + tx + 16 * e;
        *hp = fmaf(seg, *hp, u[k][e]);
      }
  }

  // ---- reverse walk
  for (int i = tid; i < N * PT; i += THREADS) {
    const int n = i / PT, p = i % PT;
    sDH[n * XP + p] = g.d_final ? g.d_final[st + (size_t)n * P + p] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q, rows = min(Q, S - c0);
    __syncthreads();   // the previous chunk's reads of the stage and of sDH are done
    stage(c0, rows, true);
    for (int i = tid; i < N * PT; i += THREADS) {
      const int n = i / PT, p = i % PT;
      sH[n * XP + p] = hs[(size_t)c * N * P + (size_t)n * P + p];
    }
    __syncthreads();
    chunk_cumsum(sDt, sCum, a);
    __syncthreads();
    const float last = sCum[Q - 1];
    if (tid < Q) {
      sIn[tid] = expf(sCum[tid]);
      sOut[tid] = expf(last - sCum[tid]);
    }

    // S = (C.B^T) L and W = L dt_j (dy_i . x_j), rows ty*4+i, columns tx+16j, j <= i
    {
      float gs[4][4], ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) gs[i][j] = ds[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty * 4 + i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gs[i][j] = fmaf(cv[i], bv[j], gs[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < PT; ++p) {
        float dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = sDY[(ty * 4 + i) * XP + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sX[(tx + 16 * j) * XP + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ds[i][j] = fmaf(dv[i], xv[j], ds[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float l = col <= r ? expf(sCum[r] - sCum[col]) : 0.f;
          sS[r * QP + col] = gs[i][j] * l;
          sW[r * QP + col] = l * sDt[col] * ds[i][j];
        }
      }
    }
    __syncthreads();

    // y and dxs at rows ty*4+i, columns tx+16e; their row dots; dx; <h_c, dh>
    {
      float yi[4][2], yh[4][2], di[4][2], dh2[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) yi[i][e] = yh[i][e] = di[i][e] = dh2[i][e] = 0.f;
      for (int j = 0; j < ty * 4 + 4; ++j) {         // y: columns j <= row
        float sv[4];
        const float d = sDt[j];
        const float x0 = sX[j * XP + tx] * d, x1 = sX[j * XP + tx + 16] * d;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sv[i] = sS[(ty * 4 + i) * QP + j];
          yi[i][0] = fmaf(sv[i], x0, yi[i][0]);
          yi[i][1] = fmaf(sv[i], x1, yi[i][1]);
        }
      }
      for (int r = ty * 4; r < Q; ++r) {             // dxs: rows r >= column
        const float d0 = sDY[r * XP + tx], d1 = sDY[r * XP + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = sS[r * QP + ty * 4 + i];
          di[i][0] = fmaf(sv, d0, di[i][0]);
          di[i][1] = fmaf(sv, d1, di[i][1]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {                   // the readouts of h_c and dh
        const float h0 = sH[n * XP + tx], h1 = sH[n * XP + tx + 16];
        const float g0 = sDH[n * XP + tx], g1 = sDH[n * XP + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cv = sC[(ty * 4 + i) * NP + n], bv = sB[(ty * 4 + i) * NP + n];
          yh[i][0] = fmaf(cv, h0, yh[i][0]);
          yh[i][1] = fmaf(cv, h1, yh[i][1]);
          dh2[i][0] = fmaf(bv, g0, dh2[i][0]);
          dh2[i][1] = fmaf(bv, g1, dh2[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float r1 = 0.f, r2 = 0.f, r3 = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = tx + 16 * e;
          const float y = fmaf(sIn[r], yh[i][e], yi[i][e]);
          const float st_part = sOut[r] * dh2[i][e];
          const float dxs = di[i][e] + st_part;
          const float xv = sX[r * XP + p];
          r1 = fmaf(sDY[r * XP + p], y, r1);
          r2 = fmaf(xv, dxs, r2);
          r3 = fmaf(xv, st_part, r3);
          if (r < rows) dxb[(size_t)(c0 + r) * yrow + p] = sDt[r] * dxs;
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {             // over the 16 lanes of the row
          r1 += __shfl_xor_sync(0xffffffffu, r1, o);
          r2 += __shfl_xor_sync(0xffffffffu, r2, o);
          r3 += __shfl_xor_sync(0xffffffffu, r3, o);
        }
        if (tx == 0) {
          sR1[r] = r1;
          sR2[r] = r2;
          sR3[r] = r3;
        }
      }
      float hd = 0.f;
      for (int i = tid; i < N * PT; i += THREADS) {
        const int n = i / PT, p = i % PT;
        hd = fmaf(sH[n * XP + p], sDH[n * XP + p], hd);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, o);
      if (lane == 0) sRed[warp] = hd;
    }
    __syncthreads();

    // partial dB and dC at rows ty*4+i, state columns tx+16k
    {
      float dcv[4][NPT], dbv[4][NPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < NPT; ++k) dcv[i][k] = dbv[i][k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float wr[4], wc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wr[i] = sW[(ty * 4 + i) * QP + j];   // W[row, j], j <= row: dC
          wc[i] = sW[j * QP + ty * 4 + i];     // W[j, row], j >= row: dB
        }
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const float bv = sB[j * NP + tx + 16 * k], cv = sC[j * NP + tx + 16 * k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dcv[i][k] = fmaf(wr[i], bv, dcv[i][k]);
            dbv[i][k] = fmaf(wc[i], cv, dbv[i][k]);
          }
        }
      }
      float fin[4], fout[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        fin[i] = sIn[r];
        fout[i] = sOut[r] * sDt[r];
      }
#pragma unroll 4
      for (int p = 0; p < PT; ++p) {
        float dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = sDY[(ty * 4 + i) * XP + p] * fin[i];
          xv[i] = sX[(ty * 4 + i) * XP + p] * fout[i];
        }
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const float hv = sH[(tx + 16 * k) * XP + p], gv = sDH[(tx + 16 * k) * XP + p];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dcv[i][k] = fmaf(dv[i], hv, dcv[i][k]);
            dbv[i][k] = fmaf(xv[i], gv, dbv[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= rows) continue;
        const size_t o = (prow + c0 + r) * N + tx;
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          g.part_b[o + 16 * k] = dbv[i][k];
          g.part_c[o + 16 * k] = dcv[i][k];
        }
      }
    }
    // dcum and x . dxs of each row inside S; d(seg) on the last of them
    if (tid < rows) {
      float dcum = sR1[tid] - sDt[tid] * sR2[tid];
      if (tid == rows - 1) {
        float hd = 0.f, sj = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) hd += sRed[w];
        for (int j = 0; j < rows; ++j) sj = fmaf(sDt[j], sR3[j], sj);
        dcum += expf(last) * hd + sj;
      }
      const size_t o = ((size_t)tile * g.B + b) * S * H + (size_t)(c0 + tid) * H + h;
      g.part_t[o] = dcum;
      g.part_t[(size_t)NT * bsh + o] = sR2[tid];
    }
    __syncthreads();   // every read of sDH for this chunk is done

    // dh <- exp(seg) dh + sum_i exp(cum_i) C_i dy_i^T, rows ty*NPT+k, columns tx+16e
    {
      const float seg = expf(last);
      float u[NPT][2];
#pragma unroll
      for (int k = 0; k < NPT; ++k) u[k][0] = u[k][1] = 0.f;
      for (int i = 0; i < rows; ++i) {
        const float f = sIn[i];
        const float d0 = sDY[i * XP + tx] * f, d1 = sDY[i * XP + tx + 16] * f;
#pragma unroll
        for (int k = 0; k < NPT; ++k) {
          const float cv = sC[i * NP + ty * NPT + k];
          u[k][0] = fmaf(cv, d0, u[k][0]);
          u[k][1] = fmaf(cv, d1, u[k][1]);
        }
      }
#pragma unroll
      for (int k = 0; k < NPT; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* gp = sDH + (ty * NPT + k) * XP + tx + 16 * e;
          *gp = fmaf(seg, *gp, u[k][e]);
        }
    }
  }
  if (g.d_init) {
    __syncthreads();
    for (int i = tid; i < N * PT; i += THREADS) {
      const int n = i / PT, p = i % PT;
      g.d_init[st + (size_t)n * P + p] = sDH[n * XP + p];
    }
  }
}

// Blocks [0, n_bc): dB and dC, an element a thread, summed over the (tile, head)
// partial rows in order. Blocks n_bc + h: head h's ddt and dA.
__global__ void __launch_bounds__(THREADS)
ssd_scan_bwd_finish(BwdArgs g, int N, int n_bc) {
  const int NT = g.P / PT, S = g.S, H = g.H;
  if ((int)blockIdx.x < n_bc) {
    const size_t total = (size_t)g.B * S * N;
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    float sb = 0.f, sc = 0.f;
    for (int t = 0; t < NT * H; ++t) {
      sb += g.part_b[t * total + e];
      sc += g.part_c[t * total + e];
    }
    g.dbm[e] = sb;
    g.dcm[e] = sc;
    return;
  }
  __shared__ float part[THREADS / 32];
  const int h = blockIdx.x - n_bc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = (S + Q - 1) / Q;
  const float a = g.A[h];
  const size_t bsh = (size_t)g.B * S * H;
  float da = 0.f;
  for (int k = warp; k < g.B * nc; k += THREADS / 32) {   // a warp a (batch, chunk)
    const int b = k / nc, c0 = (k % nc) * Q;
    float v[2], dd[2], dtv[2];
    size_t idx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = c0 + 2 * lane + r;
      idx[r] = ((size_t)b * S + s) * H + h;
      v[r] = dd[r] = dtv[r] = 0.f;
      if (s < S) {
        dtv[r] = g.dt[idx[r]];
        for (int t = 0; t < NT; ++t) {
          v[r] += g.part_t[t * bsh + idx[r]];
          dd[r] += g.part_t[(NT + t) * bsh + idx[r]];
        }
      }
    }
    // reverse inclusive cumsum over the chunk's 64 rows (lane l: rows 2l, 2l+1)
    float sum = v[0] + v[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, sum, o);
      if (lane + o < 32) sum += t;
    }
    float after = __shfl_down_sync(0xffffffffu, sum, 1);   // the lanes above
    if (lane == 31) after = 0.f;
    const float rc[2] = {after + v[1] + v[0], after + v[1]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (c0 + 2 * lane + r >= S) continue;
      g.ddt[idx[r]] = fmaf(a, rc[r], dd[r]);
      da = fmaf(dtv[r], rc[r], da);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) part[warp] = da;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += part[w];
    g.dA[h] = s;
  }
}

template <int N>
cudaError_t launch_bwd(const BwdArgs& g, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_bwd_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_kernel<N><<<dim3(g.P / PT, g.H, g.B), THREADS, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)g.B * g.S * N;
  const int n_bc = (int)((total + THREADS - 1) / THREADS);
  ssd_scan_bwd_finish<<<n_bc + g.H, THREADS, 0, stream>>>(g, N, n_bc);
  return cudaGetLastError();
}

cudaError_t launch_bwd_n(const BwdArgs& g, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch_bwd<16>(g, s);
    case 32: return launch_bwd<32>(g, s);
    case 64: return launch_bwd<64>(g, s);
    case 128: return launch_bwd<128>(g, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ backward, bf16: tensor cores
constexpr int HG = 10;           // heads a gradient block
constexpr int GR_THREADS = 256;  // the gradient block: 8 warps

struct Bf16BwdArgs {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* bm;
  const __nv_bfloat16* cm;
  const float* init_state;   // null: a zero initial state
  const __nv_bfloat16* dy;   // [B, S, H, P]
  const float* d_final;      // null: zero
  __nv_bfloat16* dx;         // [B, S, H, P]
  float* ddt;                // [B, S, H]
  float* dA;                 // [H]
  __nv_bfloat16* dbm;        // [B, S, N]
  __nv_bfloat16* dcm;
  float* d_init;             // null: not wanted
  // scratch: h_c and dh_c as bf16 hi and lo planes, [B, nc, H, 2, N, P] each
  __nv_bfloat16* states;
  __nv_bfloat16* dstates;
  float* part_b;             // [ceil(H / HG), B, S, N]: dB summed over each block's heads
  float* part_c;             // the same for dC
  float* part_a;             // [B, nc, H]: dA of each chunk and head
  int B, S, H;                // P and N are the kernels' template parameters
  long long sxb, sxs, sbb, sbs, scb, scs;
};

// The hi + lo planes of chunk c's state (or cotangent) of head h.
__device__ __forceinline__ size_t plane(int b, int c, int h, int nc, int H, int N, int P) {
  return (((size_t)b * nc + c) * H + h) * 2 * N * P;
}

// ---- (a) + (b): the two state walks
template <int N, int P>
struct StSmem {
  static constexpr int NS = N < 64 ? N : 64;   // state rows a block
  static constexpr int WARPS = 4;              // each P / 4 columns of them
  static constexpr int MR = NS + 8;            // padded row of the B (C) tile, elements
  static constexpr int VR = P + 8;             // padded row of the x (dy) tile and the staged state
  // a stage: B or C (bf16 [Q][NS]), x or dy (bf16 [Q][P]), dt (f32 [Q]); two
  // stages; then the state's hi and lo copies (bf16 [NS][P]) twice, by the chunk's
  // parity; then per warp two per-row factors (f32)
  static constexpr size_t STAGE = ((size_t)Q * MR + (size_t)Q * VR) * 2 + Q * 4;
  static constexpr size_t OUT = 2 * (size_t)NS * VR * 2;
  static constexpr size_t bytes = 2 * STAGE + 2 * OUT + (size_t)WARPS * 2 * Q * 4;
};

template <int N, int P>
__global__ void __launch_bounds__(StSmem<N, P>::WARPS * 32)
ssd_scan_bwd_states(Bf16BwdArgs g) {
  using L = StSmem<N, P>;
  using bf16 = __nv_bfloat16;
  constexpr int NS = L::NS, THREADS_ = L::WARPS * 32;
  constexpr int MT = NS / 16, PW = P / L::WARPS, NT = PW / 8;   // a warp: MT x NT mma tiles
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * NS, h = blockIdx.y, b = blockIdx.z / 2, p0 = PW * warp;
  const bool rev = blockIdx.z % 2;   // 0: h_c, walking forward; 1: dh_c, walking back
  const int S = g.S, H = g.H, nc = (S + Q - 1) / Q;
  const float a = g.A[h];
  // this walk's inputs: B, x and w_j = exp(seg - cum_j) dt_j, or C, dy and exp(cum_i)
  const bf16* mb = rev ? g.cm + b * g.scb : g.bm + b * g.sbb;
  const long long ms = rev ? g.scs : g.sbs;
  const bf16* vb = rev ? g.dy + (size_t)b * S * H * P + (size_t)h * P
                       : g.x + b * g.sxb + (size_t)h * P;
  const long long vs = rev ? (long long)H * P : g.sxs;
  const float* dtb = g.dt + (size_t)b * S * H + h;
  bf16* out = rev ? g.dstates : g.states;
  float* cw = reinterpret_cast<float*>(smem_raw + 2 * L::STAGE + 2 * L::OUT) + warp * 2 * Q;
  float* fw = cw + Q;

  auto stage_m = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * L::STAGE); };
  auto stage_v = [&](int s) { return stage_m(s) + Q * L::MR; };
  auto stage_dt = [&](int s) { return reinterpret_cast<float*>(stage_v(s) + Q * L::VR); };
  auto stage_out = [&](int k) {
    return reinterpret_cast<bf16*>(smem_raw + 2 * L::STAGE + (k & 1) * L::OUT);
  };
  // the state staged at the k-th chunk to its planes: two runs of NS rows, 16 bytes a thread
  auto store_state = [&](int k) {
    bf16* pl = out + plane(b, rev ? nc - 1 - k : k, h, nc, H, N, P) + (size_t)n0 * P;
    const bf16* st = stage_out(k);
    for (int i = tid; i < 2 * NS * (P / 8); i += THREADS_) {
      const int r = i / (P / 8), kk = i % (P / 8);   // r: row of the two stacked planes
      *reinterpret_cast<uint4*>(pl + (size_t)(r / NS) * N * P + (size_t)(r % NS) * P + 8 * kk) =
          *reinterpret_cast<const uint4*>(st + r * L::VR + 8 * kk);
    }
  };
  auto load_chunk = [&](int k) {   // the k-th chunk of this walk, into stage k % 2
    if (k >= nc) return;
    const int s = k % 2, r0 = (rev ? nc - 1 - k : k) * Q;
    for (int i = tid; i < Q * (NS / 8); i += THREADS_) {
      const int r = i / (NS / 8), kk = i % (NS / 8);
      const bool ok = r0 + r < S;
      tc::cp_async16(stage_m(s) + r * L::MR + 8 * kk, mb + (ok ? r0 + r : 0) * ms + n0 + 8 * kk,
                     ok);
    }
    for (int i = tid; i < Q * (P / 8); i += THREADS_) {
      const int r = i / (P / 8), kk = i % (P / 8);
      const bool ok = r0 + r < S;
      tc::cp_async16(stage_v(s) + r * L::VR + 8 * kk, vb + (ok ? r0 + r : 0) * vs + 8 * kk, ok);
    }
    for (int i = tid; i < Q; i += THREADS_) {
      const bool ok = r0 + i < S;
      tc::cp_async4(stage_dt(s) + i, dtb + (size_t)(ok ? r0 + i : 0) * H, ok);
    }
  };

  // the state: all NS rows of the block at this warp's PW columns, as mma
  // accumulators: hs[mt][nt] holds rows 16 mt + gq (+ 8), columns p0 + 8 nt + 2t (+ 1)
  float hs[MT][NT][4];
  {
    const float* s0 = rev ? g.d_final : g.init_state;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + 16 * mt + gq + 8 * half, p = p0 + 8 * nt + 2 * t;
          const float2 v = s0 ? *reinterpret_cast<const float2*>(
                                    s0 + (((size_t)b * H + h) * N + n) * P + p)
                              : make_float2(0.f, 0.f);
          hs[mt][nt][2 * half] = v.x;
          hs[mt][nt][2 * half + 1] = v.y;
        }
  }

  load_chunk(0);
  tc::cp_async_commit();
  for (int k = 0; k < nc; ++k) {
    const int s = k % 2;
    tc::cp_async_wait<0>();
    __syncthreads();   // chunk k is visible, and so is the state staged at chunk k - 1;
                       // every warp is done with the other stage and the other staging
    load_chunk(k + 1);
    tc::cp_async_commit();
    if (k > 0) store_state(k - 1);
    const bf16* sM = stage_m(s);
    const bf16* sV = stage_v(s);
    {  // inclusive cumsum of dt * A over the 64 rows (lane l: rows 2l, 2l+1), per warp
      const float2 d = *reinterpret_cast<const float2*>(stage_dt(s) + 2 * lane);
      const float v0 = d.x * a, v1 = d.y * a;
      float sum = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) sum += u;
      }
      const float before = __shfl_up_sync(0xffffffffu, sum, 1);
      const float last = __shfl_sync(0xffffffffu, sum, 31);
      const float c0 = lane ? before + v0 : v0;
      const float c1 = lane ? before + v0 + v1 : v0 + v1;
      *reinterpret_cast<float2*>(cw + 2 * lane) = make_float2(c0, c1);
      *reinterpret_cast<float2*>(fw + 2 * lane) =
          rev ? make_float2(exp2f(c0 * LOG2E), exp2f(c1 * LOG2E))
              : make_float2(exp2f((last - c0) * LOG2E) * d.x, exp2f((last - c1) * LOG2E) * d.y);
      __syncwarp();
    }
    // the state at the chunk's boundary (entering it; for dh, leaving it) as hi +
    // lo, staged for store_state
    bf16* so = stage_out(k);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (16 * mt + gq + 8 * half) * L::VR + p0 + 8 * nt + 2 * t;
          uint32_t hi, lo;
          tc::split(hs[mt][nt][2 * half], hs[mt][nt][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(so + o) = hi;
          *reinterpret_cast<uint32_t*>(so + NS * L::VR + o) = lo;
        }
    // h <- exp(seg) h + B^T (w x), or dh <- exp(seg) dh + C^T (exp(cum) dy), the
    // factor times the bf16 row entering as hi + lo
    const float seg = exp2f(cw[Q - 1] * LOG2E);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[mt][nt][e] *= seg;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      // rows 32kp .. 32kp+31 of this warp's columns: B fragments of two k-steps
      uint32_t vhi[NT][4], vlo[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t vr[4];
        tc::ldsm_x4_t(vr, sV + (32 * kp + lane) * L::VR + p0 + 8 * nt);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = tc::unpack(vr[q]);
          const float2 f = *reinterpret_cast<const float2*>(fw + 32 * kp + 8 * q + 2 * t);
          tc::split(v.x * f.x, v.y * f.y, vhi[nt][q], vlo[nt][q]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t at[4];   // M^T: rows = state rows 16 mt.., k = chunk rows
          tc::ldsm_x4_t(at, sM + (16 * (2 * kp + kk) + (lane % 8) + 8 * (lane / 16)) * L::MR +
                                16 * mt + 8 * ((lane / 8) % 2));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            tc::mma(hs[mt][nt], at, vhi[nt][2 * kk], vhi[nt][2 * kk + 1]);
            tc::mma(hs[mt][nt], at, vlo[nt][2 * kk], vlo[nt][2 * kk + 1]);
          }
        }
    }
  }
  __syncthreads();
  store_state(nc - 1);
  if (rev && g.d_init) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = n0 + 16 * mt + gq + 8 * half, p = p0 + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(g.d_init + (((size_t)b * H + h) * N + n) * P + p) =
              make_float2(hs[mt][nt][2 * half], hs[mt][nt][2 * half + 1]);
        }
  }
}

// ---- (c): the gradients of a chunk and a group of heads
template <int N, int P>
struct GrSmem {
  static constexpr int BR = N + 8;   // padded row of B and C, bf16 elements
  static constexpr int XR = P + 8;   // padded row of x, dy and the state planes
  static constexpr int QR = Q + 8;   // padded row of S' and W
  static constexpr size_t B_OFF = 0, C_OFF = (size_t)Q * BR * 2;
  static constexpr size_t XSTAGE = 2 * (size_t)Q * XR * 2 + Q * 4;  // x, dy, dt of a head
  static constexpr size_t XD_OFF = 2 * C_OFF;                      // two such stages
  static constexpr size_t PLANE = (size_t)N * XR * 2;
  static constexpr size_t H_OFF = XD_OFF + 2 * XSTAGE;             // h_c hi, lo
  static constexpr size_t DH_OFF = H_OFF + 2 * PLANE;              // dh_c hi, lo
  static constexpr size_t SW_OFF = DH_OFF + 2 * PLANE;             // S' hi, lo, W hi, lo
  static constexpr size_t SQ = (size_t)Q * QR * 2;
  // f32, two of each (by the head's parity): the per-row factors of a head (cum, dt,
  // exp(cum), exp(seg - cum), w, and [0] of a sixth: A), the P1 tiles' row and column
  // sums, the two column halves' state dots C.(dY h^T) and B.(X dh^T), the warps'
  // parts of <h_c, dh_c>
  static constexpr size_t FAC_OFF = SW_OFF + 4 * SQ;
  static constexpr size_t RS_OFF = FAC_OFF + 2 * 6 * Q * 4;
  static constexpr size_t CS_OFF = RS_OFF + 2 * 10 * 16 * 4;
  static constexpr size_t R2_OFF = CS_OFF + 2 * 10 * 16 * 4;
  static constexpr size_t R3_OFF = R2_OFF + 2 * 2 * Q * 4;
  static constexpr size_t HD_OFF = R3_OFF + 2 * 2 * Q * 4;
  static constexpr size_t bytes = HD_OFF + 2 * 8 * 4;
};

template <int N, int P>
__global__ void __launch_bounds__(GR_THREADS, 1)
ssd_scan_bwd_grad(Bf16BwdArgs g) {
  static_assert(N % 16 == 0 && (P == 32 || P == 64), "N a multiple of 16; P 32 or 64");
  using L = GrSmem<N, P>;
  using bf16 = __nv_bfloat16;
  constexpr int NH = N / 2, NT8 = NH / 8;   // this warp's columns of dB and dC
  constexpr int PH = P / 2, PT8 = PH / 8;   // this warp's columns of dx
  constexpr int FIN = 7;                    // the warp that closes each head's rows
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sB = reinterpret_cast<bf16*>(smem_raw + L::B_OFF);
  bf16* sC = reinterpret_cast<bf16*>(smem_raw + L::C_OFF);
  bf16* sHhi = reinterpret_cast<bf16*>(smem_raw + L::H_OFF);
  bf16* sHlo = sHhi + N * L::XR;
  bf16* sDhi = reinterpret_cast<bf16*>(smem_raw + L::DH_OFF);
  bf16* sDlo = sDhi + N * L::XR;
  bf16* sShi = reinterpret_cast<bf16*>(smem_raw + L::SW_OFF);
  bf16* sSlo = sShi + Q * L::QR;
  bf16* sWhi = sSlo + Q * L::QR;
  bf16* sWlo = sWhi + Q * L::QR;
  auto fac = [&](int par, int f) {
    return reinterpret_cast<float*>(smem_raw + L::FAC_OFF) + (par * 6 + f) * Q;
  };
  auto rsum = [&](int par) { return reinterpret_cast<float*>(smem_raw + L::RS_OFF) + par * 160; };
  auto csum = [&](int par) { return reinterpret_cast<float*>(smem_raw + L::CS_OFF) + par * 160; };
  auto r2s = [&](int par) { return reinterpret_cast<float*>(smem_raw + L::R2_OFF) + par * 2 * Q; };
  auto r3s = [&](int par) { return reinterpret_cast<float*>(smem_raw + L::R3_OFF) + par * 2 * Q; };
  auto hds = [&](int par) { return reinterpret_cast<float*>(smem_raw + L::HD_OFF) + par * 8; };
  auto xst = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + L::XD_OFF + s * L::XSTAGE); };
  auto dyst = [&](int s) { return xst(s) + Q * L::XR; };
  auto dtst = [&](int s) { return reinterpret_cast<float*>(dyst(s) + Q * L::XR); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  const int q = warp % 4, hf = warp / 4;   // P2: rows 16q.. and a column half
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int S = g.S, H = g.H, nc = (S + Q - 1) / Q, r0 = c * Q;
  const int h0 = grp * HG, nh = min(HG, H - h0);
  const size_t yrow = (size_t)H * P;

  auto load_xd = [&](int k, int s) {   // x, dy (and, by warp 0, dt) of head h0 + k
    const int h = h0 + k;
    const bf16* xb = g.x + b * g.sxb + (size_t)h * P;
    const bf16* yb = g.dy + (size_t)b * S * yrow + (size_t)h * P;
    for (int i = tid; i < Q * (P / 8); i += GR_THREADS) {
      const int r = i / (P / 8), kk = i % (P / 8);
      const bool ok = r0 + r < S;
      const long long row = ok ? r0 + r : 0;
      tc::cp_async16(xst(s) + r * L::XR + 8 * kk, xb + row * g.sxs + 8 * kk, ok);
      tc::cp_async16(dyst(s) + r * L::XR + 8 * kk, yb + row * (long long)yrow + 8 * kk, ok);
    }
    if (warp == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * lane + e;
        const bool ok = r0 + r < S;
        tc::cp_async4(dtst(s) + r, g.dt + ((size_t)b * S + (ok ? r0 + r : 0)) * H + h, ok);
      }
  };
  auto load_planes = [&](const bf16* src, bf16* hi, int k) {   // a state's hi and lo planes
    const bf16* p0 = src + plane(b, c, h0 + k, nc, H, N, P);
    for (int i = tid; i < 2 * N * (P / 8); i += GR_THREADS) {
      const int r = i / (P / 8), kk = i % (P / 8);   // r: row of the two stacked planes
      tc::cp_async16(hi + r * L::XR + 8 * kk, p0 + (size_t)r * P + 8 * kk, true);
    }
  };
  // warp 0: the per-row factors of head k from its dt, once its copies have landed
  auto factors = [&](int k) {
    const int par = k & 1;
    const float a = g.A[h0 + k];
    const float2 d = *reinterpret_cast<const float2*>(dtst(par) + 2 * lane);
    const float v0 = d.x * a, v1 = d.y * a;
    float sum = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += u;
    }
    const float before = __shfl_up_sync(0xffffffffu, sum, 1);
    const float last = __shfl_sync(0xffffffffu, sum, 31);
    const float c0 = lane ? before + v0 : v0;
    const float c1 = lane ? before + v0 + v1 : v0 + v1;
    const float o0 = exp2f((last - c0) * LOG2E), o1 = exp2f((last - c1) * LOG2E);
    *reinterpret_cast<float2*>(fac(par, 0) + 2 * lane) = make_float2(c0, c1);
    *reinterpret_cast<float2*>(fac(par, 1) + 2 * lane) = d;
    *reinterpret_cast<float2*>(fac(par, 2) + 2 * lane) =
        make_float2(exp2f(c0 * LOG2E), exp2f(c1 * LOG2E));
    *reinterpret_cast<float2*>(fac(par, 3) + 2 * lane) = make_float2(o0, o1);
    *reinterpret_cast<float2*>(fac(par, 4) + 2 * lane) = make_float2(o0 * d.x, o1 * d.y);
    if (lane == 0) fac(par, 5)[0] = a;
  };
  // one warp: dcum, its reverse cumsum, ddt and the chunk's dA of head k, in a
  // fixed order (lane l: rows 2l, 2l+1)
  auto finish_head = [&](int k) {
    const int par = k & 1, h = h0 + k;
    const float* rs = rsum(par);
    const float* cs = csum(par);
    float dcum[2], xdxs[2], dtv[2], wr3 = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e, ib = i / 16;
      float sr = 0.f, sc = 0.f;
      for (int jb = 0; jb <= ib; ++jb) sr += rs[(ib * (ib + 1) / 2 + jb) * 16 + i % 16];
      for (int jb = ib; jb < 4; ++jb) sc += cs[(jb * (jb + 1) / 2 + ib) * 16 + i % 16];
      const float r3 = r3s(par)[i] + r3s(par)[Q + i];
      dtv[e] = fac(par, 1)[i];
      const float dyy = fmaf(fac(par, 2)[i], r2s(par)[i] + r2s(par)[Q + i], sr);
      xdxs[e] = fmaf(fac(par, 3)[i], r3, sc);
      dcum[e] = dyy - dtv[e] * xdxs[e];
      wr3 = fmaf(fac(par, 4)[i], r3, wr3);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) wr3 += __shfl_xor_sync(0xffffffffu, wr3, o);
    if (lane == 31) {   // d(seg) = <h_{c+1}, dh_c> = exp(seg) <h_c, dh_c> + sum_j w_j r3_j
      float hd = 0.f;
      for (int w = 0; w < 8; ++w) hd += hds(par)[w];
      dcum[1] += fmaf(exp2f(fac(par, 0)[Q - 1] * LOG2E), hd, wr3);
    }
    float sum = dcum[0] + dcum[1];   // reverse inclusive cumsum over the 64 rows
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, sum, o);
      if (lane + o < 32) sum += u;
    }
    float after = __shfl_down_sync(0xffffffffu, sum, 1);
    if (lane == 31) after = 0.f;
    const float rc[2] = {after + dcum[1] + dcum[0], after + dcum[1]};
    const float a = fac(par, 5)[0];
    float da = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + 2 * lane + e;
      if (row < S) g.ddt[((size_t)b * S + row) * H + h] = fmaf(a, rc[e], xdxs[e]);
      da = fmaf(dtv[e], rc[e], da);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
    if (lane == 0) g.part_a[((size_t)b * nc + c) * H + h] = da;
  };

  // ---- B and C of the chunk, and head 0's x, dy, dt, h_c, dh_c
  for (int i = tid; i < Q * (N / 8); i += GR_THREADS) {
    const int r = i / (N / 8), kk = i % (N / 8);
    const bool ok = r0 + r < S;
    const long long row = ok ? r0 + r : 0;
    tc::cp_async16(sB + r * L::BR + 8 * kk, g.bm + b * g.sbb + row * g.sbs + 8 * kk, ok);
    tc::cp_async16(sC + r * L::BR + 8 * kk, g.cm + b * g.scb + row * g.scs + 8 * kk, ok);
  }
  load_xd(0, 0);
  tc::cp_async_commit();
  load_planes(g.states, sHhi, 0);
  tc::cp_async_commit();
  load_planes(g.dstates, sDhi, 0);
  tc::cp_async_commit();
  if (warp == 0) {
    tc::cp_async_wait<2>();
    factors(0);
  }

  // P1's tiles of the chunk's lower triangle: tile t = (ib, jb), t = ib (ib + 1) / 2 + jb;
  // this warp's are t = warp and t = warp + 8
  int tib[2], tjb[2];
  const int ntile = warp < 2 ? 2 : 1;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int tt = warp + 8 * u;
    tib[u] = tt < 1 ? 0 : tt < 3 ? 1 : tt < 6 ? 2 : 3;
    tjb[u] = tt - tib[u] * (tib[u] + 1) / 2;
  }
  float G[2][2][4];   // C.B^T on this warp's tiles, for every head
  float accC[NT8][4], accB[NT8][4];   // dC and dB of rows 16q.., columns NH*hf.., over the heads
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accC[nt][e] = accB[nt][e] = 0.f;

  for (int k = 0; k < nh; ++k) {
    const int s = k & 1, h = h0 + k;
    const bf16* sX = xst(s);
    const bf16* sDY = dyst(s);
    const float* cum = fac(s, 0);
    const float* dtr = fac(s, 1);
    tc::cp_async_wait<2>();
    __syncthreads();   // A: head k's x, dy and factors are visible
    if (k + 1 < nh) load_xd(k + 1, s ^ 1);
    tc::cp_async_commit();
    if (k == 0)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == ntile) break;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) G[u][n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t af[4], bfr[4];
          tc::ldsm_x4(af, sC + (16 * tib[u] + (lane % 8) + 8 * ((lane / 8) % 2)) * L::BR +
                              16 * ks + 8 * (lane / 16));
          tc::ldsm_x4(bfr, sB + (16 * tjb[u] + (lane % 8) + 8 * (lane / 16)) * L::BR + 16 * ks +
                               8 * ((lane / 8) % 2));
          tc::mma(G[u][0], af, bfr[0], bfr[1]);
          tc::mma(G[u][1], af, bfr[2], bfr[3]);
        }
      }
    if (k > 0 && warp == FIN) finish_head(k - 1);

    // P1: D = dY X^T on this warp's tiles; S' = G o L and W = L o D dt_j to shared
    // memory as hi + lo; the row sums of G o W and the column sums of G o L o D
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == ntile) break;
      const int ib = tib[u], jb = tjb[u], tt = warp + 8 * u;
      float D[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t af[4], bfr[4];
        tc::ldsm_x4(af, sDY + (16 * ib + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR + 16 * ks +
                            8 * (lane / 16));
        tc::ldsm_x4(bfr, sX + (16 * jb + (lane % 8) + 8 * (lane / 16)) * L::XR + 16 * ks +
                             8 * ((lane / 8) % 2));
        tc::mma(D[0], af, bfr[0], bfr[1]);
        tc::mma(D[1], af, bfr[2], bfr[3]);
      }
      float rp[2] = {0.f, 0.f}, cp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * ib + gq + 8 * r, j = 16 * jb + 8 * n + 2 * t;
          float sp[2], wv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float l = j + e <= i ? exp2f((cum[i] - cum[j + e]) * LOG2E) : 0.f;
            const float gv = G[u][n][2 * r + e], wp = l * D[n][2 * r + e];
            sp[e] = gv * l;
            wv[e] = wp * dtr[j + e];
            rp[r] = fmaf(gv, wv[e], rp[r]);
            cp[n][e] = fmaf(gv, wp, cp[n][e]);
          }
          uint32_t hi, lo;
          tc::split(sp[0], sp[1], hi, lo);
          *reinterpret_cast<uint32_t*>(sShi + i * L::QR + j) = hi;
          *reinterpret_cast<uint32_t*>(sSlo + i * L::QR + j) = lo;
          tc::split(wv[0], wv[1], hi, lo);
          *reinterpret_cast<uint32_t*>(sWhi + i * L::QR + j) = hi;
          *reinterpret_cast<uint32_t*>(sWlo + i * L::QR + j) = lo;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // over the quad: the tile's 16 columns
        rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 1);
        rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 2);
        if (t == 0) rsum(s)[tt * 16 + gq + 8 * r] = rp[r];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {   // over the eight row groups: the tile's 16 rows
          float v = cp[n][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) csum(s)[tt * 16 + 8 * n + 2 * t + e] = v;
        }
    }
    tc::cp_async_wait<2>();
    __syncthreads();   // B: S', W and head k's h_c are visible

    // P2, h_c: dC += exp(cum_i) (dY h_c^T) + W B, rows 16q.., columns NH*hf..;
    // the row dots C.(dY h_c^T) for dy.y
    float tmp[NT8][4];
    {
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t af[4];
        tc::ldsm_x4(af, sDY + (16 * q + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR + 16 * ks +
                            8 * (lane / 16));
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const int off = (NH * hf + 8 * nt + (lane % 8)) * L::XR + 16 * ks + 8 * ((lane / 8) % 2);
          uint32_t bh[2], bl[2];
          tc::ldsm_x2(bh, sHhi + off);
          tc::ldsm_x2(bl, sHlo + off);
          tc::mma(tmp[nt], af, bh[0], bh[1]);
          tc::mma(tmp[nt], af, bl[0], bl[1]);
        }
      }
      const float* ecum = fac(s, 2);
      float rd[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * q + gq + 8 * r, n = NH * hf + 8 * nt + 2 * t;
          const float2 cv = tc::unpack(*reinterpret_cast<const uint32_t*>(sC + i * L::BR + n));
          rd[r] = fmaf(cv.x, tmp[nt][2 * r], fmaf(cv.y, tmp[nt][2 * r + 1], rd[r]));
          accC[nt][2 * r] = fmaf(ecum[i], tmp[nt][2 * r], accC[nt][2 * r]);
          accC[nt][2 * r + 1] = fmaf(ecum[i], tmp[nt][2 * r + 1], accC[nt][2 * r + 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 1);
        rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 2);
        if (t == 0) r2s(s)[hf * Q + 16 * q + gq + 8 * r] = rd[r];
      }
      for (int kb = 0; kb <= q; ++kb) {   // W B over the columns j <= i
        uint32_t wh[4], wl[4];
        const int off =
            (16 * q + (lane % 8) + 8 * ((lane / 8) % 2)) * L::QR + 16 * kb + 8 * (lane / 16);
        tc::ldsm_x4(wh, sWhi + off);
        tc::ldsm_x4(wl, sWlo + off);
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          uint32_t bb[2];
          tc::ldsm_x2_t(bb, sB + (16 * kb + (lane % 8) + 8 * ((lane / 8) % 2)) * L::BR + NH * hf +
                                8 * nt);
          tc::mma(accC[nt], wh, bb[0], bb[1]);
          tc::mma(accC[nt], wl, bb[0], bb[1]);
        }
      }
    }
    tc::cp_async_wait<1>();
    __syncthreads();   // D: head k's dh_c is visible
    {  // <h_c, dh_c> over the planes, this warp's share
      float hd = 0.f;
      for (int i = tid; i < N * (P / 2); i += GR_THREADS) {
        const int o = (i / (P / 2)) * L::XR + 2 * (i % (P / 2));
        const float2 hh = tc::unpack(*reinterpret_cast<const uint32_t*>(sHhi + o));
        const float2 hl = tc::unpack(*reinterpret_cast<const uint32_t*>(sHlo + o));
        const float2 dh = tc::unpack(*reinterpret_cast<const uint32_t*>(sDhi + o));
        const float2 dl = tc::unpack(*reinterpret_cast<const uint32_t*>(sDlo + o));
        hd = fmaf(hh.x + hl.x, dh.x + dl.x, fmaf(hh.y + hl.y, dh.y + dl.y, hd));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, o);
      if (lane == 0) hds(s)[warp] = hd;
    }
    __syncthreads();   // E: every read of h_c is done
    if (k + 1 < nh) load_planes(g.states, sHhi, k + 1);
    tc::cp_async_commit();

    // P2, dh_c: dB += w_j (X dh_c^T) + W^T C, rows 16q.., columns NH*hf..; the row
    // dots B.(X dh_c^T) for x.dxs and d(seg)
    {
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t af[4];
        tc::ldsm_x4(af, sX + (16 * q + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR + 16 * ks +
                            8 * (lane / 16));
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          const int off = (NH * hf + 8 * nt + (lane % 8)) * L::XR + 16 * ks + 8 * ((lane / 8) % 2);
          uint32_t bh[2], bl[2];
          tc::ldsm_x2(bh, sDhi + off);
          tc::ldsm_x2(bl, sDlo + off);
          tc::mma(tmp[nt], af, bh[0], bh[1]);
          tc::mma(tmp[nt], af, bl[0], bl[1]);
        }
      }
      const float* wr = fac(s, 4);
      float rd[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 16 * q + gq + 8 * r, n = NH * hf + 8 * nt + 2 * t;
          const float2 bv = tc::unpack(*reinterpret_cast<const uint32_t*>(sB + j * L::BR + n));
          rd[r] = fmaf(bv.x, tmp[nt][2 * r], fmaf(bv.y, tmp[nt][2 * r + 1], rd[r]));
          accB[nt][2 * r] = fmaf(wr[j], tmp[nt][2 * r], accB[nt][2 * r]);
          accB[nt][2 * r + 1] = fmaf(wr[j], tmp[nt][2 * r + 1], accB[nt][2 * r + 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 1);
        rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 2);
        if (t == 0) r3s(s)[hf * Q + 16 * q + gq + 8 * r] = rd[r];
      }
      for (int kb = q; kb < 4; ++kb) {   // W^T C over the rows i >= j
        uint32_t wh[4], wl[4];
        const int off =
            (16 * kb + (lane % 8) + 8 * (lane / 16)) * L::QR + 16 * q + 8 * ((lane / 8) % 2);
        tc::ldsm_x4_t(wh, sWhi + off);
        tc::ldsm_x4_t(wl, sWlo + off);
#pragma unroll
        for (int nt = 0; nt < NT8; ++nt) {
          uint32_t cc[2];
          tc::ldsm_x2_t(cc, sC + (16 * kb + (lane % 8) + 8 * ((lane / 8) % 2)) * L::BR + NH * hf +
                                8 * nt);
          tc::mma(accB[nt], wh, cc[0], cc[1]);
          tc::mma(accB[nt], wl, cc[0], cc[1]);
        }
      }
    }
    // dxs = exp(seg - cum_j) (B dh_c) + S'^T dY, rows 16q.., columns PH*hf..; dx = dt dxs
    {
      float ax[PT8][4];
#pragma unroll
      for (int nt = 0; nt < PT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t af[4];
        tc::ldsm_x4(af, sB + (16 * q + (lane % 8) + 8 * ((lane / 8) % 2)) * L::BR + 16 * ks +
                            8 * (lane / 16));
#pragma unroll
        for (int pp = 0; pp < PT8 / 2; ++pp) {
          const int off = (16 * ks + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR + PH * hf +
                          16 * pp + 8 * (lane / 16);
          uint32_t fh[4], fl[4];
          tc::ldsm_x4_t(fh, sDhi + off);
          tc::ldsm_x4_t(fl, sDlo + off);
          tc::mma(ax[2 * pp], af, fh[0], fh[1]);
          tc::mma(ax[2 * pp], af, fl[0], fl[1]);
          tc::mma(ax[2 * pp + 1], af, fh[2], fh[3]);
          tc::mma(ax[2 * pp + 1], af, fl[2], fl[3]);
        }
      }
      const float* eout = fac(s, 3);
#pragma unroll
      for (int nt = 0; nt < PT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[nt][e] *= eout[16 * q + gq + 8 * (e / 2)];
      for (int kb = q; kb < 4; ++kb) {   // S'^T dY over the rows i >= j
        uint32_t sh[4], sl[4];
        const int off =
            (16 * kb + (lane % 8) + 8 * (lane / 16)) * L::QR + 16 * q + 8 * ((lane / 8) % 2);
        tc::ldsm_x4_t(sh, sShi + off);
        tc::ldsm_x4_t(sl, sSlo + off);
#pragma unroll
        for (int pp = 0; pp < PT8 / 2; ++pp) {
          uint32_t f[4];
          tc::ldsm_x4_t(f, sDY + (16 * kb + (lane % 8) + 8 * ((lane / 8) % 2)) * L::XR + PH * hf +
                               16 * pp + 8 * (lane / 16));
          tc::mma(ax[2 * pp], sh, f[0], f[1]);
          tc::mma(ax[2 * pp], sl, f[0], f[1]);
          tc::mma(ax[2 * pp + 1], sh, f[2], f[3]);
          tc::mma(ax[2 * pp + 1], sl, f[2], f[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = 16 * q + gq + 8 * r, row = r0 + j;
        if (row >= S) continue;
        const float d = dtr[j];
        uint32_t* o = reinterpret_cast<uint32_t*>(g.dx + ((size_t)b * S + row) * yrow +
                                                  (size_t)h * P + PH * hf + 2 * t);
#pragma unroll
        for (int nt = 0; nt < PT8; ++nt)
          o[4 * nt] = tc::pack(d * ax[nt][2 * r], d * ax[nt][2 * r + 1]);
      }
    }
    __syncthreads();   // C: every read of dh_c, S', W and this stage is done
    if (k + 1 < nh) load_planes(g.dstates, sDhi, k + 1);
    tc::cp_async_commit();
    if (warp == 0 && k + 1 < nh) {
      tc::cp_async_wait<2>();
      factors(k + 1);
    }
  }
  __syncthreads();
  if (warp == FIN) finish_head(nh - 1);
  // this block's dB and dC rows, summed over its heads
  const size_t prow = ((size_t)grp * g.B + b) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * q + gq + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const size_t o = (prow + row) * N + NH * hf + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(g.part_b + o) = make_float2(accB[nt][2 * r], accB[nt][2 * r + 1]);
      *reinterpret_cast<float2*>(g.part_c + o) = make_float2(accC[nt][2 * r], accC[nt][2 * r + 1]);
    }
  }
}

// Blocks [0, n_bc): dB and dC, an element a thread, summed over the head groups'
// rows in order. Block n_bc: dA, a head a thread, summed over (batch, chunk) in order.
__global__ void __launch_bounds__(THREADS)
ssd_scan_bwd_bf16_finish(Bf16BwdArgs g, int N, int n_bc) {
  const int S = g.S, H = g.H, nc = (S + Q - 1) / Q, groups = (H + HG - 1) / HG;
  if ((int)blockIdx.x < n_bc) {
    const size_t total = (size_t)g.B * S * N;
    const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < groups; ++k) {
      sb += g.part_b[k * total + e];
      sc += g.part_c[k * total + e];
    }
    g.dbm[e] = __float2bfloat16_rn(sb);
    g.dcm[e] = __float2bfloat16_rn(sc);
    return;
  }
  for (int h = threadIdx.x; h < H; h += THREADS) {
    float s = 0.f;
    for (int k = 0; k < g.B * nc; ++k) s += g.part_a[(size_t)k * H + h];
    g.dA[h] = s;
  }
}

template <int N, int P>
cudaError_t launch_bwd_bf16(const Bf16BwdArgs& g, cudaStream_t stream) {
  using SL = StSmem<N, P>;
  using GL = GrSmem<N, P>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_states<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SL::bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_states<N, P>
      <<<dim3(N / SL::NS, g.H, 2 * g.B), SL::WARPS * 32, SL::bytes, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_scan_bwd_grad<N, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GL::bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_grad<N, P>
      <<<dim3((g.S + Q - 1) / Q, (g.H + HG - 1) / HG, g.B), GR_THREADS, GL::bytes, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)g.B * g.S * N;
  const int n_bc = (int)((total + THREADS - 1) / THREADS);
  ssd_scan_bwd_bf16_finish<<<n_bc + 1, THREADS, 0, stream>>>(g, N, n_bc);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bwd_bf16_n(const Bf16BwdArgs& g, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch_bwd_bf16<16, P>(g, s);
    case 32: return launch_bwd_bf16<32, P>(g, s);
    case 64: return launch_bwd_bf16<64, P>(g, s);
    case 128: return launch_bwd_bf16<128, P>(g, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* bm,
                   const void* cm, const float* init_state, void* y, float* final_state,
                   int B, int S, int H, int P, const long long* st, int dtype,
                   cudaStream_t stream) {
  const dim3 grid(P / PT, H, B);
  cudaError_t err;
  if (dtype == 1) {
    constexpr size_t smem = TcSmem<N>::bytes;
    err = cudaFuncSetAttribute(ssd_scan_bf16_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_bf16_kernel<N><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(bm),
        static_cast<const __nv_bfloat16*>(cm), init_state, static_cast<__nv_bfloat16*>(y),
        final_state, S, H, P, st[0], st[1], st[2], st[3], st[4], st[5]);
  } else {
    constexpr size_t smem = smem_floats<N>() * sizeof(float);
    err = cudaFuncSetAttribute(ssd_scan_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel<N><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(bm),
        static_cast<const float*>(cm), init_state, static_cast<float*>(y), final_state, S, H,
        P, st[0], st[1], st[2], st[3], st[4], st[5]);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = f32 (the
// CUDA-core design), 1 = bf16 (the tensor-core design). init_state may be null
// (a zero initial state). Strides are in elements: batch and row strides of x,
// then of bm, then of cm. For bf16 every base pointer and stride is 16-byte
// aligned (the wrapper checks).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, const void* init_state, void* y,
                            void* final_state, int B, int S, int H, int P, int N,
                            long long x_batch, long long x_row, long long b_batch,
                            long long b_row, long long c_batch, long long c_row, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % PT != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0 = static_cast<const float*>(init_state);
  float* hT = static_cast<float*>(final_state);
  const long long st[6] = {x_batch, x_row, b_batch, b_row, c_batch, c_row};
  switch (N) {
    case 16: return (int)launch<16>(x, dtf, Af, bm, cm, h0, y, hT, B, S, H, P, st, dtype, s);
    case 32: return (int)launch<32>(x, dtf, Af, bm, cm, h0, y, hT, B, S, H, P, st, dtype, s);
    case 64: return (int)launch<64>(x, dtf, Af, bm, cm, h0, y, hT, B, S, H, P, st, dtype, s);
    case 128: return (int)launch<128>(x, dtf, Af, bm, cm, h0, y, hT, B, S, H, P, st, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
// Bytes of scratch that ssd_scan_bwd needs (256-byte aligned pieces). bf16: h_c
// and dh_c as hi and lo planes, bf16 [B, ceil(S/64), H, 2, N, P] each; the head
// groups' dB and dC rows, f32 [ceil(H/10), B, S, N] each; dA's parts, f32
// [B, ceil(S/64), H]. f32: the states entering each chunk, f32
// [B, H, ceil(S/64), N, P]; part_b and part_c [P/32 * H, B, S, N]; part_t
// [2, P/32, B, S, H].
namespace {
size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// the pieces of the scratch, in order
void scratch_pieces(int B, int S, int H, int P, int N, int dtype, size_t (&sz)[5]) {
  const size_t nc = (S + Q - 1) / Q, rows = (size_t)B * S;
  if (dtype == 1) {
    const size_t planes = (size_t)B * nc * H * 2 * N * P * 2, groups = (H + HG - 1) / HG;
    sz[0] = sz[1] = align256(planes);
    sz[2] = sz[3] = align256(groups * rows * N * 4);
    sz[4] = align256((size_t)B * nc * H * 4);
  } else {
    sz[0] = align256((size_t)B * H * nc * N * P * 4);
    sz[1] = sz[2] = align256((size_t)(P / PT) * H * rows * N * 4);
    sz[3] = align256(2 * (size_t)(P / PT) * rows * H * 4);
    sz[4] = 0;
  }
}
}  // namespace

extern "C" long long ssd_scan_bwd_scratch(int B, int S, int H, int P, int N, int dtype) {
  size_t sz[5];
  scratch_pieces(B, S, H, P, N, dtype, sz);
  return (long long)(sz[0] + sz[1] + sz[2] + sz[3] + sz[4]);
}

// The gradient of ssd_scan_fwd: dy (contiguous [B,S,H,P], x's dtype) and d_final
// (f32 [B,H,N,P] or null: zero) -> dx (x's dtype), ddt (f32 [B,S,H]), dA (f32
// [H]), dbm and dcm (x's dtype, contiguous [B,S,N]), d_init (f32, or null when
// not wanted). Inputs as ssd_scan_fwd takes them; bf16 takes P of 32 or 64.
// scratch: ssd_scan_bwd_scratch bytes, 256-byte aligned. Launches on `stream`
// (bf16: three, f32: two); returns the cudaError_t.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, const void* init_state, const void* dy,
                            const void* d_final, void* dx, void* ddt, void* dA, void* dbm,
                            void* dcm, void* d_init, void* scratch, int B, int S, int H, int P,
                            int N, long long x_batch, long long x_row, long long b_batch,
                            long long b_row, long long c_batch, long long c_row, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % PT != 0 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && P != 32 && P != 64))
    return (int)cudaErrorInvalidValue;
  size_t sz[5];
  scratch_pieces(B, S, H, P, N, dtype, sz);
  char* w = static_cast<char*>(scratch);
  char* piece[5];
  for (int i = 0; i < 5; ++i) {
    piece[i] = w;
    w += sz[i];
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const Bf16BwdArgs g{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                        static_cast<const float*>(A), static_cast<const bf16*>(bm),
                        static_cast<const bf16*>(cm), static_cast<const float*>(init_state),
                        static_cast<const bf16*>(dy), static_cast<const float*>(d_final),
                        static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
                        static_cast<bf16*>(dbm), static_cast<bf16*>(dcm),
                        static_cast<float*>(d_init), reinterpret_cast<bf16*>(piece[0]),
                        reinterpret_cast<bf16*>(piece[1]), reinterpret_cast<float*>(piece[2]),
                        reinterpret_cast<float*>(piece[3]), reinterpret_cast<float*>(piece[4]),
                        B, S, H, x_batch, x_row, b_batch, b_row, c_batch, c_row};
    return (int)(P == 32 ? launch_bwd_bf16_n<32>(g, N, s) : launch_bwd_bf16_n<64>(g, N, s));
  }
  const BwdArgs g{static_cast<const float*>(x), static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(bm),
                  static_cast<const float*>(cm), static_cast<const float*>(init_state),
                  static_cast<const float*>(dy), static_cast<const float*>(d_final),
                  static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(dA),
                  static_cast<float*>(dbm), static_cast<float*>(dcm), static_cast<float*>(d_init),
                  reinterpret_cast<float*>(piece[0]), reinterpret_cast<float*>(piece[1]),
                  reinterpret_cast<float*>(piece[2]), reinterpret_cast<float*>(piece[3]), B, S,
                  H, P, x_batch, x_row, b_batch, b_row, c_batch, c_row};
  return (int)launch_bwd_n(g, N, s);
}
