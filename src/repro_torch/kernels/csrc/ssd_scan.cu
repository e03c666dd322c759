// Mamba-2 SSD chunked scan for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_pallas` of
// src/repro/kernels/ssd_scan.py. It computes what the JAX package's model path
// computes, the jnp `_ssd_blocked` of src/repro/kernels/ops.py: y and the final
// state, from an optional initial state, for any S. Single B/C group (G = 1).
//
//   x [B, S, H, P], bm/cm [B, S, N] (contiguous, f32 or bf16, one dtype)
//   dt [B, S, H] f32 (> 0), A [H] f32 (< 0), init_state [B, H, N, P] f32 or null
//   y [B, S, H, P] in x's dtype, final_state [B, H, N, P] f32. All arithmetic f32.
//
// Per chunk of Q rows, with cum = cumsum(dt * A) from the chunk's start:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i . h
//   h'    = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// The SSD math does not depend on the chunk length except through rounding, so
// the kernel walks its own tiles of Q = 64 rows whatever the model's chunk is.
// Rows at or past S act as dt = 0, x = B = C = 0 and are not written: exactly
// the zero padding of `_ssd_blocked`, without a padded copy.
//
// Design. The TPU kernel carries the [N, P] state in VMEM across a sequential
// chunk grid axis; Hopper blocks run in no order, so here each block loops over
// the chunks itself and keeps its state in shared memory. One block per
// (32-column tile of P, head, batch): y[:, p] needs only state[:, p] and
// x[:, p], while C.B^T and the decay are shared by the columns, so the P tiles
// are independent and the grid has P/32 * H * B blocks (160 for mamba2-2.7b at
// B = 1, more than the 132 SMs; one block per (batch, head) would give 80). The
// price is that C.B^T is recomputed by each P tile and each head; a two-pass
// form (chunk states in parallel, then the recurrence) was not taken because
// the recurrence is cheap here and one pass keeps the state out of device
// memory. A [64, 128] chunk of B or C is 32 KB in f32, so one chunk of B, C,
// x*dt, the [64, 64] score tile and the [N, 32] state fit in ~108 KB of shared
// memory (two blocks an SM). Rows of B, C and the score tile are padded by one
// float so that the per-row and per-column reads hit distinct banks.
//
// Overflow: L[i,j] = exp(cum_i - cum_j) is formed from the difference, never as
// exp(cum_i) * exp(-cum_j) (cum falls to about -1000 over a long chunk), and
// only for j <= i: the causal mask is applied before the exp, so the positive
// upper triangle never becomes inf (and inf * 0 never becomes NaN).
//
// What bounds it on the H100. At the serving shape (B=1, S=512, H=80, P=64,
// N=128, bf16) it moves 13.5 MB (0.004 ms at 3.35 TB/s) and needs 2.7 GFLOP
// with C.B^T counted once per chunk (0.0027 ms on the bf16 tensor cores), so
// its bound is set by bytes. This first version does f32 FMAs on the CUDA cores
// and recomputes C.B^T for every (head, P tile): ~4 GFLOP at 64 FMA a clock an
// SM (two shared-memory reads per four FMAs), so it is bound by its own
// arithmetic, with the tile loops shaped for a later mma/wgmma inner product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int Q = 64;         // rows per chunk tile
constexpr int PT = 32;        // columns of P per block
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RPT = 4;        // score / y rows per thread (Q / 16)
constexpr int CPT = 4;        // score columns per thread (Q / 16)
constexpr int YPT = 2;        // y / state columns per thread (PT / 16)

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

template <int N>
constexpr size_t smem_floats() {
  // sB, sC [Q][N+1]; sXdt [Q][PT]; sS [Q][Q+1]; sH [N][PT]; sCum, sDt, sOut, sIn [Q]
  return 2 * (size_t)Q * (N + 1) + (size_t)Q * PT + (size_t)Q * (Q + 1) +
         (size_t)N * PT + 4 * (size_t)Q;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ init_state,
                T* __restrict__ y, float* __restrict__ final_state, int S, int H,
                int P) {
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

  const size_t xrow = (size_t)H * P;   // between consecutive x / y rows
  const T* xb = x + (size_t)b * S * xrow + (size_t)h * P + p0;
  T* yb = y + (size_t)b * S * xrow + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* bb = bm + (size_t)b * S * N;
  const T* cb = cm + (size_t)b * S * N;
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
      const size_t g = (size_t)(c0 + r) * N + n;
      sB[r * NP + n] = ok ? to_f32(bb[g]) : 0.f;
      sC[r * NP + n] = ok ? to_f32(cb[g]) : 0.f;
    }
    if (tid < Q) sDt[tid] = tid < rows ? dtb[(size_t)(c0 + tid) * H] : 0.f;
    __syncthreads();

    for (int i = tid; i < Q * PT; i += THREADS) {
      const int r = i / PT, p = i % PT;
      sXdt[i] = r < rows ? to_f32(xb[(size_t)(c0 + r) * xrow + p]) * sDt[r] : 0.f;
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
          yb[(size_t)(c0 + r) * xrow + tx + 16 * e] =
              from_f32<T>(yi[i][e] + sIn[r] * yh[i][e]);
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

template <typename T, int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* bm,
                   const void* cm, const float* init_state, void* y,
                   float* final_state, int B, int S, int H, int P,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(P / PT, H, B);
  ssd_scan_kernel<T, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(bm),
      static_cast<const T*>(cm), init_state, static_cast<T*>(y), final_state, S, H, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_state(const void* x, const float* dt, const float* A,
                             const void* bm, const void* cm, const float* init_state,
                             void* y, float* final_state, int B, int S, int H, int P,
                             int N, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(x, dt, A, bm, cm, init_state, y, final_state, B, S, H, P, stream);
    case 32: return launch<T, 32>(x, dt, A, bm, cm, init_state, y, final_state, B, S, H, P, stream);
    case 64: return launch<T, 64>(x, dt, A, bm, cm, init_state, y, final_state, B, S, H, P, stream);
    case 128: return launch<T, 128>(x, dt, A, bm, cm, init_state, y, final_state, B, S, H, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = f32, 1 = bf16.
// init_state may be null (a zero initial state).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* bm,
                            const void* cm, const void* init_state, void* y,
                            void* final_state, int B, int S, int H, int P, int N,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % PT != 0) return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* h0 = static_cast<const float*>(init_state);
  float* hT = static_cast<float*>(final_state);
  const cudaError_t err =
      dtype == 1 ? launch_for_state<__nv_bfloat16>(x, dtf, Af, bm, cm, h0, y, hT, B, S, H,
                                                   P, N, s)
      : dtype == 0 ? launch_for_state<float>(x, dtf, Af, bm, cm, h0, y, hT, B, S, H, P, N, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
