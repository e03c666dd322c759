// RMSNorm forward for Hopper (sm_90a), alone and fused with the elementwise work
// that the serving paths run beside it, with a plain C interface for ctypes.
//
// Replaces the TPU kernel `_rmsnorm_kernel` / `rmsnorm_pallas` of
// src/repro/kernels/rmsnorm.py. Per row of x [rows, D]: the f32 mean of x^2, then
// x * rsqrt(var + eps) * scale, rounded to x's dtype (f32 or bf16). The four entry
// points share one row-reduction core and differ only in what they read before
// the norm and write after it:
//   rmsnorm_fwd        y = rmsnorm(x)
//   add_rmsnorm_fwd    s = x + r, rounded to the dtype and written out (the new
//                      residual stream); y = rmsnorm(s)
//   gated_rmsnorm_fwd  t = y * silu(z): silu in f32 (expf as PyTorch's silu; a
//                      2-ulp division), rounded to the dtype, the product
//                      rounded; out = rmsnorm(t)
//   qk_norm_rope_fwd   q [B,S,H,hd] and k [B,S,K,hd] in one launch: every (token,
//                      head) row normalised with q_norm / k_norm and rounded, then
//                      split-half RoPE in f32 at positions[b, s], rounded again.
// Each fusion rounds where the unfused PyTorch sequence rounds, and the products
// and sums that PyTorch runs as separate kernels are written with __fmul_rn /
// __fadd_rn so that nvcc cannot contract them into an FMA.
//
// What bounds it on the H100: bytes. The norm does ~4 flops an element (RoPE ~4
// more plus a sincosf) against 4-10 bytes moved an element, far below the card's
// ~20 f32 flops a byte, so the least time is the bytes over 3.35 TB/s: 0.63 us
// for rmsnorm at [512, 1024] bf16. The design moves each byte once:
//   - 16-byte vector loads and stores, neighbouring lanes on neighbouring
//     addresses; a row stays in registers between its reduction and its write,
//     so nothing is read twice and no intermediate touches device memory.
//   - Rows go to threads by D. Up to 128 vectors a row (bf16 D <= 1024, f32 D <=
//     512) a group of TPR lanes (a power of two, 8..32) owns a row, NV <= 4
//     vectors a lane, and reduces with xor shuffles: a half warp for a bf16 qk
//     row of hd = 128, a warp for D = 1024. Wider rows (mamba2's 2560 and 5120)
//     take one block each, NV vectors a thread (160 threads at both widths), and
//     add the warps' partial sums through shared memory.
//   - Blocks hold 32-256 threads: as many rows a block as still leaves >= 2 blocks
//     an SM, so the 512-row prefill shapes spread over all 132 SMs (one warp a
//     block at D = 1024). A grid-stride loop walks the rows; each thread's slice
//     of scale is read once per block.
//   - All of a row's loads are issued before its first store (no store between
//     two loads that the compiler cannot reorder), and values stay packed in the
//     dtype between steps (half the registers in bf16).
//   - qk_norm_rope computes each token's cos and sin once per block into shared
//     memory: its heads share them, and the accurate sincosf per element would
//     cost more than the row's bytes.
// What is left at the prefill shapes (chip_smoke.py's profile on an H100): 2.6-5
// us a launch for 2-10 MB against bounds of 0.6-3.1 us, and 9.6 us for the gated
// norm's 15.7 MB (bound 4.7 us). Kernels this small pay the launch ramp and two
// DRAM round trips in sequence (the loads, then the stores after the reduction).
// Decode shapes (4 rows) cannot fill the card; there the launch is the cost, and
// the fusions remove launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_GROUP_VECS = 128;   // widest row a lane group takes, in vectors
constexpr int MAX_THREADS = 256;      // largest block

template <typename T> struct Vec;     // elements in a 16-byte vector
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf_pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// a 16-byte vector widened to f32
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float* f) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  } else {
    f[0] = bf_lo(u.x); f[1] = bf_hi(u.x); f[2] = bf_lo(u.y); f[3] = bf_hi(u.y);
    f[4] = bf_lo(u.z); f[5] = bf_hi(u.z); f[6] = bf_lo(u.w); f[7] = bf_hi(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p, long long i) {
  return reinterpret_cast<const uint4*>(p)[i];
}

// f rounded to T, as a 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    return make_uint4(bf_pack(f[0], f[1]), bf_pack(f[2], f[3]),
                      bf_pack(f[4], f[5]), bf_pack(f[6], f[7]));
  }
}

template <typename T>
__device__ __forceinline__ void put16(T* p, long long i, const uint4& u) {
  reinterpret_cast<uint4*>(p)[i] = u;
}

// v rounded to T and back: the value a PyTorch op with output dtype T keeps
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

// sum over an aligned group of `width` lanes (a power of two <= 32); every lane
// of the warp takes part, and every lane of a group gets the same sum
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// sum over the block (a multiple of 32 threads); every thread gets the same sum
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = group_sum(v, 32);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t += partial[w];
  __syncthreads();   // partial is reused by the next row
  return t;
}

// ------------------------------------------------- what each entry point reads
// fetch(i, raw): load the IN input vectors of flat vector i; pre(i, raw): the
// pre-norm values as a vector of T, rounded where PyTorch rounds them, with any
// side output written; post(i, y): the normed vector's store. The kernel
// fetches all of a row's vectors before the first pre(), so no store sits
// between two loads and every load of the row is in flight at once. Values
// stay packed in T between the steps (half the registers in bf16).
template <typename T>
struct PlainOp {
  static constexpr int IN = 1;
  const T* x; T* y;
  __device__ void fetch(long long i, uint4* raw) const { raw[0] = ld16(x, i); }
  __device__ uint4 pre(long long, const uint4* raw) const { return raw[0]; }
  __device__ void post(long long i, const float* o) const { put16(y, i, pack<T>(o)); }
};

template <typename T>
struct AddOp {
  static constexpr int IN = 2;
  const T* x; const T* r; T* s; T* y;
  __device__ void fetch(long long i, uint4* raw) const {
    raw[0] = ld16(x, i);
    raw[1] = ld16(r, i);
  }
  __device__ uint4 pre(long long i, const uint4* raw) const {
    constexpr int VEC = Vec<T>::N;
    float a[VEC], b[VEC];
    widen<T>(raw[0], a);
    widen<T>(raw[1], b);
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = __fadd_rn(a[k], b[k]);
    const uint4 t = pack<T>(a);
    put16(s, i, t);
    return t;
  }
  __device__ void post(long long i, const float* o) const { put16(y, i, pack<T>(o)); }
};

template <typename T>
struct GatedOp {
  static constexpr int IN = 2;
  const T* y; const T* z; T* out;
  __device__ void fetch(long long i, uint4* raw) const {
    raw[0] = ld16(y, i);
    raw[1] = ld16(z, i);
  }
  __device__ uint4 pre(long long, const uint4* raw) const {
    constexpr int VEC = Vec<T>::N;
    float a[VEC], g[VEC];
    widen<T>(raw[0], a);
    widen<T>(raw[1], g);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      // PyTorch's silu is g / (1 + expf(-g)). __fdividef (2 ulp; 0 once the
      // divisor passes 2^126, where silu is below 1e-36) takes the place of the
      // IEEE division, whose slow-path check is the costliest step here
      const float silu = round_to<T>(__fdividef(g[k], 1.0f + expf(-g[k])));
      a[k] = __fmul_rn(a[k], silu);
    }
    return pack<T>(a);
  }
  __device__ void post(long long i, const float* o) const { put16(out, i, pack<T>(o)); }
};

// ------------------------------------------------------------- the row kernel
// tpr <= 32: blockDim.x / tpr rows a block, tpr lanes a row (shuffle sums).
// tpr > 32: one row a block, tpr == blockDim.x threads (shared-memory sum).
// Lane l of a row holds vectors l, l + tpr, ..., l + (NV-1) tpr (< nvec).
template <typename T, int NV, class Op>
__global__ void __launch_bounds__(MAX_THREADS)
rows_kernel(Op op, const T* __restrict__ scale, long long rows, int nvec, int tpr,
            float inv_d, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float partial[32];
  const bool wide = tpr > 32;
  const int rpb = wide ? 1 : blockDim.x / tpr;
  const int lane = wide ? threadIdx.x : (threadIdx.x & (tpr - 1));
  const int sub = wide ? 0 : threadIdx.x / tpr;

  uint4 sc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * tpr + lane;
    if (i < nvec) sc[v] = ld16(scale, i);
  }
  for (long long r0 = (long long)blockIdx.x * rpb; r0 < rows;
       r0 += (long long)gridDim.x * rpb) {
    const long long row = r0 + sub;
    const bool live = row < rows;
    uint4 raw[NV][Op::IN];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) op.fetch(row * nvec + i, raw[v]);
    }
    uint4 t[NV];
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        t[v] = op.pre(row * nvec + i, raw[v]);
        float f[VEC];
        widen<T>(t[v], f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) ss += f[k] * f[k];
      }
    }
    ss = wide ? block_sum(ss, partial) : group_sum(ss, tpr);
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float f[VEC], w[VEC];
        widen<T>(t[v], f);
        widen<T>(sc[v], w);
#pragma unroll
        for (int k = 0; k < VEC; ++k) f[k] = __fmul_rn(__fmul_rn(f[k], rstd), w[k]);
        op.post(row * nvec + i, f);
      }
    }
  }
}

// ------------------------------------------------------------ qk-norm + RoPE
template <typename T>
struct QkArgs {
  const T* x[2];           // q, k
  const T* scale[2];       // q_norm, k_norm
  T* out[2];
  int heads[2];            // H, K
  const int* pos;          // positions [B, S], read through its strides
  long long pos_sb, pos_ss;
  const float* inv_freq;   // [hd / 2]
  int S, nvec, tpr;        // nvec = hd / VEC = NV * tpr
  int rows[2];             // B * S * heads (< 2^31: 32-bit divisions, not 64-bit)
  float inv_d, eps;
};

// Row groups of q come first, then those of k, in one grid-stride loop (no
// block sits idle on the shorter of the two). A row of hd elements is NV * tpr vectors; its
// first half pairs with its second half (RoPE's x1, x2). With NV == 1 the
// partner vector is in lane ^ tpr/2, with NV even in the same lane's vector
// v ^ NV/2. The heads of a token share its angles, so a block computes the
// cos and sin of the tokens its rows span once, into shared memory: the
// accurate sincosf (range reduction for angles up to the context length) costs
// more than the row's bytes if every head recomputes it.
template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
qk_norm_rope_kernel(QkArgs<T> a) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TABLE = MAX_THREADS * NV * VEC / 2;   // tokens a block x hd / 2, at most
  __shared__ float tab_c[TABLE], tab_s[TABLE];
  const int tpr = a.tpr, nvec = a.nvec, half = nvec >> 1, hh = half * VEC;
  const int rpb = blockDim.x / tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int sub = threadIdx.x / tpr;
  const int q_groups = (a.rows[0] + rpb - 1) / rpb;
  const int groups = q_groups + (a.rows[1] + rpb - 1) / rpb;

  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    // picked with selects: indexing the parameter arrays would copy them to the stack
    const bool is_k = g >= q_groups;
    const T* __restrict__ x = is_k ? a.x[1] : a.x[0];
    const T* __restrict__ scale = is_k ? a.scale[1] : a.scale[0];
    T* __restrict__ out = is_k ? a.out[1] : a.out[0];
    const int heads = is_k ? a.heads[1] : a.heads[0];
    const int rows = is_k ? a.rows[1] : a.rows[0];
    const int r0 = (is_k ? g - q_groups : g) * rpb;
    const int row = r0 + sub;
    const bool live = row < rows;
    uint4 raw[NV], sc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (live) raw[v] = ld16(x, (long long)row * nvec + v * tpr + lane);
      sc[v] = ld16(scale, v * tpr + lane);
    }
    // the angles of this block's tokens, while the rows' loads are in flight
    const int t0 = r0 / heads;
    const int last = (r0 + rpb < rows ? r0 + rpb : rows) - 1;
    const int n_ang = (last / heads - t0 + 1) * hh;
    for (int e = threadIdx.x; e < n_ang; e += blockDim.x) {
      const int t = t0 + e / hh;
      const float p = (float)a.pos[(t / a.S) * a.pos_sb + (t % a.S) * a.pos_ss];
      sincosf(__fmul_rn(p, a.inv_freq[e % hh]), &tab_s[e], &tab_c[e]);
    }
    __syncthreads();
    float xn[NV][VEC];
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (live) {
        widen<T>(raw[v], xn[v]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xn[v][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss += xn[v][k] * xn[v][k];
    }
    ss = group_sum(ss, tpr);
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float w[VEC];
      widen<T>(sc[v], w);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        xn[v][k] = round_to<T>(__fmul_rn(__fmul_rn(xn[v][k], rstd), w[k]));
    }
    const int base = (row / heads - t0) * hh;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      const bool first = i < half;
      const int e0 = base + (i % half) * VEC;
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float partner;
        if constexpr (NV == 1) partner = __shfl_xor_sync(FULL, xn[0][k], tpr >> 1);
        else partner = xn[v ^ (NV >> 1)][k];
        float cs = 0.f, sn = 0.f;
        if (live) {
          cs = tab_c[e0 + k];
          sn = tab_s[e0 + k];
        }
        const float own_c = __fmul_rn(xn[v][k], cs), other_s = __fmul_rn(partner, sn);
        // first half: x1 cos - x2 sin; second half: x2 cos + x1 sin
        y[k] = first ? __fsub_rn(own_c, other_s) : __fadd_rn(own_c, other_s);
      }
      if (live) put16(out, (long long)row * nvec + i, pack<T>(y));
    }
    __syncthreads();   // the table is rewritten for the next rows
  }
}

// ------------------------------------------------------------------- backward
// The gradient of y = T(x * rstd * w), x and w widened to f32, rstd = rsqrt(mean(x^2)
// + eps), for the cotangent dy (in T), as autodiff of `rmsnorm_ref` gives it:
//   g = dy * w,   dx = rstd * g - x * rstd^3 * sum(g * x) / D   (rounded to T),
//   dw = the sum over every row of dy * x * rstd                 (f32, rounded once).
// One pass over the rows on the forward's row core: both row sums (x^2 and g x)
// in one reduction, the row in registers between it and the store.
//   rmsnorm_bwd       dx of the plain norm
//   add_rmsnorm_bwd   the forward returned (s, rmsnorm(s)) with s = x + r, so
//                     dx = dr = ds + dnorm: ds is added inside the pass, rounded
//                     where the unfused sequence rounds: T(ds + T(dnorm))
//   qk_norm_rope_bwd  q and k in one launch: the cotangent of the roped output is
//                     rotated back by -theta (RoPE's transpose, f32) and rounded
//                     to T (the grad of apply_rope's cast), then the norm's
//                     backward over head_dim with q_norm / k_norm.
// dw is a sum over every row (131,072 of them for qwen3's q-norm at 4 x 2048
// tokens), where f32 loses ~1e-5 of the sum's scale. So its path runs in f64: the
// row's sum of squares, rstd, each dy x rstd term and every partial sum (dx keeps
// f32, as the forward). It is deterministic: each block sums its rows into one
// f64 partial row (its lane groups added in a fixed order through shared memory),
// then colsum_kernel, one small launch, sums the partial rows in block order. No
// atomics, so two runs give the same bits. What bounds it: bytes, as the forward
// (x, dy and dx, plus ds for the add; the partial rows are ~4 MB at qwen3's
// widths), and the f64 work is a few operations an element.

__device__ __forceinline__ double group_sum_d(double v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the block's sums of a (f64) and b (f32); every thread gets both
__device__ __forceinline__ void block_sum2(double& a, float& b, double* pa, float* pb) {
  a = group_sum_d(a, 32);
  b = group_sum(b, 32);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    pa[threadIdx.x >> 5] = a;
    pb[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  double ta = 0.0;
  float tb = 0.f;
  for (int w = 0; w < warps; ++w) {
    ta += pa[w];
    tb += pb[w];
  }
  __syncthreads();   // the partials are reused by the next row
  a = ta;
  b = tb;
}

template <typename T>
__device__ __forceinline__ void store1(T* p, int i, float v) {
  if constexpr (sizeof(T) == 4) p[i] = v;
  else p[i] = __float2bfloat16_rn(v);
}

// a block's lane groups add their f64 partials `acc` (vectors v * tpr + lane of a
// row of nvec vectors) into red[0 .. nvec*VEC) in group order; then the block
// writes red to its partial row `out`
template <int NV, int VEC>
__device__ __forceinline__ void block_partial(const double (&acc)[NV][VEC], double* red,
                                              double* out, int nvec, int tpr, int lane,
                                              int sub, int rpb) {
  for (int g = 0; g < rpb; ++g) {
    if (sub == g) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v * tpr + lane;
        if (i < nvec)
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            red[i * VEC + k] = (g ? red[i * VEC + k] : 0.0) + acc[v][k];
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < nvec * VEC; c += blockDim.x) out[c] = red[c];
}

struct Cols {              // one reduction job: out[c] = sum over blocks of partial[b][c]
  const double* partial;
  int blocks;
  void* out;
};

template <typename T>
__global__ void colsum_kernel(Cols a, Cols b, int D) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool second = blockIdx.y != 0;
  const double* partial = second ? b.partial : a.partial;
  const int blocks = second ? b.blocks : a.blocks;
  T* out = static_cast<T*>(second ? b.out : a.out);
  if (col >= D) return;
  double s = 0.0;
  for (int i = 0; i < blocks; ++i) s += partial[(long long)i * D + col];
  store1(out, col, (float)s);
}

// Rows as rows_kernel assigns them. ADD: dx = T(ds + T(dx_norm)).
template <typename T, int NV, bool ADD>
__global__ void __launch_bounds__(MAX_THREADS)
rows_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ ds,
                const T* __restrict__ scale, T* __restrict__ dx, double* __restrict__ partial,
                long long rows, int nvec, int tpr, float inv_d, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ double sums_d[32];
  __shared__ float sums_f[32];
  __shared__ double red[MAX_GROUP_VECS * 8];
  const bool wide = tpr > 32;
  const int rpb = wide ? 1 : blockDim.x / tpr;
  const int lane = wide ? threadIdx.x : (threadIdx.x & (tpr - 1));
  const int sub = wide ? 0 : threadIdx.x / tpr;

  uint4 sc[NV];
  double dw[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * tpr + lane;
    if (i < nvec) sc[v] = ld16(scale, i);
#pragma unroll
    for (int k = 0; k < VEC; ++k) dw[v][k] = 0.0;
  }
  for (long long r0 = (long long)blockIdx.x * rpb; r0 < rows;
       r0 += (long long)gridDim.x * rpb) {
    const long long row = r0 + sub;
    const bool live = row < rows;
    uint4 rx[NV], rg[NV], rs[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        rx[v] = ld16(x, row * nvec + i);
        rg[v] = ld16(dy, row * nvec + i);
        if constexpr (ADD) rs[v] = ld16(ds, row * nvec + i);
      }
    }
    double ss = 0.0;
    float sg = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float xf[VEC], gf[VEC], w[VEC];
        widen<T>(rx[v], xf);
        widen<T>(rg[v], gf);
        widen<T>(sc[v], w);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          ss += (double)xf[k] * xf[k];
          sg += gf[k] * w[k] * xf[k];
        }
      }
    }
    if (wide) {
      block_sum2(ss, sg, sums_d, sums_f);
    } else {
      ss = group_sum_d(ss, tpr);
      sg = group_sum(sg, tpr);
    }
    const double rstd_d = 1.0 / sqrt(ss * inv_d + eps);
    const float rstd = (float)rstd_d;
    const float coef = rstd * rstd * rstd * sg * inv_d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float xf[VEC], gf[VEC], w[VEC], o[VEC];
        widen<T>(rx[v], xf);
        widen<T>(rg[v], gf);
        widen<T>(sc[v], w);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          o[k] = rstd * gf[k] * w[k] - xf[k] * coef;
          dw[v][k] += (double)gf[k] * xf[k] * rstd_d;
        }
        if constexpr (ADD) {
          float sf[VEC];
          widen<T>(rs[v], sf);
#pragma unroll
          for (int k = 0; k < VEC; ++k) o[k] = __fadd_rn(sf[k], round_to<T>(o[k]));
        }
        put16(dx, row * nvec + i, pack<T>(o));
      }
    }
  }
  double* prow = partial + (long long)blockIdx.x * nvec * VEC;
  if (wide) {   // one row a block: every column belongs to one thread
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (i < nvec)
#pragma unroll
        for (int k = 0; k < VEC; ++k) prow[i * VEC + k] = dw[v][k];
    }
    return;
  }
  block_partial<NV, VEC>(dw, red, prow, nvec, tpr, lane, sub, rpb);
}

template <typename T>
struct QkGrad {
  const T* dout[2];        // cotangents of the roped q, k
  double* partial[2];      // [blocks, hd] partial rows of dq_scale, dk_scale
};

// The forward's assignment of rows (q's row groups, then k's, in one grid-stride
// loop) and its table of each token's cos / sin; a.out[] receives dq and dk.
template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
qk_norm_rope_bwd_kernel(QkArgs<T> a, QkGrad<T> gr) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TABLE = MAX_THREADS * NV * VEC / 2;
  __shared__ float tab_c[TABLE], tab_s[TABLE];
  __shared__ double red[64 * 8];
  const int tpr = a.tpr, nvec = a.nvec, half = nvec >> 1, hh = half * VEC;
  const int rpb = blockDim.x / tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int sub = threadIdx.x / tpr;
  const int q_groups = (a.rows[0] + rpb - 1) / rpb;
  const int groups = q_groups + (a.rows[1] + rpb - 1) / rpb;

  uint4 scq[NV], sck[NV];
  double dwq[NV][VEC], dwk[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    scq[v] = ld16(a.scale[0], v * tpr + lane);
    sck[v] = ld16(a.scale[1], v * tpr + lane);
#pragma unroll
    for (int k = 0; k < VEC; ++k) dwq[v][k] = dwk[v][k] = 0.0;
  }

  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const bool is_k = g >= q_groups;
    const T* __restrict__ x = is_k ? a.x[1] : a.x[0];
    const T* __restrict__ dout = is_k ? gr.dout[1] : gr.dout[0];
    T* __restrict__ dx = is_k ? a.out[1] : a.out[0];
    const int heads = is_k ? a.heads[1] : a.heads[0];
    const int rows = is_k ? a.rows[1] : a.rows[0];
    const int r0 = (is_k ? g - q_groups : g) * rpb;
    const int row = r0 + sub;
    const bool live = row < rows;
    uint4 rx[NV], rd[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (live) {
        rx[v] = ld16(x, (long long)row * nvec + v * tpr + lane);
        rd[v] = ld16(dout, (long long)row * nvec + v * tpr + lane);
      }
    }
    const int t0 = r0 / heads;
    const int last = (r0 + rpb < rows ? r0 + rpb : rows) - 1;
    const int n_ang = (last / heads - t0 + 1) * hh;
    for (int e = threadIdx.x; e < n_ang; e += blockDim.x) {
      const int t = t0 + e / hh;
      const float p = (float)a.pos[(t / a.S) * a.pos_sb + (t % a.S) * a.pos_ss];
      sincosf(__fmul_rn(p, a.inv_freq[e % hh]), &tab_s[e], &tab_c[e]);
    }
    __syncthreads();
    float d[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (live) {
        widen<T>(rd[v], d[v]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) d[v][k] = 0.f;
      }
    }
    // RoPE's transpose: first half d1 cos + d2 sin, second half d2 cos - d1 sin
    const int base = (row / heads - t0) * hh;
    float du[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      const bool first = i < half;
      const int e0 = base + (i % half) * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float partner;
        if constexpr (NV == 1) partner = __shfl_xor_sync(FULL, d[0][k], tpr >> 1);
        else partner = d[v ^ (NV >> 1)][k];
        float cs = 0.f, sn = 0.f;
        if (live) {
          cs = tab_c[e0 + k];
          sn = tab_s[e0 + k];
        }
        const float own_c = __fmul_rn(d[v][k], cs), other_s = __fmul_rn(partner, sn);
        du[v][k] = round_to<T>(first ? __fadd_rn(own_c, other_s) : __fsub_rn(own_c, other_s));
      }
    }
    float xf[NV][VEC];
    double ss = 0.0;
    float sg = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float w[VEC];
      widen<T>(is_k ? sck[v] : scq[v], w);
      if (live) {
        widen<T>(rx[v], xf[v]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xf[v][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ss += (double)xf[v][k] * xf[v][k];
        sg += du[v][k] * w[k] * xf[v][k];
      }
    }
    ss = group_sum_d(ss, tpr);
    sg = group_sum(sg, tpr);
    const double rstd_d = 1.0 / sqrt(ss * a.inv_d + a.eps);
    const float rstd = (float)rstd_d;
    const float coef = rstd * rstd * rstd * sg * a.inv_d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float w[VEC], o[VEC];
      widen<T>(is_k ? sck[v] : scq[v], w);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o[k] = rstd * du[v][k] * w[k] - xf[v][k] * coef;
        const double c = (double)du[v][k] * xf[v][k] * rstd_d;
        if (is_k) dwk[v][k] += c;
        else dwq[v][k] += c;
      }
      if (live) put16(dx, (long long)row * nvec + v * tpr + lane, pack<T>(o));
    }
    __syncthreads();   // the table is rewritten for the next rows
  }
  const int hd = nvec * VEC;
  block_partial<NV, VEC>(dwq, red, gr.partial[0] + (long long)blockIdx.x * hd, nvec, tpr,
                         lane, sub, rpb);
  __syncthreads();   // red is reused for k
  block_partial<NV, VEC>(dwk, red, gr.partial[1] + (long long)blockIdx.x * hd, nvec, tpr,
                         lane, sub, rpb);
}

// ------------------------------------------------------------------ launching
int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// Makes `dev` current for the launch and restores the caller's device after.
struct DeviceScope {
  int prev = -1;
  explicit DeviceScope(int dev) {
    int cur = 0;
    cudaGetDevice(&cur);
    if (cur != dev) {
      prev = cur;
      cudaSetDevice(dev);
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Rows a block in the lane-group path: the most (up to MAX_THREADS threads) that
// still leaves two blocks an SM, and never under one warp.
int rows_per_block(long long rows, int tpr) {
  int rpb = MAX_THREADS / tpr;
  const long long want = 2LL * sm_count();
  while (rpb * tpr > 32 && (rows + rpb - 1) / rpb < want) rpb >>= 1;
  return rpb;
}

unsigned grid_for(long long groups, int threads) {
  const long long cap = (long long)sm_count() * (2048 / threads);   // one full wave
  return (unsigned)(groups < cap ? groups : cap);
}

template <typename T, class Op>
cudaError_t launch_rows(const Op& op, const void* scale, long long rows, int D,
                        float eps, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (rows <= 0 || D <= 0 || D % VEC) return cudaErrorInvalidValue;
  const int nvec = D / VEC;
  int tpr, nv, threads;
  long long groups;
  if (nvec <= MAX_GROUP_VECS) {
    tpr = 8;
    while (tpr < 32 && tpr < nvec) tpr <<= 1;
    nv = (nvec + tpr - 1) / tpr;
    if (nv == 3) nv = 4;
    const int rpb = rows_per_block(rows, tpr);
    threads = rpb * tpr;
    groups = (rows + rpb - 1) / rpb;
  } else {
    nv = 1;
    while (nv < 8 && (nvec + nv - 1) / nv > MAX_THREADS) nv <<= 1;
    tpr = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    if (tpr > MAX_THREADS) return cudaErrorInvalidValue;
    threads = tpr;
    groups = rows;
  }
  const unsigned blocks = grid_for(groups, threads);
  const T* sc = static_cast<const T*>(scale);
  const float inv_d = 1.0f / (float)D;
  switch (nv) {
    case 1: rows_kernel<T, 1, Op><<<blocks, threads, 0, s>>>(op, sc, rows, nvec, tpr, inv_d, eps); break;
    case 2: rows_kernel<T, 2, Op><<<blocks, threads, 0, s>>>(op, sc, rows, nvec, tpr, inv_d, eps); break;
    case 4: rows_kernel<T, 4, Op><<<blocks, threads, 0, s>>>(op, sc, rows, nvec, tpr, inv_d, eps); break;
    case 8: rows_kernel<T, 8, Op><<<blocks, threads, 0, s>>>(op, sc, rows, nvec, tpr, inv_d, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qk(QkArgs<T> a, int hd, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (hd <= 0 || hd % (2 * VEC)) return cudaErrorInvalidValue;
  const int nvec = hd / VEC;
  if (nvec & (nvec - 1) || nvec > 64) return cudaErrorInvalidValue;   // a power of two
  const int tpr = nvec < 32 ? nvec : 32;
  const int nv = nvec / tpr;
  a.nvec = nvec;
  a.tpr = tpr;
  a.inv_d = 1.0f / (float)hd;
  const int rows = a.rows[0] + a.rows[1];
  const int rpb = rows_per_block(rows, tpr);
  const unsigned grid = grid_for((a.rows[0] + rpb - 1) / rpb + (a.rows[1] + rpb - 1) / rpb,
                                 rpb * tpr);
  switch (nv) {
    case 1: qk_norm_rope_kernel<T, 1><<<grid, rpb * tpr, 0, s>>>(a); break;
    case 2: qk_norm_rope_kernel<T, 2><<<grid, rpb * tpr, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the backward's grid: the forward's, capped at the caller's partial rows
template <typename T, bool ADD>
cudaError_t launch_rows_bwd(const void* x, const void* dy, const void* ds, const void* scale,
                            void* dx, void* dscale, double* partial, int max_blocks,
                            long long rows, int D, float eps, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (rows <= 0 || D <= 0 || D % VEC || max_blocks <= 0) return cudaErrorInvalidValue;
  const int nvec = D / VEC;
  int tpr, nv, threads;
  long long groups;
  if (nvec <= MAX_GROUP_VECS) {
    tpr = 8;
    while (tpr < 32 && tpr < nvec) tpr <<= 1;
    nv = (nvec + tpr - 1) / tpr;
    if (nv == 3) nv = 4;
    const int rpb = rows_per_block(rows, tpr);
    threads = rpb * tpr;
    groups = (rows + rpb - 1) / rpb;
  } else {
    nv = 1;
    while (nv < 8 && (nvec + nv - 1) / nv > MAX_THREADS) nv <<= 1;
    tpr = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    if (tpr > MAX_THREADS) return cudaErrorInvalidValue;
    threads = tpr;
    groups = rows;
  }
  unsigned blocks = grid_for(groups, threads);
  if (blocks > (unsigned)max_blocks) blocks = (unsigned)max_blocks;
  const T* x_ = static_cast<const T*>(x);
  const T* dy_ = static_cast<const T*>(dy);
  const T* ds_ = static_cast<const T*>(ds);
  const T* sc = static_cast<const T*>(scale);
  T* dx_ = static_cast<T*>(dx);
  const float inv_d = 1.0f / (float)D;
  switch (nv) {
    case 1: rows_bwd_kernel<T, 1, ADD><<<blocks, threads, 0, s>>>(x_, dy_, ds_, sc, dx_, partial, rows, nvec, tpr, inv_d, eps); break;
    case 2: rows_bwd_kernel<T, 2, ADD><<<blocks, threads, 0, s>>>(x_, dy_, ds_, sc, dx_, partial, rows, nvec, tpr, inv_d, eps); break;
    case 4: rows_bwd_kernel<T, 4, ADD><<<blocks, threads, 0, s>>>(x_, dy_, ds_, sc, dx_, partial, rows, nvec, tpr, inv_d, eps); break;
    case 8: rows_bwd_kernel<T, 8, ADD><<<blocks, threads, 0, s>>>(x_, dy_, ds_, sc, dx_, partial, rows, nvec, tpr, inv_d, eps); break;
    default: return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Cols job{partial, (int)blocks, dscale};
  colsum_kernel<T><<<dim3((D + 255) / 256, 1), 256, 0, s>>>(job, job, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qk_bwd(QkArgs<T> a, QkGrad<T> gr, void* dq_scale, void* dk_scale,
                          int max_blocks, int hd, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (hd <= 0 || hd % (2 * VEC) || max_blocks <= 0) return cudaErrorInvalidValue;
  const int nvec = hd / VEC;
  if (nvec & (nvec - 1) || nvec > 64) return cudaErrorInvalidValue;
  const int tpr = nvec < 32 ? nvec : 32;
  const int nv = nvec / tpr;
  a.nvec = nvec;
  a.tpr = tpr;
  a.inv_d = 1.0f / (float)hd;
  const int rows = a.rows[0] + a.rows[1];
  const int rpb = rows_per_block(rows, tpr);
  unsigned grid = grid_for((a.rows[0] + rpb - 1) / rpb + (a.rows[1] + rpb - 1) / rpb,
                           rpb * tpr);
  if (grid > (unsigned)max_blocks) grid = (unsigned)max_blocks;
  gr.partial[1] = gr.partial[0] + (long long)max_blocks * hd;
  switch (nv) {
    case 1: qk_norm_rope_bwd_kernel<T, 1><<<grid, rpb * tpr, 0, s>>>(a, gr); break;
    case 2: qk_norm_rope_bwd_kernel<T, 2><<<grid, rpb * tpr, 0, s>>>(a, gr); break;
    default: return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<T><<<dim3((hd + 255) / 256, 2), 256, 0, s>>>(
      Cols{gr.partial[0], (int)grid, dq_scale}, Cols{gr.partial[1], (int)grid, dk_scale}, hd);
  return cudaGetLastError();
}

template <typename T>
QkArgs<T> qk_args(const void* q, const void* k, const void* q_scale, const void* k_scale,
                  void* q_out, void* k_out, const void* positions, long long pos_sb,
                  long long pos_ss, const void* inv_freq, int B, int S, int H, int K,
                  float eps) {
  QkArgs<T> a{};
  const long long tokens = (long long)B * S;
  a.x[0] = (const T*)q; a.x[1] = (const T*)k;
  a.scale[0] = (const T*)q_scale; a.scale[1] = (const T*)k_scale;
  a.out[0] = (T*)q_out; a.out[1] = (T*)k_out;
  a.heads[0] = H; a.heads[1] = K;
  a.rows[0] = (int)(tokens * H); a.rows[1] = (int)(tokens * K);
  a.pos = (const int*)positions; a.pos_sb = pos_sb; a.pos_ss = pos_ss;
  a.inv_freq = (const float*)inv_freq;
  a.S = S; a.eps = eps;
  return a;
}

}  // namespace

// Every entry point: contiguous, 16-byte aligned tensors of one dtype (0 = f32,
// 1 = bf16), D a multiple of 16 bytes; launches on `stream` of `device` and
// returns cudaGetLastError() (0 when the launch was taken).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, long long rows,
                           int D, float eps, int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_rows<float>(PlainOp<float>{(const float*)x, (float*)y}, scale, rows, D, eps, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_rows<B>(PlainOp<B>{(const B*)x, (B*)y}, scale, rows, D, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int add_rmsnorm_fwd(const void* x, const void* r, const void* scale, void* s_out,
                               void* y, long long rows, int D, float eps, int dtype,
                               int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_rows<float>(
        AddOp<float>{(const float*)x, (const float*)r, (float*)s_out, (float*)y},
        scale, rows, D, eps, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_rows<B>(AddOp<B>{(const B*)x, (const B*)r, (B*)s_out, (B*)y},
                               scale, rows, D, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gated_rmsnorm_fwd(const void* y, const void* z, const void* scale, void* out,
                                 long long rows, int D, float eps, int dtype, int device,
                                 void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_rows<float>(GatedOp<float>{(const float*)y, (const float*)z, (float*)out},
                                   scale, rows, D, eps, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_rows<B>(GatedOp<B>{(const B*)y, (const B*)z, (B*)out}, scale, rows, D,
                               eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// q [B,S,H,hd], k [B,S,K,hd]; positions int32 with element strides (pos_sb,
// pos_ss); inv_freq f32 [hd/2]. hd / (16 bytes) must be a power of two <= 64.
extern "C" int qk_norm_rope_fwd(const void* q, const void* k, const void* q_scale,
                                const void* k_scale, void* q_out, void* k_out,
                                const void* positions, long long pos_sb, long long pos_ss,
                                const void* inv_freq, int B, int S, int H, int K, int hd,
                                float eps, int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * S * (H + K) >= (1LL << 31) - MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_qk(qk_args<float>(q, k, q_scale, k_scale, q_out, k_out, positions,
                                         pos_sb, pos_ss, inv_freq, B, S, H, K, eps), hd, s);
  if (dtype == 1)
    return (int)launch_qk(qk_args<__nv_bfloat16>(q, k, q_scale, k_scale, q_out, k_out,
                                                 positions, pos_sb, pos_ss, inv_freq, B, S,
                                                 H, K, eps), hd, s);
  return (int)cudaErrorInvalidValue;
}

// Backward entry points. `partial` is f64 scratch of max_blocks rows of D (two
// such blocks of rows for qk_norm_rope_bwd, q's then k's); the launch uses at most
// max_blocks blocks, then one colsum launch writes dscale in the input dtype.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, void* partial, int max_blocks, long long rows,
                           int D, float eps, int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(partial);
  if (dtype == 0)
    return (int)launch_rows_bwd<float, false>(x, dy, nullptr, scale, dx, dscale, p, max_blocks,
                                              rows, D, eps, s);
  if (dtype == 1)
    return (int)launch_rows_bwd<__nv_bfloat16, false>(x, dy, nullptr, scale, dx, dscale, p,
                                                      max_blocks, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

// s: the forward's residual sum (its first output); ds, dn: the cotangents of s
// and of rmsnorm(s). dx = ds + the norm's dx, the gradient of both x and r.
extern "C" int add_rmsnorm_bwd(const void* s_in, const void* scale, const void* ds,
                               const void* dn, void* dx, void* dscale, void* partial,
                               int max_blocks, long long rows, int D, float eps, int dtype,
                               int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(partial);
  if (dtype == 0)
    return (int)launch_rows_bwd<float, true>(s_in, dn, ds, scale, dx, dscale, p, max_blocks,
                                             rows, D, eps, s);
  if (dtype == 1)
    return (int)launch_rows_bwd<__nv_bfloat16, true>(s_in, dn, ds, scale, dx, dscale, p,
                                                     max_blocks, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

// q, k: the forward's inputs (before the norm); dq_out, dk_out: the cotangents of
// its outputs; dq, dk, dq_scale, dk_scale receive the gradients.
extern "C" int qk_norm_rope_bwd(const void* q, const void* k, const void* q_scale,
                                const void* k_scale, const void* dq_out, const void* dk_out,
                                const void* positions, long long pos_sb, long long pos_ss,
                                const void* inv_freq, void* dq, void* dk, void* dq_scale,
                                void* dk_scale, void* partial, int max_blocks, int B, int S,
                                int H, int K, int hd, float eps, int dtype, int device,
                                void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * S * (H + K) >= (1LL << 31) - MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    QkGrad<float> gr{{(const float*)dq_out, (const float*)dk_out},
                     {(double*)partial, nullptr}};
    return (int)launch_qk_bwd(qk_args<float>(q, k, q_scale, k_scale, dq, dk, positions,
                                             pos_sb, pos_ss, inv_freq, B, S, H, K, eps),
                              gr, dq_scale, dk_scale, max_blocks, hd, s);
  }
  if (dtype == 1) {
    using Bf = __nv_bfloat16;
    QkGrad<Bf> gr{{(const Bf*)dq_out, (const Bf*)dk_out}, {(double*)partial, nullptr}};
    return (int)launch_qk_bwd(qk_args<Bf>(q, k, q_scale, k_scale, dq, dk, positions, pos_sb,
                                          pos_ss, inv_freq, B, S, H, K, eps),
                              gr, dq_scale, dk_scale, max_blocks, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}
