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
//   gated_rmsnorm_fwd  t = y * silu(z): silu in f32 (expf as PyTorch's silu; in
//                      f32 its IEEE division, in bf16 a 2-ulp one), rounded to
//                      the dtype, the product rounded; out = rmsnorm(t)
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

// silu(g) = g / (1 + expf(-g)), PyTorch's, rounded to T. In f32 the IEEE division,
// to the bit: the gated backward's dscale sums t over every row, and an f32 t off
// by a 2-ulp division in a quarter of its elements moved dscale past its 1e-5 gate
// against the exact sum over 32,768 rows on some draws of the inputs. In bf16,
// rounded to 8 bits right after, __fdividef (2 ulp; 0 once the divisor passes
// 2^126, where silu is below 1e-36) takes the place of the IEEE division, whose
// slow-path check is the costliest step of the gated row
template <typename T>
__device__ __forceinline__ float gate_silu(float g) {
  if constexpr (sizeof(T) == 4) return g / (1.0f + expf(-g));
  else return round_to<T>(__fdividef(g, 1.0f + expf(-g)));
}

// sum over an aligned group of `width` lanes (a power of two <= 32); every lane
// of the warp takes part, and every lane of a group gets the same sum
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ double group_sum(double v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// sum over the block (a multiple of 32 threads); every thread gets the same sum
template <typename A>
__device__ __forceinline__ A block_sum(A v, A* partial) {
  v = group_sum(v, 32);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  A t = 0;
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
      if constexpr (sizeof(T) == 4) {
        a[k] = __fmul_rn(a[k], gate_silu<T>(g[k]));
      } else {
        // gate_silu<T>'s expression written out: called through gate_silu, the
        // compiler schedules this row otherwise
        const float silu = round_to<T>(__fdividef(g[k], 1.0f + expf(-g[k])));
        a[k] = __fmul_rn(a[k], silu);
      }
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
// Each of these is one launch, dw included. gated_rmsnorm_bwd has a kernel of its
// own, gated_bwd_kernel, below.
//
// dw is a sum over every row (131,072 of them for qwen3's q-norm at 4 x 2048
// tokens). For f32 inputs, held at 1e-5 against the exact sum, f32 is not enough
// there: each f32 term carries ~7e-8 of its size in rounding, which adds up to
// ~2.5e-5 over 131,072 rows, in the products as much as in the adds. So their row
// math is f64 wherever dw reads it: the row's sum of squares, rstd, each dy x rstd
// term, qk_norm_rope's RoPE transpose of dy (taken in f32, it put dq_scale past
// the gate near zero at 4 x 2048 tokens of qwen3's q on some draws of the inputs)
// and every partial sum (dx keeps f32, as the forward; its bits are those of the
// earlier two-launch design). For bf16 the same f32 error is ~1e-4 of the
// bf16 rounding of dw and of its 2e-2 gate, while the f32 -> f64 conversions (two
// an element, at 16 an SM a clock) and f64 shared-memory traffic were the costliest
// steps of the pass; so bf16 takes the row's sum of squares, rstd (rsqrtf, as the
// forward) and each slot's terms in f32, and f64 from the block's sum on.
// Where the sums live and in what order they are taken (no atomics on values, so
// two runs give the same bits):
//   1. Each row slot of a block (a lane group; the whole block for a wide row) has
//      its own accumulator row in shared memory (f64; f32 for bf16), laid out
//      [element k][vector i] so that neighbouring lanes hit neighbouring banks. A
//      thread adds its own columns only, row by row: no registers held for it
//      across the loop, which is what bounds the occupancy of this pass, and no
//      barrier per row.
//   2. After its last row a block adds its slots in slot order into one f64 row
//      of the scratch (`Fold::partial`), in that layout.
//   3. The blocks fold those rows in one launch, wait-free: each block takes a
//      ticket of its group (ceil(sqrt(blocks)) blocks a group); the group's last
//      block sums the group's rows in block order into a group row, then takes a
//      ticket of the groups; the last group's block sums the group rows in group
//      order and writes dw, rounded to T. So two ~sqrt(blocks)-row reads end the
//      launch (12 and 11 rows at qwen3's 132 blocks), the first spread over the
//      groups' last blocks, and no block ever waits for another. (A last block
//      that spun until every block was done could spread the final sum wider,
//      but it is only safe while every block still to come can be scheduled,
//      which no launch can promise when another stream's kernel shares the card.
//      Thread block clusters would cut the rows by their size, but not the need
//      for a ticket across clusters.) A counter's last user sets it back to 0, so
//      the next launch on the stream finds them all at 0 without a memset launch;
//      the scratch is one stream's (the wrapper keeps one a stream).
// The grid is as many blocks as are resident at once (cudaOccupancy from the
// registers and shared memory of the compiled kernel), capped by the scratch.
// What bounds it: bytes (x, dy and dx, plus ds for the add), 15-45 us at qwen3's
// training shapes. Choices the card decided (H100, variants in turns): the fold
// is a few us a launch, most of it the two row reads (one SM each), and one level
// over every block's row cost several times more; fewer blocks mean fewer rows
// to fold, so the row pass takes 512-thread blocks, one an SM, where two smaller
// blocks an SM or loading the next row ahead did not move the pass itself. f32
// rather than f64 row work for bf16 sped qk_norm_rope_bwd up and left the plain
// rows as they were.

// the type of a row's sum of squares, rstd and dw's terms: f64 for f32 inputs,
// f32 for bf16 (see above)
template <typename T> struct AccOf { using type = double; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double rstd_of(double ss, float inv_d, float eps) {
  return 1.0 / sqrt(ss * inv_d + eps);
}
__device__ __forceinline__ float rstd_of(float ss, float inv_d, float eps) {   // the forward's
  return rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
}

// the block's sums of a and b (f32); every thread gets both
template <typename A>
__device__ __forceinline__ void block_sum2(A& a, float& b, A* pa, float* pb) {
  a = group_sum(a, 32);
  b = group_sum(b, 32);
  const int warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    pa[threadIdx.x >> 5] = a;
    pb[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  A ta = 0;
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

constexpr int FOLD_COUNTERS = 256;   // tickets at the head of the scratch (1 KB)

// blocks in a group of the fold: ceil(sqrt(blocks))
__host__ __device__ inline int fold_group(int blocks) {
  int m = 1;
  while (m * m < blocks) ++m;
  return m;
}

// One stream's scratch for the fold: [FOLD_COUNTERS tickets][blocks rows][groups
// rows] of W doubles. The tickets are 0 between launches.
struct Fold {
  unsigned* count;
  double* partial;
  double* group;
};

Fold fold_at(double* scratch, int blocks, int W) {
  Fold f;
  f.count = reinterpret_cast<unsigned*>(scratch);
  f.partial = scratch + FOLD_COUNTERS / 2;
  f.group = f.partial + (long long)blocks * W;
  return f;
}

// Sums rows [r0, r1) (row stride W) in row order for each of the block's columns
// and hands each sum to out(column, sum). A thread keeps 8 rows x 2 columns of
// loads in flight (the rows were written by other SMs: read from L2).
template <class Out>
__device__ __forceinline__ void sum_rows(const double* rows, int r0, int r1, int W, Out out) {
  constexpr int R = 8, C = 2;
  for (int e0 = threadIdx.x; e0 < W; e0 += C * blockDim.x) {
    double s[C] = {};
    for (int b = r0; b < r1; b += R) {
      double v[R][C];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int e = e0 + c * blockDim.x;
          v[r][c] = b + r < r1 && e < W ? __ldcg(rows + (long long)(b + r) * W + e) : 0.0;
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] += v[r][c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (e0 + c * blockDim.x < W) out(e0 + c * blockDim.x, s[c]);
  }
}

// Takes a ticket of counter `count` for the block once every thread's writes are
// done; returns it to every thread. The fence after the barrier covers the whole
// block's writes (a release fence is cumulative), and a block that goes on to
// read the others' rows has, by its ticket, seen every earlier ticket's writes.
__device__ __forceinline__ unsigned block_ticket(unsigned* count) {
  __shared__ unsigned ticket;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    ticket = atomicAdd(count, 1u);
    __threadfence();
  }
  __syncthreads();
  return ticket;
}

// Run by every thread of every block once the block's row f.partial[blockIdx.x]
// is written. Element e of a row (of W) goes to output e / W1 (out0 or out1),
// column (r % nvec) * VEC + r / nvec of it, r = e % W1: the [k][i] layout undone.
// Not inlined: its loads in flight would otherwise count in the registers of the
// whole row pass (117 against 80 for qk_norm_rope_bwd's, and a block an SM less).
template <typename T, int VEC>
__device__ __noinline__ void fold(const Fold& f, int W, int W1, int nvec, T* out0, T* out1) {
  const int blocks = gridDim.x, m = fold_group(blocks), g = blockIdx.x / m;
  const int groups = (blocks + m - 1) / m, first = g * m;
  const int size = blocks - first < m ? blocks - first : m;
  if (block_ticket(&f.count[g]) != (unsigned)size - 1) return;
  double* grow = f.group + (long long)g * W;
  sum_rows(f.partial, first, first + size, W, [&](int e, double s) { grow[e] = s; });
  if (threadIdx.x == 0) f.count[g] = 0;   // every block of the group has its ticket
  if (block_ticket(&f.count[groups]) != (unsigned)groups - 1) return;
  sum_rows(f.group, 0, groups, W, [&](int e, double s) {
    const int r = e % W1;
    store1(e < W1 ? out0 : out1, (r % nvec) * VEC + r / nvec, (float)s);
  });
  if (threadIdx.x == 0) f.count[groups] = 0;
}

// what the row pass of rows_bwd_kernel reads besides x and dy, and writes besides dx
constexpr int BWD_PLAIN = 0, BWD_ADD = 1;

// the arguments of rows_bwd_kernel and of gated_bwd_kernel (the gated fields in
// brackets)
template <typename T>
struct RowsBwd {
  const T* x;              // (y)
  const T* dy;             // (dout)
  const T* ds;             // ADD: ds (z)
  const T* scale;
  T* dx;                   // (dy)
  T* dz;                   // (dz); unread by rows_bwd_kernel, whose parameters keep it
                           // (their layout, and so its SASS, as before)
  T* dscale;
  long long rows;
  int nvec, tpr;
  float inv_d, eps;
};

constexpr int BWD_THREADS = 512;   // largest block of the backward row pass

// Rows as rows_kernel assigns them, up to BWD_THREADS threads a block (a block
// an SM: the fewer blocks, the fewer rows the fold reads at the end, and a second
// block an SM did not move the row pass). ADD: dx = T(ds + T(dx_norm)).
template <typename T, int NV, int MODE>
__global__ void __launch_bounds__(NV < 8 ? BWD_THREADS : MAX_THREADS, 1)
rows_bwd_kernel(RowsBwd<T> a, Fold fold_) {
  constexpr int VEC = Vec<T>::N;
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(8) unsigned char smem[];
  Acc* acc = reinterpret_cast<Acc*>(smem);   // [rows a block][VEC][nvec]: each slot's dw
  __shared__ Acc sums_a[32];
  __shared__ float sums_f[32];
  const int nvec = a.nvec, tpr = a.tpr, D = nvec * VEC;
  const bool wide = tpr > 32;
  const int rpb = wide ? 1 : blockDim.x / tpr;
  const int lane = wide ? threadIdx.x : (threadIdx.x & (tpr - 1));
  const int sub = wide ? 0 : threadIdx.x / tpr;
  Acc* mine = acc + sub * D;

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * tpr + lane;
    if (i < nvec)
#pragma unroll
      for (int k = 0; k < VEC; ++k) mine[k * nvec + i] = 0;
  }
  for (long long r0 = (long long)blockIdx.x * rpb; r0 < a.rows;
       r0 += (long long)gridDim.x * rpb) {
    const long long row = r0 + sub;
    const bool live = row < a.rows;
    uint4 rx[NV], rg[NV], rs[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        rx[v] = ld16(a.x, row * nvec + i);
        rg[v] = ld16(a.dy, row * nvec + i);
        if constexpr (MODE == BWD_ADD) rs[v] = ld16(a.ds, row * nvec + i);
      }
    }
    Acc ss = 0;
    float sg = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float xf[VEC], gf[VEC], w[VEC];
        widen<T>(rx[v], xf);
        widen<T>(rg[v], gf);
        widen<T>(ld16(a.scale, i), w);   // from L1: no registers held for it
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          ss += (Acc)xf[k] * xf[k];
          sg += gf[k] * w[k] * xf[k];
        }
      }
    }
    if (wide) {
      block_sum2(ss, sg, sums_a, sums_f);
    } else {
      ss = group_sum(ss, tpr);
      sg = group_sum(sg, tpr);
    }
    const Acc rstd_a = rstd_of(ss, a.inv_d, a.eps);
    const float rstd = (float)rstd_a;
    const float coef = rstd * rstd * rstd * sg * a.inv_d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float xf[VEC], gf[VEC], w[VEC], o[VEC];
        widen<T>(rx[v], xf);
        widen<T>(rg[v], gf);
        widen<T>(ld16(a.scale, i), w);   // from L1: no registers held for it
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          o[k] = rstd * gf[k] * w[k] - xf[k] * coef;
          mine[k * nvec + i] += (Acc)gf[k] * xf[k] * rstd_a;
        }
        if constexpr (MODE == BWD_ADD) {
          float sf[VEC];
          widen<T>(rs[v], sf);
#pragma unroll
          for (int k = 0; k < VEC; ++k) o[k] = __fadd_rn(sf[k], round_to<T>(o[k]));
        }
        put16(a.dx, row * nvec + i, pack<T>(o));
      }
    }
  }
  __syncthreads();
  double* part = fold_.partial + (long long)blockIdx.x * D;
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    double s = 0.0;
    for (int j = 0; j < rpb; ++j) s += acc[j * D + e];
    part[e] = s;
  }
  fold<T, VEC>(fold_, D, D, nvec, a.dscale, a.dscale);
}

// ------------------------------------------------------- the gated backward
// gated_rmsnorm_bwd: the gradient of out = rmsnorm(t), t = T(y * T(silu(z))), for
// the cotangent dout (T = the dtype; the casts of the JAX sequence
// y * silu(z.astype(f32)).astype(y.dtype) of src/repro/models/ssm.py):
//   t recomputed exactly as GatedOp::pre rounds it (a different t would move rstd
//   and dscale); dt = the norm's dx on t, rounded to T; dy = T(dt * T(silu(z)));
//   dz = T(silu'(z) * T(dt * y)) in f32, silu'(z) = sig (1 + z (1 - sig));
//   dscale = the sum over every row of dout * t * rstd, in f64 (for bf16 each
//   thread's terms in f32 and f64 from the block's sum on).
// Replaces, with the rest of this file, the TPU kernel `_rmsnorm_kernel`
// (src/repro/kernels/rmsnorm.py:11); the JAX package differentiates the gate and
// the norm by autodiff.
//
// What bounds it on the H100: bytes. y, z and dout read once, dy and dz written
// once: 104.9 MB at mamba2-2.7b's training rows [2048, 5120] bf16 (0.0313 ms at
// 3.35 TB/s) and 146.8 MB at zamba2-7b's [2048, 7168] (0.0438 ms). But its
// arithmetic (an expf, two divisions and five roundings an element) is not hidden
// behind those bytes by itself, so the design cuts instructions and keeps loads
// in flight behind them:
//   - Rows go to teams. A block holds several; a team takes one row at a time:
//     a lane group of 8-32 lanes for rows of up to 128 vectors, as
//     rows_bwd_kernel assigns them (each row's sums, and so dy and dz, as there),
//     else tpr threads of GATED_WIDE_NV vectors each, whose warps sum through a
//     named barrier of the team's own, once a row (the warp sums double-
//     buffered), so no team's reduction stalls another's.
//   - Each thread copies its own vectors of the row GATED_STAGES - 1 rounds
//     ahead into its own slots of a ring in shared memory (cp.async) and reads
//     back only those: the next row's loads are in flight while this one
//     reduces, no barrier guards the ring, and no register holds a row.
//   - The gate once an element: e = expf(-z) gives silu = z / (1 + e) (the IEEE
//     division in f32, __fdividef in bf16, as gate_silu) in the first pass and
//     sig = __fdividef(1, 1 + e) in the second, bits as before; silu, in T,
//     stays in registers and e in shared memory between the two passes.
//   - A thread owns the same columns in every row it takes, so its dscale terms
//     stay in registers until the block's last row.
//   - One block an SM, as many teams as its registers and shared memory allow,
//     the rows dealt to the blocks in turn; each block sums its teams' terms in
//     team order into one f64 row of the scratch (132 rows, not one a block of
//     3-8 an SM), and gated_fold_kernel sums them column by column in row order
//     across the whole card. No atomics on values: two runs give the same bits.
// Choices the card decided (H100 80GB HBM3 at 700 W; bf16, ms at [2048, 5120] /
// [2048, 7168], the least of four runs in turns by tools/gated_bwd_variants.py):
// this design 0.0564 / 0.0747, against rows_bwd_kernel's gated mode 0.1207 /
// 0.1324, of which its fold (one row a block of 3-8 an SM, two serial reads of
// ~sqrt(blocks) rows) took half: 0.0600 / 0.0800 without it. Undoing one choice
// at a time: dscale folded inside the launch by rows_bwd_kernel's ticket tree
// over the 132 rows, 0.0724 / 0.0957 (the second launch's kernel takes ~3 us;
// a cluster of blocks summing through distributed shared memory, tried before,
// leaves SMs idle, as clusters of 8 do not tile this card's SMs, and lost to it
// too); 4 vectors a thread, rows_bwd_kernel's row order, 0.0609 / 0.0813; a
// bound of 1,024 threads (64 registers), 0.0603 / 0.0792; e recomputed in the
// second pass, 0.0579 / 0.0753; a ring of 1 or 3 stages, 0.0597 / 0.0756 and
// 0.0603 / 0.0806. What is left: torch.add(y, z) streams at ~2.56 TB/s here, so
// ~0.041 / 0.057 ms is near the floor for these bytes; the rest is the row pass's
// arithmetic, which fewer instructions (e kept) and more warps moved and more
// rows in flight (3 stages) did not.

constexpr int GATED_STAGES = 2;      // rows in a team's ring
constexpr int GATED_WIDE_NV = 2;     // vectors a thread of a row past 128 vectors
constexpr int GATED_MAX_TEAMS = 15;  // wide teams a block: named barriers 1-15
constexpr int GATED_SLICES = 8;      // row slices of a column in gated_fold_kernel

// threads a block at most, by NV: what bounds each thread's registers
__host__ __device__ constexpr int gated_threads(int nv) { return nv <= 2 ? 896 : 512; }

__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

// silu(z) with e = expf(-z), as gate_silu<T>(z) forms it
template <typename T>
__device__ __forceinline__ float silu_of(float z, float e) {
  if constexpr (sizeof(T) == 4) return z / (1.0f + e);
  else return round_to<T>(__fdividef(z, 1.0f + e));
}

// Shared memory a team: its ring, [stage][y, dout, z][NV][tpr] vectors, and its e,
// [NV * VEC / 4][tpr] float4; the teams' rings come first, then their e.
template <typename T, int NV>
constexpr size_t gated_team_bytes(int tpr) {
  return (size_t)tpr * (GATED_STAGES * 3 * NV * sizeof(uint4) + NV * Vec<T>::N * sizeof(float));
}

// Team `team` of a block takes rows blockIdx.x + gridDim.x * (team + teams * k),
// round k = 0, 1, ...; every thread runs every round of its block (the lane
// groups' shuffles take the whole warp), a team past the last row with nothing
// live. Writes the block's f64 row of dscale terms to rows[blockIdx.x].
template <typename T, int NV>
__global__ void __launch_bounds__(gated_threads(NV), 1)
gated_bwd_kernel(RowsBwd<T> a, double* rows) {
  constexpr int VEC = Vec<T>::N, S = GATED_STAGES;
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) uint4 ring[];
  __shared__ Acc warp_a[2][32];      // a wide team's warp sums, double-buffered by row
  __shared__ float warp_b[2][32];
  const int nvec = a.nvec, tpr = a.tpr, D = nvec * VEC;
  const bool wide = tpr > 32;
  const int teams = blockDim.x / tpr, team = threadIdx.x / tpr;
  const int lane = threadIdx.x - team * tpr;
  uint4* slots = ring + (size_t)team * S * 3 * NV * tpr + lane;   // (stage, input, v) at
                                                                   // ((stage * 3 + input) * NV + v) * tpr
  float4* ekeep = reinterpret_cast<float4*>(ring + (size_t)teams * S * 3 * NV * tpr) +
                  (size_t)team * NV * VEC / 4 * tpr + lane;        // (v, q) at (v * VEC / 4 + q) * tpr
  const long long round_rows = (long long)gridDim.x * teams;
  const long long row0 = blockIdx.x + (long long)gridDim.x * team;
  const long long rounds =
      blockIdx.x < a.rows ? (a.rows - blockIdx.x + round_rows - 1) / round_rows : 0;
  // round k's row into stage k % S, one commit group a round (empty past the rows)
  auto fetch = [&](long long k) {
    const long long r = row0 + k * round_rows;
    if (k < rounds && r < a.rows) {
      uint4* st = slots + (size_t)(k % S) * 3 * NV * tpr;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v * tpr + lane;
        if (i < nvec) {
          cp_async16(st + (0 * NV + v) * tpr, reinterpret_cast<const uint4*>(a.x) + r * nvec + i);
          cp_async16(st + (1 * NV + v) * tpr, reinterpret_cast<const uint4*>(a.dy) + r * nvec + i);
          cp_async16(st + (2 * NV + v) * tpr, reinterpret_cast<const uint4*>(a.ds) + r * nvec + i);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  Acc acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[v][k] = 0;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) fetch(k);
  int buf = 0;
  for (long long k = 0; k < rounds; ++k) {
    fetch(k + S - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(S - 1) : "memory");
    const long long row = row0 + k * round_rows;
    const bool live = row < a.rows;
    const uint4* st = slots + (size_t)(k % S) * 3 * NV * tpr;
    uint4 sl[NV];                      // silu(z) in T
    Acc ss = 0;
    float sg = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float yf[VEC], gf[VEC], zf[VEC], w[VEC], sf[VEC];
        widen<T>(st[(0 * NV + v) * tpr], yf);
        widen<T>(st[(1 * NV + v) * tpr], gf);
        widen<T>(st[(2 * NV + v) * tpr], zf);
        widen<T>(ld16(a.scale, i), w);   // from L1
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float e = expf(-zf[k]);
          reinterpret_cast<float*>(ekeep + (v * VEC / 4 + k / 4) * tpr)[k % 4] = e;
          sf[k] = silu_of<T>(zf[k], e);
          const float t = round_to<T>(__fmul_rn(yf[k], sf[k]));
          ss += (Acc)t * t;
          sg += gf[k] * w[k] * t;
        }
        sl[v] = pack<T>(sf);           // exact: sf is already in T
      }
    }
    if (wide) {                        // rows_bwd_kernel's block_sum2, over the team
      ss = group_sum(ss, 32);
      sg = group_sum(sg, 32);
      const int wpt = tpr >> 5, w0 = team * wpt;
      if ((threadIdx.x & 31) == 0) {
        warp_a[buf][threadIdx.x >> 5] = ss;
        warp_b[buf][threadIdx.x >> 5] = sg;
      }
      team_sync(1 + team, tpr);
      Acc ta = 0;
      float tb = 0.f;
      for (int w = 0; w < wpt; ++w) {
        ta += warp_a[buf][w0 + w];
        tb += warp_b[buf][w0 + w];
      }
      ss = ta;
      sg = tb;
      buf ^= 1;   // the next row's sums go to the other buffer: no second barrier
    } else {
      ss = group_sum(ss, tpr);
      sg = group_sum(sg, tpr);
    }
    const Acc rstd_a = rstd_of(ss, a.inv_d, a.eps);
    const float rstd = (float)rstd_a;
    const float coef = rstd * rstd * rstd * sg * a.inv_d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float yf[VEC], gf[VEC], zf[VEC], w[VEC], sf[VEC], ef[VEC], o[VEC], dz[VEC];
        widen<T>(st[(0 * NV + v) * tpr], yf);
        widen<T>(st[(1 * NV + v) * tpr], gf);
        widen<T>(st[(2 * NV + v) * tpr], zf);
        widen<T>(ld16(a.scale, i), w);
        widen<T>(sl[v], sf);
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f = ekeep[(v * VEC / 4 + q) * tpr];
          ef[4 * q] = f.x;
          ef[4 * q + 1] = f.y;
          ef[4 * q + 2] = f.z;
          ef[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float sig = __fdividef(1.0f, 1.0f + ef[k]);
          const float t = round_to<T>(__fmul_rn(yf[k], sf[k]));
          o[k] = rstd * gf[k] * w[k] - t * coef;
          acc[v][k] += (Acc)gf[k] * t * rstd_a;
          const float dt = round_to<T>(o[k]);
          dz[k] = __fmul_rn(round_to<T>(__fmul_rn(dt, yf[k])),
                            __fmul_rn(sig, 1.0f + zf[k] * (1.0f - sig)));
          o[k] = __fmul_rn(dt, sf[k]);
        }
        put16(a.dz, row * nvec + i, pack<T>(dz));
        put16(a.dx, row * nvec + i, pack<T>(o));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");   // (empty groups only)
  __syncthreads();                                       // the ring is reused below

  // the block's sum of its teams' terms, in team order, in f64
  Acc* stage = reinterpret_cast<Acc*>(ring);   // [teams][D]
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * tpr + lane;
    if (i < nvec)
#pragma unroll
      for (int k = 0; k < VEC; ++k) stage[(size_t)team * D + i * VEC + k] = acc[v][k];
  }
  __syncthreads();
  double* out = rows + (long long)blockIdx.x * D;
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    double s = 0.0;
    for (int j = 0; j < teams; ++j) s += stage[(size_t)j * D + e];
    out[e] = s;
  }
}

// dscale[e] = the sum of rows[0..n) at column e, rounded to T: 32 columns a
// block, GATED_SLICES slices of a column's rows summed apart (8 loads in flight
// each), then in slice order; the order is fixed, so are the bits
template <typename T>
__global__ void __launch_bounds__(32 * GATED_SLICES)
gated_fold_kernel(const double* rows, int n, int D, T* dscale) {
  __shared__ double sums[GATED_SLICES][32];
  const int c = threadIdx.x & 31, j = threadIdx.x >> 5, e = blockIdx.x * 32 + c;
  double s = 0.0;
  if (e < D)
    for (int r = j; r < n; r += 8 * GATED_SLICES) {
      double v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int rq = r + GATED_SLICES * q;
        v[q] = rq < n ? rows[(long long)rq * D + e] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) s += v[q];
    }
  sums[j][c] = s;
  __syncthreads();
  if (j == 0 && e < D) {
    double t = 0.0;
    for (int q = 0; q < GATED_SLICES; ++q) t += sums[q][c];
    store1(dscale, e, (float)t);
  }
}

template <typename T>
struct QkGrad {
  const T* dout[2];        // cotangents of the roped q, k
  T* dscale[2];            // dq_scale, dk_scale
  int tokens;              // B * S
  int n_tok;               // tokens a block takes at a time
};

constexpr int QK_TOKENS = 8;   // the most tokens a block takes at a time

// Row j of a chunk of tokens: token j / (H + K), then its H q heads and K k heads.
__device__ __forceinline__ void qk_locate(int j, int t0, int H, int K, int& tt, bool& is_k,
                                          int& row) {
  tt = j / (H + K);
  const int h = j - tt * (H + K);
  is_k = h >= H;
  row = is_k ? (t0 + tt) * K + (h - H) : (t0 + tt) * H + h;
}

// A block takes n_tok tokens at a time with all their q and k heads, so one
// cos / sin table serves a token's every head and two barriers serve n_tok
// tokens. Its row slots (lane groups of tpr) walk the chunk's rows, loading the
// next row before working on this one. The row math is the forward's assignment
// of a row to a lane group; a.out[] receives dq and dk.
template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS, NV == 1 ? 3 : 2)
qk_norm_rope_bwd_kernel(QkArgs<T> a, QkGrad<T> gr, Fold fold_) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TABLE = QK_TOKENS * 32 * NV * VEC / 2;   // n_tok x hd / 2, at most
  using Acc = typename AccOf<T>::type;
  __shared__ float tab_c[TABLE], tab_s[TABLE];
  extern __shared__ __align__(8) unsigned char smem[];
  Acc* acc = reinterpret_cast<Acc*>(smem);   // [q, k][slot][VEC][nvec]: each slot's dw
  const int tpr = a.tpr, nvec = a.nvec, half = nvec >> 1, hh = half * VEC, hd = nvec * VEC;
  const int slots = blockDim.x / tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int slot = threadIdx.x / tpr;
  const int H = a.heads[0], K = a.heads[1];
  const int n_tok = gr.n_tok, chunks = (gr.tokens + n_tok - 1) / n_tok;
  Acc* acc_q = acc + slot * hd;
  Acc* acc_k = acc + (slots + slot) * hd;

  uint4 scq[NV], sck[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * tpr + lane;
    scq[v] = ld16(a.scale[0], i);
    sck[v] = ld16(a.scale[1], i);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc_q[k * nvec + i] = acc_k[k * nvec + i] = 0;
  }

  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int t0 = c * n_tok;
    const int nt = gr.tokens - t0 < n_tok ? gr.tokens - t0 : n_tok;
    const int nrows = nt * (H + K), iters = (nrows + slots - 1) / slots;
    uint4 rx[NV], rd[NV];
    int tt, row;
    bool is_k;
    qk_locate(slot, t0, H, K, tt, is_k, row);
    if (slot < nrows) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        rx[v] = ld16(is_k ? a.x[1] : a.x[0], (long long)row * nvec + v * tpr + lane);
        rd[v] = ld16(is_k ? gr.dout[1] : gr.dout[0], (long long)row * nvec + v * tpr + lane);
      }
    }
    // the angles of this chunk's tokens, while the first rows' loads are in flight
    for (int e = threadIdx.x; e < nt * hh; e += blockDim.x) {
      const int t = t0 + e / hh;
      const float p = (float)a.pos[(t / a.S) * a.pos_sb + (t % a.S) * a.pos_ss];
      sincosf(__fmul_rn(p, a.inv_freq[e % hh]), &tab_s[e], &tab_c[e]);
    }
    __syncthreads();
    // every lane group runs every iteration (the shuffles take the full warp)
    for (int m = 0; m < iters; ++m) {
      const int j = slot + m * slots;
      const bool live = j < nrows;
      uint4 nx[NV], nd[NV];
      int ntt, nrow;
      bool nk;
      qk_locate(j + slots, t0, H, K, ntt, nk, nrow);
      if (j + slots < nrows) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          nx[v] = ld16(nk ? a.x[1] : a.x[0], (long long)nrow * nvec + v * tpr + lane);
          nd[v] = ld16(nk ? gr.dout[1] : gr.dout[0], (long long)nrow * nvec + v * tpr + lane);
        }
      }
      T* __restrict__ dx = is_k ? a.out[1] : a.out[0];
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
      // RoPE's transpose: first half d1 cos + d2 sin, second half d2 cos - d1 sin;
      // dw's terms take it in Acc (f64 for f32 inputs: see above), dx in f32
      const int base = tt * hh;
      float du[NV][VEC];
      Acc duw[NV][VEC];
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
          if constexpr (sizeof(Acc) == sizeof(double)) {
            const double oc = (double)d[v][k] * cs, os = (double)partner * sn;
            duw[v][k] = first ? oc + os : oc - os;
          } else {
            duw[v][k] = du[v][k];
          }
        }
      }
      float xf[NV][VEC];
      Acc ss = 0;
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
          ss += (Acc)xf[v][k] * xf[v][k];
          sg += du[v][k] * w[k] * xf[v][k];
        }
      }
      ss = group_sum(ss, tpr);
      sg = group_sum(sg, tpr);
      const Acc rstd_a = rstd_of(ss, a.inv_d, a.eps);
      const float rstd = (float)rstd_a;
      const float coef = rstd * rstd * rstd * sg * a.inv_d;
      Acc* mine = is_k ? acc_k : acc_q;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v * tpr + lane;
        float w[VEC], o[VEC];
        widen<T>(is_k ? sck[v] : scq[v], w);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          o[k] = rstd * du[v][k] * w[k] - xf[v][k] * coef;
          if (live) mine[k * nvec + i] += duw[v][k] * xf[v][k] * rstd_a;
        }
        if (live) put16(dx, (long long)row * nvec + i, pack<T>(o));
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        rx[v] = nx[v];
        rd[v] = nd[v];
      }
      tt = ntt;
      is_k = nk;
      row = nrow;
    }
    __syncthreads();   // the table is rewritten for the next chunk
  }
  __syncthreads();
  const int W = 2 * hd;
  double* part = fold_.partial + (long long)blockIdx.x * W;
  for (int e = threadIdx.x; e < W; e += blockDim.x) {
    const int p = e < hd ? 0 : 1, r = e - p * hd;
    double s = 0.0;
    for (int j = 0; j < slots; ++j) s += acc[(p * slots + j) * hd + r];
    part[e] = s;
  }
  fold<T, VEC>(fold_, W, hd, nvec, gr.dscale[0], gr.dscale[1]);
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

// Rows a block in the lane-group path: the most (up to `threads`) that still
// leaves two blocks an SM, and never under one warp.
int rows_per_block(long long rows, int tpr, int threads = MAX_THREADS) {
  int rpb = threads / tpr;
  const long long want = 2LL * sm_count();
  while (rpb * tpr > 32 && (rows + rpb - 1) / rpb < want) rpb >>= 1;
  return rpb;
}

// How rows_kernel and rows_bwd_kernel take a row of nvec vectors: up to
// MAX_GROUP_VECS a lane group of tpr lanes (rows a block up to max_threads),
// wider rows a block each; nv vectors a lane; groups = the blocks' row groups.
struct RowShape {
  int nvec, tpr, nv, threads;
  long long groups;
};

bool row_shape(long long rows, int nvec, int max_threads, RowShape& r) {
  r.nvec = nvec;
  if (nvec <= MAX_GROUP_VECS) {
    r.tpr = 8;
    while (r.tpr < 32 && r.tpr < nvec) r.tpr <<= 1;
    r.nv = (nvec + r.tpr - 1) / r.tpr;
    if (r.nv == 3) r.nv = 4;
    const int rpb = rows_per_block(rows, r.tpr, max_threads);
    r.threads = rpb * r.tpr;
    r.groups = (rows + rpb - 1) / rpb;
  } else {
    r.nv = 1;
    while (r.nv < 8 && (nvec + r.nv - 1) / r.nv > MAX_THREADS) r.nv <<= 1;
    r.tpr = ((nvec + r.nv - 1) / r.nv + 31) / 32 * 32;
    r.threads = r.tpr;
    r.groups = rows;
  }
  return r.tpr <= MAX_THREADS;
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
  RowShape r;
  if (!row_shape(rows, D / VEC, MAX_THREADS, r)) return cudaErrorInvalidValue;
  const int nvec = r.nvec, tpr = r.tpr, threads = r.threads;
  const unsigned blocks = grid_for(r.groups, threads);
  const T* sc = static_cast<const T*>(scale);
  const float inv_d = 1.0f / (float)D;
  switch (r.nv) {
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

// Blocks of `kernel` resident on one SM at `threads` and `smem` bytes of dynamic
// shared memory: what the compiled kernel's registers and shared memory allow.
template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, size_t smem, int* n) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && (size_t)attr.maxDynamicSharedSizeBytes < smem)   // only raised
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads, smem);
  if (err == cudaSuccess && *n < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

// the fold's grid: every group of blocks resident at once, at most max_blocks
// (the rows the caller's scratch holds) and at most `work` (one item each)
unsigned fold_grid(int per_sm, long long work, int max_blocks) {
  long long g = (long long)per_sm * sm_count();
  if (g > work) g = work;
  if (g > max_blocks) g = max_blocks;
  return (unsigned)g;
}

template <typename T, int NV, int MODE>
cudaError_t run_rows_bwd(const RowsBwd<T>& a, long long groups, int threads, size_t smem,
                         double* scratch, int max_blocks, cudaStream_t s) {
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(rows_bwd_kernel<T, NV, MODE>, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const unsigned grid = fold_grid(per_sm, groups, max_blocks);
  rows_bwd_kernel<T, NV, MODE><<<grid, threads, smem, s>>>(
      a, fold_at(scratch, (int)grid, a.nvec * Vec<T>::N));
  return cudaGetLastError();
}

// the forward's rows a block and threads a row; one launch, dscale folded in
template <typename T, int MODE>
cudaError_t launch_rows_bwd(RowsBwd<T> a, double* scratch, int max_blocks, int D,
                            cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  RowShape r;
  if (a.rows <= 0 || D <= 0 || D % VEC || max_blocks <= 0 ||
      fold_group(max_blocks) + 1 > FOLD_COUNTERS || !row_shape(a.rows, D / VEC, BWD_THREADS, r))
    return cudaErrorInvalidValue;
  const int threads = r.threads;
  const long long groups = r.groups;
  a.nvec = r.nvec;
  a.tpr = r.tpr;
  a.inv_d = 1.0f / (float)D;
  const size_t smem =
      (size_t)(r.tpr > 32 ? 1 : threads / r.tpr) * D * sizeof(typename AccOf<T>::type);
  switch (r.nv) {
    case 1: return run_rows_bwd<T, 1, MODE>(a, groups, threads, smem, scratch, max_blocks, s);
    case 2: return run_rows_bwd<T, 2, MODE>(a, groups, threads, smem, scratch, max_blocks, s);
    case 4: return run_rows_bwd<T, 4, MODE>(a, groups, threads, smem, scratch, max_blocks, s);
    case 8: return run_rows_bwd<T, 8, MODE>(a, groups, threads, smem, scratch, max_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// A block of `kernel` at one block an SM: as many teams of tpr threads as the
// compiled kernel's registers (its maxThreadsPerBlock), max_teams and shared memory
// allow, smem_of(teams) bytes of it dynamic (the kernel's bound raised to it).
template <typename K, class SmemOf>
cudaError_t team_block(K kernel, int tpr, int max_teams, SmemOf smem_of, int* threads,
                       size_t* smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int teams = attr.maxThreadsPerBlock / tpr;
  if (teams > max_teams) teams = max_teams;
  while (teams > 0 && attr.sharedSizeBytes + smem_of(teams) > (size_t)optin) --teams;
  if (teams < 1) return cudaErrorInvalidConfiguration;
  *threads = teams * tpr;
  *smem = smem_of(teams);
  if ((size_t)attr.maxDynamicSharedSizeBytes < *smem)   // only raised
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return err;
}

// the grid of a row pass of teams: at most one block an SM, a row and a scratch row each
unsigned one_block_an_sm(long long rows, int max_rows) {
  long long blocks = sm_count();
  if (blocks > rows) blocks = rows;
  if (blocks > max_rows) blocks = max_rows;
  return (unsigned)blocks;
}

// The gated backward's block: team_block's, at most GATED_MAX_TEAMS wide teams (the
// named barriers); the grid one_block_an_sm's. Then the fold, on the same stream.
template <typename T, int NV>
cudaError_t run_gated_bwd(const RowsBwd<T>& a, double* scratch, int max_rows, cudaStream_t s) {
  using Acc = typename AccOf<T>::type;
  auto kernel = gated_bwd_kernel<T, NV>;
  const int D = a.nvec * Vec<T>::N;
  auto smem_of = [&](int teams) {   // the teams' rings, reused for their dscale rows
    const size_t rings = teams * gated_team_bytes<T, NV>(a.tpr);
    const size_t sums = (size_t)teams * D * sizeof(Acc);
    return rings > sums ? rings : sums;
  };
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = team_block(kernel, a.tpr, a.tpr > 32 ? GATED_MAX_TEAMS : 1 << 30, smem_of,
                               &threads, &smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = one_block_an_sm(a.rows, max_rows);
  double* rows = scratch + FOLD_COUNTERS / 2;
  kernel<<<blocks, threads, smem, s>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gated_fold_kernel<T><<<(D + 31) / 32, 32 * GATED_SLICES, 0, s>>>(rows, (int)blocks, D,
                                                                   a.dscale);
  return cudaGetLastError();
}

// The gated backward's teams, which the split row's finish shares: rows_bwd_kernel's
// lane groups for rows of up to 128 vectors (each row's sums in its order),
// GATED_WIDE_NV vectors a thread past them (twice as many where a row would take
// more threads than the kernel's bound: rows of 2,048 vectors)
bool gated_shape(long long rows, int nvec, RowShape& r) {
  if (!row_shape(rows, nvec, BWD_THREADS, r)) return false;
  if (r.nvec > MAX_GROUP_VECS) {
    r.nv = GATED_WIDE_NV;
    r.tpr = ((r.nvec + r.nv - 1) / r.nv + 31) / 32 * 32;
    if (r.tpr > gated_threads(r.nv)) {
      r.nv *= 2;
      r.tpr = ((r.nvec + r.nv - 1) / r.nv + 31) / 32 * 32;
    }
  }
  return true;
}

template <typename T>
cudaError_t launch_gated_bwd(RowsBwd<T> a, double* scratch, int max_rows, int D,
                             cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  RowShape r;
  if (a.rows <= 0 || D <= 0 || D % VEC || max_rows <= 0 || !gated_shape(a.rows, D / VEC, r))
    return cudaErrorInvalidValue;
  a.nvec = r.nvec;
  a.tpr = r.tpr;
  a.inv_d = 1.0f / (float)D;
  switch (r.nv) {
    case 1: return run_gated_bwd<T, 1>(a, scratch, max_rows, s);
    case 2: return run_gated_bwd<T, 2>(a, scratch, max_rows, s);
    case 4: return run_gated_bwd<T, 4>(a, scratch, max_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NV>
cudaError_t run_qk_bwd(const QkArgs<T>& a, const QkGrad<T>& gr, int threads, size_t smem,
                       double* scratch, int max_blocks, cudaStream_t s) {
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(qk_norm_rope_bwd_kernel<T, NV>, threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const unsigned grid = fold_grid(per_sm, (gr.tokens + gr.n_tok - 1) / gr.n_tok, max_blocks);
  qk_norm_rope_bwd_kernel<T, NV><<<grid, threads, smem, s>>>(
      a, gr, fold_at(scratch, (int)grid, 2 * a.nvec * Vec<T>::N));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qk_bwd(QkArgs<T> a, QkGrad<T> gr, double* scratch, int max_blocks, int hd,
                          cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (hd <= 0 || hd % (2 * VEC) || max_blocks <= 0 ||
      fold_group(max_blocks) + 1 > FOLD_COUNTERS)
    return cudaErrorInvalidValue;
  const int nvec = hd / VEC;
  if (nvec & (nvec - 1) || nvec > 64) return cudaErrorInvalidValue;
  const int tpr = nvec < 32 ? nvec : 32;
  const int nv = nvec / tpr;
  a.nvec = nvec;
  a.tpr = tpr;
  a.inv_d = 1.0f / (float)hd;
  const int slots = rows_per_block(a.rows[0] + a.rows[1], tpr);
  // tokens a chunk: those whose rows fill the slots' last pass the best; of
  // those the fewest that give each slot 4 rows or more (fewer barriers a row)
  const int per_tok = a.heads[0] + a.heads[1];
  int best = 1;
  long long best_idle = -1, best_rows = 1;
  for (int n = 1; n <= QK_TOKENS; ++n) {
    const long long rows = (long long)n * per_tok;
    const long long idle = (rows + slots - 1) / slots * slots - rows;
    const bool fewer_idle = best_idle < 0 || idle * best_rows < best_idle * rows;
    const bool as_idle = idle * best_rows == best_idle * rows;
    if (fewer_idle || (as_idle && best_rows < 4LL * slots)) {
      best = n;
      best_idle = idle;
      best_rows = rows;
    }
  }
  gr.n_tok = best;
  const size_t smem = (size_t)2 * slots * hd * sizeof(typename AccOf<T>::type);
  switch (nv) {
    case 1: return run_qk_bwd<T, 1>(a, gr, slots * tpr, smem, scratch, max_blocks, s);
    case 2: return run_qk_bwd<T, 2>(a, gr, slots * tpr, smem, scratch, max_blocks, s);
    default: return cudaErrorInvalidValue;
  }
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


// ------------------------------------------------ the gated norm over a split row
// gated_rmsnorm of a row whose D columns lie on M ranks, each holding D_local of
// them (mamba2's d_inner split over the "model" axis of a mesh; the JAX package's
// GSPMD sums the row's squares across the shards in f32). A row's sums cross the
// ranks, so each direction is two passes with an f32 all-reduce of one float a
// row between them, which the caller runs (kernels/autograd.py):
//   forward   split_rows_kernel<SPLIT_SQUARES>: ss = the sum of t^2 over the local
//             columns, t = T(y * T(silu(z))) formed as GatedOp::pre forms it;
//             [ss summed over the ranks]
//             split_rows_kernel<SPLIT_NORM>: out = T(t * rstd * w), rstd =
//             rsqrt(ss / D + eps) with the whole row's D, as rows_kernel forms it.
//   backward  split_rows_kernel<SPLIT_DOT>: dot = the sum of dout * w * t over the
//             local columns;
//             [dot summed over the ranks]
//             split_bwd_kernel: dt = T(rstd dout w - t rstd^3 dot / D), then
//             dy = T(dt * T(silu(z))) and dz = T(silu'(z) * T(dt * y)) as
//             gated_bwd_kernel forms them; dscale's terms (f64 for f32 inputs, f32
//             for bf16: AccOf) summed by each block into one f64 row of the
//             scratch, then gated_fold_kernel sums those rows in row order. No
//             atomics on values: two runs give the same bits.
// The sums take AccOf<T>: for f32 inputs a lane's sequential f32 sum of 80 terms
// (a 2,560-wide local row) is ~2e-5 off, past K2's 1e-5 where dout * w * t
// cancels.
//
// What bounds them on the H100: bytes. t is formed in both passes of a direction
// (the second reads y and z again), so the forward moves 2 + 3 times the local
// row's bytes (y, z in; y, z in and out) and the backward 3 + 5 (y, z, dout in;
// the same in and dy, dz out), where one launch on a whole row moves 3 and 5. At
// the training rows of two ranks, [2048, 2560] / [2048, 3584] bf16: 21.0 / 29.4 MB
// for the sums, 31.5 / 44.1 for the norm and the dot, 52.4 / 73.4 for the finish,
// bounds of 0.00626 / 0.00877, 0.00939 / 0.01315 and 0.01566 / 0.02192 ms at 3.35
// TB/s. Passes this short are lost to the launch ramp and to loads that wait on
// each other, and each element's gate (an expf and a division) costs about as
// much issue as its bytes, so the design keeps a row's loads in flight together
// and cuts instructions:
//   - The three row passes are one kernel, split_rows_kernel, on rows_kernel's
//     plan (row_shape, grid_for): a lane group a row up to 128 vectors (the 8-way
//     splits, 640 and 896 bf16 columns), a block a row past that (the 2- and
//     4-way ones), NV vectors a thread; every load of a row issued before its
//     first sum or store; scale held in registers across the grid-stride loop.
//     A kernel of its own rather than Ops of rows_kernel: the sums are
//     AccOf<T>'s where rows_kernel reduces in f32, and the norm reads its row's
//     sum where rows_kernel reduces one, two hooks that would fork rows_kernel's
//     loop. Their roundings to bf16 go two values a conversion (round_pair,
//     pack_pairs: the same bits as round_to and pack).
//   - The finish runs on gated_bwd_kernel's plan (gated_shape, team_block,
//     one_block_an_sm): teams of lane groups or of tpr threads of GATED_WIDE_NV
//     vectors, one block an SM, each thread copying its own vectors of the row
//     GATED_STAGES - 1 rounds ahead into its slots of a cp.async ring. The whole
//     row's ss and dot are read, not reduced: no team waits on another, and a
//     row is one pass; the gate is formed once an element (e = expf(-z) gives
//     silu and sig). At most SPLIT_THREADS threads a block, so 96 registers a
//     thread (a warp scheduler's 16,384 registers over 5 warps).
//   - A thread owns the same columns in every row it takes, so its dscale terms
//     stay in registers until the block's last row; the block sums its teams'
//     terms in team order into its f64 row, and gated_fold_kernel folds the rows.
// Choices the card decided (H100 80GB HBM3 at 700 W; bf16, ms at [2048, 2560] /
// [2048, 3584], the median of four turns of tools/split_norm_variants.py, each
// the median of 20 calls with the L2 flushed before each; sums, norm, dot,
// finish): this design 0.0138 / 0.0168, 0.0148 / 0.0177, 0.0171 / 0.0214,
// 0.0271 / 0.0325, against the first design's warp-a-row passes and
// thread-a-column finish
// 0.0179 / 0.0223, 0.0189 / 0.0250, 0.0234 / 0.0306, 0.0305 / 0.0378, and
// torch.add(y, z) on the same local rows 0.0136 / 0.0164. Undoing one choice at
// a time: one conversion a rounding in the row passes, 0.0144 / 0.0167, 0.0149 /
// 0.0181, 0.0172 / 0.0216 (0.0095 against 0.0089 for the sums at 8 ways); scale
// read from L1 at every row, 0.0139 / 0.0167, 0.0153 / 0.0184, 0.0181 / 0.0220;
// twice the vectors a thread past 128 vectors (half the threads), 0.0140 /
// 0.0164, 0.0163 / 0.0195, 0.0180 / 0.0223; the row passes compiled for 6
// blocks of 256 an SM (40 registers), 0.0139 / 0.0168 for the sums and 0.0201 /
// 0.0244, 0.0263 / 0.0325 for the norm and the dot, which spill: more blocks
// resident do not move the sums; the finish at 768 threads (80 registers),
// 0.0276 / 0.0347; with no row ahead (one stage), 0.0286 / 0.0375; two rows
// ahead, 0.0279 / 0.0335; 4 vectors a thread, 0.0297 / 0.0373. Rounding the
// finish's values in pairs spills at 96 registers and stays one a value. What is
// left: a 16-element torch.add times ~0.005 ms by the same events (the launch and
// the event pair; chip_smoke.py's phase_split_norm), and torch.add(y, z), which
// moves half as many bytes again as the sums read, times as the sums do.
constexpr int SPLIT_SQUARES = 0, SPLIT_DOT = 1, SPLIT_NORM = 2;   // split_rows_kernel's passes
constexpr int SPLIT_THREADS = 640;   // the finish's bound on a block at NV <= 2

template <typename T>
struct SplitArgs {
  const T* y;
  const T* z;
  const T* dout;            // DOT, the finish
  const T* scale;           // DOT, NORM, the finish
  const float* ss;          // NORM, the finish: the whole row's sum of t^2
  const float* dot;         // the finish: the whole row's sum of dout * w * t
  float* sums;              // SQUARES, DOT: each row's sum over the local columns
  T* out;                   // NORM: the normed row; the finish: dy
  T* dz;                    // the finish
  long long rows;
  int nvec, tpr;
  float inv_d, eps;         // inv_d: 1 / the whole row's width
};

// a and b rounded to T and back, as round_to rounds them: in bf16 one
// cvt.rn.bf16x2.f32 for the pair
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
    a = bf_lo(w);
    b = bf_hi(w);
  }
}

// f rounded to T, as a 16-byte vector (pack<T>'s bits, a pair a conversion)
template <typename T>
__device__ __forceinline__ uint4 pack_pairs(const float* f) {
  if constexpr (sizeof(T) == 4) {
    return pack<T>(f);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// silu(z) = z / (1 + e) with e = expf(-z) before its rounding to T, as gate_silu<T>
// forms it: the IEEE division in f32, __fdividef in bf16
template <typename T>
__device__ __forceinline__ float silu_raw(float z, float e) {
  if constexpr (sizeof(T) == 4) return z / (1.0f + e);
  else return __fdividef(z, 1.0f + e);
}

// t = T(y * T(silu(z))) of a vector, as GatedOp::pre rounds it
template <typename T>
__device__ __forceinline__ void gate_product(const float* yf, const float* zf, float* t) {
#pragma unroll
  for (int k = 0; k < Vec<T>::N; k += 2) {
    float s0 = silu_raw<T>(zf[k], expf(-zf[k])), s1 = silu_raw<T>(zf[k + 1], expf(-zf[k + 1]));
    round_pair<T>(s0, s1);
    t[k] = __fmul_rn(yf[k], s0);
    t[k + 1] = __fmul_rn(yf[k + 1], s1);
    round_pair<T>(t[k], t[k + 1]);
  }
}

// One pass over the local rows, taken as rows_kernel takes them. SQUARES and DOT
// write each row's sum (a lane group's shuffles, or the block's), rounded to f32
// once; NORM writes the normed row from the row's whole ss.
template <typename T, int NV, int WHAT>
__global__ void __launch_bounds__(MAX_THREADS)
split_rows_kernel(SplitArgs<T> a) {
  constexpr int VEC = Vec<T>::N, IN = WHAT == SPLIT_DOT ? 3 : 2;
  using Acc = typename AccOf<T>::type;
  __shared__ Acc partial[32];
  const int nvec = a.nvec, tpr = a.tpr;
  const bool wide = tpr > 32;
  const int rpb = wide ? 1 : blockDim.x / tpr;
  const int lane = wide ? threadIdx.x : (threadIdx.x & (tpr - 1));
  const int sub = wide ? 0 : threadIdx.x / tpr;

  uint4 sc[NV];
  if constexpr (WHAT != SPLIT_SQUARES) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (i < nvec) sc[v] = ld16(a.scale, i);
    }
  }
  for (long long r0 = (long long)blockIdx.x * rpb; r0 < a.rows;
       r0 += (long long)gridDim.x * rpb) {
    const long long row = r0 + sub;
    const bool live = row < a.rows;
    float ss = 0.f;
    if constexpr (WHAT == SPLIT_NORM) {
      if (live) ss = a.ss[row];
    }
    uint4 raw[NV][IN];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        raw[v][0] = ld16(a.y, row * nvec + i);
        raw[v][1] = ld16(a.z, row * nvec + i);
        if constexpr (WHAT == SPLIT_DOT) raw[v][2] = ld16(a.dout, row * nvec + i);
      }
    }
    if constexpr (WHAT == SPLIT_NORM) {
      const float rstd = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v * tpr + lane;
        if (live && i < nvec) {
          float yf[VEC], zf[VEC], t[VEC], w[VEC];
          widen<T>(raw[v][0], yf);
          widen<T>(raw[v][1], zf);
          widen<T>(sc[v], w);
          gate_product<T>(yf, zf, t);
#pragma unroll
          for (int k = 0; k < VEC; ++k) t[k] = __fmul_rn(__fmul_rn(t[k], rstd), w[k]);
          put16(a.out, row * nvec + i, pack_pairs<T>(t));
        }
      }
    } else {
      Acc s = 0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v * tpr + lane;
        if (live && i < nvec) {
          float yf[VEC], zf[VEC], t[VEC];
          widen<T>(raw[v][0], yf);
          widen<T>(raw[v][1], zf);
          gate_product<T>(yf, zf, t);
          if constexpr (WHAT == SPLIT_DOT) {
            float gf[VEC], w[VEC];
            widen<T>(raw[v][2], gf);
            widen<T>(sc[v], w);
#pragma unroll
            for (int k = 0; k < VEC; ++k) s += (Acc)gf[k] * w[k] * t[k];
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) s += (Acc)t[k] * t[k];
          }
        }
      }
      s = wide ? block_sum(s, partial) : group_sum(s, tpr);
      if (live && lane == 0) a.sums[row] = (float)s;
    }
  }
}

// threads a block of the finish at most, by NV: what bounds each thread's registers
__host__ __device__ constexpr int split_threads(int nv) { return nv <= 2 ? SPLIT_THREADS : 512; }

// The finish. Team `team` of a block takes rows blockIdx.x + gridDim.x * (team +
// teams * k), round k = 0, 1, ..., as gated_bwd_kernel's teams; each thread copies
// its own vectors of y, dout and z into its slots of the ring ([team][stage][y,
// dout, z][NV][tpr] vectors) and reads back only those, so no barrier guards it.
// Writes the block's f64 row of dscale terms to rows[blockIdx.x].
template <typename T, int NV>
__global__ void __launch_bounds__(split_threads(NV), 1)
split_bwd_kernel(SplitArgs<T> a, double* rows) {
  constexpr int VEC = Vec<T>::N, S = GATED_STAGES;
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) uint4 ring[];
  const int nvec = a.nvec, tpr = a.tpr, D = nvec * VEC;
  const int teams = blockDim.x / tpr, team = threadIdx.x / tpr;
  const int lane = threadIdx.x - team * tpr;
  uint4* slots = ring + (size_t)team * S * 3 * NV * tpr + lane;   // (stage, input, v) at
                                                                   // ((stage * 3 + input) * NV + v) * tpr
  const long long round_rows = (long long)gridDim.x * teams;
  const long long row0 = blockIdx.x + (long long)gridDim.x * team;
  const long long rounds =
      blockIdx.x < a.rows ? (a.rows - blockIdx.x + round_rows - 1) / round_rows : 0;
  // round k's row into stage k % S, one commit group a round (empty past the rows)
  auto fetch = [&](long long k) {
    const long long r = row0 + k * round_rows;
    if (k < rounds && r < a.rows) {
      uint4* st = slots + (size_t)(k % S) * 3 * NV * tpr;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v * tpr + lane;
        if (i < nvec) {
          cp_async16(st + (0 * NV + v) * tpr, reinterpret_cast<const uint4*>(a.y) + r * nvec + i);
          cp_async16(st + (1 * NV + v) * tpr, reinterpret_cast<const uint4*>(a.dout) + r * nvec + i);
          cp_async16(st + (2 * NV + v) * tpr, reinterpret_cast<const uint4*>(a.z) + r * nvec + i);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  Acc acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[v][j] = 0;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) fetch(k);
  for (long long k = 0; k < rounds; ++k) {
    const long long row = row0 + k * round_rows;
    const bool live = row < a.rows;
    float ss = 0.f, dot = 0.f;         // in flight with the ring's wait
    if (live) {
      ss = a.ss[row];
      dot = a.dot[row];
    }
    fetch(k + S - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(S - 1) : "memory");
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
    const float coef = rstd * rstd * rstd * dot * a.inv_d;
    const uint4* st = slots + (size_t)(k % S) * 3 * NV * tpr;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v * tpr + lane;
      if (live && i < nvec) {
        float yf[VEC], gf[VEC], zf[VEC], w[VEC], dy[VEC], dz[VEC];
        widen<T>(st[(0 * NV + v) * tpr], yf);
        widen<T>(st[(1 * NV + v) * tpr], gf);
        widen<T>(st[(2 * NV + v) * tpr], zf);
        widen<T>(ld16(a.scale, i), w);   // from L1
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float e = expf(-zf[j]);
          const float sf = silu_of<T>(zf[j], e);
          const float sig = __fdividef(1.0f, 1.0f + e);
          const float t = round_to<T>(__fmul_rn(yf[j], sf));
          acc[v][j] += (Acc)gf[j] * t * (Acc)rstd;
          const float dt = round_to<T>(rstd * gf[j] * w[j] - t * coef);
          dz[j] = __fmul_rn(round_to<T>(__fmul_rn(dt, yf[j])),
                            __fmul_rn(sig, 1.0f + zf[j] * (1.0f - sig)));
          dy[j] = __fmul_rn(dt, sf);
        }
        put16(a.dz, row * nvec + i, pack<T>(dz));
        put16(a.out, row * nvec + i, pack<T>(dy));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");   // (empty groups only)
  __syncthreads();                                       // the ring is reused below

  // the block's sum of its teams' terms, in team order, in f64
  Acc* stage = reinterpret_cast<Acc*>(ring);   // [teams][D]
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = v * tpr + lane;
    if (i < nvec)
#pragma unroll
      for (int j = 0; j < VEC; ++j) stage[(size_t)team * D + i * VEC + j] = acc[v][j];
  }
  __syncthreads();
  double* out = rows + (long long)blockIdx.x * D;
  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    double s = 0.0;
    for (int j = 0; j < teams; ++j) s += stage[(size_t)j * D + e];
    out[e] = s;
  }
}

// SplitArgs of the entries' pointers; width: the whole row's columns
template <typename T>
SplitArgs<T> split_args(const void* y, const void* z, const void* dout, const void* scale,
                        const void* ss, const void* dot, void* sums, void* out, void* dz,
                        long long rows, int width, float eps) {
  return SplitArgs<T>{(const T*)y, (const T*)z, (const T*)dout, (const T*)scale,
                      (const float*)ss, (const float*)dot, (float*)sums, (T*)out, (T*)dz,
                      rows, 0, 0, 1.0f / (float)width, eps};
}

// a row pass: row_shape's plan, rows_kernel's grid
template <typename T, int WHAT>
cudaError_t launch_split_rows(SplitArgs<T> a, int D, int width, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  RowShape r;
  if (a.rows <= 0 || D <= 0 || D % VEC || width < D || !row_shape(a.rows, D / VEC, MAX_THREADS, r))
    return cudaErrorInvalidValue;
  a.nvec = r.nvec;
  a.tpr = r.tpr;
  const unsigned blocks = grid_for(r.groups, r.threads);
  switch (r.nv) {
    case 1: split_rows_kernel<T, 1, WHAT><<<blocks, r.threads, 0, s>>>(a); break;
    case 2: split_rows_kernel<T, 2, WHAT><<<blocks, r.threads, 0, s>>>(a); break;
    case 4: split_rows_kernel<T, 4, WHAT><<<blocks, r.threads, 0, s>>>(a); break;
    case 8: split_rows_kernel<T, 8, WHAT><<<blocks, r.threads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the finish: team_block's block, one_block_an_sm's grid; then the fold
template <typename T, int NV>
cudaError_t run_split_bwd(const SplitArgs<T>& a, T* dscale, double* scratch, int max_rows,
                          cudaStream_t s) {
  using Acc = typename AccOf<T>::type;
  auto kernel = split_bwd_kernel<T, NV>;
  const int D = a.nvec * Vec<T>::N;
  auto smem_of = [&](int teams) {   // the teams' rings, reused for their dscale rows
    const size_t rings = (size_t)teams * a.tpr * GATED_STAGES * 3 * NV * sizeof(uint4);
    const size_t sums = (size_t)teams * D * sizeof(Acc);
    return rings > sums ? rings : sums;
  };
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = team_block(kernel, a.tpr, 1 << 30, smem_of, &threads, &smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = one_block_an_sm(a.rows, max_rows);
  double* rows = scratch + FOLD_COUNTERS / 2;
  kernel<<<blocks, threads, smem, s>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gated_fold_kernel<T><<<(D + 31) / 32, 32 * GATED_SLICES, 0, s>>>(rows, (int)blocks, D, dscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split_bwd(SplitArgs<T> a, T* dscale, double* scratch, int max_rows, int D,
                             int width, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  RowShape r;
  if (a.rows <= 0 || D <= 0 || D % VEC || width < D || max_rows <= 0 ||
      !gated_shape(a.rows, D / VEC, r))
    return cudaErrorInvalidValue;
  a.nvec = r.nvec;
  a.tpr = r.tpr;
  switch (r.nv) {
    case 1: return run_split_bwd<T, 1>(a, dscale, scratch, max_rows, s);
    case 2: return run_split_bwd<T, 2>(a, dscale, scratch, max_rows, s);
    case 4: return run_split_bwd<T, 4>(a, dscale, scratch, max_rows, s);
    default: return cudaErrorInvalidValue;
  }
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

// Backward entry points, one launch each but gated_rmsnorm_bwd's two. `scratch`
// is the calling stream's own: f64, FOLD_COUNTERS / 2 doubles of tickets (zero
// when first handed over; each launch leaves them at zero), then room for
// max_blocks + fold_group(max_blocks) + 1 rows of W doubles (W = D; 2 * hd for
// qk_norm_rope_bwd; gated_rmsnorm_bwd's below). The launch uses at most
// max_blocks blocks and writes dscale in the input dtype.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, void* scratch, int max_blocks, long long rows,
                           int D, float eps, int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(scratch);
  if (dtype == 0)
    return (int)launch_rows_bwd<float, BWD_PLAIN>(
        RowsBwd<float>{(const float*)x, (const float*)dy, nullptr, (const float*)scale,
                       (float*)dx, nullptr, (float*)dscale, rows, 0, 0, 0.f, eps},
        p, max_blocks, D, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_rows_bwd<B, BWD_PLAIN>(
        RowsBwd<B>{(const B*)x, (const B*)dy, nullptr, (const B*)scale, (B*)dx, nullptr,
                   (B*)dscale, rows, 0, 0, 0.f, eps},
        p, max_blocks, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// s: the forward's residual sum (its first output); ds, dn: the cotangents of s
// and of rmsnorm(s). dx = ds + the norm's dx, the gradient of both x and r.
extern "C" int add_rmsnorm_bwd(const void* s_in, const void* scale, const void* ds,
                               const void* dn, void* dx, void* dscale, void* scratch,
                               int max_blocks, long long rows, int D, float eps, int dtype,
                               int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(scratch);
  if (dtype == 0)
    return (int)launch_rows_bwd<float, BWD_ADD>(
        RowsBwd<float>{(const float*)s_in, (const float*)dn, (const float*)ds,
                       (const float*)scale, (float*)dx, nullptr, (float*)dscale, rows, 0, 0,
                       0.f, eps},
        p, max_blocks, D, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_rows_bwd<B, BWD_ADD>(
        RowsBwd<B>{(const B*)s_in, (const B*)dn, (const B*)ds, (const B*)scale, (B*)dx,
                   nullptr, (B*)dscale, rows, 0, 0, 0.f, eps},
        p, max_blocks, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// y, z: the forward's inputs; dout: the cotangent of its output; dy, dz and
// dscale receive the gradients; two launches (the rows, then the fold). Its
// scratch: FOLD_COUNTERS / 2 doubles of tickets (unused), then max_rows rows of D
// doubles, one a block of the row pass (at most one block an SM).
extern "C" int gated_rmsnorm_bwd(const void* y, const void* z, const void* scale,
                                 const void* dout, void* dy, void* dz, void* dscale,
                                 void* scratch, int max_rows, long long rows, int D, float eps,
                                 int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(scratch);
  if (dtype == 0)
    return (int)launch_gated_bwd<float>(
        RowsBwd<float>{(const float*)y, (const float*)dout, (const float*)z,
                       (const float*)scale, (float*)dy, (float*)dz, (float*)dscale, rows, 0,
                       0, 0.f, eps},
        p, max_rows, D, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_gated_bwd<B>(
        RowsBwd<B>{(const B*)y, (const B*)dout, (const B*)z, (const B*)scale, (B*)dy, (B*)dz,
                   (B*)dscale, rows, 0, 0, 0.f, eps},
        p, max_rows, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// q, k: the forward's inputs (before the norm); dq_out, dk_out: the cotangents of
// its outputs; dq, dk, dq_scale, dk_scale receive the gradients.
extern "C" int qk_norm_rope_bwd(const void* q, const void* k, const void* q_scale,
                                const void* k_scale, const void* dq_out, const void* dk_out,
                                const void* positions, long long pos_sb, long long pos_ss,
                                const void* inv_freq, void* dq, void* dk, void* dq_scale,
                                void* dk_scale, void* scratch, int max_blocks, int B, int S,
                                int H, int K, int hd, float eps, int dtype, int device,
                                void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * S * (H + K) >= (1LL << 31) - MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  double* p = static_cast<double*>(scratch);
  if (dtype == 0) {
    QkGrad<float> gr{{(const float*)dq_out, (const float*)dk_out},
                     {(float*)dq_scale, (float*)dk_scale}, B * S, 1};
    return (int)launch_qk_bwd(qk_args<float>(q, k, q_scale, k_scale, dq, dk, positions,
                                             pos_sb, pos_ss, inv_freq, B, S, H, K, eps),
                              gr, p, max_blocks, hd, s);
  }
  if (dtype == 1) {
    using Bf = __nv_bfloat16;
    QkGrad<Bf> gr{{(const Bf*)dq_out, (const Bf*)dk_out}, {(Bf*)dq_scale, (Bf*)dk_scale},
                  B * S, 1};
    return (int)launch_qk_bwd(qk_args<Bf>(q, k, q_scale, k_scale, dq, dk, positions, pos_sb,
                                          pos_ss, inv_freq, B, S, H, K, eps),
                              gr, p, max_blocks, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}

// gated_rmsnorm over a split row (see "the gated norm over a split row" above): y, z
// [rows, D] this rank's D columns of rows `width` wide, scale its [D]; ss, dot and
// the sums are f32 [rows]. gated_rmsnorm_split_bwd's scratch is gated_rmsnorm_bwd's:
// FOLD_COUNTERS / 2 doubles (unused), then max_rows rows of D doubles; two launches.
extern "C" int gated_rmsnorm_split_stats(const void* y, const void* z, void* ss, long long rows,
                                         int D, int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_split_rows<float, SPLIT_SQUARES>(
        split_args<float>(y, z, nullptr, nullptr, nullptr, nullptr, ss, nullptr, nullptr, rows,
                          D, 0.f),
        D, D, s);
  if (dtype == 1)
    return (int)launch_split_rows<__nv_bfloat16, SPLIT_SQUARES>(
        split_args<__nv_bfloat16>(y, z, nullptr, nullptr, nullptr, nullptr, ss, nullptr,
                                  nullptr, rows, D, 0.f),
        D, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gated_rmsnorm_split_fwd(const void* y, const void* z, const void* scale,
                                       const void* ss, void* out, long long rows, int D,
                                       int width, float eps, int dtype, int device,
                                       void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_split_rows<float, SPLIT_NORM>(
        split_args<float>(y, z, nullptr, scale, ss, nullptr, nullptr, out, nullptr, rows, width,
                          eps),
        D, width, s);
  if (dtype == 1)
    return (int)launch_split_rows<__nv_bfloat16, SPLIT_NORM>(
        split_args<__nv_bfloat16>(y, z, nullptr, scale, ss, nullptr, nullptr, out, nullptr,
                                  rows, width, eps),
        D, width, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gated_rmsnorm_split_dot(const void* y, const void* z, const void* scale,
                                       const void* dout, void* dot, long long rows, int D,
                                       int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_split_rows<float, SPLIT_DOT>(
        split_args<float>(y, z, dout, scale, nullptr, nullptr, dot, nullptr, nullptr, rows, D,
                          0.f),
        D, D, s);
  if (dtype == 1)
    return (int)launch_split_rows<__nv_bfloat16, SPLIT_DOT>(
        split_args<__nv_bfloat16>(y, z, dout, scale, nullptr, nullptr, dot, nullptr, nullptr,
                                  rows, D, 0.f),
        D, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gated_rmsnorm_split_bwd(const void* y, const void* z, const void* scale,
                                       const void* dout, const void* ss, const void* dot,
                                       void* dy, void* dz, void* dscale, void* scratch,
                                       int max_rows, long long rows, int D, int width,
                                       float eps, int dtype, int device, void* stream) {
  DeviceScope scope(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(scratch);
  if (dtype == 0)
    return (int)launch_split_bwd<float>(
        split_args<float>(y, z, dout, scale, ss, dot, nullptr, dy, dz, rows, width, eps),
        (float*)dscale, p, max_rows, D, width, s);
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return (int)launch_split_bwd<B>(
        split_args<B>(y, z, dout, scale, ss, dot, nullptr, dy, dz, rows, width, eps),
        (B*)dscale, p, max_rows, D, width, s);
  }
  return (int)cudaErrorInvalidValue;
}
