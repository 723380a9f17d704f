// K4a-c: flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels that blendjax/ops/attention.py:157
// reaches through jax.experimental.pallas.ops.tpu.flash_attention (JAX
// 0.9.0):
//   K4a bjt_flash_fwd      <- _flash_attention_impl    (pallas_call at :758)
//   K4b bjt_flash_bwd_dkv  <- _flash_attention_bwd_dkv (pallas_call at :1121)
//   K4c bjt_flash_bwd_dq   <- _flash_attention_bwd_dq  (pallas_call at :1456)
// These are the "simple" variants: bf16 inputs with a head dim of 64 or 128
// that TMA can address take the sm90 kernels of flash_fwd_sm90.cu and
// flash_bwd_sm90.cu instead (kernels/attention.py: fwd_variant,
// bwd_variant); f32 and every other input run here.
//
// What it computes. q (B, Tq, H, D), k and v (B, Tk, H, D) are read in the
// JAX layout through their (b, t, h) strides with a unit stride over D, so
// the q/k/v views of the fused qkv projection need no transpose or copy.
// s = q k^T * scale is summed in f32; `causal` masks col > row (top-left
// aligned, as the JAX reference); the ragged edges (rows >= Tq, cols >= Tk,
// d >= D up to the padded head dim) are masked in the kernel.
//   fwd: one block per (b, h, 64 q rows), an online softmax over k-tiles of
//        64: o = sum_j cast(exp(s - m)) v / l in the input dtype, and
//        lse = m + log(l) in f32 for the backward (the JAX kernel saves m
//        and l; lse carries both). No (Tq, Tk) tensor touches device memory.
//   dkv: one block per (b, h, 64 kv rows), looping over q-tiles of 32:
//        p = exp(s - lse), dv += cast(p)^T do, ds = p (do v^T - di) scale,
//        dk += cast(ds)^T q.
//   dq:  one block per (b, h, 64 q rows), looping over k-tiles of 64:
//        dq += cast(ds) k.
//   Neither backward kernel uses atomics: each output row is summed by
//   one block, so the result is deterministic. di = rowsum(o * do) in f32
//   comes from the caller (plain torch, as flash_attention.py:274 computes
//   it outside its kernels).
//
// Products. Four warps per block, each owning 16 rows of the block's
// tile. For bf16 inputs every tile product is mma.sync m16n8k16 (bf16
// operands, f32 accumulation); operands come from shared memory (rows
// padded by 16 bytes, so the 32-bit fragment loads hit 32 distinct banks)
// or, for p and ds, straight from the f32 accumulator fragments in
// registers, cast to bf16 as the JAX kernels cast before their second
// products (:471, :900, :918, :1258). f32 inputs run the same code with
// the mma replaced by exact f32 FMAs over warp shuffles (no TF32), so the
// f32 path can be held to an f32 tolerance; it is for parity, not speed.
//
// What bounds it on an H100: operations. At the slice's shape (B 8, H 4,
// T 768, D 128, bf16) the forward does 4*B*H*Tq*Tk*D = 9.66 GFLOP for
// 9.5 MB moved: 9.8 us at 989 TFLOP/s against 2.8 us at 3.35 TB/s. dkv
// does 8*B*H*Tq*Tk*D, dq 6*B*H*Tq*Tk*D. This design is the simple one:
// mma.sync from padded shared memory, no cp.async/TMA pipelining, no
// wgmma, no warp specialisation, so it reaches a fraction of the bf16
// peak. Those are later work (ROADMAP).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kFwdBq = 64, kFwdBk = 64;  // fwd: q rows per block, k-tile
constexpr int kDkvBk = 64, kDkvBq = 32;  // dkv: kv rows per block, q-tile
constexpr int kDqBq = 64, kDqBk = 64;    // dq: q rows per block, k-tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* di;
  void* out;      // o (fwd), dk (dkv) or dq (dq): (B, T, H, D) contiguous
  void* out2;     // dv (dkv)
  float* lse_out; // (B, H, Tq) (fwd)
  long long qs[3], ks[3], vs[3], dos[3];  // (b, t, h) strides, elements
  int B, H, Tq, Tk, D, causal, vec;
  float scale;
};

// Per-type helpers. A "pair" holds two consecutive k-elements of an mma
// fragment: two bf16 in one 32-bit register, or two floats.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  using pair = uint32_t;
  static constexpr int pad = 8;  // 16 bytes of row padding
  __device__ static bf16 zero() { return __float2bfloat16(0.f); }
  __device__ static pair pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static pair row(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static pair col(const bf16* p, int ld) {
    const uint32_t lo = __bfloat16_as_ushort(p[0]);
    const uint32_t hi = __bfloat16_as_ushort(p[ld]);
    return lo | (hi << 16);
  }
  __device__ static void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Elem<float> {
  using pair = float2;
  static constexpr int pad = 4;  // 16 bytes of row padding
  __device__ static float zero() { return 0.f; }
  __device__ static pair pack(float lo, float hi) { return make_float2(lo, hi); }
  __device__ static pair row(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static pair col(const float* p, int ld) {
    return make_float2(p[0], p[ld]);
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// c (16x8, f32) += a (16x16) * b (16x8). Fragment layouts are PTX's for
// m16n8k16 with g = lane / 4, t = lane % 4:
//   a: {row g, k 2t..2t+1}, {row g+8, k 2t..}, {row g, k 2t+8..}, {row g+8, k 2t+8..}
//   b: {k 2t..2t+1, n g}, {k 2t+8..2t+9, n g}
//   c: c0,c1 at (row g, n 2t, 2t+1); c2,c3 at (row g+8, n 2t, 2t+1)
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, src),
                     __shfl_sync(0xffffffffu, v.y, src));
}

// The same product in exact f32 with the same fragment layouts: each lane
// gathers its rows of a from the lanes of its group and its columns of b
// from the lanes that hold them.
__device__ __forceinline__ void mma(float c[4], const float2 a[4],
                                    const float2 b[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const float2 a_lo = shfl2(a[2 * half], g * 4 + tt);
      const float2 a_hi = shfl2(a[2 * half + 1], g * 4 + tt);
      const float2 b0 = shfl2(b[half], 8 * t + tt);
      const float2 b1 = shfl2(b[half], 8 * t + 4 + tt);
      c[0] = fmaf(a_lo.y, b0.y, fmaf(a_lo.x, b0.x, c[0]));
      c[1] = fmaf(a_lo.y, b1.y, fmaf(a_lo.x, b1.x, c[1]));
      c[2] = fmaf(a_hi.y, b0.y, fmaf(a_hi.x, b0.x, c[2]));
      c[3] = fmaf(a_hi.y, b1.y, fmaf(a_hi.x, b1.x, c[3]));
    }
  }
}

// a fragment of rows r0.. and columns c0.. of a row-major smem tile
template <typename T>
__device__ __forceinline__ void load_a(typename Elem<T>::pair a[4],
                                       const T* s, int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const T* p = s + (r0 + (lane >> 2)) * ld + c0 + 2 * (lane & 3);
  a[0] = Elem<T>::row(p);
  a[1] = Elem<T>::row(p + 8 * ld);
  a[2] = Elem<T>::row(p + 8);
  a[3] = Elem<T>::row(p + 8 * ld + 8);
}

// b fragment with b[k][n] = s[n0 + n][k0 + k] (k runs along a smem row)
template <typename T>
__device__ __forceinline__ void load_b_nk(typename Elem<T>::pair b[2],
                                          const T* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const T* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = Elem<T>::row(p);
  b[1] = Elem<T>::row(p + 8);
}

// b fragment with b[k][n] = s[k0 + k][n0 + n] (k runs down a smem column)
template <typename T>
__device__ __forceinline__ void load_b_kn(typename Elem<T>::pair b[2],
                                          const T* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const T* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = Elem<T>::col(p, ld);
  b[1] = Elem<T>::col(p + 8 * ld, ld);
}

// a fragment from two adjacent 16x8 f32 accumulators, cast to T
template <typename T>
__device__ __forceinline__ void frag_a(typename Elem<T>::pair a[4],
                                       const float c0[4], const float c1[4]) {
  a[0] = Elem<T>::pack(c0[0], c0[1]);
  a[1] = Elem<T>::pack(c0[2], c0[3]);
  a[2] = Elem<T>::pack(c1[0], c1[1]);
  a[3] = Elem<T>::pack(c1[2], c1[3]);
}

// rows x DP tile from global rows g[0], g[st], ... into smem (row stride
// DP + pad); rows >= valid and columns >= D are zero.
template <typename T, int DP>
__device__ void load_tile(T* s, const T* g, long long st, int rows, int valid,
                          int D, int vec) {
  constexpr int LD = DP + Elem<T>::pad;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int PER = DP / E;
    for (int i = threadIdx.x; i < rows * PER; i += kThreads) {
      const int r = i / PER, c = (i - r * PER) * E;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < D) x = *reinterpret_cast<const uint4*>(g + r * st + c);
      *reinterpret_cast<uint4*>(s + r * LD + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      s[r * LD + c] = (r < valid && c < D) ? g[r * st + c] : Elem<T>::zero();
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// last k-tile (exclusive) a block of q rows [q0, q0 + bq) needs
__device__ __forceinline__ int k_tiles(const Params& p, int q0, int bq, int bk) {
  const int n = (p.Tk + bk - 1) / bk;
  return p.causal ? min(n, (q0 + bq - 1) / bk + 1) : n;
}

// s (16 x BK per warp) = q rows r0.. of sA times the BK rows of sB, over DP
template <typename T, int DP, int BK>
__device__ __forceinline__ void tile_qkt(float s[BK / 8][4], const T* sA,
                                         const T* sB, int r0) {
  using pair = typename Elem<T>::pair;
  constexpr int LD = DP + Elem<T>::pad;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    pair a[4];
    load_a<T>(a, sA, LD, r0, kc * 16);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      pair b[2];
      load_b_nk<T>(b, sB, LD, nt * 8, kc * 16);
      mma(s[nt], a, b);
    }
  }
}

// acc (16 x DP per warp) += cast(x) (16 x BK, registers) times sB (BK x DP)
template <typename T, int DP, int BK>
__device__ __forceinline__ void tile_pv(float acc[DP / 8][4],
                                        const float x[BK / 8][4], const T* sB) {
  using pair = typename Elem<T>::pair;
  constexpr int LD = DP + Elem<T>::pad;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pair a[4];
    frag_a<T>(a, x[2 * kc], x[2 * kc + 1]);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      pair b[2];
      load_b_kn<T>(b, sB, LD, kc * 16, nt * 8);
      mma(acc[nt], a, b);
    }
  }
}

// rows r (< T) of a (B, T, H, D) contiguous output from a warp's 16 x DP
// accumulator scaled by mul[0] (row g) and mul[1] (row g + 8)
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, const float acc[DP / 8][4],
                                           const int row[2], const float mul[2],
                                           int b, int h, int Tn, const Params& p) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (row[j] >= Tn) continue;
    T* o = out + ((static_cast<long long>(b) * Tn + row[j]) * p.H + h) * p.D;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + 2 * t;
      if (d < p.D)
        Elem<T>::store2(o + d, acc[nt][2 * j] * mul[j], acc[nt][2 * j + 1] * mul[j]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int LD = DP + Elem<T>::pad;
  constexpr int BK = kFwdBk;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kFwdBq * LD;
  T* sV = sK + BK * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFwdBq;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int row[2] = {q0 + r0 + (lane >> 2), q0 + r0 + (lane >> 2) + 8};
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2];

  load_tile<T, DP>(sQ, q + q0 * p.qs[1], p.qs[1], kFwdBq, p.Tq - q0, p.D, p.vec);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_tiles = k_tiles(p, q0, kFwdBq, BK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, DP>(sK, k + k0 * p.ks[1], p.ks[1], BK, p.Tk - k0, p.D, p.vec);
    load_tile<T, DP>(sV, v + k0 * p.vs[1], p.vs[1], BK, p.Tk - k0, p.D, p.vec);
    __syncthreads();

    float s[BK / 8][4];
    tile_qkt<T, DP, BK>(s, sQ, sK, r0);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        float x = s[nt][i] * p.scale;
        if (col >= p.Tk || (p.causal && col > row[i >> 1])) x = -INFINITY;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m_new = fmaxf(m[j], quad_max(mx[j]));
      base[j] = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
      alpha[j] = expf(m[j] - base[j]);
      m[j] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[nt][i] - base[i >> 1]);
        s[nt][i] = e;
        sum[i >> 1] += e;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + quad_sum(sum[j]);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    tile_pv<T, DP, BK>(acc, s, sV);
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) inv[j] = l[j] > 0.f ? 1.f / l[j] : 0.f;
  store_rows<T, DP>(static_cast<T*>(p.out), acc, row, inv, b, h, p.Tq, p);
  if (t == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (row[j] < p.Tq)
        p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Tq + row[j]] =
            m[j] + logf(l[j]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(const Params p) {
  constexpr int LD = DP + Elem<T>::pad;
  constexpr int BQ = kDkvBq;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kDkvBk * LD;
  T* sQ = sV + kDkvBk * LD;
  T* sO = sQ + BQ * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);
  float* sD = sL + BQ;

  const int b = blockIdx.z, h = blockIdx.y, kv0 = blockIdx.x * kDkvBk;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int row[2] = {kv0 + r0 + (lane >> 2), kv0 + r0 + (lane >> 2) + 8};
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2];
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.Tq;

  load_tile<T, DP>(sK, k + kv0 * p.ks[1], p.ks[1], kDkvBk, p.Tk - kv0, p.D, p.vec);
  load_tile<T, DP>(sV, v + kv0 * p.vs[1], p.vs[1], kDkvBk, p.Tk - kv0, p.D, p.vec);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  // causal: q rows below kv0 see none of this block's kv rows
  const int first = p.causal ? kv0 / BQ : 0;
  const int n_tiles = (p.Tq + BQ - 1) / BQ;
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, DP>(sQ, q + q0 * p.qs[1], p.qs[1], BQ, p.Tq - q0, p.D, p.vec);
    load_tile<T, DP>(sO, dout + q0 * p.dos[1], p.dos[1], BQ, p.Tq - q0, p.D, p.vec);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = q0 + i < p.Tq;
      sL[i] = in ? p.lse_in[stat + q0 + i] : 0.f;
      sD[i] = in ? p.di[stat + q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T (this warp's 16 kv rows x BQ q columns)
    float pt[BQ / 8][4];
    tile_qkt<T, DP, BQ>(pt, sK, sQ, r0);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = nt * 8 + 2 * t + (i & 1);
        const int kr = row[i >> 1];
        const bool ok = q0 + qi < p.Tq && kr < p.Tk && (!p.causal || kr <= q0 + qi);
        pt[nt][i] = ok ? expf(pt[nt][i] * p.scale - sL[qi]) : 0.f;
      }
    }
    tile_pv<T, DP, BQ>(dv, pt, sO);  // dv += cast(p)^T do

    float dpt[BQ / 8][4];  // (do v^T)^T
    tile_qkt<T, DP, BQ>(dpt, sV, sO, r0);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = nt * 8 + 2 * t + (i & 1);
        pt[nt][i] = pt[nt][i] * (dpt[nt][i] - sD[qi]) * p.scale;
      }
    }
    tile_pv<T, DP, BQ>(dk, pt, sQ);  // dk += cast(ds)^T q
  }

  const float one[2] = {1.f, 1.f};
  store_rows<T, DP>(static_cast<T*>(p.out), dk, row, one, b, h, p.Tk, p);
  store_rows<T, DP>(static_cast<T*>(p.out2), dv, row, one, b, h, p.Tk, p);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  constexpr int LD = DP + Elem<T>::pad;
  constexpr int BK = kDqBk;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kDqBq * LD;  // dO
  T* sK = sO + kDqBq * LD;
  T* sV = sK + BK * LD;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kDqBq;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int row[2] = {q0 + r0 + (lane >> 2), q0 + r0 + (lane >> 2) + 8};
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2];
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.Tq;

  load_tile<T, DP>(sQ, q + q0 * p.qs[1], p.qs[1], kDqBq, p.Tq - q0, p.D, p.vec);
  load_tile<T, DP>(sO, dout + q0 * p.dos[1], p.dos[1], kDqBq, p.Tq - q0, p.D, p.vec);
  float lse[2], di[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    lse[j] = row[j] < p.Tq ? p.lse_in[stat + row[j]] : 0.f;
    di[j] = row[j] < p.Tq ? p.di[stat + row[j]] : 0.f;
  }
  float dq[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
    dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  const int n_tiles = k_tiles(p, q0, kDqBq, BK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, DP>(sK, k + k0 * p.ks[1], p.ks[1], BK, p.Tk - k0, p.D, p.vec);
    load_tile<T, DP>(sV, v + k0 * p.vs[1], p.vs[1], BK, p.Tk - k0, p.D, p.vec);
    __syncthreads();

    float s[BK / 8][4];
    tile_qkt<T, DP, BK>(s, sQ, sK, r0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        const bool ok = col < p.Tk && (!p.causal || col <= row[i >> 1]);
        s[nt][i] = ok ? expf(s[nt][i] * p.scale - lse[i >> 1]) : 0.f;
      }
    }
    float dp[BK / 8][4];  // do v^T
    tile_qkt<T, DP, BK>(dp, sO, sV, r0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[nt][i] = s[nt][i] * (dp[nt][i] - di[i >> 1]) * p.scale;
    }
    tile_pv<T, DP, BK>(dq, s, sK);  // dq += cast(ds) k
  }

  const float one[2] = {1.f, 1.f};
  store_rows<T, DP>(static_cast<T*>(p.out), dq, row, one, b, h, p.Tq, p);
}

constexpr int kMaxDevices = 64;

// Sets a kernel's dynamic shared-memory limit the first time it launches on
// a device (a function attribute, not stream work), as the sm90 launchers
// do: a CUDA graph capture then records launches only.
template <typename K>
cudaError_t set_smem_once(bool (&done)[kMaxDevices], K kernel, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int DP>
int launch(int which, const Params& p, cudaStream_t stream) {
  constexpr int LD = DP + Elem<T>::pad;
  constexpr int row_bytes = LD * static_cast<int>(sizeof(T));
  static bool attr_set[3][kMaxDevices] = {};
  cudaError_t err;
  if (which == 0) {
    const int smem = (kFwdBq + 2 * kFwdBk) * row_bytes;
    err = set_smem_once(attr_set[0], flash_fwd<T, DP>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.Tq + kFwdBq - 1) / kFwdBq, p.H, p.B);
    flash_fwd<T, DP><<<grid, kThreads, smem, stream>>>(p);
  } else if (which == 1) {
    const int smem = (2 * kDkvBk + 2 * kDkvBq) * row_bytes +
                     2 * kDkvBq * static_cast<int>(sizeof(float));
    err = set_smem_once(attr_set[1], flash_bwd_dkv<T, DP>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.Tk + kDkvBk - 1) / kDkvBk, p.H, p.B);
    flash_bwd_dkv<T, DP><<<grid, kThreads, smem, stream>>>(p);
  } else {
    const int smem = (2 * kDqBq + 2 * kDqBk) * row_bytes;
    err = set_smem_once(attr_set[2], flash_bwd_dq<T, DP>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.Tq + kDqBq - 1) / kDqBq, p.H, p.B);
    flash_bwd_dq<T, DP><<<grid, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int which, const Params& p, int dtype, void* stream) {
  if (p.D < 8 || p.D > 128 || p.D % 8 || p.Tq < 1 || p.Tk < 1 || p.B < 1 ||
      p.H < 1 || p.B > 65535 || p.H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return p.D <= 64 ? launch<bf16, 64>(which, p, s) : launch<bf16, 128>(which, p, s);
  return p.D <= 64 ? launch<float, 64>(which, p, s) : launch<float, 128>(which, p, s);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const long long* strides, int B, int H,
                   int Tq, int Tk, int D, int causal, int vec, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.dos[i] = strides[9 + i];
  }
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.causal = causal;
  p.vec = vec;
  p.scale = scale;
  return p;
}

}  // namespace

// strides: 12 host int64s, the (b, t, h) element strides of q, k, v and do
// (do's are ignored by the forward). dtype 0 = bf16, 1 = f32. Each call
// returns a cudaError_t code (0 on a successful launch).
extern "C" int bjt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int B, int H, int Tq, int Tk, int D, int causal,
                             int dtype, int vec, float scale, void* stream) {
  Params p = make_params(q, k, v, nullptr, strides, B, H, Tq, Tk, D, causal,
                         vec, scale);
  p.out = o;
  p.lse_out = static_cast<float*>(lse);
  return dispatch(0, p, dtype, stream);
}

extern "C" int bjt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* di, void* dk, void* dv,
                                 const long long* strides, int B, int H,
                                 int Tq, int Tk, int D, int causal, int dtype,
                                 int vec, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, strides, B, H, Tq, Tk, D, causal, vec,
                         scale);
  p.lse_in = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.out = dk;
  p.out2 = dv;
  return dispatch(1, p, dtype, stream);
}

extern "C" int bjt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dq,
                                const long long* strides, int B, int H, int Tq,
                                int Tk, int D, int causal, int dtype, int vec,
                                float scale, void* stream) {
  Params p = make_params(q, k, v, dout, strides, B, H, Tq, Tk, D, causal, vec,
                         scale);
  p.lse_in = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.out = dq;
  return dispatch(2, p, dtype, stream);
}

extern "C" const char* bjt_flash_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
