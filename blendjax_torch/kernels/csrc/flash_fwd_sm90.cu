// K4a on Hopper: the flash-attention forward with TMA, wgmma and warp
// specialisation (sm_90a).
//
// Replaces the forward Pallas TPU kernel that blendjax/ops/attention.py:157
// reaches through jax.experimental.pallas.ops.tpu.flash_attention (JAX
// 0.9.0, _flash_attention_impl, pallas_call at :758), for bf16 q/k/v with
// a head dim of 64 or 128 that TMA can address (16-byte aligned bases,
// (b, t, h) strides that are multiples of 16 bytes, a unit stride over D).
// Every other input (f32, other head dims, unaligned views) keeps the
// simple kernel in flash_attention.cu; the wrapper's fwd_variant() is the
// rule. Both compute the same function: o = softmax(q k^T * scale) v in
// q's dtype with f32 sums, p cast to bf16 before the second product, and
// the f32 row statistics lse = m + log(l), (B, H, Tq), for the backward.
//
// What bounds it on an H100: operations. At the slice's shape (B 8, H 4,
// T 768, D 128) it does 4*B*H*Tq*Tk*D = 9.66 GFLOP for 9.5 MB moved:
// 9.8 us at 989 TFLOP/s against 2.8 us at 3.35 TB/s.
//
// Design. One block per (b, h, 192 q rows): three consumer warpgroups of
// 64 q rows each, then one producer warpgroup. At the slice's shape that
// is 128 blocks of 512 threads and ~113 KB of shared memory, one per SM,
// all in one wave on 132 SMs; 64-row blocks (384 at two per SM) and
// 128-row blocks (192 at one per SM) both need 1.45 waves and ran slower
// on an H100 (PERF.md).
//   - Loads. Each of q, k, v has a 4-d TMA tensor map (d, h, t, b) over its
//     strided view, so the q/k/v views of the fused qkv projection load
//     with no copy. Boxes are 64 columns (128 bytes) wide with the 128-byte
//     swizzle; a D 128 tile is two boxes. TMA zero-fills rows past T.
//   - Pipeline. One thread of the producer warpgroup loads each consumer
//     warpgroup's 64 q rows once (the first before k tile 0, the others
//     after it, each on its own barrier), and keeps kStages k/v tiles of
//     64 rows in flight: a full
//     barrier per stage for k and one for v (expect_tx bytes), an empty
//     barrier per stage that each consumer warp arrives on once it is done
//     with the stage. The producer warpgroup gives its registers up
//     (setmaxnreg.dec), the consumers take them (setmaxnreg.inc).
//   - Products. s = q k^T is wgmma m64n64k16 with both operands read from
//     shared memory (K-major); o += p v is wgmma m64nDk16 with p in
//     registers (the s accumulator cast to bf16 in place of an A fragment)
//     and v read from shared memory as a transposed (MN-major) operand.
//   - Softmax. Online, in registers, in base 2: the row max is taken over
//     the raw scores and the scale, folded into log2(e), enters each
//     exponential as one FFMA before one ex2. Each thread keeps its partial
//     row sums and reduces them across its quad once at the end; o is
//     rescaled only when some row's max moved in the warp.
//   - Masking. The causal mask (col > row, top-left aligned) and the ragged
//     last k tile are applied in registers, only on tiles that need them; a
//     causal block stops at the k tile holding its last row's diagonal.
//   - Outputs. o is written from registers in q's dtype to a contiguous
//     (B, Tq, H, D) tensor, lse as f32 (B, H, Tq).
// The tensor maps are encoded on the host for each call with libcuda's
// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library links against the CUDA runtime only. Each instance's
// shared-memory attribute is set once per device.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockN = 64;  // k/v rows per pipeline stage
constexpr int kStages = 2;
constexpr int kBoxCols = 64;  // d columns per TMA box: 128 bytes of bf16
constexpr int kRowBytes = kBoxCols * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarpgroups = 3;  // consumer warpgroups of 64 q rows per block

template <int D>
struct Cfg {
  static constexpr int kBlockM = 64 * kWarpgroups;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kThreads = (kWarpgroups + 1) * 128;  // + the producer
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;  // k or v, one stage
  // offsets from a 1024-byte aligned base (the 128-byte swizzle's period)
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  // + 1024 bytes of slack for the alignment
  static constexpr int kSmem = kBar + 8 * (kWarpgroups + 3 * kStages) + 1024;
  // Registers per thread: __launch_bounds__ at 512 threads leaves 128 at
  // launch (ptxas compiles the whole kernel to that count), then setmaxnreg
  // moves what the producer warpgroup gives up (down to 24) to the
  // consumers, never more than it frees.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 160;
};

struct FwdParams {
  CUtensorMap tq, tk, tv;  // 64-byte aligned; live in the kernel's .param space
  bf16* o;
  float* lse;
  int H, Tq, Tk, causal;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spin until the barrier's phase differs from `parity`. A wait that never
// ends (a pipeline fault) traps after ~2^28 polls, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle, as two 32-bit
// words: the low word holds the start address and the leading byte offset
// (both in 16-byte units), the high word (kDescHi, the same for every
// operand here) the stride byte offset, 1024 bytes between 8-row groups, and
// layout type 1 (B128). K-major tiles (rows of 128 bytes along K) leave the
// leading offset unused (16 bytes); MN-major tiles take the byte distance
// between their 64-column boxes along N. The wgmma helpers join the words in
// PTX, so a hoisted descriptor costs one register, not two.
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

// d (64 x 64, f32) {+}= a (64 x 16, smem, K-major) * b (64 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint32_t da,
                                                  uint32_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %34, 0;\n"
      "mov.b64 da, {%32, %35};\nmov.b64 db, {%33, %35};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(da), "r"(db), "r"(accumulate), "r"(kDescHi));
}

// d (64 x 64, f32) += a (64 x 16, bf16 registers) * b (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %37, 0;\n"
      "mov.b64 db, {%36, %38};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(db), "r"(1),
        "r"(kDescHi));
}

// d (64 x 128, f32) += a (64 x 16, bf16 registers) * b (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint32_t db) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %69, 0;\n"
      "mov.b64 db, {%68, %70};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(db), "r"(1),
        "r"(kDescHi));
}


template <int D>
struct PV;
template <>
struct PV<64> {
  __device__ static void mma(float (&o)[32], const uint32_t (&a)[4], uint32_t db) {
    wgmma_m64n64k16_rs(o, a, db);
  }
};
template <>
struct PV<128> {
  __device__ static void mma(float (&o)[64], const uint32_t (&a)[4], uint32_t db) {
    wgmma_m64n128k16_rs(o, a, db);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (MUFU.EX2: relative error ~2^-22, far inside bf16's rounding;
// 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ FwdParams p) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::kK, sV = base + C::kV;
  // barriers: q full per consumer warpgroup w, then per stage s: k full,
  // v full, empty
  const uint32_t bar = base + C::kBar;
  auto q_full = [&](int w) { return bar + 8 * w; };
  auto k_full = [&](int s) { return bar + 8 * (kWarpgroups + s); };
  auto v_full = [&](int s) { return bar + 8 * (kWarpgroups + kStages + s); };
  auto empty = [&](int s) { return bar + 8 * (kWarpgroups + 2 * kStages + s); };
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * C::kBlockM;
  int n_tiles = (p.Tk + kBlockN - 1) / kBlockN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + C::kBlockM - 1) / kBlockN + 1);

  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarpgroups; ++w) mbar_init(q_full(w), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWarpgroups) {
    // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x == kWarpgroups * 128) {
      // each consumer warpgroup's 64 q rows on its own barrier: the first
      // starts once its rows and k tile 0 are in, not the whole block's q
      auto load_q = [&](int w) {
        mbar_expect_tx(q_full(w), C::kQBytes / kWarpgroups);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sQ + (x * C::kBlockM + w * 64) * kRowBytes, &p.tq,
                   q_full(w), x * kBoxCols, h, q0 + w * 64, b);
      };
      load_q(0);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sK + s * C::kKVBytes + x * kBlockN * kRowBytes, &p.tk,
                   k_full(s), x * kBoxCols, h, kt * kBlockN, b);
        if (kt == 0)
          for (int w = 1; w < kWarpgroups; ++w) load_q(w);
        mbar_expect_tx(v_full(s), C::kKVBytes);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sV + s * C::kKVBytes + x * kBlockN * kRowBytes, &p.tv,
                   v_full(s), x * kBoxCols, h, kt * kBlockN, b);
      }
    }
  } else {
    // consumer warpgroup wg: q rows q0 + 64 wg ..
    setmaxnreg_inc<C::kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, t4 = lane % 4;
    const int wrow0 = q0 + wg * 64;                    // this warpgroup's first row
    const int row0 = wrow0 + (tid / 32) * 16 + lane / 4;  // fragment rows row0, row0 + 8
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_at = sQ + wg * 64 * kRowBytes;

    // s = q k^T for tile kt into sc: issued, not waited for
    auto issue_scores = [&](float (&sc)[32], int kt) {
      const uint32_t k_at = sK + (kt % kStages) * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the box
        const uint32_t da =
            desc_lo(q_at + (kk / 4) * C::kBlockM * kRowBytes + off, 16);
        const uint32_t db =
            desc_lo(k_at + (kk / 4) * kBlockN * kRowBytes + off, 16);
        wgmma_m64n64k16_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // online softmax over tile kt, base 2, in place: sc becomes p (f32),
    // l gains the tile's row sums, alpha rescales what o holds. The scale
    // (> 0) commutes with the max, so the max is taken over the raw scores
    // and each exponential is one FFMA and one ex2.
    auto softmax = [&](float (&sc)[32], int kt, float (&alpha)[2]) {
      const int k0 = kt * kBlockN;
      if (k0 + kBlockN > p.Tk || (p.causal && k0 + kBlockN - 1 > wrow0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + (i / 4) * 8 + 2 * t4 + (i % 2);
          const int row = row0 + 8 * ((i / 2) % 2);
          if (col >= p.Tk || (p.causal && col > row)) sc[i] = -INFINITY;
        }
      }
      // maxima and sums in four independent chains per row, not one
      float mx[2][4], sum[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[(i / 2) % 2][i / 4 * 2 + i % 2] = sc[i];
#pragma unroll
      for (int i = 8; i < 32; ++i) {
        float& x = mx[(i / 2) % 2][(i / 4) % 2 * 2 + i % 2];
        x = fmaxf(x, sc[i]);
      }
      float base_[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float t = fmaxf(fmaxf(mx[j][0], mx[j][1]), fmaxf(mx[j][2], mx[j][3]));
        const float m_new = fmaxf(m[j], quad_max(t) * p.scale_log2);
        base_[j] = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
        alpha[j] = ex2(m[j] - base_[j]);
        m[j] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float e = ex2(fmaf(sc[i], p.scale_log2, -base_[(i / 2) % 2]));
        sc[i] = e;
        float& acc = sum[(i / 2) % 2][(i / 4) % 2 * 2 + i % 2];
        acc = i < 8 ? e : acc + e;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        l[j] = fmaf(l[j], alpha[j], (sum[j][0] + sum[j][1]) + (sum[j][2] + sum[j][3]));
    };
    // o *= alpha, then o += cast(p) v for tile kt: issued, not waited for
    // (p's bf16 fragments must live until the products are done)
    auto issue_pv = [&](const float (&sc)[32], const float (&alpha)[2],
                        uint32_t (&pa)[16], int kt) {
      // once the row maxima settle, alpha is 1 for the whole warp
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
      const uint32_t v_at = sV + (kt % kStages) * C::kKVBytes;
      mbar_wait(v_full(kt % kStages), (kt / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        PV<D>::mma(o, a, desc_lo(v_at + kk * 16 * kRowBytes,
                                 kBlockN * kRowBytes));
      }
      wgmma_commit();
    };
    mbar_wait(q_full(wg), 0);
    float sc[32], alpha[2];
    uint32_t pa[16];
    for (int kt = 0; kt < n_tiles; ++kt) {
      mbar_wait(k_full(kt % kStages), (kt / kStages) & 1);
      wgmma_fence();
      issue_scores(sc, kt);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, kt, alpha);
      issue_pv(sc, alpha, pa, kt);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(kt % kStages));
    }

    float inv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] = quad_sum(l[j]);
      inv[j] = l[j] > 0.f ? 1.f / l[j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 8 * j;
      if (row >= p.Tq) continue;
      bf16* out = p.o + ((static_cast<long long>(b) * p.Tq + row) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(out + c * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[4 * c + 2 * j] * inv[j],
                                  o[4 * c + 2 * j + 1] * inv[j]);
      if (t4 == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Tq + row] =
            m[j] * kLn2 + logf(l[j]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrNoEncoder = 20000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10000;     // + the CUresult of a failed encode
constexpr int kMaxDevices = 64;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the (d, h, t, b) map of one (B, T, H, D) bf16 view with element strides
// st = {b, t, h} and a unit stride over d; boxes of 64 columns x `rows` rows
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, const long long* st,
           int B, int T, int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const long long* st, int B, int H, int Tq, int Tk, int causal,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  FwdParams p;
  int rc = encode(fn, &p.tq, q, st, B, Tq, H, D, 64);
  if (!rc) rc = encode(fn, &p.tk, k, st + 3, B, Tk, H, D, kBlockN);
  if (!rc) rc = encode(fn, &p.tv, v, st + 6, B, Tk, H, D, kBlockN);
  if (rc) return rc;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  const dim3 grid((Tq + C::kBlockM - 1) / C::kBlockM, H, B);
  flash_fwd_sm90<D><<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16 (B, T, H, D) views with a unit stride over D; strides: 9
// host int64s, the (b, t, h) element strides of q, k and v. o: contiguous
// bf16 (B, Tq, H, D); lse: contiguous f32 (B, H, Tq). D is 64 or 128;
// scale > 0 (the row max is taken over the unscaled scores). Returns a
// cudaError_t code (0 on a successful launch), or a code of
// bjt_flash_fwd_sm90_error's own for a tensor map that could not be made.
extern "C" int bjt_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const long long* strides,
                                  int B, int H, int Tq, int Tk, int D,
                                  int causal, float scale, void* stream) {
  if ((D != 64 && D != 128) || !(scale > 0.f) || B < 1 || H < 1 || Tq < 1 ||
      Tk < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, strides, B, H, Tq, Tk, causal, scale, s);
  return launch<128>(q, k, v, o, lse, strides, B, H, Tq, Tk, causal, scale, s);
}

extern "C" const char* bjt_flash_fwd_sm90_error(int code) {
  if (code == kErrNoEncoder)
    return "libcuda offers no cuTensorMapEncodeTiled";
  if (code >= kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
