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
// shared-memory attribute is set once per device. The device and host
// helpers shared with the backward (flash_bwd_sm90.cu) are in sm90.cuh.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockN = 64;  // k/v rows per pipeline stage
constexpr int kStages = 2;
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
        RsMma<D>::mma(o, a, desc_lo(v_at + kk * 16 * kRowBytes,
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
  return error_string(code);
}
