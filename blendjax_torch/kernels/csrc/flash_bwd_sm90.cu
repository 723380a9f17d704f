// K4b and K4c on Hopper: the flash-attention backward, dK/dV and dQ, with
// TMA, wgmma and warp specialisation (sm_90a).
//
// Replaces the two backward Pallas TPU kernels that
// blendjax/ops/attention.py:157 reaches through
// jax.experimental.pallas.ops.tpu.flash_attention (JAX 0.9.0):
//   K4b bjt_flash_bwd_dkv_sm90 <- _flash_attention_bwd_dkv (pallas_call at :1121)
//   K4c bjt_flash_bwd_dq_sm90  <- _flash_attention_bwd_dq  (pallas_call at :1456)
// for bf16 q/k/v/do with a head dim of 64 or 128 that TMA can address
// (16-byte aligned bases, (b, t, h) strides that are multiples of 16 bytes,
// a unit stride over D). Every other input keeps the simple kernels of
// flash_attention.cu; the wrapper's bwd_variant() is the rule. Both compute
// the same functions, from the forward's f32 row statistics lse (B, H, Tq)
// and di = rowsum(o * do) (B, H, Tq, from the caller):
//   p = exp(s * scale - lse), ds = p (do v^T - di) scale (f32),
//   dv = cast(p)^T do, dk = cast(ds)^T q, dq = cast(ds) k,
// summed in f32 and written in the input dtype. The causal mask is col > row,
// top-left aligned, as the JAX reference. No atomics: each output row is
// summed by one block in a fixed order, so the results are deterministic.
//
// What bounds them on an H100: operations. At the slice's shape (B 8, H 4,
// T 768, D 128) dK/dV's function is 8*B*H*Tq*Tk*D = 19.33 GFLOP (4
// products), dQ's 6*B*H*Tq*Tk*D = 14.50 GFLOP (3: it recomputes s and dp),
// for 37.9 and 31.7 MB read once and written once: 19.5 and 14.7 us at
// 989 TFLOP/s against 11.3 and 9.5 us at 3.35 TB/s.
//
// Design: K4a's (flash_fwd_sm90.cu), with one block per (b, h, 64 resident
// rows): two consumer warpgroups that split the streamed tiles in halves,
// each over a ring of its own, then one producer warpgroup that gives its
// registers to them (setmaxnreg). At the end warpgroup 1 hands its f32
// partial sums to warpgroup 0 through its drained ring (a named barrier
// between them), which adds them to its own in that fixed order and writes
// the rows. At the slice's shape that is 384 dQ blocks and 768 dK/dV blocks
// of 384 threads, 167 KB of shared memory and 168 registers each, one
// block per SM. 128-row blocks (a warpgroup per 64 rows, each over every
// tile, one ring) make half as many blocks: 1.45 waves of dQ blocks on 132
// SMs, 22% slower there; dK/dV took 4% less time that way, not worth a
// second structure (PERF.md).
//   - Loads. q, k, v and do each have a 4-d TMA tensor map (d, h, t, b) over
//     their strided views (sm90.cuh), boxes of 64 columns x 64 rows with the
//     128-byte swizzle, zero-filled past T. The first lane of producer warp
//     0 loads the resident rows once; that of producer warp w keeps
//     consumer warpgroup w's ring of kStages 64-row tiles in flight: a full
//     barrier per operand and stage (expect_tx bytes), an empty barrier per
//     stage that each of the warpgroup's warps arrives on once it is done
//     with the stage.
//   - dQ (flash_bwd_dq_sm90): resident q and do rows, rings of k and v
//     tiles. s = q k^T and dp = do v^T are wgmma m64n64k16 with both
//     operands in shared memory (K-major); dq += cast(ds) k is wgmma
//     m64nDk16 with ds in registers (the accumulator cast to bf16 in place
//     of an A fragment) and k read as a transposed (MN-major) operand: K4a's
//     two operand kinds. Each thread reads its two rows' lse and di once.
//   - dK/dV (flash_bwd_dkv_sm90): resident k and v rows, rings of q and do
//     tiles with their rows' lse (in base 2) and di, which the producer
//     warp writes into the stage beside the TMA tiles. The products run
//     transposed, so they are the same two operand kinds: s^T = k q^T and
//     dp^T = v do^T from shared memory, dv += cast(p^T) do and
//     dk += cast(ds^T) q with p^T and ds^T in registers; lse and di are per
//     column here. Each 64 kv rows have two blocks: a dk block (s^T, dp^T,
//     then the dk product) and a dv block (s^T, then the dv product), so
//     s^T is computed twice (10, not 8, B*H*Tq*Tk*D FLOPs) and no thread
//     holds dk and dv at once. The dk blocks, the longer ones, come first in
//     the grid.
//   - Arithmetic. p = exp2(s * scale log2(e) - lse log2(e)), one FFMA and
//     one ex2; ds is computed in place in dp's registers. Masked entries
//     (the causal mask, columns past the other operand's T, rows past Tq in
//     dK/dV) are set to 0 in registers on the tiles that hold any, never left
//     to TMA's zero fill (a zero-filled score gives exp(-lse), not 0). A
//     causal dQ block stops at the k tile holding its last row's diagonal; a
//     causal dK/dV block starts at the q tile holding its first row.
//   - Registers. ptxas compiles the whole kernel to the launch bound's 168
//     registers (384 threads), whatever setmaxnreg.inc asks for: dk, dv, s^T
//     and dp^T in one thread (192 f32 accumulators at D 128) spilled and
//     ran several times slower (PERF.md). A dk block holds D/2 + 64
//     accumulators per thread, as dQ does, a dv block D/2 + 32.
//   - Outputs. dk, dv and dq are written from registers in the input dtype to
//     contiguous (B, T, H, D) tensors.
// Each instance's shared-memory attribute is set once per device.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kTile = 64;       // rows of a TMA tile, a ring stage, a block's resident rows
constexpr int kStages = 2;      // ring stages per consumer warpgroup
constexpr int kWarpgroups = 2;  // consumer warpgroups per block, a ring each

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kThreads = (kWarpgroups + 1) * 128;  // + the producer
  static constexpr int kTileBytes = kTile * D * 2;  // one operand's 64 rows
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;  // a warpgroup's ring
  static constexpr int kStatBytes = 2 * kTile * 4;  // a stage's lse (base 2), di
  // offsets from a 1024-byte aligned base (the 128-byte swizzle's period):
  // the two resident operands, each consumer warpgroup's ring (per stage
  // two tiles), the rings' statistics (dK/dV), the barriers
  static constexpr int kRing = 2 * kTileBytes;
  static constexpr int kStats = kRing + kWarpgroups * kRingBytes;
  static constexpr int kBar = kStats + kWarpgroups * kStages * kStatBytes;
  // + 1024 bytes of slack for the alignment
  static constexpr int kSmem = kBar + 8 * (1 + 3 * kWarpgroups * kStages) + 1024;
  // Registers per thread: __launch_bounds__ at 384 threads leaves 168 at
  // launch (ptxas compiles the whole kernel to that count), then setmaxnreg
  // moves what the producer warpgroup gives up (down to 24) to the
  // consumers, never more than it frees: (2 x 240 + 24) x 128 <= 65536.
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  // warpgroup 1 hands its f32 partial sums to warpgroup 0 through its ring
  static_assert(kWarpgroups == 2 && kTile * D * 4 <= kRingBytes, "partials");
};

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // 64-byte aligned; live in the kernel's .param space
  const float* lse;  // (B, H, Tq)
  const float* di;   // (B, H, Tq)
  bf16* out;         // dq or dk
  bf16* out2;        // dv
  int H, Tq, Tk, causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// The block's shared memory: resident operands, the consumer warpgroups'
// rings, their statistics and the barriers.
template <int D>
struct Smem {
  using C = Cfg<D>;
  uint32_t base;           // shared-space address, 1024-byte aligned
  unsigned char* generic;  // the same bytes through a generic pointer

  __device__ uint32_t res0() const { return base; }
  __device__ uint32_t res1() const { return base + C::kTileBytes; }
  __device__ uint32_t tile0(int w, int s) const {
    return base + C::kRing + w * C::kRingBytes + s * 2 * C::kTileBytes;
  }
  __device__ uint32_t tile1(int w, int s) const { return tile0(w, s) + C::kTileBytes; }
  __device__ float* stats(int w, int s) const {
    return reinterpret_cast<float*>(generic + C::kStats + (w * kStages + s) * C::kStatBytes);
  }
  // warpgroup 1's partial sums, in its ring once it has drained
  __device__ float* partial() const {
    return reinterpret_cast<float*>(generic + C::kRing + C::kRingBytes);
  }
  // barriers: the resident rows, then per warpgroup w and stage s the first
  // tile (+ statistics) full, the second tile full, the stage empty
  __device__ uint32_t bar(int i) const { return base + C::kBar + 8 * i; }
  __device__ uint32_t res_full() const { return bar(0); }
  __device__ uint32_t full0(int w, int s) const { return bar(1 + w * kStages + s); }
  __device__ uint32_t full1(int w, int s) const {
    return bar(1 + (kWarpgroups + w) * kStages + s);
  }
  __device__ uint32_t empty(int w, int s) const {
    return bar(1 + (2 * kWarpgroups + w) * kStages + s);
  }

  // one thread: every barrier; full0 counts `full0_arrivals`
  __device__ void init(int full0_arrivals) const {
    mbar_init(res_full(), 1);
    for (int w = 0; w < kWarpgroups; ++w)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full0(w, s), full0_arrivals);
        mbar_init(full1(w, s), 1);
        mbar_init(empty(w, s), 4);  // the warpgroup's warps
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // one 64-row tile (rows r0 ..) of a tensor map into `dst`, on `full`
  __device__ void load_tile(uint32_t dst, const CUtensorMap* m, uint32_t full,
                            int h, int r0, int b) const {
    mbar_expect_tx(full, C::kTileBytes);
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x)
      tma_load(dst + x * kTile * kRowBytes, m, full, x * kBoxCols, h, r0, b);
  }
};

template <int D>
__device__ __forceinline__ Smem<D> block_smem(unsigned char* raw) {
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  return {base, raw + (base - smem_u32(raw))};
}

// the half of a block's streamed tiles [t0, t1) that consumer warpgroup w
// takes, as [x, y)
__device__ __forceinline__ int2 tile_range(int w, int t0, int t1) {
  const int mid = t0 + (t1 - t0 + 1) / 2;
  return w == 0 ? make_int2(t0, mid) : make_int2(mid, t1);
}

// The producer warpgroup. Warp 0's first lane loads the block's resident
// rows (r0m into res0, r1m into res1, rows res_row ..) once; then warp w
// feeds consumer warpgroup w's ring with its half of the streamed tiles
// [t0, t1) of m0 (into tile0) and m1 (into tile1), its first lane issuing
// the TMA loads. With kStats the warp's lanes also write each stage's lse
// (in base 2) and di for the tile's q rows, and arrive on its full0.
template <int D, bool kStats>
__device__ __forceinline__ void produce(const Smem<D>& sm, const BwdParams& p,
                                        const CUtensorMap* r0m,
                                        const CUtensorMap* r1m,
                                        const CUtensorMap* m0, const CUtensorMap* m1,
                                        int t0, int t1, int res_row, int h, int b) {
  const int warp = threadIdx.x / 32 - kWarpgroups * 4, lane = threadIdx.x % 32;
  if (warp >= kWarpgroups) return;
  if (warp == 0 && lane == 0 && t1 > t0) {
    mbar_expect_tx(sm.res_full(), 2 * Cfg<D>::kTileBytes);
#pragma unroll
    for (int x = 0; x < Cfg<D>::kBoxes; ++x) {
      tma_load(sm.res0() + x * kTile * kRowBytes, r0m, sm.res_full(), x * kBoxCols, h,
               res_row, b);
      tma_load(sm.res1() + x * kTile * kRowBytes, r1m, sm.res_full(), x * kBoxCols, h,
               res_row, b);
    }
  }
  const int2 range = tile_range(warp, t0, t1);
  const long long stat = (static_cast<long long>(b) * p.H + h) * p.Tq;
  for (int t = range.x; t < range.y; ++t) {
    const int j = t - range.x, s = j % kStages, r = t * kTile;
    mbar_wait(sm.empty(warp, s), ((j / kStages) & 1) ^ 1);
    if (lane == 0) {
      sm.load_tile(sm.tile0(warp, s), m0, sm.full0(warp, s), h, r, b);
      sm.load_tile(sm.tile1(warp, s), m1, sm.full1(warp, s), h, r, b);
    }
    if (kStats) {
      float* st = sm.stats(warp, s);
      for (int i = lane; i < kTile; i += 32) {
        const bool in = r + i < p.Tq;
        st[i] = in ? p.lse[stat + r + i] * kLog2e : 0.f;
        st[kTile + i] = in ? p.di[stat + r + i] : 0.f;
      }
      mbar_arrive(sm.full0(warp, s));
    }
  }
}

// d = a b^T over D, issued (not committed): a the block's 64 resident rows
// of one operand, b the 64 rows of a ring tile, both K-major
template <int D>
__device__ __forceinline__ void ss_product(float (&d)[32], uint32_t a_at,
                                           uint32_t b_at) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kTile * kRowBytes + (kk % 4) * 32;  // 16 columns
    wgmma_m64n64k16_ss(d, desc_lo(a_at + off, 16), desc_lo(b_at + off, 16), kk > 0);
  }
}

// d += x b, issued (not committed): x a 64 x 64 accumulator packed as bf16
// A fragments, b a ring tile (64 rows x D) read MN-major
template <int D>
__device__ __forceinline__ void rs_product(float (&d)[D / 2], const uint32_t (&x)[16],
                                           uint32_t b_at) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3]};
    RsMma<D>::mma(d, a, desc_lo(b_at + kk * 16 * kRowBytes, kTile * kRowBytes));
  }
}

// Warpgroup 0's acc += warpgroup 1's, always in that order (deterministic).
template <int D>
__device__ __forceinline__ void sum_partials(float (&acc)[D / 2], const Smem<D>& sm,
                                             int wg, int tid) {
  float* part = sm.partial();
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i * 128 + tid] = acc[i];
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWarpgroups * 128) : "memory");
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += part[i * 128 + tid];
  }
}

// rows row0 and row0 + 8 (< T) of a contiguous (B, T, H, D) output from a
// warpgroup's 64 x D accumulator
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           int row0, int T, int H, int b, int h,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    if (row >= T) continue;
    bf16* o = out + ((static_cast<long long>(b) * T + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(o + c * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * c + 2 * j], acc[4 * c + 2 * j + 1]);
  }
}

// Accumulator entry i of a thread holds row (i / 2) % 2 (of its two rows)
// and column (i / 4) * 8 + 2 * t4 + i % 2 of the warpgroup's 64 x 64 tile.
__device__ __forceinline__ int acc_col(int i, int t4) {
  return (i / 4) * 8 + 2 * t4 + (i % 2);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // resident q (res0) and do (res1); rings of k (tile0) and v (tile1)
  const Smem<D> sm = block_smem<D>(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  int n_tiles = (p.Tk + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, q0 / kTile + 1);  // the last row's diagonal

  if (threadIdx.x == 0) sm.init(1);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWarpgroups) {
    setmaxnreg_dec<Cfg<D>::kProducerRegs>();
    produce<D, false>(sm, p, &p.tq, &p.tdo, &p.tk, &p.tv, 0, n_tiles, q0, h, b);
    return;
  }
  // consumer warpgroup wg: its half of the k tiles, for all 64 q rows
  setmaxnreg_inc<Cfg<D>::kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row0 = q0 + (tid / 32) * 16 + lane / 4;  // fragment rows row0, row0 + 8
  float lse2[2], di[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + 8 * j;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Tq + row;
    lse2[j] = row < p.Tq ? p.lse[at] * kLog2e : 0.f;
    di[j] = row < p.Tq ? p.di[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const int2 range = tile_range(wg, 0, n_tiles);
  if (range.y > range.x) mbar_wait(sm.res_full(), 0);
  float s[32], dp[32];
  uint32_t ds[16];
  for (int kt = range.x; kt < range.y; ++kt) {
    const int j = kt - range.x, st = j % kStages, k0 = kt * kTile;
    const uint32_t ph = (j / kStages) & 1;
    mbar_wait(sm.full0(wg, st), ph);
    mbar_wait(sm.full1(wg, st), ph);
    wgmma_fence();
    ss_product<D>(s, sm.res0(), sm.tile0(wg, st));  // s = q k^T
    wgmma_commit();
    ss_product<D>(dp, sm.res1(), sm.tile1(wg, st));  // dp = do v^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = ex2(fmaf(s[i], p.scale_log2, -lse2[(i / 2) % 2]));
    if (k0 + kTile > p.Tk || (p.causal && k0 + kTile - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + acc_col(i, t4);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (col >= p.Tk || (p.causal && col > row)) s[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // ds = p (dp - di) scale in place in dp, then as bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - di[(i / 2) % 2]) * p.scale;
#pragma unroll
    for (int i = 0; i < 16; ++i) ds[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    wgmma_fence();
    rs_product<D>(dq, ds, sm.tile0(wg, st));  // dq += cast(ds) k
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(sm.empty(wg, st));
  }
  sum_partials<D>(dq, sm, wg, tid);
  if (wg == 0) store_rows<D>(p.out, dq, row0, p.Tq, p.H, b, h, t4);
}

// A dK/dV consumer warpgroup's loop over its q tiles [lo, hi):
// dv += cast(p^T) do (kDk false), or dk += cast(ds^T) q (kDk true), into acc.
template <int D, bool kDk>
__device__ __forceinline__ void dkv_pass(float (&acc)[D / 2], const Smem<D>& sm,
                                         const BwdParams& p, int wg, int lo, int hi,
                                         int kv0, int row0, int t4, int lane) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t a[16];
  for (int qt = lo; qt < hi; ++qt) {
    const int j = qt - lo, st = j % kStages, q0 = qt * kTile;
    const uint32_t ph = (j / kStages) & 1;
    const float* lse2 = sm.stats(wg, st);  // by column
    const float* di = lse2 + kTile;
    mbar_wait(sm.full0(wg, st), ph);
    mbar_wait(sm.full1(wg, st), ph);
    wgmma_fence();
    ss_product<D>(s, sm.res0(), sm.tile0(wg, st));  // s^T = k q^T
    wgmma_commit();
    if (kDk) {
      ss_product<D>(dp, sm.res1(), sm.tile1(wg, st));  // dp^T = v do^T
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + acc_col(i, t4));
      s[i] = ex2(fmaf(s[i], p.scale_log2, -l.x));
      s[i + 1] = ex2(fmaf(s[i + 1], p.scale_log2, -l.y));
    }
    if (q0 + kTile > p.Tq || (p.causal && q0 < kv0 + kTile - 1)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = q0 + acc_col(i, t4);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (col >= p.Tq || (p.causal && row > col)) s[i] = 0.f;
      }
    }
    if (kDk) {
      wgmma_wait<0>();
      fence_regs(dp);
      // ds^T = p^T (dp^T - di) scale in place in dp, then as bf16 A fragments
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 d = *reinterpret_cast<const float2*>(di + acc_col(i, t4));
        dp[i] = s[i] * (dp[i] - d.x) * p.scale;
        dp[i + 1] = s[i + 1] * (dp[i + 1] - d.y) * p.scale;
        a[i / 2] = pack_bf16(dp[i], dp[i + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
    wgmma_fence();
    // dk += cast(ds^T) q, or dv += cast(p^T) do
    rs_product<D>(acc, a, kDk ? sm.tile0(wg, st) : sm.tile1(wg, st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(sm.empty(wg, st));
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // resident k (res0) and v (res1); rings of q (tile0) and do (tile1) with
  // the q rows' statistics. The first half of the grid's x blocks sum dk,
  // the second dv, each over the same 64 kv rows.
  const Smem<D> sm = block_smem<D>(smem_raw);
  const int blocks = gridDim.x / 2;
  const bool dk_block = blockIdx.x < blocks;
  const int b = blockIdx.z, h = blockIdx.y, kv0 = (blockIdx.x % blocks) * kTile;
  const int n_tiles = (p.Tq + kTile - 1) / kTile;
  // causal: q rows below kv0 see none of this block's kv rows
  const int first = p.causal ? min(kv0 / kTile, n_tiles) : 0;

  // full0 completes on the producer warp's 32 arrivals after it wrote the
  // statistics, and on one more with the q tile's bytes
  if (threadIdx.x == 0) sm.init(33);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWarpgroups) {
    setmaxnreg_dec<Cfg<D>::kProducerRegs>();
    produce<D, true>(sm, p, &p.tk, &p.tv, &p.tq, &p.tdo, first, n_tiles, kv0, h, b);
    return;
  }
  // consumer warpgroup wg: its half of the q tiles, for all 64 kv rows
  setmaxnreg_inc<Cfg<D>::kConsumerRegs>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t4 = lane % 4;
  const int row0 = kv0 + (tid / 32) * 16 + lane / 4;  // fragment rows row0, row0 + 8
  const int2 range = tile_range(wg, first, n_tiles);
  if (range.y > range.x) mbar_wait(sm.res_full(), 0);
  float acc[D / 2];
  if (dk_block)
    dkv_pass<D, true>(acc, sm, p, wg, range.x, range.y, kv0, row0, t4, lane);
  else
    dkv_pass<D, false>(acc, sm, p, wg, range.x, range.y, kv0, row0, t4, lane);
  sum_partials<D>(acc, sm, wg, tid);
  if (wg == 0) store_rows<D>(dk_block ? p.out : p.out2, acc, row0, p.Tk, p.H, b, h, t4);
}

template <int D, bool kDkv>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* out, void* out2,
           const long long* st, int B, int H, int Tq, int Tk, int causal,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = kDkv ? flash_bwd_dkv_sm90<D> : flash_bwd_dq_sm90<D>;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  BwdParams p;
  int rc = encode(fn, &p.tq, q, st, B, Tq, H, D, kTile);
  if (!rc) rc = encode(fn, &p.tk, k, st + 3, B, Tk, H, D, kTile);
  if (!rc) rc = encode(fn, &p.tv, v, st + 6, B, Tk, H, D, kTile);
  if (!rc) rc = encode(fn, &p.tdo, dout, st + 9, B, Tq, H, D, kTile);
  if (rc) return rc;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.out = static_cast<bf16*>(out);
  p.out2 = static_cast<bf16*>(out2);
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  // dK/dV: a dk block and a dv block per 64 kv rows
  const dim3 grid(((kDkv ? Tk : Tq) + kTile - 1) / kTile * (kDkv ? 2 : 1), H, B);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDkv>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* di, void* out, void* out2,
             const long long* strides, int B, int H, int Tq, int Tk, int D,
             int causal, float scale, void* stream) {
  if ((D != 64 && D != 128) || B < 1 || H < 1 || Tq < 1 || Tk < 1 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, kDkv>(q, k, v, dout, lse, di, out, out2, strides, B, H, Tq,
                            Tk, causal, scale, s);
  return launch<128, kDkv>(q, k, v, dout, lse, di, out, out2, strides, B, H, Tq,
                           Tk, causal, scale, s);
}

}  // namespace

// q, k, v, do: bf16 (B, T, H, D) views with a unit stride over D; strides:
// 12 host int64s, the (b, t, h) element strides of q, k, v and do. lse, di:
// contiguous f32 (B, H, Tq). dk, dv: contiguous bf16 (B, Tk, H, D); dq:
// contiguous bf16 (B, Tq, H, D). D is 64 or 128; any scale. Each returns a
// cudaError_t code (0 on a successful launch), or a code of
// bjt_flash_bwd_sm90_error's own for a tensor map that could not be made.
extern "C" int bjt_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* di, void* dk, void* dv,
                                      const long long* strides, int B, int H,
                                      int Tq, int Tk, int D, int causal,
                                      float scale, void* stream) {
  return dispatch<true>(q, k, v, dout, lse, di, dk, dv, strides, B, H, Tq, Tk, D,
                        causal, scale, stream);
}

extern "C" int bjt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* di, void* dq,
                                     const long long* strides, int B, int H,
                                     int Tq, int Tk, int D, int causal,
                                     float scale, void* stream) {
  return dispatch<false>(q, k, v, dout, lse, di, dq, nullptr, strides, B, H, Tq,
                         Tk, D, causal, scale, stream);
}

extern "C" const char* bjt_flash_bwd_sm90_error(int code) {
  return error_string(code);
}
