// K3: uint8 -> gamma-corrected [0, 1] for Hopper (sm_90a).
//
// Replaces blendjax/ops/image.py:_pallas_gamma_normalize (the Pallas TPU
// kernel behind uint8_gamma_normalize).
//
// What it computes: out[i] = cast((float(x[i]) * scale) ** inv_gamma)
// over any number of uint8 elements (the NHWC frame read as one flat
// row), with scale = f32(1/255) and inv_gamma = f32(1/gamma) as the
// Pallas body does (blendjax/ops/image.py:64-67). The output type is f32
// or bf16 (round to nearest even, __float2bfloat16_rn).
//
// What bounds it: bytes. It reads each input byte once and writes each
// output once: 1 + 4 bytes per element for f32, 1 + 2 for bf16. The
// arithmetic is a table lookup: a uint8 input has only 256 values, so each
// block fills a 256-entry table in shared memory with the accurate powf of
// every value (never __powf), one entry per thread.
//
// Design, for a store-heavy stream (four output bytes per input byte):
// - Every store instruction is warp-contiguous. The buffer is read as
//   32-bit words; lane t of a warp loads word j*32+t and writes that
//   word's four outputs as one 16-byte float4 (or 8-byte packed bf16)
//   store at output word j*32+t, so a warp writes 512 (256) contiguous
//   bytes per instruction and every 32-byte sector is written whole.
// - No ragged last round. The grid is the number of blocks that are
//   resident at once (SMs x the occupancy calculator's blocks per SM, fewer
//   for a small buffer), and each block owns one contiguous equal share of
//   the words (a multiple of 32), so every SM streams the same amount and
//   they finish together.
// - Several loads in flight per thread: each thread loads kUnroll words
//   of its block's next group before it stores the current group's
//   outputs, and the first group's loads are issued before the table
//   fill and its __syncthreads, so the fill hides under their latency.
// - Stores are evict-first (st.global.cs): nothing here reads the output
//   again, and on the echo batch they beat plain stores by a fifth.
// A buffer whose pointers are not word-aligned (a uint8 view at an odd
// offset) takes a plain grid-stride loop over single elements.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // words loaded per thread ahead of its stores

template <bool kBf16>
struct Out;

template <>
struct Out<false> {  // four f32
  using Vec = float4;
  __device__ static Vec make(uint32_t w, const float* lut, const uint32_t*) {
    return make_float4(lut[w & 255u], lut[(w >> 8) & 255u],
                       lut[(w >> 16) & 255u], lut[w >> 24]);
  }
};

template <>
struct Out<true> {  // four bf16, packed two to a word
  using Vec = uint2;
  __device__ static Vec make(uint32_t w, const float*, const uint32_t* lut) {
    return make_uint2(lut[w & 255u] | (lut[(w >> 8) & 255u] << 16),
                      lut[(w >> 16) & 255u] | (lut[w >> 24] << 16));
  }
};

__device__ __forceinline__ void fill_tables(float* lut, uint32_t* lut_bf16,
                                            float scale, float inv_gamma) {
  const float v = powf(static_cast<float>(threadIdx.x) * scale, inv_gamma);
  lut[threadIdx.x] = v;
  lut_bf16[threadIdx.x] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  __syncthreads();
}

template <bool kBf16>
__device__ __forceinline__ void store_element(void* out, int64_t i, uint8_t b,
                                              const float* lut,
                                              const uint32_t* lut_bf16) {
  if (kBf16) {
    reinterpret_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(lut_bf16[b]);
  } else {
    reinterpret_cast<float*>(out)[i] = lut[b];
  }
}

// Word-aligned buffers: n / 4 words in equal contiguous shares per block,
// then the last n % 4 elements by block 0.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
gamma_words(const uint32_t* __restrict__ x, void* __restrict__ out,
            int64_t n, int64_t share, float scale, float inv_gamma) {
  __shared__ float lut[256];
  __shared__ uint32_t lut_bf16[256];  // bf16 bits in the low half
  using Vec = typename Out<kBf16>::Vec;
  Vec* o = reinterpret_cast<Vec*>(out);
  const int64_t words = n / 4;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * share;
  const int64_t end = start + share < words ? start + share : words;
  constexpr int64_t kGroup = static_cast<int64_t>(kThreads) * kUnroll;

  uint32_t w[kUnroll] = {};
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = start + u * kThreads + threadIdx.x;
    if (i < end) w[u] = x[i];
  }
  fill_tables(lut, lut_bf16, scale, inv_gamma);

  for (int64_t base = start; base < end; base += kGroup) {
    uint32_t cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = w[u];
    const int64_t next = base + kGroup;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = next + u * kThreads + threadIdx.x;
      if (i < end) w[u] = x[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      if (i < end) {
        __stcs(o + i, Out<kBf16>::make(cur[u], lut, lut_bf16));
      }
    }
  }

  if (blockIdx.x == 0 && threadIdx.x < n - words * 4) {
    const int64_t i = words * 4 + threadIdx.x;
    store_element<kBf16>(out, i, reinterpret_cast<const uint8_t*>(x)[i], lut,
                         lut_bf16);
  }
}

// Any alignment: one element per thread, grid-stride.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
gamma_bytes(const uint8_t* __restrict__ x, void* __restrict__ out, int64_t n,
            float scale, float inv_gamma) {
  __shared__ float lut[256];
  __shared__ uint32_t lut_bf16[256];
  fill_tables(lut, lut_bf16, scale, inv_gamma);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    store_element<kBf16>(out, i, x[i], lut, lut_bf16);
  }
}

template <bool kBf16>
void launch_words(const void* x, void* out, int64_t n, int sms, float scale,
                  float inv_gamma, cudaStream_t s) {
  static int per_sm = 0;  // resident blocks per SM, asked once per instance
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gamma_words<kBf16>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t max_blocks = static_cast<int64_t>(sms) * per_sm;
  const int64_t words = n / 4;
  // blocks with at least one full group of work, at most the resident grid
  int64_t blocks = (words + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  int64_t share = (words + blocks - 1) / blocks;
  share = (share + 31) / 32 * 32;  // whole warps: every store full-width
  gamma_words<kBf16><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(x), out, n, share, scale, inv_gamma);
}

}  // namespace

// dtype: 0 = f32 output, 1 = bf16 output. words: x is 4-byte and out
// 16-byte aligned (the word path); else the element path. sms: the card's
// SM count. Returns a cudaError_t (0 = ok).
extern "C" int bjt_gamma_normalize(const void* x, void* out, long long n,
                                   int dtype, int words, float scale,
                                   float inv_gamma, int sms, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words) {
    if (dtype == 1) {
      launch_words<true>(x, out, n, sms, scale, inv_gamma, s);
    } else {
      launch_words<false>(x, out, n, sms, scale, inv_gamma, s);
    }
  } else {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    const int64_t max_blocks = static_cast<int64_t>(sms) * 8;
    if (blocks > max_blocks) blocks = max_blocks;
    const uint8_t* in = static_cast<const uint8_t*>(x);
    if (dtype == 1) {
      gamma_bytes<true><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
          in, out, n, scale, inv_gamma);
    } else {
      gamma_bytes<false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
          in, out, n, scale, inv_gamma);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bjt_gamma_normalize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
