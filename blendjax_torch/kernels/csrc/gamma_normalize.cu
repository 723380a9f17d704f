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
// Design: a uint8 input has only 256 values, so each block first fills a
// 256-entry table in shared memory with the accurate powf of every value
// (never __powf), one entry per thread, then every element is a table
// lookup. Each thread of a grid-stride loop loads 16 input bytes in one
// 16-byte load and writes 16 outputs: four float4 stores for f32, or two
// 16-byte stores of packed bf16 pairs. A scalar loop takes the tail (and
// every element when the wrapper finds a buffer that is not 16-byte
// aligned), so any element count works.
//
// What bounds it: bytes. It reads each input byte once and writes each
// output once (1 + 4 bytes per element for f32, 1 + 2 for bf16); the
// 256 powf per block are noise. Making it fast is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
gamma_normalize(const uint8_t* __restrict__ x, void* __restrict__ out,
                int64_t n, int vec16, float scale, float inv_gamma) {
  __shared__ float lut[256];
  __shared__ uint32_t lut_bf16[256];  // bf16 bits in the low half
  {
    const float v = powf(static_cast<float>(threadIdx.x) * scale, inv_gamma);
    lut[threadIdx.x] = v;
    lut_bf16[threadIdx.x] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nvec = vec16 ? n / 16 : 0;
  for (int64_t i = tid; i < nvec; i += stride) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if (kBf16) {
      uint32_t p[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = w[j];
        p[2 * j] = lut_bf16[b & 255u] | (lut_bf16[(b >> 8) & 255u] << 16);
        p[2 * j + 1] = lut_bf16[(b >> 16) & 255u] | (lut_bf16[b >> 24] << 16);
      }
      uint4* o = reinterpret_cast<uint4*>(out) + i * 2;
      o[0] = make_uint4(p[0], p[1], p[2], p[3]);
      o[1] = make_uint4(p[4], p[5], p[6], p[7]);
    } else {
      float4* o = reinterpret_cast<float4*>(out) + i * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = w[j];
        o[j] = make_float4(lut[b & 255u], lut[(b >> 8) & 255u],
                           lut[(b >> 16) & 255u], lut[b >> 24]);
      }
    }
  }
  for (int64_t i = nvec * 16 + tid; i < n; i += stride) {
    const uint8_t b = x[i];
    if (kBf16) {
      reinterpret_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(lut_bf16[b]);
    } else {
      reinterpret_cast<float*>(out)[i] = lut[b];
    }
  }
}

}  // namespace

// dtype: 0 = f32 output, 1 = bf16 output. Returns a cudaError_t (0 = ok).
extern "C" int bjt_gamma_normalize(const void* x, void* out, long long n,
                                   int dtype, int vec16, float scale,
                                   float inv_gamma, int max_blocks,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t per_block = static_cast<int64_t>(kThreads) * (vec16 ? 16 : 1);
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > max_blocks) blocks = max_blocks;
  const uint8_t* in = static_cast<const uint8_t*>(x);
  if (dtype == 1) {
    gamma_normalize<true><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        in, out, n, vec16, scale, inv_gamma);
  } else {
    gamma_normalize<false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        in, out, n, vec16, scale, inv_gamma);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bjt_gamma_normalize_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
