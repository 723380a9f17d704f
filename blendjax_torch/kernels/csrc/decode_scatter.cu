// K2: slot-scatter tile-delta decode for Hopper (sm_90a).
//
// Replaces blendjax/ops/tiles.py:_pallas_decode_scatter (the Pallas TPU
// kernel of square-tile streams).
//
// What it computes, bit-exactly: slots (B, N, th*tw*C) uint8, which the
// caller initialised to the reference tiles broadcast over B (outside
// the kernel, as the JAX package does outside pallas_call); block (b, k)
// copies tile k of frame b into slot idx[b, k]. The caller permutes the
// slots to frames.
//
// The TPU kernel needed a padded slot N to absorb sentinel writes
// (its output index map must stay in bounds); here each block reads its
// own index and skips the sentinel N (and anything outside [0, N)), so
// no pad slot exists. Indices are unique per row by contract.
//
// What bounds it: bytes (one read and one write of each changed tile, no
// arithmetic). Tiles move as 16-byte uint4 copies when th*tw*C % 16 == 0
// and the buffers are 16-byte aligned (the wrapper checks); other sizes
// take the byte-wide instance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename V>
__global__ void scatter_tiles(const int32_t* __restrict__ idx,
                              const uint8_t* __restrict__ tiles,
                              uint8_t* __restrict__ slots, int K, int N,
                              int tile_bytes) {
  const int64_t bk = blockIdx.x;  // b * K + k
  const int64_t b = bk / K;
  const int32_t s = idx[bk];
  if (s < 0 || s >= N) return;  // sentinel: nothing to write
  const V* src = reinterpret_cast<const V*>(tiles + bk * tile_bytes);
  V* dst = reinterpret_cast<V*>(slots + (b * N + s) * tile_bytes);
  const int n = tile_bytes / static_cast<int>(sizeof(V));
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
}

int threads_for(int items) {
  int t = ((items + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

}  // namespace

extern "C" int bjt_decode_scatter(const void* idx, const void* tiles,
                                  void* slots, int B, int K, int N,
                                  int tile_bytes, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = static_cast<unsigned int>(
      static_cast<int64_t>(B) * K);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const uint8_t* t = static_cast<const uint8_t*>(tiles);
  uint8_t* o = static_cast<uint8_t*>(slots);
  if (vec16) {
    scatter_tiles<uint4><<<blocks, threads_for(tile_bytes / 16), 0, s>>>(
        i, t, o, K, N, tile_bytes);
  } else {
    scatter_tiles<uint8_t><<<blocks, threads_for(tile_bytes), 0, s>>>(
        i, t, o, K, N, tile_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bjt_decode_scatter_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
