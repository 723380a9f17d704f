// K2: slot-scatter tile-delta decode for Hopper (sm_90a).
//
// Replaces blendjax/ops/tiles.py:_pallas_decode_scatter (the Pallas TPU
// kernel of square-tile streams).
//
// What it computes, bit-exactly: slots (B, N, th*tw*C) uint8 in which slot
// s of frame b holds changed tile k of frame b where idx[b, k] == s, and
// reference tile s everywhere else. Sentinels (N) and any index outside
// [0, N) write nothing; indices are unique per row by contract. The
// caller permutes the slots to frames.
//
// The TPU kernel DMAs each changed tile into a reference-initialised
// buffer through a data-dependent output index map, with a padded slot N
// to absorb sentinel writes. Here one launch writes every slot exactly
// once, reference or changed tile, so the slots need no initialisation
// and no pad slot: block (r, b) owns the run of kSlots slots r*kSlots..
// of frame b. It reads its row's K indices and builds its own inverse map
// (slot -> k, or none) in shared memory, then copies its kSlots tiles
// with 16-byte loads and stores, kUnroll loads in flight per thread.
//
// What bounds it: bytes. Each slot is written once (39.3 MB at B 32,
// N 1200, 16x16x4); each changed tile is read once; the reference
// (1.2 MB) is read once per frame but stays in the 50 MB L2; the row's
// indices (1,152 bytes at K 288) are re-read by each of the row's blocks,
// a few percent of a block's 16 KB of output. Tiles move as uint4 when
// th*tw*C % 16 == 0 and the buffers are 16-byte aligned (the wrapper
// checks); other sizes take the byte-wide instance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 16;    // slots per block
constexpr int kThreads = 256;
constexpr int kUnroll = 4;    // loads in flight per thread

template <typename V>
__global__ void __launch_bounds__(kThreads)
    scatter_slots(const uint8_t* __restrict__ ref,
                  const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ tiles,
                  uint8_t* __restrict__ slots, int K, int N, int tile_bytes) {
  __shared__ int inv[kSlots];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kSlots;
  const int ns = min(kSlots, N - s0);
  if (threadIdx.x < kSlots) inv[threadIdx.x] = -1;
  __syncthreads();
  const int32_t* row = idx + static_cast<int64_t>(b) * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int s = row[k];
    if (s >= s0 && s < s0 + ns) inv[s - s0] = k;
  }
  __syncthreads();

  const int per = tile_bytes / static_cast<int>(sizeof(V));  // vectors per tile
  const int total = ns * per;
  const V* ref_v = reinterpret_cast<const V*>(ref);
  const V* tiles_v = reinterpret_cast<const V*>(tiles);
  V* out = reinterpret_cast<V*>(slots) + (static_cast<int64_t>(b) * N + s0) * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kUnroll) {
    V x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        const int j = i / per;
        const int k = inv[j];
        const V* src = k >= 0
            ? tiles_v + (static_cast<int64_t>(b) * K + k) * per
            : ref_v + static_cast<int64_t>(s0 + j) * per;
        x[u] = src[i - j * per];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) out[i] = x[u];
    }
  }
}

}  // namespace

extern "C" int bjt_decode_scatter(const void* ref, const void* idx,
                                  const void* tiles, void* slots, int B, int K,
                                  int N, int tile_bytes, int vec16,
                                  void* stream) {
  if (B < 1 || N < 1 || B > 65535 || K < 0 || tile_bytes < 1 ||
      (vec16 && tile_bytes % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kSlots - 1) / kSlots, B);
  const uint8_t* r = static_cast<const uint8_t*>(ref);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const uint8_t* t = static_cast<const uint8_t*>(tiles);
  uint8_t* o = static_cast<uint8_t*>(slots);
  if (vec16)
    scatter_slots<uint4><<<grid, kThreads, 0, s>>>(r, i, t, o, K, N, tile_bytes);
  else
    scatter_slots<uint8_t><<<grid, kThreads, 0, s>>>(r, i, t, o, K, N, tile_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bjt_decode_scatter_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
