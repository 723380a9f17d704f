// Host C++ of the producer's tile-delta encoder (the port's copy of
// bjx_tile_delta and bjx_palettize, blendjax/_native/tiledelta.cpp:24,65).
//
// bjt_tile_delta: the changed-tile scan of TileDeltaEncoder.encode
// (blendjax_torch/ops/tiles.py). It compares a frame with the stream's
// reference one tile row at a time (memcmp over tw*c contiguous bytes) and
// copies out only the changed tiles: exact byte equality, row-major flat
// tile indices, the same result as the numpy twin.
//
// bjt_palettize: the batch palettizer behind palettize_tiles and
// palettize_frames. One linear scan with a small open-addressing table maps
// each c-byte pixel to a palette index; colours are numbered in the order
// they are first seen (the numpy twin numbers them by value).
//
// Built by blendjax_torch/_native/build.py with g++ -O3 and loaded with
// ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// img, ref: h*w*c uint8, C-contiguous. Tiles are th x tw pixels (th divides
// h, tw divides w: the caller checks). idx_out holds (h/th)*(w/tw) int32 and
// tiles_out as many th*tw*c blocks, so nothing overflows. [ty0,ty1) x
// [tx0,tx1) bounds the scan to the tiles the caller knows may have changed
// (the rasterizer's dirty rect); the full grid when there is no such
// promise. Returns the number of changed tiles.
int64_t bjt_tile_delta(const uint8_t* img, const uint8_t* ref,
                       int64_t h, int64_t w, int64_t c,
                       int64_t th, int64_t tw,
                       int64_t ty0, int64_t ty1, int64_t tx0, int64_t tx1,
                       int32_t* idx_out, uint8_t* tiles_out) {
  const int64_t gw = w / tw;
  const int64_t gh = h / th;
  const int64_t row_bytes = w * c;     // one image row
  const int64_t trow_bytes = tw * c;   // one tile row
  ty0 = std::max<int64_t>(ty0, 0); ty1 = std::min<int64_t>(ty1, gh);
  tx0 = std::max<int64_t>(tx0, 0); tx1 = std::min<int64_t>(tx1, gw);
  int64_t count = 0;
  for (int64_t ty = ty0; ty < ty1; ++ty) {
    for (int64_t tx = tx0; tx < tx1; ++tx) {
      const int64_t base = (ty * th) * row_bytes + tx * trow_bytes;
      bool changed = false;
      for (int64_t y = 0; y < th; ++y) {
        if (std::memcmp(img + base + y * row_bytes,
                        ref + base + y * row_bytes, trow_bytes) != 0) {
          changed = true;
          break;
        }
      }
      if (!changed) continue;
      idx_out[count] = (int32_t)(ty * gw + tx);
      uint8_t* dst = tiles_out + count * th * trow_bytes;
      for (int64_t y = 0; y < th; ++y) {
        std::memcpy(dst + y * trow_bytes, img + base + y * row_bytes,
                    trow_bytes);
      }
      ++count;
    }
  }
  return count;
}

// px: n pixels of c <= 4 bytes (each zero-padded into a uint32 key).
// Returns the palette size (palette_out receives size*c bytes, idx_out one
// byte per pixel), or -1 when more than `cap` (<= 256) distinct colours
// occur: the caller then ships raw tiles.
int64_t bjt_palettize(const uint8_t* px, int64_t n, int64_t c,
                      int64_t cap, uint8_t* palette_out,
                      uint8_t* idx_out) {
  if (cap > 256 || c > 4) return -1;  // uint8 indices; fixed tables
  // table size: the power of two >= 4*cap (cap 256 -> 1024 slots)
  int64_t tsize = 1;
  while (tsize < cap * 4) tsize <<= 1;
  const int64_t mask = tsize - 1;
  uint32_t keys[1024];
  int16_t vals[1024];
  for (int64_t i = 0; i < tsize; ++i) vals[i] = -1;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t key = 0;
    for (int64_t j = 0; j < c; ++j)
      key |= (uint32_t)px[i * c + j] << (8 * j);
    int64_t h = (int64_t)((key * 2654435761u) & mask);
    for (;;) {  // linear probing
      if (vals[h] < 0) {
        if (count == cap) return -1;
        keys[h] = key;
        vals[h] = (int16_t)count;
        for (int64_t j = 0; j < c; ++j)
          palette_out[count * c + j] = px[i * c + j];
        ++count;
        break;
      }
      if (keys[h] == key) break;
      h = (h + 1) & mask;
    }
    idx_out[i] = (uint8_t)vals[h];
  }
  return count;
}

}  // extern "C"
