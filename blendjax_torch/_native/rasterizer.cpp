// Host C++ of the producer's rasterizer (the port's copy of bjx_clear,
// bjx_clear_rect and bjx_render_frame, blendjax/_native/rasterizer.cpp:42,
// 56, 179).
//
// bjt_render_frame renders a whole frame of the cube scene in one call:
// projection, flat shading, near-plane culling, the dirty-rect clear and a
// span-solved scanline fill with a float32 z-buffer. The same math as the
// numpy twin (blendjax_torch/producer/sim.py Rasterizer with native=False),
// which evaluates the barycentric weights per pixel: the two agree except
// for rounding at triangle-edge pixels.
//
// Built by blendjax_torch/_native/build.py with g++ -O3 and loaded with
// ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>
#include <vector>

// The color buffer contract is BYTE-ordered RGBA. A uint32 store writes
// its bytes in native order, so the packed fill pattern must be built by
// memcpy from the byte quad — identical bytes land on either endianness
// (and on little-endian this compiles to the same single 32-bit load a
// shift-or would).
static inline uint32_t rgba_pattern(const uint8_t* rgba) {
  uint32_t pat;
  std::memcpy(&pat, rgba, 4);
  return pat;
}

extern "C" {

// Clear the frame: color <- rgba pattern, zbuf <- +inf. The two buffers
// total ~2.4MB at 640x480, which costs more than the fill itself when
// cleared through numpy broadcasting.
void bjt_clear(uint8_t* color, float* zbuf, int64_t h, int64_t w,
               const uint8_t* rgba) {
  const int64_t n = h * w;
  const uint32_t pat = rgba_pattern(rgba);
  uint32_t* c32 = reinterpret_cast<uint32_t*>(color);
  std::fill(c32, c32 + n, pat);
  const float inf = std::numeric_limits<float>::infinity();
  std::fill(zbuf, zbuf + n, inf);
}

// Clear only rows [y0,y1) x cols [x0,x1) — the dirty-rect fast path:
// when the caller knows which region the previous frame touched, the
// rest of the frame is already background and clearing it again is
// wasted bandwidth (the full clear moves ~2.4MB/frame at 640x480).
void bjt_clear_rect(uint8_t* color, float* zbuf, int64_t h, int64_t w,
                    const uint8_t* rgba, int64_t y0, int64_t y1,
                    int64_t x0, int64_t x1) {
  y0 = std::max<int64_t>(y0, 0); y1 = std::min<int64_t>(y1, h);
  x0 = std::max<int64_t>(x0, 0); x1 = std::min<int64_t>(x1, w);
  if (y0 >= y1 || x0 >= x1) return;
  const uint32_t pat = rgba_pattern(rgba);
  const float inf = std::numeric_limits<float>::infinity();
  const int64_t span = x1 - x0;
  for (int64_t y = y0; y < y1; ++y) {
    uint32_t* c32 = reinterpret_cast<uint32_t*>(color) + y * w + x0;
    std::fill(c32, c32 + span, pat);
    float* z = zbuf + y * w + x0;
    std::fill(z, z + span, inf);
  }
}

// One triangle's span-solved scanline fill (the full-frame renderer's
// inner loop). px6 = (x0,y0,x1,y1,x2,y2)
// pixel coords, z3 = per-vertex view depths, cpat = packed RGBA fill.
static void fill_one(const double* px6, const double* z3, uint32_t cpat,
                     uint8_t* color, float* zbuf, int64_t h, int64_t w) {
  {
    const double x0 = px6[0], y0 = px6[1];
    const double x1 = px6[2], y1 = px6[3];
    const double x2 = px6[4], y2 = px6[5];
    const double z0 = z3[0], z1 = z3[1], z2 = z3[2];

    const double area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    if (std::fabs(area) < 1e-12) return;
    const double inv_area = 1.0 / area;

    int64_t xmin = (int64_t)std::floor(std::min({x0, x1, x2}));
    int64_t xmax = (int64_t)std::ceil(std::max({x0, x1, x2})) + 1;
    int64_t ymin = (int64_t)std::floor(std::min({y0, y1, y2}));
    int64_t ymax = (int64_t)std::ceil(std::max({y0, y1, y2})) + 1;
    xmin = std::max<int64_t>(xmin, 0); xmax = std::min<int64_t>(xmax, w);
    ymin = std::max<int64_t>(ymin, 0); ymax = std::min<int64_t>(ymax, h);
    if (xmin >= xmax || ymin >= ymax) return;

    // Edge functions at the first pixel center, plus per-x / per-y steps
    // (each w_i is affine in gx, gy). Instead of testing every bbox
    // pixel (~half fail the half-plane tests for a typical face), each
    // row's covered span [k0, k1) is solved analytically from the three
    // constraints w_i + k*dw_i >= 0, and the inner loop is one z
    // compare + one 32-bit store per covered pixel (z is affine in x
    // too). Edge pixels can shift by an ulp vs per-pixel evaluation —
    // within the documented rounding tolerance.
    const double sx = (double)xmin + 0.5, sy = (double)ymin + 0.5;
    const double w0_row0 =
        ((x1 - sx) * (y2 - sy) - (x2 - sx) * (y1 - sy)) * inv_area;
    const double w1_row0 =
        ((x2 - sx) * (y0 - sy) - (x0 - sx) * (y2 - sy)) * inv_area;
    const double w0dx = (y1 - y2) * inv_area, w0dy = (x2 - x1) * inv_area;
    const double w1dx = (y2 - y0) * inv_area, w1dy = (x0 - x2) * inv_area;
    const double w2dx = -(w0dx + w1dx);
    const double zdx = w0dx * z0 + w1dx * z1 + w2dx * z2;

    const int64_t span = xmax - xmin;
    for (int64_t y = ymin; y < ymax; ++y) {
      const double dy = (double)(y - ymin);
      const double w0r = w0_row0 + dy * w0dy;
      const double w1r = w1_row0 + dy * w1dy;
      const double w2r = 1.0 - w0r - w1r;
      // real-valued bounds on covered ks: lo <= k <= hi
      double lo = 0.0, hi = (double)(span - 1);
      bool empty = false;
      const double wr[3] = {w0r, w1r, w2r};
      const double dw[3] = {w0dx, w1dx, w2dx};
      for (int e = 0; e < 3; ++e) {
        if (dw[e] > 0.0) {
          const double k = -wr[e] / dw[e];  // w(k) >= 0 for k >= this
          if (k > lo) lo = k;
        } else if (dw[e] < 0.0) {
          const double k = -wr[e] / dw[e];  // w(k) >= 0 for k <= this
          if (k < hi) hi = k;
        } else if (wr[e] < 0.0) {
          empty = true;
          break;
        }
      }
      if (empty) continue;
      // Clamp in double BEFORE the casts: a denormal dw makes the ratio
      // overflow int64, and that cast is UB (x86 wraps to INT64_MIN,
      // turning an empty row into a full one).
      if (lo < 0.0) lo = 0.0;
      if (hi > (double)(span - 1)) hi = (double)(span - 1);
      if (lo > hi) continue;
      int64_t k0 = (int64_t)std::ceil(lo);
      int64_t k1 = (int64_t)std::floor(hi) + 1;  // exclusive
      if (k0 >= k1) continue;
      double z = (w0r + k0 * w0dx) * z0 + (w1r + k0 * w1dx) * z1 +
                 (w2r + k0 * w2dx) * z2;
      float* zrow = zbuf + y * w + xmin;
      uint32_t* crow = reinterpret_cast<uint32_t*>(color) + y * w + xmin;
      for (int64_t k = k0; k < k1; ++k) {
        const float zf = (float)z;
        if (zf < zrow[k]) {
          zrow[k] = zf;
          crow[k] = cpat;
        }
        z += zdx;
      }
    }
  }
}

// Full-frame render: projection, flat shading, near-plane cull, clear
// (dirty-rect aware) and fill, all in one call — the producer's per-
// frame Python cost collapses to a single FFI crossing (the numpy glue
// for 12 triangles measurably rivals the fill itself on 1-core hosts).
//
// verts:  n*3*3 float64 world-space triangle vertices
// rgba:   n*4   uint8 UNSHADED fill colors
// light:  3     float64 unit light direction (shade = .35+.65|n.l|)
// view:   16    float64 row-major world->camera matrix
// proj:   16    float64 row-major camera->clip (GL-style) matrix
// clip_near:    cull triangles with any vertex depth <= this
// color/zbuf/h/w/bg: as bjt_clear
// prev_rect: i64[4] (y0,y1,x0,x1) previously drawn rect for a same-
//   buffer re-render; prev_rect[0] == -2 forces a FULL clear (fresh
//   buffer), -1 means "nothing drawn last time" (clear new bbox only)
// out_rect: i64[4] receives the drawn bbox, [0] = -1 when nothing drew
void bjt_render_frame(const double* verts, const uint8_t* rgba, int64_t n,
                      const double* light, const double* view,
                      const double* proj, double clip_near,
                      uint8_t* color, float* zbuf, int64_t h, int64_t w,
                      const uint8_t* bg, const int64_t* prev_rect,
                      int64_t* out_rect) {
  // Project + shade into stack/heap scratch (n is small: one cube = 12).
  std::vector<double> px(n * 6);
  std::vector<double> dz(n * 3);
  std::vector<uint32_t> cpat(n);
  std::vector<uint8_t> vis(n);
  const double pv_w = 0.5 * (double)w;
  int64_t ymin = h, ymax = 0, xmin = w, xmax = 0;
  bool any = false;
  for (int64_t t = 0; t < n; ++t) {
    // flat shade from the world-space normal
    const double* a = verts + t * 9;
    const double e1x = a[3] - a[0], e1y = a[4] - a[1], e1z = a[5] - a[2];
    const double e2x = a[6] - a[0], e2y = a[7] - a[1], e2z = a[8] - a[2];
    double nx = e1y * e2z - e1z * e2y;
    double ny = e1z * e2x - e1x * e2z;
    double nz = e1x * e2y - e1y * e2x;
    const double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    double shade = 0.35;
    if (nn > 1e-12) {
      const double d =
          (nx * light[0] + ny * light[1] + nz * light[2]) / nn;
      shade = 0.35 + 0.65 * std::fabs(d);
    }
    uint8_t sc[4];
    for (int c = 0; c < 3; ++c) {
      const double v = (double)rgba[t * 4 + c] * shade;
      sc[c] = (uint8_t)(v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v));
    }
    sc[3] = rgba[t * 4 + 3];
    cpat[t] = rgba_pattern(sc);

    bool ok = true;
    for (int v3 = 0; v3 < 3; ++v3) {
      const double* p = verts + t * 9 + v3 * 3;
      // camera space (row-major 4x4 times column vector)
      const double cx =
          view[0] * p[0] + view[1] * p[1] + view[2] * p[2] + view[3];
      const double cy =
          view[4] * p[0] + view[5] * p[1] + view[6] * p[2] + view[7];
      const double cz =
          view[8] * p[0] + view[9] * p[1] + view[10] * p[2] + view[11];
      const double depth = -cz;
      if (depth <= clip_near) { ok = false; break; }
      // clip space
      const double qx = proj[0] * cx + proj[1] * cy + proj[2] * cz + proj[3];
      const double qy = proj[4] * cx + proj[5] * cy + proj[6] * cz + proj[7];
      const double qw =
          proj[12] * cx + proj[13] * cy + proj[14] * cz + proj[15];
      const double inv_w = 1.0 / qw;
      // NDC -> pixels, upper-left origin (camera.py ndc_to_pixel)
      const double sx = (qx * inv_w + 1.0) * pv_w;
      const double sy = (1.0 - (qy * inv_w + 1.0) * 0.5) * (double)h;
      px[t * 6 + v3 * 2 + 0] = sx;
      px[t * 6 + v3 * 2 + 1] = sy;
      dz[t * 3 + v3] = depth;
    }
    vis[t] = ok ? 1 : 0;
    if (!ok) continue;
    any = true;
    for (int v3 = 0; v3 < 3; ++v3) {
      const double sx = px[t * 6 + v3 * 2 + 0];
      const double sy = px[t * 6 + v3 * 2 + 1];
      const int64_t fy0 = (int64_t)std::floor(sy);
      const int64_t fx0 = (int64_t)std::floor(sx);
      if (fy0 < ymin) ymin = fy0;
      if (fy0 + 1 > ymax) ymax = fy0 + 2;  // ceil+1 bound, clamped below
      if (fx0 < xmin) xmin = fx0;
      if (fx0 + 1 > xmax) xmax = fx0 + 2;
    }
  }
  int64_t bbox[4] = {-1, -1, -1, -1};
  if (any) {
    if (ymin < 0) ymin = 0;
    if (xmin < 0) xmin = 0;
    if (ymax > h) ymax = h;
    if (xmax > w) xmax = w;
    if (ymin < ymax && xmin < xmax) {
      bbox[0] = ymin; bbox[1] = ymax; bbox[2] = xmin; bbox[3] = xmax;
    }
  }

  // Clear: full for a fresh buffer; union(prev drawn, new bbox) when
  // re-rendering the same target (same induction as Rasterizer._clear).
  if (prev_rect[0] == -2) {
    bjt_clear(color, zbuf, h, w, bg);
  } else {
    int64_t y0 = -1, y1 = -1, x0 = -1, x1 = -1;
    if (prev_rect[0] >= 0) {
      y0 = prev_rect[0]; y1 = prev_rect[1];
      x0 = prev_rect[2]; x1 = prev_rect[3];
    }
    if (bbox[0] >= 0) {
      if (y0 < 0) { y0 = bbox[0]; y1 = bbox[1]; x0 = bbox[2]; x1 = bbox[3]; }
      else {
        y0 = std::min(y0, bbox[0]); y1 = std::max(y1, bbox[1]);
        x0 = std::min(x0, bbox[2]); x1 = std::max(x1, bbox[3]);
      }
    }
    if (y0 >= 0) bjt_clear_rect(color, zbuf, h, w, bg, y0, y1, x0, x1);
  }

  for (int64_t t = 0; t < n; ++t) {
    if (vis[t]) {
      fill_one(px.data() + t * 6, dz.data() + t * 3, cpat[t],
               color, zbuf, h, w);
    }
  }
  out_rect[0] = bbox[0]; out_rect[1] = bbox[1];
  out_rect[2] = bbox[2]; out_rect[3] = bbox[3];
}

}  // extern "C"
