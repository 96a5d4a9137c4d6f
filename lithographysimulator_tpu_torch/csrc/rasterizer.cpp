// Polygon -> pixel-grid rasterizer and boundary-loop tracer: the host
// half of layout import and contour export in lithographysimulator_tpu_torch
// (io/native.py, through ctypes). The port's own copy of the JAX package's
// native/rasterizer.cpp, with the same C interface and the same arithmetic,
// so both packages' rasters agree bit for bit.
//
// Layout ingestion (GDSII/OASIS polygons -> mask grids) is CPU-side data
// loading: tile windows are rasterized on the host and uploaded to the
// card. Scanline even-odd fill with pixel-center sampling: pixel (iy, ix) is
// filled iff its center (x0 + (ix + 0.5) * pixel, y0 + (iy + 0.5) * pixel)
// lies inside an odd number of polygon boundary crossings, the interior of
// a GDSII BOUNDARY element. An anti-aliased variant gives area coverage by
// ss x ss subsampling, for gray-level masks.
//
// Built at first use by io/native.py:
//   g++ -O3 -shared -fPIC -o librasterizer-<hash>.so rasterizer.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Edge {
  double y_min, y_max;   // y range (exclusive of y_max for crossing rule)
  double x_at_ymin;
  double inv_slope;      // dx/dy
};

// Gather non-horizontal edges of one polygon ring.
void collect_edges(const double* xy, int n_pts, std::vector<Edge>& edges) {
  for (int i = 0; i < n_pts; ++i) {
    double x1 = xy[2 * i], y1 = xy[2 * i + 1];
    int j = (i + 1) % n_pts;
    double x2 = xy[2 * j], y2 = xy[2 * j + 1];
    if (y1 == y2) continue;  // horizontal edges never cross a scanline
    Edge e;
    if (y1 < y2) {
      e.y_min = y1; e.y_max = y2; e.x_at_ymin = x1;
    } else {
      e.y_min = y2; e.y_max = y1; e.x_at_ymin = x2;
    }
    e.inv_slope = (x2 - x1) / (y2 - y1);
    edges.push_back(e);
  }
}

// Fill one scanline row at sample height y: accumulate crossings, fill spans.
void fill_row(const std::vector<Edge>& edges, double y, double x0,
              double pixel, int n_cols, float* row, float value) {
  thread_local std::vector<double> xs;
  xs.clear();
  for (const Edge& e : edges) {
    if (y >= e.y_min && y < e.y_max) {
      xs.push_back(e.x_at_ymin + (y - e.y_min) * e.inv_slope);
    }
  }
  if (xs.empty()) return;
  std::sort(xs.begin(), xs.end());
  for (size_t k = 0; k + 1 < xs.size(); k += 2) {
    // span [xs[k], xs[k+1]): pixel centers x0 + (ix + 0.5) * pixel inside
    double lo = (xs[k] - x0) / pixel - 0.5;
    double hi = (xs[k + 1] - x0) / pixel - 0.5;
    int ix_lo = (int)std::ceil(lo);
    int ix_hi = (int)std::ceil(hi);  // exclusive
    ix_lo = std::max(ix_lo, 0);
    ix_hi = std::min(ix_hi, n_cols);
    for (int ix = ix_lo; ix < ix_hi; ++ix) row[ix] = value;
  }
}

}  // namespace

extern "C" {

// xy: concatenated polygon vertices [x0 y0 x1 y1 ...] in layout units (nm).
// poly_sizes: vertex count per polygon. grid: (n, n) float32, row iy maps to
// y = y0 + (iy + 0.5) * pixel (row-major, y down like the mask arrays).
// Returns 0 on success.
int rasterize_polygons(const double* xy, const int32_t* poly_sizes,
                       int32_t n_polys, double x0, double y0, double pixel,
                       int32_t n, float* grid) {
  if (pixel <= 0.0 || n <= 0) return 1;
  const double* cursor = xy;
  for (int32_t p = 0; p < n_polys; ++p) {
    int n_pts = poly_sizes[p];
    if (n_pts < 3) { cursor += 2 * n_pts; continue; }
    std::vector<Edge> edges;
    collect_edges(cursor, n_pts, edges);
    cursor += 2 * n_pts;
    if (edges.empty()) continue;
    double poly_ymin = edges[0].y_min, poly_ymax = edges[0].y_max;
    for (const Edge& e : edges) {
      poly_ymin = std::min(poly_ymin, e.y_min);
      poly_ymax = std::max(poly_ymax, e.y_max);
    }
    int iy_lo = std::max(0, (int)std::floor((poly_ymin - y0) / pixel - 0.5));
    int iy_hi = std::min((int)n, (int)std::ceil((poly_ymax - y0) / pixel));
    for (int iy = iy_lo; iy < iy_hi; ++iy) {
      double y = y0 + (iy + 0.5) * pixel;
      fill_row(edges, y, x0, pixel, n, grid + (size_t)iy * n, 1.0f);
    }
  }
  return 0;
}

// Anti-aliased rasterization: per-pixel coverage by ss x ss subsampling,
// accumulated (clamped to 1) so overlapping polygons don't double-count
// beyond full coverage.
int rasterize_polygons_aa(const double* xy, const int32_t* poly_sizes,
                          int32_t n_polys, double x0, double y0, double pixel,
                          int32_t n, int32_t ss, float* grid) {
  if (pixel <= 0.0 || n <= 0 || ss <= 0) return 1;
  std::vector<float> fine((size_t)n * ss * n * ss, 0.0f);
  double fine_pixel = pixel / ss;
  int rc = rasterize_polygons(xy, poly_sizes, n_polys, x0, y0, fine_pixel,
                              n * ss, fine.data());
  if (rc) return rc;
  float inv = 1.0f / (float)(ss * ss);
  for (int iy = 0; iy < n; ++iy) {
    for (int ix = 0; ix < n; ++ix) {
      float acc = 0.0f;
      for (int sy = 0; sy < ss; ++sy) {
        const float* frow = fine.data() + (size_t)(iy * ss + sy) * n * ss;
        for (int sx = 0; sx < ss; ++sx) acc += frow[ix * ss + sx];
      }
      float v = grid[(size_t)iy * n + ix] + acc * inv;
      grid[(size_t)iy * n + ix] = v > 1.0f ? 1.0f : v;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Boundary-loop tracing (the native half of io/contours.trace_contours):
// directed pixel-edge stitching with the interior kept on the LEFT (outer
// loops CCW, holes CW), checkerboard corners resolved by sharpest left
// turn, collinear runs collapsed. Mirrors the pure-python implementation;
// the python layer owns coordinate scaling and GDS emission.
//
// out_xy receives (x, y) int32 pixel-corner pairs, loop_sizes the vertex
// count per loop. Returns the number of loops, -1 if out_xy overflows,
// -2 if loop_sizes overflows.
int trace_loops(const unsigned char* grid, int h, int w, int32_t* out_xy,
                long long out_cap, int32_t* loop_sizes, long long loops_cap) {
  struct Out {
    int n = 0;
    int32_t tx[2];
    int32_t ty[2];
  };
  std::unordered_map<long long, Out> outs;
  outs.reserve((size_t)(h + w) * 4);
  auto key = [w](int32_t x, int32_t y) {
    return (long long)y * (w + 2) + x;
  };
  auto add_edge = [&](int32_t x0, int32_t y0, int32_t x1, int32_t y1) {
    Out& o = outs[key(x0, y0)];
    o.tx[o.n] = x1;
    o.ty[o.n] = y1;
    ++o.n;
  };
  auto filled = [&](int i, int j) {
    return i >= 0 && i < h && j >= 0 && j < w && grid[(size_t)i * w + j];
  };
  for (int i = 0; i < h; ++i) {
    for (int j = 0; j < w; ++j) {
      if (!grid[(size_t)i * w + j]) continue;
      if (!filled(i - 1, j)) add_edge(j, i, j + 1, i);          // below
      if (!filled(i, j + 1)) add_edge(j + 1, i, j + 1, i + 1);  // right
      if (!filled(i + 1, j)) add_edge(j + 1, i + 1, j, i + 1);  // above
      if (!filled(i, j - 1)) add_edge(j, i + 1, j, i);          // left
    }
  }
  long long n_loops = 0;
  long long out_n = 0;
  while (!outs.empty()) {
    // never START at a checkerboard (degree-2) vertex: with no incoming
    // direction the left-turn rule is ambiguous there and can stitch a
    // figure-eight across components; a degree-1 vertex always exists
    auto it = outs.begin();
    for (auto cand = outs.begin(); cand != outs.end(); ++cand) {
      if (cand->second.n == 1) { it = cand; break; }
    }
    int32_t sx = (int32_t)(it->first % (w + 2));
    int32_t sy = (int32_t)(it->first / (w + 2));
    int32_t cx = sx, cy = sy;
    int32_t pdx = 0, pdy = 0;
    // collect the raw loop, then collapse collinear runs
    std::vector<int32_t> vx, vy;
    for (;;) {
      auto oit = outs.find(key(cx, cy));
      Out& o = oit->second;
      int pick = 0;
      if (o.n == 2) {
        // sharpest LEFT turn keeps the loop on its own component
        long long best = -4;
        for (int c = 0; c < 2; ++c) {
          long long cross = (long long)pdx * (o.ty[c] - cy)
                          - (long long)pdy * (o.tx[c] - cx);
          if (cross > best) { best = cross; pick = c; }
        }
      }
      int32_t nx = o.tx[pick], ny = o.ty[pick];
      if (o.n == 2 && pick == 0) { o.tx[0] = o.tx[1]; o.ty[0] = o.ty[1]; }
      if (--o.n == 0) outs.erase(oit);
      pdx = nx - cx;
      pdy = ny - cy;
      cx = nx; cy = ny;
      if (cx == sx && cy == sy) break;
      vx.push_back(cx);
      vy.push_back(cy);
    }
    vx.push_back(sx);
    vy.push_back(sy);
    // collapse: keep vertex k when dir(k-1 -> k) != dir(k -> k+1)
    size_t m = vx.size();
    int32_t n_kept = 0;
    if (n_loops >= loops_cap) return -2;
    for (size_t k = 0; k < m; ++k) {
      size_t prev = (k + m - 1) % m, next = (k + 1) % m;
      int32_t d0x = vx[k] - vx[prev], d0y = vy[k] - vy[prev];
      int32_t d1x = vx[next] - vx[k], d1y = vy[next] - vy[k];
      if (d0x == d1x && d0y == d1y) continue;
      if (out_n + 1 > out_cap) return -1;
      out_xy[2 * out_n] = vx[k];
      out_xy[2 * out_n + 1] = vy[k];
      ++out_n;
      ++n_kept;
    }
    loop_sizes[n_loops++] = n_kept;
  }
  return (int)n_loops;
}

}  // extern "C"
