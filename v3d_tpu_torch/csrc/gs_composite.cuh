// Shared by T10 (gs_composite_fwd.cu) and T11 (gs_composite_bwd.cu): the
// tile layout, the cutoffs of the 3DGS rasterizer, the per-pair alpha and
// the per-tile cull.
#pragma once

#include "common.cuh"

namespace gs {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;  // threads per block: one per tile pixel
constexpr int CHUNK = 128;         // gaussians staged per batch = one ts row
constexpr int ATTR = 10;           // slab row: mx my ca cb cc r g b op depth
constexpr float ALPHA_MIN = 1.f / 255.f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

// One (pixel, gaussian) pair: true when the gaussian reaches the pixel
// (power <= 0 and alpha >= 1/255).  The products and sums are rounded one by
// one in the order of the plain version (ops/gs_composite.py
// composite_plain), and expf is the accurate one, so the two agree on which
// pairs pass the cutoffs: a pair that flips costs up to 1/255 of a pixel.
struct Pair {
  float dx, dy, epower, a_raw, alpha;
};

__device__ __forceinline__ bool pair_alpha(const float* g, float px, float py,
                                           Pair& o) {
  o.dx = __fsub_rn(px, g[0]);
  o.dy = __fsub_rn(py, g[1]);
  const float xx = __fmul_rn(__fmul_rn(g[2], o.dx), o.dx);
  const float yy = __fmul_rn(__fmul_rn(g[4], o.dy), o.dy);
  const float xy = __fmul_rn(__fmul_rn(g[3], o.dx), o.dy);
  const float power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(xx, yy)), xy);
  if (power > 0.f) return false;
  o.epower = expf(power);
  o.a_raw = __fmul_rn(g[8], o.epower);
  o.alpha = fminf(ALPHA_MAX, o.a_raw);
  return o.alpha >= ALPHA_MIN;
}

// The per-tile cull (K5; meant for K4 as well): false only where the
// gaussian ``g`` (a slab row) passes pair_alpha's test at no pixel of the
// 16 x 16 tile whose first pixel is (x0, y0).  alpha >= 1/255 needs op >=
// 1/255 and power >= -L, L = ln(255 op); for a positive-definite conic (a,
// b, c) the pixels with -2 power = a dx^2 + 2 b dx dy + c dy^2 <= 2L lie in
// the box |dx| <= sqrt(2L c / det), |dy| <= sqrt(2L a / det), det = ac - b^2.
// Conservative against the test's float rounding: power is off by at most
// REACH_EPS (|a| + |b| + |c|) / lambda_min of |power| (a few float ulps of
// each product), so the box is taken for 2 (L + REACH_DELTA) / (1 - that),
// in double, and padded by a pixel; a conic that is not positive definite,
// or where that relative error reaches 1/2, or any non-finite entry, is
// admitted.  A gaussian it rejects never passes pair_alpha in the tile, so
// the composite and its gradient are unchanged.  Plain version:
// ops/gs_composite.py tile_reach.
constexpr double REACH_EPS = 1e-6;    // > 16 float ulps
constexpr double REACH_DELTA = 1e-5;  // the alpha test's own rounding, in log units

__device__ __forceinline__ bool tile_reach(const float* g, float x0, float y0) {
  const float op = g[8];
  if (op < ALPHA_MIN) return false;  // dead slots (op = 0) and faint gaussians
  const double mx = g[0], my = g[1], a = g[2], b = g[3], c = g[4];
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) && isfinite(c) &&
        isfinite(op)))
    return true;
  const double det = a * c - b * b;
  if (!(det > 0.0 && a > 0.0)) return true;
  const double lmax = 0.5 * (a + c) + sqrt(0.25 * (a - c) * (a - c) + b * b);
  const double rho = REACH_EPS * (fabs(a) + fabs(b) + fabs(c)) * lmax / det;
  if (rho >= 0.5) return true;
  const double r = 2.0 * (fmax(log(255.0 * (double)op), 0.0) + REACH_DELTA) / (1.0 - rho);
  const double hx = sqrt(r * c / det) + 1.0, hy = sqrt(r * a / det) + 1.0;
  return mx + hx >= x0 && mx - hx <= x0 + (TILE - 1) && my + hy >= y0 &&
         my - hy <= y0 + (TILE - 1);
}

}  // namespace gs
