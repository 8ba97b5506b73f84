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

// pair_alpha's alpha of N gaussians ``g[u]`` at one pixel where the pair
// passes, else 0: the same operations with no branch (exp is taken for
// every pair), stage by stage over the N, so that their N chains of
// dependent operations interleave (T10's walk, one thread a pixel).
template <int N>
__device__ __forceinline__ void pair_alphas_or_0(const float* const (&g)[N], float px,
                                                 float py, float (&alpha)[N]) {
  float dx[N], dy[N], t[N], power[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    dx[u] = __fsub_rn(px, g[u][0]);
    dy[u] = __fsub_rn(py, g[u][1]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u)
    t[u] = __fadd_rn(__fmul_rn(__fmul_rn(g[u][2], dx[u]), dx[u]),
                     __fmul_rn(__fmul_rn(g[u][4], dy[u]), dy[u]));
#pragma unroll
  for (int u = 0; u < N; ++u)
    power[u] = __fsub_rn(__fmul_rn(-0.5f, t[u]), __fmul_rn(__fmul_rn(g[u][3], dx[u]), dy[u]));
#pragma unroll
  for (int u = 0; u < N; ++u) t[u] = expf(power[u]);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const float a = fminf(ALPHA_MAX, __fmul_rn(g[u][8], t[u]));
    alpha[u] = !(power[u] > 0.f) && a >= ALPHA_MIN ? a : 0.f;
  }
}

// The per-tile cull of T10 and T11: false only where the
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

// The cull's box of one gaussian: REACH_NONE where it reaches no pixel,
// REACH_ALL where it is admitted whatever the pixels, else REACH_BOX: it can
// pass the alpha test only at pixels within mx +- hx, my +- hy.
enum Reach { REACH_NONE, REACH_ALL, REACH_BOX };

__device__ __forceinline__ Reach reach_box(const float* g, double& hx, double& hy) {
  const float op = g[8];
  if (op < ALPHA_MIN) return REACH_NONE;  // dead slots (op = 0) and faint gaussians
  const double mx = g[0], my = g[1], a = g[2], b = g[3], c = g[4];
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) && isfinite(c) &&
        isfinite(op)))
    return REACH_ALL;
  const double det = a * c - b * b;
  if (!(det > 0.0 && a > 0.0)) return REACH_ALL;
  const double lmax = 0.5 * (a + c) + sqrt(0.25 * (a - c) * (a - c) + b * b);
  const double rho = REACH_EPS * (fabs(a) + fabs(b) + fabs(c)) * lmax / det;
  if (rho >= 0.5) return REACH_ALL;
  const double r = 2.0 * (fmax(log(255.0 * (double)op), 0.0) + REACH_DELTA) / (1.0 - rho);
  hx = sqrt(r * c / det) + 1.0;
  hy = sqrt(r * a / det) + 1.0;
  return REACH_BOX;
}

__device__ __forceinline__ bool tile_reach(const float* g, float x0, float y0) {
  double hx, hy;
  const Reach kind = reach_box(g, hx, hy);
  if (kind != REACH_BOX) return kind == REACH_ALL;
  const double mx = g[0], my = g[1];
  return mx + hx >= x0 && mx - hx <= x0 + (TILE - 1) && my + hy >= y0 &&
         my - hy <= y0 + (TILE - 1);
}

// reach_box in whole pixels, (x_lo, x_hi, y_lo, y_hi) = the ceil of the box's
// low ends and the floor of its high ends, clamped to int16: a tile of
// pixels x0..x1, y0..y1 (integers in [0, 32752]) meets the box exactly
// where it meets these bounds (pixel_box_meets), so on a whole tile this is
// tile_reach's test, and on any part of a tile it is as conservative.
// REACH_NONE is an empty box, REACH_ALL all of int16.  Plain version:
// ops/gs_composite.py reach_boxes.
__device__ __forceinline__ short4 reach_pixel_box(const float* g) {
  double hx, hy;
  const Reach kind = reach_box(g, hx, hy);
  if (kind != REACH_BOX) {
    const short lo = kind == REACH_ALL ? -32768 : 32767;
    return make_short4(lo, (short)(-1 - lo), lo, (short)(-1 - lo));
  }
  const double mx = g[0], my = g[1];
  auto clamp16 = [](double v) { return (short)fmin(fmax(v, -32768.0), 32767.0); };
  return make_short4(clamp16(ceil(mx - hx)), clamp16(floor(mx + hx)),
                     clamp16(ceil(my - hy)), clamp16(floor(my + hy)));
}

__device__ __forceinline__ bool pixel_box_meets(short4 bx, int x0, int x1, int y0, int y1) {
  return bx.y >= x0 && bx.x <= x1 && bx.w >= y0 && bx.z <= y1;
}

}  // namespace gs
