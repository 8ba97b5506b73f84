// Shared by T10 (gs_composite_fwd.cu) and T11 (gs_composite_bwd.cu): the
// tile layout, the cutoffs of the 3DGS rasterizer and the per-pair alpha.
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

}  // namespace gs
