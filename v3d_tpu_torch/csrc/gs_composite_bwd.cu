// T11: the 3DGS tile compositor, backward: the slab gradient of T10's rgb,
// acc and depth.
//
// Replaces: v3d_tpu/gs/pallas_raster.py composite_tiles_bwd (:267-315,
// kernel _bwd_kernel :167), the custom VJP of T10 in gs/render.py
// (:323-333).  Main path: the backward of every step of the 3DGS fit, one
// launch per step.
//
// What bounds it on the H100: operations.  A composited pair costs ~50 FP32
// operations (the alpha test again, the chain rule through alpha, the ten
// per-gaussian partials) plus their reduction over the tile's pixels; the
// bytes (slab, ts, cotangents, dslab) are ~20 MB at 512^2.
//
// Design: T10's block and thread layout, one reverse sweep over the batches
// T10 composited (k_stop - 1 down to 0).  Each thread carries the suffix sum
// S = sum over later gaussians of w_j (g . b_j), exclusive, across batches,
// and walks only the gaussians up to its pixel's last composited one (later
// ones have weight 0 and, S being 0 there, gradient 0).  T before gaussian i
// is divided back from the batch's end transmittance: ts[k + 1], which T10
// wrote (T stays fixed after the pixel's last gaussian, so for the batch that
// holds it, ts[k + 1] is the T right after it); at most 128 divisions from a
// checkpoint.  Per gaussian:
//   dalpha = T_excl (g . b) - S / (1 - alpha),
// cut where alpha was clamped at 0.99 or below 1/255, then through
// exp(power) to the means, the conic and the opacity; the colour and depth
// partials are g_rgb w and g_dep w.  The ten partials are summed over the
// warp with shuffles (skipped when no lane of the warp reaches the gaussian),
// over the block with shared-memory atomics, and added to the cell's dslab
// with one global atomicAdd per nonzero (gaussian, attribute) per tile.  The
// order of those float additions varies from run to run, so dslab is not
// bitwise deterministic (its rounding differs at the 1e-7 relative level).
#include "gs_composite.cuh"

namespace {

using namespace gs;

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NPIX)
gs_composite_bwd_kernel(const float* __restrict__ slab,
                        const int* __restrict__ cell_of_tile,
                        const int* __restrict__ tile_xy, int kc, int n_chunks,
                        const float* __restrict__ ts,
                        const int* __restrict__ last,
                        const int* __restrict__ k_stop,
                        const float* __restrict__ g_rgb,
                        const float* __restrict__ g_acc,
                        const float* __restrict__ g_dep,
                        float* __restrict__ dslab) {
  __shared__ float sg[CHUNK * ATTR];
  __shared__ float sd[CHUNK * ATTR];
  const int tile = blockIdx.x, p = threadIdx.x, lane = p % 32;
  const int cell = cell_of_tile[tile];
  const float px = (float)(tile_xy[2 * tile] + p % TILE);
  const float py = (float)(tile_xy[2 * tile + 1] + p / TILE);
  const long long pix = (long long)tile * NPIX + p;
  const int lst = last[pix];
  const float gr = g_rgb[3 * pix], gg = g_rgb[3 * pix + 1],
              gb = g_rgb[3 * pix + 2], ga = g_acc[pix], gd = g_dep[pix];
  const float* cs = slab + (long long)cell * kc * ATTR;
  float* ds = dslab + (long long)cell * kc * ATTR;
  const float* tsp = ts + (long long)tile * (n_chunks + 1) * NPIX + p;

  float S = 0.f;
  for (int k = k_stop[tile] - 1; k >= 0; --k) {
    const int base = k * CHUNK;
    const int cnt = min(CHUNK, kc - base);
    __syncthreads();  // the previous batch is flushed before the refill
    for (int i = p; i < cnt * ATTR; i += NPIX) {
      sg[i] = cs[(long long)base * ATTR + i];
      sd[i] = 0.f;
    }
    __syncthreads();
    float T = tsp[(long long)(k + 1) * NPIX];
    const int jmax = min(cnt - 1, lst - base);
    const int wmax = __reduce_max_sync(FULL, jmax);
    for (int j = wmax; j >= 0; --j) {
      const float* q = sg + j * ATTR;
      float v[ATTR];
#pragma unroll
      for (int a = 0; a < ATTR; ++a) v[a] = 0.f;
      Pair e;
      const bool on = j <= jmax && pair_alpha(q, px, py, e);
      if (on) {
        const float om = 1.f - e.alpha;
        const float t_excl = T / om;
        const float w = e.alpha * t_excl;
        const float gdotb = gr * q[5] + gg * q[6] + gb * q[7] + ga + gd * q[9];
        const float dalpha = t_excl * gdotb - S / om;
        S += w * gdotb;
        T = t_excl;
        const float da_raw = e.a_raw < ALPHA_MAX ? dalpha : 0.f;
        const float dpower = e.a_raw * da_raw;
        v[0] = dpower * (q[2] * e.dx + q[3] * e.dy);
        v[1] = dpower * (q[4] * e.dy + q[3] * e.dx);
        v[2] = -0.5f * e.dx * e.dx * dpower;
        v[3] = -e.dx * e.dy * dpower;
        v[4] = -0.5f * e.dy * e.dy * dpower;
        v[5] = gr * w;
        v[6] = gg * w;
        v[7] = gb * w;
        v[8] = da_raw * e.epower;
        v[9] = gd * w;
      }
      if (!__any_sync(FULL, on)) continue;
#pragma unroll
      for (int a = 0; a < ATTR; ++a) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          v[a] += __shfl_down_sync(FULL, v[a], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < ATTR; ++a)
          if (v[a] != 0.f) atomicAdd(&sd[j * ATTR + a], v[a]);
      }
    }
    __syncthreads();
    for (int i = p; i < cnt * ATTR; i += NPIX) {
      const float val = sd[i];
      if (val != 0.f) atomicAdd(&ds[(long long)base * ATTR + i], val);
    }
  }
}

}  // namespace

// slab: contiguous (n_cells, kc, 10) f32; cell_of_tile (n_tiles,), tile_xy
// (n_tiles, 2) int32; ts, last, k_stop as T10 wrote them; cotangents g_rgb
// (n_tiles, 256, 3), g_acc, g_dep (n_tiles, 256) f32, contiguous; dslab
// (n_cells, kc, 10) f32, zeroed by the caller, is accumulated into.
// Returns the launch's cudaError_t.
extern "C" int v3d_gs_composite_bwd(const void* slab, const void* cell_of_tile,
                                    const void* tile_xy, int n_tiles, int kc,
                                    int n_chunks, const void* ts,
                                    const void* last, const void* k_stop,
                                    const void* g_rgb, const void* g_acc,
                                    const void* g_dep, void* dslab,
                                    void* stream) {
  if (n_tiles <= 0 || kc <= 0 || n_chunks != (kc + gs::CHUNK - 1) / gs::CHUNK)
    return (int)cudaErrorInvalidValue;
  gs_composite_bwd_kernel<<<n_tiles, gs::NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const int*>(cell_of_tile),
      static_cast<const int*>(tile_xy), kc, n_chunks,
      static_cast<const float*>(ts), static_cast<const int*>(last),
      static_cast<const int*>(k_stop), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_acc), static_cast<const float*>(g_dep),
      static_cast<float*>(dslab));
  return (int)cudaGetLastError();
}
