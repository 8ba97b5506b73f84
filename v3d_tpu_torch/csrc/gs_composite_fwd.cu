// T10: the 3DGS tile compositor, forward.  Front-to-back EWA alpha
// compositing of a depth-sorted gaussian slab over each 16x16 pixel tile.
//
// Replaces: v3d_tpu/gs/pallas_raster.py composite_tiles_fwd (:318-375,
// kernel _fwd_kernel :59), reached through gs/render.py rasterize
// (:436-445).  Main path: every step of the 3DGS fit (GSTrainer.train_iter)
// and every render_view, one launch each: at 512^2, 1024 tiles over 16 coarse
// cells of Kc = 2048 gaussians.
//
// What bounds it on the H100: operations.  Each (pixel, gaussian) pair costs
// ~15 FP32 operations and an exp for the alpha test, and the pairs that pass
// ~11 more; the slab (1.3 MB) and the outputs (~10 MB) move in microseconds,
// so the floor is the pairs this run's data needs over the FP32 peak.
//
// Design (the CUDA rasterizer's renderCUDA, which the Pallas kernel recast):
// one block per tile, one thread per pixel.  The tile's cell slab
// ((n_cells, Kc, 10) gaussian-major, as build_slabs packs it) is staged in
// shared memory in batches of CHUNK gaussians; every thread reads the same
// gaussian at once (a broadcast).  Each thread composites front to back with
// its own transmittance T: a gaussian is weighted while T >= 1e-4 before it,
// and once T falls below 1e-4 nothing after it counts, so the thread stops
// there and T stays as it was (exact: the plain version weights those pairs
// by 0).  At each batch start the block writes every thread's T to ts (the
// backward's checkpoints) and votes (__syncthreads_or): it stops when no
// pixel is live, and in any case after the cell's live gaussians.  Outputs:
// rgb, acc, depth, the index of each pixel's last composited gaussian, ts
// (n_tiles, n_chunks + 1, 256; row k_stop is the final T) and k_stop.  The
// TPU's attribute-major padding, lane rolls and identity-matmul transposes
// are not carried over.
#include "gs_composite.cuh"

namespace {

using namespace gs;

__global__ void __launch_bounds__(NPIX)
gs_composite_fwd_kernel(const float* __restrict__ slab,
                        const int* __restrict__ live_count,
                        const int* __restrict__ cell_of_tile,
                        const int* __restrict__ tile_xy, int kc, int n_chunks,
                        float* __restrict__ rgb, float* __restrict__ acc,
                        float* __restrict__ dep, float* __restrict__ ts,
                        int* __restrict__ last, int* __restrict__ k_stop) {
  __shared__ float sg[CHUNK * ATTR];
  const int tile = blockIdx.x, p = threadIdx.x;
  const int cell = cell_of_tile[tile];
  const float px = (float)(tile_xy[2 * tile] + p % TILE);
  const float py = (float)(tile_xy[2 * tile + 1] + p / TILE);
  const int n_live = min(live_count[cell], kc);
  const int chunks = min((n_live + CHUNK - 1) / CHUNK, n_chunks);
  const float* cs = slab + (long long)cell * kc * ATTR;
  float* tsp = ts + (long long)tile * (n_chunks + 1) * NPIX + p;

  float T = 1.f, r = 0.f, g = 0.f, b = 0.f, a = 0.f, d = 0.f;
  int lst = -1;
  int k = 0;
  for (; k < chunks; ++k) {
    // the vote is also the barrier before the batch buffer is refilled
    if (!__syncthreads_or(T >= T_EPS)) break;
    tsp[(long long)k * NPIX] = T;
    const int base = k * CHUNK;
    const int cnt = min(CHUNK, n_live - base);
    for (int i = p; i < cnt * ATTR; i += NPIX)
      sg[i] = cs[(long long)base * ATTR + i];
    __syncthreads();
    if (T < T_EPS) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* q = sg + j * ATTR;
      Pair e;
      if (!pair_alpha(q, px, py, e)) continue;
      const float w = e.alpha * T;
      r += w * q[5];
      g += w * q[6];
      b += w * q[7];
      a += w;
      d += w * q[9];
      T *= 1.f - e.alpha;
      lst = base + j;
      if (T < T_EPS) break;
    }
  }
  tsp[(long long)k * NPIX] = T;
  const long long pix = (long long)tile * NPIX + p;
  rgb[3 * pix] = r;
  rgb[3 * pix + 1] = g;
  rgb[3 * pix + 2] = b;
  acc[pix] = a;
  dep[pix] = d;
  last[pix] = lst;
  if (p == 0) k_stop[tile] = k;
}

}  // namespace

// slab: contiguous (n_cells, kc, 10) f32; live_count (n_cells,), cell_of_tile
// (n_tiles,), tile_xy (n_tiles, 2) int32; n_chunks = ceil(kc / 128).
// Outputs (contiguous): rgb (n_tiles, 256, 3), acc, dep (n_tiles, 256) f32;
// ts (n_tiles, n_chunks + 1, 256) f32; last (n_tiles, 256), k_stop
// (n_tiles,) int32.  Returns the launch's cudaError_t.
extern "C" int v3d_gs_composite_fwd(const void* slab, const void* live_count,
                                    const void* cell_of_tile,
                                    const void* tile_xy, int n_tiles, int kc,
                                    int n_chunks, void* rgb, void* acc,
                                    void* dep, void* ts, void* last,
                                    void* k_stop, void* stream) {
  if (n_tiles <= 0 || kc <= 0 || n_chunks != (kc + gs::CHUNK - 1) / gs::CHUNK)
    return (int)cudaErrorInvalidValue;
  gs_composite_fwd_kernel<<<n_tiles, gs::NPIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const int*>(live_count),
      static_cast<const int*>(cell_of_tile), static_cast<const int*>(tile_xy),
      kc, n_chunks, static_cast<float*>(rgb), static_cast<float*>(acc),
      static_cast<float*>(dep), static_cast<float*>(ts),
      static_cast<int*>(last), static_cast<int*>(k_stop));
  return (int)cudaGetLastError();
}
