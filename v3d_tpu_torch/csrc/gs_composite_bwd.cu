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
// Design: one block per 16 x 16 tile, GROUPS = 4 groups of 256 threads,
// one thread a pixel in each group; the batches T10 composited (up to the
// block's last composited gaussian) are split in four runs, one a group, so
// that a tile that many gaussians reach (the fit's slowest block walked 16x
// the mean) is swept by four groups at once.  A group's reverse sweep needs
// S (below) at the end of its run: the sum of w (g . b) over the later
// runs, so groups 1-3 first sweep their runs front to back from T10's
// checkpoint ts[k] (the forward's own T and weights, no partials) and
// leave that sum in shared memory.  Per batch of 128 gaussians a group
// first culls the ones that cannot reach the tile (gs::tile_reach: the
// 1/255 ellipse's box, conservative against pair_alpha's rounding; most
// gaussians of a coarse cell miss a given 16 x 16 tile): threads 0-127 of
// the group test one gaussian each and __ballot_sync writes the admitted set
// as four 32-bit words to shared memory, a compacted list in bit form;
// every warp then walks only its set bits (from the top, __clz, in the
// reverse sweep), and only those up to the warp's last composited gaussian.
// Each thread carries the suffix sum
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
// warp by recursive halving (12 shuffles, ``warp_sum10``; skipped when no
// lane of the warp reaches the gaussian), over the block with shared-memory
// atomics from ten lanes at once, and added to the cell's dslab
// with one global atomicAdd per nonzero (gaussian, attribute) per tile.  The
// order of those float additions varies from run to run, so dslab is not
// bitwise deterministic (its rounding differs at the 1e-7 relative level).
#include "gs_composite.cuh"

namespace {

using namespace gs;

constexpr unsigned FULL = 0xffffffffu;
constexpr int PROF_SLOTS = 6;  // clock64 phases and counts a block (``prof``)
constexpr int GROUPS = 4;      // pixel groups of a block, each over its own batches
constexpr int THREADS = GROUPS * NPIX;
static_assert(CHUNK == 128, "the cull's bit list has four words");

// The warp's sums of the ten partials by recursive halving: at each of
// the xor distances 16, 8, 4, 2 a lane keeps half of its values, adds its
// partner's copy of that half and sends the other half (5 + 3 + 2 + 1
// shuffles, a padding slot where a count is odd), then 1 more at distance
// 1: 12 shuffles where a plain tree over each attribute takes 50.  Lane l
// ends with the total of attribute ``attr`` = 5 b4 + 3 b3 + 2 b2 + b1 (its
// bits), or attr = -1 on a padding slot; lanes l and l ^ 1 hold the same.
__device__ __forceinline__ float warp_sum10(const float (&v)[ATTR], int lane, int& attr) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float u[6], w[4], x[2];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    u[i] = (b4 ? v[i + 5] : v[i]) + __shfl_xor_sync(FULL, b4 ? v[i] : v[i + 5], 16);
  u[5] = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[i] = (b3 ? u[i + 3] : u[i]) + __shfl_xor_sync(FULL, b3 ? u[i] : u[i + 3], 8);
  w[3] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (b2 ? w[i + 2] : w[i]) + __shfl_xor_sync(FULL, b2 ? w[i] : w[i + 2], 4);
  float y = (b1 ? x[1] : x[0]) + __shfl_xor_sync(FULL, b1 ? x[0] : x[1], 2);
  y += __shfl_xor_sync(FULL, y, 1);
  const int slot = 3 * b3 + 2 * b2 + b1;  // of this half's five (slot 2 b2 + b1 <= 2)
  attr = (2 * b2 + b1 < 3 && slot < 5) ? 5 * b4 + slot : -1;
  return y;
}

// Stage batch ``base`` (``cnt`` gaussians) of the cell into ``sg`` (and
// zero ``sd`` where given), and cull it for the tile into the four words of
// ``reach``: gaussian base + i is admitted where i < cnt, base + i <= ``hi``
// (the block's last composited gaussian) and gs::tile_reach holds.  Run by
// the 256 threads of one group.
__device__ __forceinline__ void stage_batch(float* sg, float* sd, unsigned* reach,
                                            const float* cs, int base, int cnt, int hi,
                                            float x0, float y0, int p) {
  for (int i = p; i < cnt * ATTR; i += NPIX) {
    sg[i] = cs[(long long)base * ATTR + i];
    if (sd != nullptr) sd[i] = 0.f;
  }
  if (p < CHUNK) {
    const bool keep = p < cnt && base + p <= hi &&
                      tile_reach(cs + (long long)(base + p) * ATTR, x0, y0);
    const unsigned word = __ballot_sync(FULL, keep);
    if (p % 32 == 0) reach[p / 32] = word;
  }
}

// Barrier of the 256 threads of group g (ids 1-4; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(NPIX) : "memory");
}

// The admitted gaussians of a batch up to ``wmax`` in this warp's bit list:
// word w of ``reach`` with the bits past wmax cleared.
__device__ __forceinline__ unsigned reach_bits(const unsigned* reach, int w, int wmax) {
  const unsigned bits = reach[w];
  return wmax >= 32 * w + 31 ? bits : bits & ((2u << (wmax - 32 * w)) - 1u);
}

__global__ void __launch_bounds__(THREADS)
gs_composite_bwd_kernel(const float* __restrict__ slab,
                        const int* __restrict__ cell_of_tile,
                        const int* __restrict__ tile_xy, int kc, int n_chunks,
                        const float* __restrict__ ts,
                        const int* __restrict__ last,
                        const int* __restrict__ k_stop,
                        const float* __restrict__ g_rgb,
                        const float* __restrict__ g_acc,
                        const float* __restrict__ g_dep,
                        float* __restrict__ dslab, long long* __restrict__ prof) {
  __shared__ float sg_all[GROUPS][CHUNK * ATTR];
  __shared__ float sd_all[GROUPS][CHUNK * ATTR];
  __shared__ unsigned reach_all[GROUPS][CHUNK / 32];  // admitted gaussians, one bit each
  __shared__ float later[GROUPS][NPIX];  // each group's sum of w (g . b) over its batches
  __shared__ int block_last;
  __shared__ unsigned long long stats[PROF_SLOTS];
  const int g = threadIdx.x / NPIX, p = threadIdx.x % NPIX, lane = p % 32;
  float* sg = sg_all[g];
  float* sd = sd_all[g];
  unsigned* reach = reach_all[g];
  const int tile = blockIdx.x;
  const int cell = cell_of_tile[tile];
  const float x0 = (float)tile_xy[2 * tile], y0 = (float)tile_xy[2 * tile + 1];
  const float px = x0 + (float)(p % TILE);
  const float py = y0 + (float)(p / TILE);
  const long long pix = (long long)tile * NPIX + p;
  const int lst = last[pix];
  const float gr = g_rgb[3 * pix], gg = g_rgb[3 * pix + 1],
              gb = g_rgb[3 * pix + 2], ga = g_acc[pix], gd = g_dep[pix];
  const float* cs = slab + (long long)cell * kc * ATTR;
  float* ds = dslab + (long long)cell * kc * ATTR;
  const float* tsp = ts + (long long)tile * (n_chunks + 1) * NPIX + p;
  const long long t_start = clock64();

  if (threadIdx.x == 0) block_last = -1;
  if (threadIdx.x < PROF_SLOTS) stats[threadIdx.x] = 0;
  __syncthreads();
  if (g == 0) {
    const int wlast = __reduce_max_sync(FULL, lst);
    if (lane == 0) atomicMax(&block_last, wlast);
  }
  __syncthreads();
  // the batches that hold composited gaussians, split in GROUPS runs
  const int n_b = min(k_stop[tile], block_last < 0 ? 0 : block_last / CHUNK + 1);
  const int k_lo = g * n_b / GROUPS, k_hi = (g + 1) * n_b / GROUPS;

  // 1: front to back over this group's batches from the checkpoint ts[k],
  // the sum of w (g . b) (group 0's is not needed: nothing lies before it)
  long long t0 = clock64();
  float part = 0.f;
  if (g > 0) {
    for (int k = k_lo; k < k_hi; ++k) {
      const int base = k * CHUNK, cnt = min(CHUNK, kc - base);
      group_sync(g);  // the previous batch is read
      stage_batch(sg, nullptr, reach, cs, base, cnt, block_last, x0, y0, p);
      group_sync(g);
      float T = tsp[(long long)k * NPIX];
      const int jmax = min(cnt - 1, lst - base);
      const int wmax = __reduce_max_sync(FULL, jmax);
      for (int w = 0; w <= min(wmax, CHUNK - 1) / 32 && wmax >= 0; ++w) {
        unsigned bits = reach_bits(reach, w, wmax);
        while (bits != 0u) {
          const int j = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1u;
          const float* q = sg + j * ATTR;
          Pair e;
          if (j <= jmax && pair_alpha(q, px, py, e)) {
            part += e.alpha * T * (gr * q[5] + gg * q[6] + gb * q[7] + ga + gd * q[9]);
            T *= 1.f - e.alpha;
          }
        }
      }
    }
  }
  later[g][p] = part;
  long long t1 = clock64();
  __syncthreads();
  float S = 0.f;
  for (int h = GROUPS - 1; h > g; --h) S += later[h][p];

  // 2: the reverse sweep over this group's batches, S carried from the
  // groups after it
  long long t_walk = 0, t_flush = 0, n_reach = 0, n_walk = 0;
  for (int k = k_hi - 1; k >= k_lo; --k) {
    const int base = k * CHUNK, cnt = min(CHUNK, kc - base);
    group_sync(g);  // the previous batch is flushed
    stage_batch(sg, sd, reach, cs, base, cnt, block_last, x0, y0, p);
    group_sync(g);
    const long long t2 = clock64();
    if (p == 0)
      n_reach += __popc(reach[0]) + __popc(reach[1]) + __popc(reach[2]) + __popc(reach[3]);
    float T = tsp[(long long)(k + 1) * NPIX];
    const int jmax = min(cnt - 1, lst - base);
    const int wmax = __reduce_max_sync(FULL, jmax);
    for (int w = wmax >= 0 ? min(wmax, CHUNK - 1) / 32 : -1; w >= 0; --w) {
      unsigned bits = reach_bits(reach, w, wmax);
      while (bits != 0u) {
        const int bit = 31 - __clz(bits);
        bits ^= 1u << bit;
        const int j = 32 * w + bit;
        const float* q = sg + j * ATTR;
        float v[ATTR];
#pragma unroll
        for (int a = 0; a < ATTR; ++a) v[a] = 0.f;
        Pair e;
        const bool on = j <= jmax && pair_alpha(q, px, py, e);
        ++n_walk;
        if (on) {
          const float om = 1.f - e.alpha;
          const float t_excl = T / om;
          const float w_ = e.alpha * t_excl;
          const float gdotb = gr * q[5] + gg * q[6] + gb * q[7] + ga + gd * q[9];
          const float dalpha = t_excl * gdotb - S / om;
          S += w_ * gdotb;
          T = t_excl;
          const float da_raw = e.a_raw < ALPHA_MAX ? dalpha : 0.f;
          const float dpower = e.a_raw * da_raw;
          v[0] = dpower * (q[2] * e.dx + q[3] * e.dy);
          v[1] = dpower * (q[4] * e.dy + q[3] * e.dx);
          v[2] = -0.5f * e.dx * e.dx * dpower;
          v[3] = -e.dx * e.dy * dpower;
          v[4] = -0.5f * e.dy * e.dy * dpower;
          v[5] = gr * w_;
          v[6] = gg * w_;
          v[7] = gb * w_;
          v[8] = da_raw * e.epower;
          v[9] = gd * w_;
        }
        if (!__any_sync(FULL, on)) continue;
        int attr;
        const float total = warp_sum10(v, lane, attr);
        if ((lane & 1) == 0 && attr >= 0 && total != 0.f)
          atomicAdd(&sd[j * ATTR + attr], total);
      }
    }
    const long long t3 = clock64();
    group_sync(g);
    for (int i = p; i < cnt * ATTR; i += NPIX) {
      const float val = sd[i];
      if (val != 0.f) atomicAdd(&ds[(long long)base * ATTR + i], val);
    }
    t_walk += t3 - t2;
    t_flush += clock64() - t3;
  }
  if (prof == nullptr) return;
  if (p == 0) {
    atomicMax(&stats[1], (unsigned long long)(t1 - t0));
    atomicMax(&stats[2], (unsigned long long)t_walk);
    atomicMax(&stats[3], (unsigned long long)t_flush);
    atomicAdd(&stats[4], (unsigned long long)n_reach);
    atomicAdd(&stats[5], (unsigned long long)n_walk);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* out = prof + (long long)tile * PROF_SLOTS;
    out[0] = clock64() - t_start;
    for (int i = 1; i < PROF_SLOTS; ++i) out[i] = (long long)stats[i];
  }
}

}  // namespace

// slab: contiguous (n_cells, kc, 10) f32; cell_of_tile (n_tiles,), tile_xy
// (n_tiles, 2) int32; ts, last, k_stop as T10 wrote them; cotangents g_rgb
// (n_tiles, 256, 3), g_acc, g_dep (n_tiles, 256) f32, contiguous; dslab
// (n_cells, kc, 10) f32, zeroed by the caller, is accumulated into.  prof:
// null, or int64 (n_tiles, 6) that receives per block its clock64 cycles in
// all, the longest group's front-to-back sums, walks and flushes, the
// (tile, gaussian) pairs the cull admitted, and the gaussians the groups'
// first warps walked.  Returns the launch's cudaError_t.
extern "C" int v3d_gs_composite_bwd(const void* slab, const void* cell_of_tile,
                                    const void* tile_xy, int n_tiles, int kc,
                                    int n_chunks, const void* ts,
                                    const void* last, const void* k_stop,
                                    const void* g_rgb, const void* g_acc,
                                    const void* g_dep, void* dslab, void* prof,
                                    void* stream) {
  if (n_tiles <= 0 || kc <= 0 || n_chunks != (kc + gs::CHUNK - 1) / gs::CHUNK)
    return (int)cudaErrorInvalidValue;
  gs_composite_bwd_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const int*>(cell_of_tile),
      static_cast<const int*>(tile_xy), kc, n_chunks,
      static_cast<const float*>(ts), static_cast<const int*>(last),
      static_cast<const int*>(k_stop), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_acc), static_cast<const float*>(g_dep),
      static_cast<float*>(dslab), static_cast<long long*>(prof));
  return (int)cudaGetLastError();
}
