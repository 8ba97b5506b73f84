// T10: the 3DGS tile compositor, forward.  Front-to-back EWA alpha
// compositing of a depth-sorted gaussian slab over each 16x16 pixel tile.
//
// Replaces: v3d_tpu/gs/pallas_raster.py composite_tiles_fwd (:318-375,
// kernel _fwd_kernel :59), reached through gs/render.py rasterize
// (:436-445).  Main path: every step of the 3DGS fit (GSTrainer.train_iter)
// and every render_view, one call each: at 512^2, 1024 tiles over 16 coarse
// cells of Kc = 2048 gaussians.
//
// What bounds it on the H100: the bytes of the outputs and checkpoints
// (~10 MB at 512^2), once only the pairs that can pass the alpha test are
// tested: a gaussian of a coarse cell reaches few of its 64 tiles (the fit's
// first slab: ~33 of a cell's 2048 reach a mean tile), so a sweep of the
// whole cell tests ~18x the pairs the inputs need.  What sets its time is
// the busiest tile: near the centre of the fit's first view a tile is
// reached by up to ~780 gaussians, which its pixels composite one after
// another.
//
// Design: two launches.  The first (gs_reach_table_kernel) takes the cull's
// box (gs::reach_box, the box of T11's cull gs::tile_reach) of every slab
// row once, in whole pixels (gs::reach_pixel_box, 8 bytes a row), for all
// the tiles of its cell, and zeroes k_stop.  The second runs SPLIT = 4
// blocks a tile, each over a band of 4 pixel rows (64 threads, one a
// pixel), so that the busiest tile's walks run on four SMs.  Per segment of
// up to SEG = 2048 live slab rows a block culls: thread p tests rows p, p +
// 64, ... against its band (a gaussian passes the alpha test only inside
// its box), __ballot_sync writes the admitted rows as a bit list in slab
// order, one warp scans the words' counts, and every thread scatters its
// admitted rows into a compacted list of slab indices in shared memory (one
// pass and one scan a segment, three barriers, rather than a vote per
// 128-row batch as in T11).  The block walks the list front to back in
// batches of CHUNK admitted rows, staged in shared memory by cp.async while
// the batch before is walked (every thread reads the same row at once, a
// broadcast).  A batch splits into runs of rows of one 128-row slab batch:
// before a run the threads write the checkpoint rows ts[k] = T up to its
// slab batch (the T before slab row 128 k), and within it they take ILP
// rows at a time: first their alpha tests, which do not depend on T, with
// no branch and stage by stage over the ILP rows (gs::pair_alphas_or_0) so
// that their chains of operations overlap, then the composite into the
// pixel in slab order, by selects.  The operations and their roundings are
// those of a sweep of the whole slab (a rejected gaussian never passes
// pair_alpha, so skipping it changes no bit): a gaussian is weighted while
// T >= 1e-4 before it, and once T falls below 1e-4 nothing after it counts
// and T stays as it was.  At the end each thread writes its final T into
// every later ts row up to the batches of the cell's live rows (``chunks``),
// which covers row k_stop.  A pixel whose T fell below 1e-4 at slab row
// ``last`` is dead from batch last / 128 + 1 on, so k_stop, the first batch
// at whose start no pixel of the tile is live, is the largest of those
// (``chunks`` for a pixel that lives on): each block takes the largest of
// its band and atomicMax-es it into k_stop.  A block stops walking at a
// batch or segment start where no pixel of its band is live.  Outputs:
// rgb, acc, depth, the slab index of each pixel's last composited gaussian,
// ts (n_tiles, n_chunks + 1, 256; row k_stop is the final T) and k_stop, as
// T11 reads them.  The TPU's attribute-major padding, lane rolls and
// identity-matmul transposes are not carried over.
#include "gs_composite.cuh"

namespace {

using namespace gs;

constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT = 4;               // blocks a tile
constexpr int BAND = TILE / SPLIT;     // pixel rows a block
constexpr int THREADS = NPIX / SPLIT;  // one a pixel of the band
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 2048;              // slab rows culled into one compacted list
constexpr int ROUNDS = SEG / THREADS;  // rows a thread tests per segment
constexpr int WORDS = SEG / 32;        // the segment's bit list
constexpr int ILP = 8;                 // alpha tests in flight a thread
constexpr int ROW = 12;                // a staged row: the slab's 10 floats, 16-byte aligned
constexpr int PROF_SLOTS = 6;          // clock64 phases and counts a tile (``prof``)
static_assert(WORDS == 64 && WARPS * ROUNDS == WORDS && ROUNDS <= 64,
              "one scan warp, two words a lane; a thread's rows in one 64-bit word");

// The cull's boxes of every slab row in whole pixels, once for all the
// tiles of its cell; k_stop zeroed for the atomicMax of the second launch.
__global__ void __launch_bounds__(256)
gs_reach_table_kernel(const float* __restrict__ slab, long long n_rows, int n_tiles,
                      short4* __restrict__ boxes, int* __restrict__ k_stop) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < n_rows) boxes[i] = reach_pixel_box(slab + i * ATTR);
  if (i < n_tiles) k_stop[i] = 0;
}

// Stage the cell's rows ``rows[0 .. cnt)`` into ``buf`` (ROW floats a row)
// by asynchronous copies of 8 bytes (a slab row is 40 bytes, 8-byte
// aligned), as one commit group of this thread (empty where cnt <= 0).
__device__ __forceinline__ void stage_rows(float* buf, const float* cs, const int* rows,
                                           int cnt, int p) {
  for (int i = p; i < cnt * (ATTR / 2); i += THREADS) {
    const int j = i / (ATTR / 2), h = 2 * (i % (ATTR / 2));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(buf + j * ROW + h)),
                 "l"(cs + (long long)rows[j] * ATTR + h)
                 : "memory");
  }
  cp_async_commit();
}

// The lowest set bit at or after ``j`` of the CHUNK-bit list ``bits``, or
// ``end`` where there is none.
__device__ __forceinline__ int next_bit(const unsigned* bits, int j, int end) {
  for (int w = j / 32; w < CHUNK / 32; ++w) {
    const unsigned m = j > 32 * w ? bits[w] & (~0u << (j - 32 * w)) : bits[w];
    if (m != 0u) return min(32 * w + __ffs(m) - 1, end);
  }
  return end;
}

__global__ void __launch_bounds__(THREADS)
gs_composite_fwd_kernel(const float* __restrict__ slab, const short4* __restrict__ boxes,
                        const int* __restrict__ live_count,
                        const int* __restrict__ cell_of_tile,
                        const int* __restrict__ tile_xy, int kc, int n_chunks,
                        float* __restrict__ rgb, float* __restrict__ acc,
                        float* __restrict__ dep, float* __restrict__ ts,
                        int* __restrict__ last, int* __restrict__ k_stop,
                        long long* __restrict__ prof) {
  __shared__ __align__(16) float sg[2][CHUNK * ROW];  // a batch walked, the next arriving
  __shared__ int list[SEG];          // the segment's admitted slab rows, in slab order
  __shared__ unsigned bits[WORDS];   // bit i of word w: row 32 w + i of the segment admitted
  __shared__ int base[WORDS + 1];    // admitted rows before each word; [WORDS]: all
  __shared__ unsigned runs[CHUNK / 32];  // bit j: a batch's entry j starts a run
  __shared__ int stop;
  const long long t_start = clock64();
  const int tile = blockIdx.x / SPLIT, band = blockIdx.x % SPLIT;
  const int p = threadIdx.x, lane = p % 32, warp = p / 32;
  const int pix_t = band * THREADS + p;  // the pixel within the tile, 16 y + x
  const int cell = cell_of_tile[tile];
  const int x0 = tile_xy[2 * tile], y0 = tile_xy[2 * tile + 1] + band * BAND;
  const float px = (float)(x0 + pix_t % TILE);
  const float py = (float)(tile_xy[2 * tile + 1] + pix_t / TILE);
  const int n_live = min(live_count[cell], kc);
  const int chunks = min((n_live + CHUNK - 1) / CHUNK, n_chunks);
  const float* cs = slab + (long long)cell * kc * ATTR;
  const short4* cb = boxes + (long long)cell * kc;
  float* tsp = ts + (long long)tile * (n_chunks + 1) * NPIX + pix_t;

  if (p == 0) stop = 0;
  float T = 1.f, r = 0.f, g = 0.f, b = 0.f, a = 0.f, d = 0.f;
  int lst = -1;
  int kw = 0;  // rows of ts this thread has written
  long long t_cull = 0, t_walk = 0, n_adm = 0, n_walk = 0;
  for (int s0 = 0; s0 < n_live; s0 += SEG) {
    // the vote is also the barrier before the list is refilled
    if (!__syncthreads_or(T >= T_EPS)) break;
    const long long t0 = clock64();
    const int n_seg = min(SEG, n_live - s0);
    unsigned long long mine = 0;  // bit i: row THREADS i + p of the segment admitted
#pragma unroll 8
    for (int i = 0; i < ROUNDS; ++i) {
      const int row = i * THREADS + p;
      const bool keep = row < n_seg &&
                        pixel_box_meets(cb[s0 + row], x0, x0 + TILE - 1, y0, y0 + BAND - 1);
      const unsigned word = __ballot_sync(FULL, keep);
      if (lane == 0) bits[i * WARPS + warp] = word;  // rows 32 (WARPS i + warp) ...
      mine |= (unsigned long long)keep << i;
    }
    __syncthreads();
    if (warp == 0) {
      const int c0 = __popc(bits[2 * lane]), c1 = __popc(bits[2 * lane + 1]);
      int incl = c0 + c1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      base[2 * lane] = incl - c0 - c1;
      base[2 * lane + 1] = incl - c1;
      if (lane == 31) base[WORDS] = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    for (unsigned long long m = mine; m != 0ull; m &= m - 1ull) {
      const int i = __ffsll((long long)m) - 1, w = i * WARPS + warp;
      list[base[w] + __popc(bits[w] & below)] = s0 + i * THREADS + p;
    }
    const int n_list = base[WORDS];
    __syncthreads();
    const long long t1 = clock64();
    t_cull += t1 - t0;
    n_adm += n_list;

    stage_rows(sg[0], cs, list, min(CHUNK, n_list), p);
    for (int b0 = 0, buf = 0; b0 < n_list; b0 += CHUNK, buf ^= 1) {
      // the previous batch is walked, so its buffer may be refilled (the
      // first batch follows the list's barrier)
      if (b0 > 0 && !__syncthreads_or(T >= T_EPS)) break;
      const int cnt = min(CHUNK, n_list - b0);
      stage_rows(sg[buf ^ 1], cs, list + b0 + CHUNK, min(CHUNK, n_list - b0 - CHUNK), p);
      // the batch's runs: entry j starts one where its slab batch is not
      // that of entry j - 1 (bit j of ``runs``)
#pragma unroll
      for (int i = 0; i < CHUNK / THREADS; ++i) {
        const int j = i * THREADS + p;
        const bool first = j < cnt && (j == 0 || list[b0 + j] / CHUNK != list[b0 + j - 1] / CHUNK);
        const unsigned word = __ballot_sync(FULL, first);
        if (lane == 0) runs[j / 32] = word;
      }
      cp_async_wait<1>();  // this thread's copies of this batch have landed
      __syncthreads();     // and everyone's, and the runs
      n_walk += cnt;
      const float* sb = sg[buf];
      for (int j = 0; j < cnt;) {
        // a run: ts rows up to its slab batch take T before it (every
        // thread walks every entry, so kw is the block's), then its
        // gaussians with no checkpoint between them
        const int je = next_bit(runs, j + 1, cnt);
        for (const int kb = list[b0 + j] / CHUNK; kw <= kb; ++kw)
          tsp[(long long)kw * NPIX] = T;
        for (int j0 = j; j0 < je; j0 += ILP) {
          const float* rows[ILP];
#pragma unroll
          for (int u = 0; u < ILP; ++u) rows[u] = sb + min(j0 + u, je - 1) * ROW;
          float al[ILP];
          pair_alphas_or_0(rows, px, py, al);
#pragma unroll
          for (int u = 0; u < ILP; ++u) {
            // nothing counts once T < 1e-4; where alpha > 0, w = alpha T,
            // the colours and depth take w c with one rounding (fma), acc w,
            // T *= 1 - alpha, each rounded as written (as T10 always has:
            // the same bits for the same slab), by selects
            const int jj = min(j0 + u, je - 1);
            const float* q = sb + jj * ROW;
            const bool on = j0 + u < je && al[u] != 0.f && T >= T_EPS;
            const float w = __fmul_rn(al[u], T);
            r = on ? __fmaf_rn(w, q[5], r) : r;
            g = on ? __fmaf_rn(w, q[6], g) : g;
            b = on ? __fmaf_rn(w, q[7], b) : b;
            a = on ? __fadd_rn(a, w) : a;
            d = on ? __fmaf_rn(w, q[9], d) : d;
            T = on ? __fmul_rn(T, __fsub_rn(1.f, al[u])) : T;
            lst = on ? list[b0 + jj] : lst;
          }
        }
        j = je;
      }
    }
    cp_async_wait<0>();  // nothing lands in sg after an early stop
    t_walk += clock64() - t1;
  }

  // the batch from which the band's last pixel to die is dead (a pixel that
  // lives on keeps every batch of the cell's live rows)
  const long long t2 = clock64();
  const int dead_from = T < T_EPS ? lst / CHUNK + 1 : chunks;
  const int wmax = __reduce_max_sync(FULL, dead_from);
  __syncthreads();  // stop is set
  if (lane == 0) atomicMax(&stop, wmax);
  for (; kw <= chunks; ++kw) tsp[(long long)kw * NPIX] = T;
  const long long pix = (long long)tile * NPIX + pix_t;
  rgb[3 * pix] = r;
  rgb[3 * pix + 1] = g;
  rgb[3 * pix + 2] = b;
  acc[pix] = a;
  dep[pix] = d;
  last[pix] = lst;
  __syncthreads();
  if (p == 0) atomicMax(&k_stop[tile], stop);
  if (prof != nullptr && p == 0) {
    unsigned long long* out = reinterpret_cast<unsigned long long*>(prof) +
                              (long long)tile * PROF_SLOTS;
    const long long t3 = clock64();
    atomicMax(&out[0], (unsigned long long)(t3 - t_start));
    atomicMax(&out[1], (unsigned long long)t_cull);
    atomicMax(&out[2], (unsigned long long)t_walk);
    atomicMax(&out[3], (unsigned long long)(t3 - t2));
    atomicAdd(&out[4], (unsigned long long)n_adm);
    atomicAdd(&out[5], (unsigned long long)n_walk);
  }
}

}  // namespace

// slab: contiguous (n_cells, kc, 10) f32; live_count (n_cells,), cell_of_tile
// (n_tiles,), tile_xy (n_tiles, 2) int32; n_chunks = ceil(kc / 128); boxes:
// scratch of n_cells * kc * 8 bytes.  Outputs (contiguous): rgb (n_tiles,
// 256, 3), acc, dep (n_tiles, 256) f32; ts (n_tiles, n_chunks + 1, 256) f32
// (rows past the batches of the cell's live rows unwritten); last (n_tiles,
// 256), k_stop (n_tiles,) int32.  prof: null, or int64 (n_tiles, 6), zeroed
// by the caller, that receives per tile the most clock64 cycles of its
// blocks in all, in the cull (the tests, the scan and the scatter), in the
// walk (staging, compositing and the checkpoints written on the way) and in
// the final writes, and over its blocks the (band, gaussian) pairs the cull
// admitted and the gaussians they staged.  Two launches on ``stream``;
// returns the first failing launch's cudaError_t.
extern "C" int v3d_gs_composite_fwd(const void* slab, const void* live_count,
                                    const void* cell_of_tile,
                                    const void* tile_xy, int n_cells, int n_tiles,
                                    int kc, int n_chunks, void* boxes, void* rgb,
                                    void* acc, void* dep, void* ts, void* last,
                                    void* k_stop, void* prof, void* stream) {
  if (n_cells <= 0 || n_tiles <= 0 || kc <= 0 ||
      n_chunks != (kc + gs::CHUNK - 1) / gs::CHUNK)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)n_cells * kc;
  const long long n_table = n_rows > n_tiles ? n_rows : n_tiles;
  gs_reach_table_kernel<<<(unsigned)((n_table + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(slab), n_rows, n_tiles, static_cast<short4*>(boxes),
      static_cast<int*>(k_stop));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gs_composite_fwd_kernel<<<n_tiles * SPLIT, THREADS, 0, st>>>(
      static_cast<const float*>(slab), static_cast<const short4*>(boxes),
      static_cast<const int*>(live_count), static_cast<const int*>(cell_of_tile),
      static_cast<const int*>(tile_xy), kc, n_chunks, static_cast<float*>(rgb),
      static_cast<float*>(acc), static_cast<float*>(dep), static_cast<float*>(ts),
      static_cast<int*>(last), static_cast<int*>(k_stop), static_cast<long long*>(prof));
  return (int)cudaGetLastError();
}
