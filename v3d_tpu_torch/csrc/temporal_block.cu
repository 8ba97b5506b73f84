// K2: fused temporal self-attention layer.  For x (b, t, s, c):
//   q, k, v = x Wq^T, x Wk^T, x Wv^T           (no bias, heads*dh wide)
//   o       = softmax over the t frames, per (pixel, head)
//   out     = o Wo^T + bo                       (back to c)
//
// Replaces: v3d_tpu/ops/temporal_attention.py _pallas_block (:312-353, kernel
// _block_kernel :247), reached through temporal_block_attention (:357).  Main
// path: the VideoUNet's temporal self-attention at ds1 (x (2, 18, 4096, 320),
// 5 heads of 64), 5 calls per UNet forward.  All three products run inside
// this kernel, as they do inside the Pallas body: no cuBLAS.
//
// What bounds it on the H100: the products.  Per pixel they cost
// 4 * 18 * 320 * 320 MACs (~15 MFLOP for ~23 KB of x in and out, ~640
// FLOP/byte in bf16), right of the ridge: 0.126 ms at (2, 18, 4096, 320).
// Two variants, picked per call (ops/temporal_attention.py
// temporal_block_plan says which):
//
// - bf16 with dh = 64 and c a multiple of 160 whose tiles fit (the main
//   path): wgmma + TMA.  A block of 384 threads takes P = 128 / t pixels x
//   t frames (126 token rows at t = 18 or 14) and reads x through a 4-D
//   tensor map (c, s, t, b) of its strides, boxes of 64 channels x P pixels
//   x t frames with the 128-byte swizzle: a row is (frame, pixel), pixels
//   past s arrive as zeros and the output, written back by TMA through a map
//   of the same shape, is clipped there, so a ragged s needs no other path.
//   Warpgroups 0 and 1 are consumers of 64 rows each, warpgroup 2 the
//   producer (setmaxnreg 232 / 40), whose one thread issues every load: x
//   once, then each head's Wq|Wk|Wv rows (192 x 16-deep chunks, 6 KB) and
//   finally Wo's rows (160 x 16-deep, two passes of 160 output columns)
//   through a 5-slot ring of mbarriers, 32-byte swizzle (the torch Linear
//   layout (out, in) is the K-major B operand as it is).  Per head a
//   consumer runs wgmma.m64n192k16 over the x tile (A from shared memory) to
//   get q | k | v in registers and writes them as bf16 (XOR-swizzled
//   128-byte rows): k and v into a tile pair, q into the head's slot of the
//   concatenated head outputs.  Then one warp per pixel, all 8 consumer
//   warps busy while pixels remain, runs the t-frame attention on mma.sync
//   (pixel_attention) and writes o over the pixel's q rows.  The output
//   projection (wgmma.m64n160k16, A = the head outputs, two passes) adds the
//   bias and writes the tile into the x buffer, which TMA stores.
//   Shared memory (c = heads*dh = 320): x 80 KB + head outputs 80 KB + k, v
//   32 KB + ring 30 KB + barriers = 228,440 B of the 232,448, one block an
//   SM.  x, the head outputs and k / v cannot shrink at 128 rows, so the
//   ring gets what is left: five one-k-step slots, up to 24 KB of weights in
//   flight while the consumers read the fifth.
//   clock64 a block at ds1 (H100): x wait 6.3k cycles, QKV products 48.0k,
//   softmax 23.3k, output projection 18.8k, store 3.6k.  The products take
//   2.5x their tensor-core time (QKV 19.2k): they wait on the weight stream
//   (800 KB a block from L2).  Measured and not kept: 112-row tiles with two
//   24 KB slots (each weight byte serves 108 rows, not 126); sharing each
//   chunk between the 2 blocks of a cluster (TMA multicast, each block
//   loading half: 2.9x slower with a 2-slot ring, the two blocks waiting on
//   each other at every slot).  Pallas keeps q/k/v in f32 and P in f32; here
//   q, k, v and P are rounded to bf16 for the tensor cores (S and the
//   softmax stay f32).
// - otherwise (f32, other widths): f32 FMA products, described below.
//
// With a non-null ``prof`` the wgmma kernel's consumer thread 0 records
// clock64 per block: waiting for x, the QKV products, the softmax, the
// output projection, the store (chip_smoke.py phase 3 prints the means).
//
// FMA variant: a block takes PIX neighbouring pixels of one video and all t frames
// (R = t * PIX token rows), reading x straight from (b, t, s, c) through its
// strides; the TPU's (b * n_sb, t, s_blk, c) transposes and per-head weight
// pre-split are not carried over: the weights are the torch Linear layout
// (out, in) and each head reads its rows of Wq/Wk/Wv.  Shared memory holds
// the x tile (input type), one head's q/k/v in f32, the concatenated head
// outputs in the input type (as the Pallas body casts o before the output
// product), and a 64 x 32 f32 chunk of the weight being applied.  The output
// projection runs once, after all heads, from the concatenated buffer: an f32
// accumulator of the full output width would not fit beside the rest.
// GEMM thread map: column = tid % 64 (consecutive lanes, conflict-free reads
// of the padded weight chunk), rows tid / 64 + 4 * i (the x/o row is the same
// across a warp: a broadcast read).  At c = 320, 18 frames and PIX = 2 the
// block uses ~85 KB of shared memory in bf16, ~131 KB in f32.
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int PIX = 2;      // pixels per block
constexpr int NT = 64;      // output columns per GEMM pass
constexpr int KC = 32;      // weight chunk depth
constexpr int MAX_RPT = 16; // rows per thread: R = t * PIX <= 64

// acc[i] = sum_k A[row_i][k] * W[n0 + col][k] for the thread's rows.
template <typename TA, typename TW>
__device__ __forceinline__ void gemm_rows(const TA* A, int lda, int R, int K,
                                          const TW* __restrict__ W, int n0, int N,
                                          float* wbuf, float acc[MAX_RPT]) {
  const int tid = threadIdx.x;
  const int col = tid % NT, rg = tid / NT;
#pragma unroll
  for (int i = 0; i < MAX_RPT; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // previous chunk consumed
    for (int e = tid; e < NT * KC; e += THREADS) {
      const int n = e / KC, kk = e % KC;
      wbuf[n * (KC + 1) + kk] =
          (n < N && kk < kc) ? to_f(W[(long long)(n0 + n) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const float w = wbuf[col * (KC + 1) + kk];
#pragma unroll
      for (int i = 0; i < MAX_RPT; ++i) {
        const int r = rg + 4 * i;
        if (r < R) acc[i] = fmaf(to_f(A[r * lda + k0 + kk]), w, acc[i]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
temporal_block_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                      const T* __restrict__ wk, const T* __restrict__ wv,
                      const T* __restrict__ wo, const T* __restrict__ bo,
                      T* __restrict__ out, int t, int s, int c, int heads, int dh,
                      long long xsb, long long xst, long long xss, float scale) {
  extern __shared__ float smem[];
  const int R = t * PIX;
  const int inner = heads * dh;
  const int ld = dh + 1;
  float* qkv = smem;                               // [3][R][ld]
  float* wbuf = qkv + 3 * R * ld;                  // [NT][KC + 1]
  float* ps = wbuf + NT * (KC + 1);                // [PIX][t][t + 1]
  T* xs = reinterpret_cast<T*>(ps + PIX * t * (t + 1));  // [R][c]
  T* os = xs + R * c;                              // [R][inner]

  const int tid = threadIdx.x;
  const int n_sb = (s + PIX - 1) / PIX;
  const int bi = blockIdx.x / n_sb;
  const int s0 = (blockIdx.x % n_sb) * PIX;
  const T* xb = x + bi * xsb;

  // token row r <-> (frame r / PIX, pixel s0 + r % PIX)
  for (int e = tid; e < R * c; e += THREADS) {
    const int r = e / c, cc = e % c;
    const int f = r / PIX, si = s0 + r % PIX;
    xs[e] = si < s ? xb[f * xst + si * xss + cc] : from_f<T>(0.f);
  }

  const int col = tid % NT, rg = tid / NT;
  const int warp = tid / 32;
  float acc[MAX_RPT];
  for (int h = 0; h < heads; ++h) {
    const T* ws[3] = {wq, wk, wv};
    for (int m = 0; m < 3; ++m) {
      gemm_rows(xs, c, R, c, ws[m], h * dh, dh, wbuf, acc);
      const float sc = m == 0 ? scale : 1.f;
      if (col < dh) {
#pragma unroll
        for (int i = 0; i < MAX_RPT; ++i) {
          const int r = rg + 4 * i;
          if (r < R) qkv[(m * R + r) * ld + col] = acc[i] * sc;
        }
      }
    }
    __syncthreads();
    if (warp < PIX) {
      const int p = warp;
      warp_frame_attention(qkv + p * ld, qkv + (R + p) * ld, qkv + (2 * R + p) * ld,
                           PIX, ld, ps + p * t * (t + 1), t, dh,
                           [&](int i, int cc, float val) {
                             os[(i * PIX + p) * inner + h * dh + cc] = from_f<T>(val);
                           });
    }
    __syncthreads();
  }

  T* ob = out + (long long)bi * t * s * c;
  for (int n0 = 0; n0 < c; n0 += NT) {
    const int nn = min(NT, c - n0);
    gemm_rows(os, inner, R, inner, wo, n0, nn, wbuf, acc);
    if (col < nn) {
      const float bias = to_f(bo[n0 + col]);
#pragma unroll
      for (int i = 0; i < MAX_RPT; ++i) {
        const int r = rg + 4 * i;
        const int f = r / PIX, si = s0 + r % PIX;
        if (r < R && si < s)
          ob[((long long)f * s + si) * c + n0 + col] = from_f<T>(acc[i] + bias);
      }
    }
  }
}

// ---- wgmma + TMA variant (bf16, dh = 64) ------------------------------------

constexpr int WG_THREADS = 128;
constexpr int TB_CONSUMERS = 2;
constexpr int TB_THREADS = (TB_CONSUMERS + 1) * WG_THREADS;  // the producer last
constexpr int TB_ROWS = 64 * TB_CONSUMERS;  // rows of the wgmma products
constexpr int TB_TILE_ROWS = 128;  // token rows a block: P = 128 // t pixels
constexpr int TB_DH = 64;
constexpr int TB_KCH = 16;      // depth of a weight chunk: 32-byte rows, one k-step
constexpr int TB_OUT_N = 160;   // output columns of one output-projection pass
constexpr int TB_STAGES = 5;
constexpr uint32_t CHUNK = TB_TILE_ROWS * 128;  // 128 rows x 64 bf16, 128-byte swizzle
constexpr uint32_t QKV_STAGE = 3 * TB_DH * TB_KCH * 2;  // 6 KB
constexpr uint32_t OUT_STAGE = TB_OUT_N * TB_KCH * 2;   // 5 KB
constexpr uint32_t STAGE_BYTES = QKV_STAGE > OUT_STAGE ? QKV_STAGE : OUT_STAGE;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PROF_SLOTS = 6;
static_assert((TB_CONSUMERS * CONSUMER_REGS + PRODUCER_REGS) * WG_THREADS <= 65536,
              "setmaxnreg asks for more registers than an SM has");

// Byte offsets from the 1024-aligned base: x tile (c / 64 chunks), head
// outputs (inner / 64 chunks), k and v (one chunk each), the ring, the
// barriers; the total adds 1 KB of alignment slack.
struct TbLayout {
  size_t os, kv, ring, bars, total;
};

__host__ __device__ inline TbLayout tb_layout(int c, int inner) {
  TbLayout L;
  L.os = (size_t)(c / 64) * CHUNK;
  L.kv = L.os + (size_t)(inner / 64) * CHUNK;
  L.ring = L.kv + 2 * (size_t)CHUNK;
  L.bars = L.ring + (size_t)TB_STAGES * STAGE_BYTES;
  L.total = L.bars + 8 * (1 + 2 * TB_STAGES) + 1024;
  return L;
}

// Byte offset of bf16 column pair (8n + 2u, +1) of row r in a 128-byte-row
// tile with the 128-byte swizzle (16-byte chunk n XOR r % 8).
__device__ __forceinline__ uint32_t sw_off(int r, int n, int u) {
  return r * 128 + ((n ^ (r & 7)) << 4) + 4 * u;
}

__device__ __forceinline__ void st_bf16x2(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Attention over the t <= 32 frames of pixel p, one warp, on mma.sync
// m16n8k16 (bf16 in, f32 sums): frame j of pixel p is row j * pix + p of
// the q, k and v tiles (bf16, 128-byte rows, sw_off).  S = q k^T as 2 x 4
// tiles of 16 frames x 8 keys (keys past t set to -inf; frames past t read
// frame 0's row and are not stored), the softmax in f32 on the S fragments
// (a row spans the 4 lanes of a quad), P rounded to bf16 as the A fragments
// of P v (the S layout of two 8-key tiles is the A layout of one 16-key
// step), v by transposing ldmatrix.  o (scaled by 1 / row sum) is written
// as bf16 over the pixel's q rows, which only this warp reads.
__device__ __forceinline__ void pixel_attention(unsigned char* qo, const unsigned char* ks,
                                                const unsigned char* vs, int t, int pix,
                                                int p, float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane / 4, u = lane % 4;
  const uint32_t q_a = smem_u32(qo), k_a = smem_u32(ks), v_a = smem_u32(vs);
  auto row = [&](int j) { return (j < t ? j : 0) * pix + p; };
  auto at = [](int r, int chunk) { return (uint32_t)(r * 128 + ((chunk ^ (r & 7)) << 4)); };
  float S[2][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // head dims 16kk .. 16kk + 15
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], q_a + at(row(16 * mt + lane % 16), 2 * kk + lane / 16));
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
      ldmatrix_x4(b[nb], k_a + at(row(16 * nb + lane % 8 + 8 * (lane / 16)),
                                  2 * kk + (lane / 8) % 2));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(S[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)], b[nt / 2][2 * (nt % 2) + 1]);
  }
  uint32_t pa[2][2][4];
  float inv[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 16mt + g + 8h
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * nt + 2 * u + e >= t) S[mt][nt][2 * h + e] = -INFINITY;
          m = fmaxf(m, S[mt][nt][2 * h + e]);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = exp2f((S[mt][nt][2 * h + e] - m) * scale_log2);
          S[mt][nt][2 * h + e] = v;
          sum += v;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[mt][h] = 1.f / sum;
    }
#pragma unroll
    for (int ks2 = 0; ks2 < 2; ++ks2) {  // keys 16ks2 .. 16ks2 + 15
      pa[mt][ks2][0] = pack_bf16(S[mt][2 * ks2][0], S[mt][2 * ks2][1]);
      pa[mt][ks2][1] = pack_bf16(S[mt][2 * ks2][2], S[mt][2 * ks2][3]);
      pa[mt][ks2][2] = pack_bf16(S[mt][2 * ks2 + 1][0], S[mt][2 * ks2 + 1][1]);
      pa[mt][ks2][3] = pack_bf16(S[mt][2 * ks2 + 1][2], S[mt][2 * ks2 + 1][3]);
    }
  }
  float O[2][8][4] = {};
#pragma unroll
  for (int ks2 = 0; ks2 < 2; ++ks2) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {  // head dims 16nb .. 16nb + 15
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_a + at(row(16 * ks2 + lane % 8 + 8 * ((lane / 8) % 2)),
                                    2 * nb + lane / 16));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(O[mt][2 * nb], pa[mt][ks2], b[0], b[1]);
        mma_bf16(O[mt][2 * nb + 1], pa[mt][ks2], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mt + g + 8 * h;
      if (i < t) {
        const int r = i * pix + p;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          st_bf16x2(qo + sw_off(r, nt, u), O[mt][nt][2 * h] * inv[mt][h],
                    O[mt][nt][2 * h + 1] * inv[mt][h]);
      }
    }
}

__global__ void __launch_bounds__(TB_THREADS, 1)
temporal_block_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap twq,
                            const __grid_constant__ CUtensorMap twk,
                            const __grid_constant__ CUtensorMap twv,
                            const __grid_constant__ CUtensorMap two,
                            const __grid_constant__ CUtensorMap tout,
                            const bf16* __restrict__ bo, int t, int s, int c, int heads,
                            int pix, float scale_log2, long long* prof) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const int inner = heads * TB_DH;
  const TbLayout L = tb_layout(c, inner);
  unsigned char* xs = base;  // the x tile, later the output tile
  unsigned char* os = base + L.os;
  unsigned char* ks = base + L.kv;
  unsigned char* vs = ks + CHUNK;
  unsigned char* ring = base + L.ring;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* full = x_full + 1;
  uint64_t* empty = full + TB_STAGES;

  const int rows = pix * t;
  const int n_sb = (s + pix - 1) / pix;
  const int bi = blockIdx.x / n_sb, s0 = (blockIdx.x % n_sb) * pix;
  const int xchunks = c / 64, nk = c / TB_KCH, nko = inner / TB_KCH;
  const int passes = c / TB_OUT_N;
  const int wg = threadIdx.x / WG_THREADS;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int i = 0; i < TB_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, TB_CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the x tile's rows past the box are zero (TMA writes rows < P * t)
  const int pad = (TB_TILE_ROWS - rows) * 8;
  for (int e = threadIdx.x; e < xchunks * pad; e += TB_THREADS)
    *reinterpret_cast<uint4*>(xs + (e / pad) * CHUNK + rows * 128 + (e % pad) * 16) =
        make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  __syncthreads();

  if (wg == TB_CONSUMERS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == TB_CONSUMERS * WG_THREADS) {
      mbar_expect_tx(x_full, (uint32_t)(xchunks * rows * 128));
      for (int k = 0; k < xchunks; ++k)
        tma_load_4d(xs + k * CHUNK, &tx, x_full, 64 * k, s0, 0, bi);
      const int n_stages = heads * nk + passes * nko;
      for (int j = 0; j < n_stages; ++j) {
        const int st = j % TB_STAGES;
        if (j >= TB_STAGES) mbar_wait(empty + st, ((j / TB_STAGES) & 1) ^ 1);
        unsigned char* dst = ring + st * STAGE_BYTES;
        if (j < heads * nk) {
          const int h = j / nk, k0 = (j % nk) * TB_KCH;
          mbar_expect_tx(full + st, QKV_STAGE);
          tma_load_2d(dst, &twq, full + st, k0, h * TB_DH);
          tma_load_2d(dst + QKV_STAGE / 3, &twk, full + st, k0, h * TB_DH);
          tma_load_2d(dst + 2 * QKV_STAGE / 3, &twv, full + st, k0, h * TB_DH);
        } else {
          const int jj = j - heads * nk;
          mbar_expect_tx(full + st, OUT_STAGE);
          tma_load_2d(dst, &two, full + st, (jj % nko) * TB_KCH, (jj / nko) * TB_OUT_N);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, u = lane % 4;
    const uint32_t x_a = smem_u32(xs) + wg * 64 * 128;  // this warpgroup's 64 rows
    const uint32_t o_a = smem_u32(os) + wg * 64 * 128;
    const uint32_t ring_a = smem_u32(ring);
    const bool timing = prof != nullptr && threadIdx.x == 0;
    long long clk[PROF_SLOTS] = {};
    long long t0 = timing ? clock64() : 0;
    int j = 0;  // ring stages consumed

    mbar_wait(x_full, 0);
    if (timing) clk[0] = clock64() - t0;
    for (int h = 0; h < heads; ++h) {
      if (timing) t0 = clock64();
      float acc[96];
#pragma unroll
      for (int i = 0; i < 96; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < nk; ++kc, ++j) {
        const int st = j % TB_STAGES;
        mbar_wait(full + st, (j / TB_STAGES) & 1);
        // a 16-deep chunk is a quarter of a 64-wide x chunk's 128-byte rows
        fence_regs(acc);
        wgmma_fence();
        wgmma_m64n192k16_ss(acc, desc_k_major(x_a + (kc >> 2) * CHUNK + (kc & 3) * 32),
                            sw32_desc_k_major(ring_a + st * STAGE_BYTES), kc);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();  // stage j - 1 has been read
          mbar_arrive(empty + (j - 1) % TB_STAGES);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + (j - 1) % TB_STAGES);
      if (timing) {
        clk[1] += clock64() - t0;
        t0 = clock64();
      }

      // q (into head h's output tile), k and v of this warpgroup's rows, bf16,
      // for every consumer to read
      named_barrier(1, TB_CONSUMERS * WG_THREADS);  // the last head's are read
      unsigned char* qo = os + h * CHUNK;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int R = wg * 64 + warp * 16 + g + 8 * r;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          st_bf16x2(qo + sw_off(R, n, u), acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
          st_bf16x2(ks + sw_off(R, n, u), acc[4 * (n + 8) + 2 * r],
                    acc[4 * (n + 8) + 2 * r + 1]);
          st_bf16x2(vs + sw_off(R, n, u), acc[4 * (n + 16) + 2 * r],
                    acc[4 * (n + 16) + 2 * r + 1]);
        }
      }
      named_barrier(1, TB_CONSUMERS * WG_THREADS);
      // one warp a pixel: all 8 consumer warps while pixels remain
      for (int p = wg * 4 + warp; p < pix; p += 2 * 4)
        pixel_attention(qo, ks, vs, t, pix, p, scale_log2);
      if (timing) clk[2] += clock64() - t0;
    }

    // output projection from the head outputs, two passes of 160 columns
    fence_proxy_async();
    named_barrier(1, TB_CONSUMERS * WG_THREADS);  // every head output is written
    if (timing) t0 = clock64();
    for (int pass = 0; pass < passes; ++pass) {
      float acc[80];
#pragma unroll
      for (int i = 0; i < 80; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < nko; ++kc, ++j) {
        const int st = j % TB_STAGES;
        mbar_wait(full + st, (j / TB_STAGES) & 1);
        fence_regs(acc);
        wgmma_fence();
        wgmma_m64n160k16_ss(acc, desc_k_major(o_a + (kc >> 2) * CHUNK + (kc & 3) * 32),
                            sw32_desc_k_major(ring_a + st * STAGE_BYTES), kc);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + (j - 1) % TB_STAGES);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + (j - 1) % TB_STAGES);
      // + bias, bf16, into the x buffer (free since the last head's product)
#pragma unroll
      for (int n = 0; n < TB_OUT_N / 8; ++n) {
        const int col = pass * TB_OUT_N + 8 * n + 2 * u;
        const float b0 = __bfloat162float(bo[col]), b1 = __bfloat162float(bo[col + 1]);
        const int chunk8 = col / 8;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int R = wg * 64 + warp * 16 + g + 8 * r;
          st_bf16x2(xs + (chunk8 / 8) * CHUNK + sw_off(R, chunk8 % 8, u),
                    acc[4 * n + 2 * r] + b0, acc[4 * n + 2 * r + 1] + b1);
        }
      }
    }
    fence_proxy_async();
    named_barrier(1, TB_CONSUMERS * WG_THREADS);  // the output tile is written
    if (timing) {
      clk[3] = clock64() - t0;
      t0 = clock64();
    }
    if (threadIdx.x == 0) {
      for (int k = 0; k < xchunks; ++k)
        tma_store_4d(&tout, xs + k * CHUNK, 64 * k, s0, 0, bi);
      bulk_commit();
      bulk_wait_read();
    }
    if (timing) {
      clk[4] = clock64() - t0;
      clk[5] = rows;
      for (int i = 0; i < PROF_SLOTS; ++i)
        prof[(long long)blockIdx.x * PROF_SLOTS + i] = clk[i];
    }
  }
}

bool wgmma_eligible(int dtype, int t, int c, int heads, int dh) {
  return dtype == V3D_BF16 && dh == TB_DH && c % TB_OUT_N == 0 && t >= 1 &&
         t <= 32 && tb_layout(c, heads * dh).total <= 232448;
}

// x: (b, t, s, c) through element strides (b, t, s), all multiples of 8
// (a dim of size 1 excepted), 16-byte aligned; out contiguous.
int launch_wgmma(const void* x, const void* wq, const void* wk, const void* wv,
                 const void* wo, const void* bo, void* out, int b, int t, int s, int c,
                 int heads, long long xsb, long long xst, long long xss, long long* prof,
                 cudaStream_t stream) {
  const int inner = heads * TB_DH;
  const int pix = TB_TILE_ROWS / t;
  CUtensorMap tx, tq, tk, tv, to, tout;
  const cuuint64_t xdims[4] = {(cuuint64_t)c, (cuuint64_t)s, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)pix, (cuuint32_t)t, 1};
  const cuuint64_t xstr[3] = {(cuuint64_t)xss * 2, (cuuint64_t)xst * 2, (cuuint64_t)xsb * 2};
  const cuuint64_t ostr[3] = {(cuuint64_t)c * 2, (cuuint64_t)s * c * 2,
                              (cuuint64_t)t * s * c * 2};
  const cuuint64_t wdims[2] = {(cuuint64_t)c, (cuuint64_t)inner};
  const cuuint64_t wstr[1] = {(cuuint64_t)c * 2};
  const cuuint32_t wbox[2] = {TB_KCH, TB_DH};
  const cuuint64_t odims[2] = {(cuuint64_t)inner, (cuuint64_t)c};
  const cuuint64_t owstr[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t obox[2] = {TB_KCH, TB_OUT_N};
  int err = encode_bf16_map(&tx, x, 4, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_bf16_map(&tout, out, 4, xdims, ostr, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = encode_bf16_map(&tq, wq, 2, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == 0) err = encode_bf16_map(&tk, wk, 2, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == 0) err = encode_bf16_map(&tv, wv, 2, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == 0) err = encode_bf16_map(&to, wo, 2, odims, owstr, obox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != 0) return err;
  const size_t smem = tb_layout(c, inner).total;
  auto kernel = temporal_block_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)b * ((s + pix - 1) / pix);
  kernel<<<blocks, TB_THREADS, smem, stream>>>(tx, tq, tk, tv, to, tout,
                                               static_cast<const bf16*>(bo), t, s, c, heads,
                                               pix, 1.4426950408889634f / sqrtf((float)TB_DH),
                                               prof);
  return (int)cudaGetLastError();
}

size_t smem_bytes(int t, int c, int heads, int dh, size_t elem) {
  const int R = t * PIX;
  return sizeof(float) * (3 * R * (dh + 1) + NT * (KC + 1) + PIX * t * (t + 1)) +
         elem * (R * c + R * heads * dh);
}

template <typename T>
int launch(const void* x, const void* wq, const void* wk, const void* wv,
           const void* wo, const void* bo, void* out, int b, int t, int s, int c,
           int heads, int dh, long long xsb, long long xst, long long xss,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(t, c, heads, dh, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      temporal_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)b * ((s + PIX - 1) / PIX);
  temporal_block_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<T*>(out), t, s, c, heads, dh, xsb, xst, xss, 1.f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory the launch needs (bytes); ops/temporal_attention.py
// temporal_block_plan computes the same, and the wrapper refuses shapes
// over the card's per-block limit before launching.
extern "C" long long v3d_temporal_block_smem(int dtype, int t, int c, int heads,
                                             int dh) {
  if (wgmma_eligible(dtype, t, c, heads, dh))
    return (long long)tb_layout(c, heads * dh).total;
  return (long long)smem_bytes(t, c, heads, dh, dtype == V3D_F32 ? 4 : 2);
}

// x: (b, t, s, c) through element strides (b, t, s), unit channel stride
// (for the bf16 wgmma variant 16-byte aligned with strides in multiples of
// 8 elements: the wrapper copies other x first).  wq/wk/wv: (heads*dh, c),
// wo: (c, heads*dh), bo: (c,), all contiguous and 16-byte aligned, torch
// Linear layout.  out: contiguous (b, t, s, c).  t <= 32, dh <= 64.  prof:
// null, or b * ceil(s / (128 / t)) * 6 int64 for the wgmma variant's
// per-block cycles.  Returns the launch's cudaError_t, or 9001 where a
// tensor map could not be made.
extern "C" int v3d_temporal_block(int dtype, const void* x, const void* wq,
                                  const void* wk, const void* wv, const void* wo,
                                  const void* bo, void* out, int b, int t, int s,
                                  int c, int heads, int dh, long long xsb,
                                  long long xst, long long xss, void* prof,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma_eligible(dtype, t, c, heads, dh))
    return launch_wgmma(x, wq, wk, wv, wo, bo, out, b, t, s, c, heads, xsb, xst, xss,
                        static_cast<long long*>(prof), st);
  if (dtype == V3D_F32)
    return launch<float>(x, wq, wk, wv, wo, bo, out, b, t, s, c, heads, dh, xsb,
                         xst, xss, st);
  if (dtype == V3D_BF16)
    return launch<__nv_bfloat16>(x, wq, wk, wv, wo, bo, out, b, t, s, c, heads,
                                 dh, xsb, xst, xss, st);
  return (int)cudaErrorInvalidValue;
}
