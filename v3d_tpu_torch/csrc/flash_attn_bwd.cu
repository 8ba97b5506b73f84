// K7 / K8: flash attention backward, d = 64, bf16 in, f32 accumulation, on
// wgmma + TMA.
//
// Replaces: the stock jax.experimental.pallas TPU flash kernel's backward,
// which jax.grad of v3d_tpu/ops/attention.py attention_bhsd ("flash_jax",
// :154-168, block sizes :161-166) runs: _flash_attention_bwd_dkv (K7; its
// pallas_call in jax/experimental/pallas/ops/tpu/flash_attention.py :1121)
// and _flash_attention_bwd_dq (K8; :1456).  Main path: the VideoUNet
// fine-tune step, spatial self-attention at ds1 (18, 5, 4096, 64) and ds2
// (18, 10, 1024, 64), q/k/v as strided views of the projection output.
//
// Math (FlashAttention-2's backward): with S = Q K^T * scale, P = exp(S -
// lse) recomputed from the forward's per-row log-sum-exp (K1 writes it),
// D = rowsum(dO o O), dP = dO V^T and dS = P o (dP - D):
//   dV = P^T dO,  dK = dS^T Q * scale,  dQ = dS K * scale.
//
// What bounds it on the H100: arithmetic.  K8 runs three 64-deep products
// per (q, k) pair (S, dP, dQ), K7 four (S^T, dP^T, dV, dK): 0.586 and 0.782
// ms of tensor-core time at ds1, against 0.977 ms for the five products of
// a fused backward, which would sum dQ across blocks with f32 atomics (not
// deterministic, and a third kernel).  Design: the stock split, each kernel
// deterministic, built as K1 (flash_attn_fwd.cu) on hopper.cuh: one block
// of 384 threads, warpgroups 0 and 1 consumers of 64 rows each, warpgroup 2
// the producer, whose one elected thread issues every TMA load (setmaxnreg
// gives the producer 40 registers a thread and the consumers 232).  Every
// bf16 tile is a box of a 4-D tensor map (d, s, h, b) built per call from
// the caller's strides, with the 128-byte swizzle, so any (b, h, s) view
// with 16-byte strides is read in place; rows past the sequence come in as
// zeros.
//
// - K8 flash_bwd_dq_kernel, first: a block per (batch*head, 128 query rows).
//   The producer loads the block's Q and dO once, then each 128-key K and V
//   tile into a ring of 3 slots (K-full, V-full and empty mbarriers each).
//   Before the loop a consumer computes D of its rows from O and dO in
//   global memory (a quad of lanes a row) and writes D and lse * log2 e into
//   ``stats`` for K7.  Per key tile: S = Q K^T and dP = dO V^T, four
//   wgmma.m64n128k16 each (both operands K-major); P = exp2(S * scale *
//   log2 e - lse * log2 e) while dP is in flight (keys past sk set to 0);
//   dS = P (dP - D) packed to bf16 A fragments (the accumulator layout of
//   two 8-key chunks is the A fragment of one 16-key chunk); dQ += dS K,
//   eight wgmma.m64n64k16 with B = K MN-major; then the slot is released.
//   dQ * scale is stored in bf16 through the caller's strides.
// - K7 flash_bwd_dkv_kernel: a block per (batch*head, 128 keys).  A
//   consumer loads its 64 keys' K and V once, from global memory straight
//   into wgmma A fragments: they are loop-invariant, so only B is read from
//   shared memory.  The ring (4 slots) holds per 64 query rows the Q and dO
//   tiles (8 KB each) and the rows' lse * log2 e and D (256 B each, one box
//   of a 2-D map of ``stats``).  Per tile: S^T = K Q^T and dP^T = V dO^T,
//   four wgmma.m64n64k16 each (A from registers, B K-major); P^T while dP^T
//   is in flight (queries past sq set to 0); dV += P^T dO (B = dO MN-major);
//   dS^T = P^T (dP^T - D); dK += dS^T Q (B = Q MN-major).  One swizzled
//   [q][d] tile thus serves as a K-major and an MN-major operand, as K1 reads
//   its [key][d] tiles as K and as V.  dK * scale and dV are stored in bf16.
//
// Per block (ptxas, chip_smoke.py phase 2; phase 3): 384 threads, 168
// registers a thread at entry, 0 spilled; K8 132,176 bytes of dynamic shared
// memory (Q + dO 32 KB, 3 x (K + V) 96 KB, barriers, alignment), K7 68,672
// (4 x (Q + dO + statistics) 66 KB, barriers, alignment); one block an SM
// (registers).  Each warpgroup waits for a tile's products within the tile;
// the two warpgroups and the producer overlap one another.  Tried and not
// kept (PERF.md): deferring a tile's last wait behind the next tile's
// products (no faster), and issuing the last tile's dQ / dK between the
// next tile's two products (slower).
//
// ``stats``: (b*h, 2, pitch) f32, pitch = sq rounded up to 4, row 0 lse *
// log2 e and row 1 D.  K8 writes it because a 2-D map needs 16-byte row
// strides, which K1's (b, h, sq) log-sum-exp does not have at odd sq.
// With a non-null ``prof`` consumer thread 0 of each block records clock64
// phases (PROF_SLOTS a block): the prologue, waiting for tiles, the first two
// products with P, dS, the accumulating products, the store, and the rows
// (K8) or keys (K7) the block holds.
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int WG_THREADS = 128;
constexpr int THREADS = (CONSUMERS + 1) * WG_THREADS;  // the producer last
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert((CONSUMERS * CONSUMER_REGS + PRODUCER_REGS) * WG_THREADS <= 65536,
              "setmaxnreg asks for more registers than an SM has");
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PROF_SLOTS = 7;

// K8: 128 query rows a block, K/V tiles of 128 keys in 3 slots
constexpr int DQ_BM = 64 * CONSUMERS;
constexpr int DQ_BN = 128;
constexpr int DQ_STAGES = 3;
constexpr uint32_t DQ_ROWS_BYTES = DQ_BM * D * 2;  // the block's Q or dO, 16 KB
constexpr uint32_t DQ_TILE_BYTES = DQ_BN * D * 2;  // a K or V tile, 16 KB
// Q, dO, 3 x (K, V), the barriers, and 1 KB to align the tiles to the
// 1024-byte period of the 128-byte swizzle
constexpr size_t DQ_SMEM =
    2 * DQ_ROWS_BYTES + 2 * DQ_STAGES * DQ_TILE_BYTES + 8 * (1 + 3 * DQ_STAGES) + 1024;

// K7: 128 keys a block, Q/dO tiles of 64 query rows in 4 slots
constexpr int DKV_BN = 64 * CONSUMERS;
constexpr int DKV_BM = 64;
constexpr int DKV_STAGES = 4;
constexpr uint32_t DKV_TILE_BYTES = DKV_BM * D * 2;   // a Q or dO tile, 8 KB
constexpr uint32_t DKV_STATS_BYTES = 2 * DKV_BM * 4;  // lse * log2 e and D of a tile
constexpr size_t DKV_SMEM =
    DKV_STAGES * (2 * DKV_TILE_BYTES + DKV_STATS_BYTES) + 8 * 2 * DKV_STAGES + 1024;

struct Strides {
  long long b, h, s;
};

// 2^x on the special-function unit, subnormal results flushed to zero (a P
// below 2^-126 adds nothing to a bf16 gradient); exp2f's rescaling of
// subnormals cost 12% of the pair's time at ds1 (PERF.md).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// B read MN-major from a [k rows][64] tile of ``tile_bytes``: SBO = 1024 B
// between 8-row groups, LBO the stride between 64-wide column atoms (d = 64
// has one).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t tile_bytes) {
  return sw128_desc(addr, tile_bytes);
}

// A fragments (wgmma's register-A layout, m16n8k16's per warp) of the
// 16-row slice ``row``, ``row`` + 8 of a bf16 [rows][64] matrix with row
// stride ``stride`` elements: a[kk] covers columns 16 kk .. 16 kk + 15.
// Rows at or past ``rows`` are zeros.  Needs 4-byte aligned rows.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const bf16* base,
                                             long long stride, int row, int rows, int u) {
  const bool lo = row < rows, hi = row + 8 < rows;
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(base + row * stride + 2 * u);
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(base + (row + 8) * stride + 2 * u);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = lo ? p0[8 * kk] : 0u;
    a[kk][1] = hi ? p1[8 * kk] : 0u;
    a[kk][2] = lo ? p0[8 * kk + 4] : 0u;
    a[kk][3] = hi ? p1[8 * kk + 4] : 0u;
  }
}

// A fragments of chunk kc (columns 16 kc .. 16 kc + 15) from an f32
// accumulator of the wgmma layout (columns 8n + 2u + e): chunks 2 kc and
// 2 kc + 1.
template <int N>
__device__ __forceinline__ void pack_frags(const float (&x)[4 * N], uint32_t (&a)[N / 2][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 2; ++kc) {
    a[kc][0] = pack_bf16(x[8 * kc + 0], x[8 * kc + 1]);
    a[kc][1] = pack_bf16(x[8 * kc + 2], x[8 * kc + 3]);
    a[kc][2] = pack_bf16(x[8 * kc + 4], x[8 * kc + 5]);
    a[kc][3] = pack_bf16(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// Store a warpgroup's 64 x 64 accumulator times ``mul`` as bf16 rows
// ``row0`` + g and ``row0`` + g + 8 (rows at or past ``rows`` skipped).
__device__ __forceinline__ void store_rows(bf16* base, long long stride, int row0, int rows,
                                           const float (&acc)[32], float mul, int g, int u) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    bf16* p = base + row * stride;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * n + 2 * u) =
          __floats2bfloat162_rn(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n_full, int n_empty) {
  for (int i = 0; i < n_full; ++i) mbar_init(bars + i, 1);
  for (int i = 0; i < n_empty; ++i) mbar_init(bars + n_full + i, CONSUMERS * WG_THREADS);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void write_prof(long long* prof, long long (&clk)[PROF_SLOTS]) {
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int i = 0; i < PROF_SLOTS; ++i) prof[blk * PROF_SLOTS + i] = clk[i];
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ stats, bf16* __restrict__ dq, int heads, int sq,
                    int sk, int pitch, Strides os, Strides dos, Strides dqs,
                    float scale_log2, float scale, long long* prof) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* q_tile = base;
  unsigned char* do_tile = q_tile + DQ_ROWS_BYTES;
  unsigned char* k_tiles = do_tile + DQ_ROWS_BYTES;
  unsigned char* v_tiles = k_tiles + DQ_STAGES * DQ_TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_tiles + DQ_STAGES * DQ_TILE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + DQ_STAGES;
  uint64_t* empty = v_full + DQ_STAGES;

  const int wg = threadIdx.x / WG_THREADS;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * DQ_BM;
  const int n_tiles = (sk + DQ_BN - 1) / DQ_BN;

  if (threadIdx.x == 0) init_barriers(q_full, 1 + 2 * DQ_STAGES, DQ_STAGES);
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG_THREADS) {
      mbar_expect_tx(q_full, 2 * DQ_ROWS_BYTES);
      tma_load_4d(q_tile, &tq, q_full, 0, q0, hi, bi);
      tma_load_4d(do_tile, &tdo, q_full, 0, q0, hi, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % DQ_STAGES;
        if (j >= DQ_STAGES) mbar_wait(empty + s, ((j / DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, DQ_TILE_BYTES);
        tma_load_4d(k_tiles + s * DQ_TILE_BYTES, &tk, k_full + s, 0, j * DQ_BN, hi, bi);
        mbar_expect_tx(v_full + s, DQ_TILE_BYTES);
        tma_load_4d(v_tiles + s * DQ_TILE_BYTES, &tv, v_full + s, 0, j * DQ_BN, hi, bi);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int row0 = q0 + wg * 64 + warp * 16;  // this warp's rows: row0 + g (+ 8)
  const bool timing = prof != nullptr && threadIdx.x == 0;
  long long clk[PROF_SLOTS] = {};
  long long t0 = timing ? clock64() : 0;

  // D and lse * log2 e of this thread's two rows; the quad's lanes each
  // take 16 of the 64 columns
  float dr[2], lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    float acc = 0.f;
    if (row < sq) {
      const bf16* orow = o + bi * os.b + hi * os.h + row * os.s + 16 * u;
      const bf16* drow = dout + bi * dos.b + hi * dos.h + row * dos.s + 16 * u;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(op[e]), df = __bfloat1622float2(dp[e]);
          acc = fmaf(of.x, df.x, fmaf(of.y, df.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dr[r] = acc;
    lr[r] = row < sq ? lse[(long long)bh * sq + row] * LOG2E : 0.f;
    if (row < sq && u == 0) {
      stats[(2LL * bh) * pitch + row] = lr[r];
      stats[(2LL * bh + 1) * pitch + row] = acc;
    }
  }

  const uint32_t q_addr = smem_u32(q_tile + wg * (DQ_ROWS_BYTES / CONSUMERS));
  const uint32_t do_addr = smem_u32(do_tile + wg * (DQ_ROWS_BYTES / CONSUMERS));
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float sc[64], dp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = dp[i] = 0.f;
  uint32_t ds[8][4];

  mbar_wait(q_full, 0);
  if (timing) clk[0] = clock64() - t0;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % DQ_STAGES;
    const uint32_t parity = (j / DQ_STAGES) & 1;
    if (timing) t0 = clock64();
    mbar_wait(k_full + s, parity);
    mbar_wait(v_full + s, parity);
    if (timing) {
      clk[1] += clock64() - t0;
      t0 = clock64();
    }
    const uint32_t k_addr = smem_u32(k_tiles + s * DQ_TILE_BYTES);
    const uint32_t v_addr = smem_u32(v_tiles + s * DQ_TILE_BYTES);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
      wgmma_m64n128k16_ss(sc, desc_k_major(q_addr + 32 * kk), desc_k_major(k_addr + 32 * kk),
                          kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
      wgmma_m64n128k16_ss(dp, desc_k_major(do_addr + 32 * kk),
                          desc_k_major(v_addr + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    // P in base 2; element i is row g + 8 ((i >> 1) & 1), key 8 (i >> 2) + 2u + (i & 1)
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = ex2_ftz(fmaf(sc[i], scale_log2, -lr[(i >> 1) & 1]));
    const int k0 = j * DQ_BN;
    if (k0 + DQ_BN > sk) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (k0 + 8 * (i >> 2) + 2 * u + (i & 1) >= sk) sc[i] = 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if (timing) {
      clk[2] += clock64() - t0;
      t0 = clock64();
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= dp[i] - dr[(i >> 1) & 1];  // dS
    pack_frags<16>(sc, ds);
    if (timing) {
      clk[3] += clock64() - t0;
      t0 = clock64();
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DQ_BN / 16; ++kc)  // dQ += dS K, 16 keys (2048 B) a step
      wgmma_m64n64k16_rs(acc, ds[kc], desc_mn_major(k_addr + 2048 * kc, DQ_TILE_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + s);
    if (timing) clk[4] += clock64() - t0;
  }
  if (timing) t0 = clock64();
  store_rows(dq + bi * dqs.b + hi * dqs.h, dqs.s, row0, sq, acc, scale, g, u);
  if (timing) {
    clk[5] = clock64() - t0;
    clk[6] = max(0, min(sq - q0, DQ_BM));
    write_prof(prof, clk);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tstats, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int heads, int sq, int sk, Strides ks,
                     Strides vs, Strides dks, Strides dvs, float scale_log2, float scale,
                     long long* prof) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* tiles = base;  // [stage][Q, dO]
  float* st_tiles = reinterpret_cast<float*>(tiles + DKV_STAGES * 2 * DKV_TILE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(st_tiles + DKV_STAGES * 2 * DKV_BM);
  uint64_t* empty = full + DKV_STAGES;

  const int wg = threadIdx.x / WG_THREADS;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int k0 = blockIdx.x * DKV_BN;
  const int n_tiles = (sq + DKV_BM - 1) / DKV_BM;

  if (threadIdx.x == 0) init_barriers(full, DKV_STAGES, DKV_STAGES);
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG_THREADS) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % DKV_STAGES;
        if (j >= DKV_STAGES) mbar_wait(empty + s, ((j / DKV_STAGES) & 1) ^ 1);
        unsigned char* slot = tiles + s * 2 * DKV_TILE_BYTES;
        mbar_expect_tx(full + s, 2 * DKV_TILE_BYTES + DKV_STATS_BYTES);
        tma_load_4d(slot, &tq, full + s, 0, j * DKV_BM, hi, bi);
        tma_load_4d(slot + DKV_TILE_BYTES, &tdo, full + s, 0, j * DKV_BM, hi, bi);
        tma_load_2d(st_tiles + s * 2 * DKV_BM, &tstats, full + s, j * DKV_BM, 2 * bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int key0 = k0 + wg * 64 + warp * 16;  // this warp's keys: key0 + g (+ 8)
  const bool timing = prof != nullptr && threadIdx.x == 0;
  long long clk[PROF_SLOTS] = {};
  long long t0 = timing ? clock64() : 0;

  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, k + bi * ks.b + hi * ks.h, ks.s, key0 + g, sk, u);
  load_a_frags(vf, v + bi * vs.b + hi * vs.h, vs.s, key0 + g, sk, u);
  float dka[32], dva[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = st[i] = dpt[i] = 0.f;
  uint32_t pf[4][4], dsf[4][4];
  if (timing) clk[0] = clock64() - t0;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % DKV_STAGES;
    if (timing) t0 = clock64();
    mbar_wait(full + s, (j / DKV_STAGES) & 1);
    if (timing) {
      clk[1] += clock64() - t0;
      t0 = clock64();
    }
    const uint32_t q_addr = smem_u32(tiles + s * 2 * DKV_TILE_BYTES);
    const uint32_t do_addr = q_addr + DKV_TILE_BYTES;
    const float* ls = st_tiles + s * 2 * DKV_BM;  // lse * log2 e of the tile's rows
    const float* dsm = ls + DKV_BM;               // D
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
      wgmma_m64n64k16_rs_k(st, kf[kk], desc_k_major(q_addr + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
      wgmma_m64n64k16_rs_k(dpt, vf[kk], desc_k_major(do_addr + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    // P^T; element 4n + 2r + e is key g + 8r, query column 8n + 2u + e
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * u);
      st[4 * n + 0] = ex2_ftz(fmaf(st[4 * n + 0], scale_log2, -l.x));
      st[4 * n + 1] = ex2_ftz(fmaf(st[4 * n + 1], scale_log2, -l.y));
      st[4 * n + 2] = ex2_ftz(fmaf(st[4 * n + 2], scale_log2, -l.x));
      st[4 * n + 3] = ex2_ftz(fmaf(st[4 * n + 3], scale_log2, -l.y));
    }
    const int q0 = j * DKV_BM;
    if (q0 + DKV_BM > sq) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (q0 + 8 * (i >> 2) + 2 * u + (i & 1) >= sq) st[i] = 0.f;
    }
    pack_frags<8>(st, pf);
    if (timing) {
      clk[2] += clock64() - t0;
      t0 = clock64();
    }
    fence_regs(dva);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DKV_BM / 16; ++kc)  // dV += P^T dO, 16 queries (2048 B) a step
      wgmma_m64n64k16_rs(dva, pf[kc], desc_mn_major(do_addr + 2048 * kc, DKV_TILE_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV may still run
    fence_regs(dpt);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // dS^T = P^T (dP^T - D)
      const float2 dd = *reinterpret_cast<const float2*>(dsm + 8 * n + 2 * u);
      dpt[4 * n + 0] = st[4 * n + 0] * (dpt[4 * n + 0] - dd.x);
      dpt[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - dd.y);
      dpt[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - dd.x);
      dpt[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - dd.y);
    }
    pack_frags<8>(dpt, dsf);
    if (timing) {
      clk[3] += clock64() - t0;
      t0 = clock64();
    }
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DKV_BM / 16; ++kc)  // dK += dS^T Q
      wgmma_m64n64k16_rs(dka, dsf[kc], desc_mn_major(q_addr + 2048 * kc, DKV_TILE_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    mbar_arrive(empty + s);
    if (timing) clk[4] += clock64() - t0;
  }
  if (timing) t0 = clock64();
  store_rows(dk + bi * dks.b + hi * dks.h, dks.s, key0, sk, dka, scale, g, u);
  store_rows(dv + bi * dvs.b + hi * dvs.h, dvs.s, key0, sk, dva, 1.f, g, u);
  if (timing) {
    clk[5] = clock64() - t0;
    clk[6] = max(0, min(sk - k0, DKV_BN));
    write_prof(prof, clk);
  }
}

// -- the register-A products of K7 alone, for the card tests --

// out (64 x 64, f32, row-major) = a (64 x 64, bf16 contiguous, read into A
// fragments by load_a_frags) times b^T (which 0: b a contiguous [n][k]
// tile read K-major, K7's S^T = K Q^T) or b (which 1: b a contiguous
// [k][n] tile read MN-major, K7's dV += P^T dO).
__global__ void __launch_bounds__(WG_THREADS)
wgmma_bwd_probe_kernel(const __grid_constant__ CUtensorMap tb, const bf16* __restrict__ a,
                       float* __restrict__ out, int which) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* b_tile = align_1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_tile + DKV_TILE_BYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, DKV_TILE_BYTES);
    tma_load_4d(b_tile, &tb, bar, 0, 0, 0, 0);
  }
  uint32_t af[4][4];
  load_a_frags(af, a, D, warp * 16 + g, 64, u);
  mbar_wait(bar, 0);
  const uint32_t b_addr = smem_u32(b_tile);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
  if (which == 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs_k(acc, af[kk], desc_k_major(b_addr + 32 * kk), kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs(acc, af[kk], desc_mn_major(b_addr + 2048 * kk, DKV_TILE_BYTES));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out[(warp * 16 + g + 8 * ((i >> 1) & 1)) * D + 8 * (i >> 2) + 2 * u + (i & 1)] = acc[i];
}

// -- host --

// A 4-D map (d, s, h, b) of a bf16 (b, h, s, 64) view with element strides
// ``st``; boxes of ``box_rows`` x 64 with the 128-byte swizzle.
int make_map(CUtensorMap* map, const void* ptr, int s, int heads, int b, Strides st,
             int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)heads,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1, 1};
  return encode_bf16_map(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The dynamic shared-memory attribute once per device and kernel.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && !done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    done[dev] = e == cudaSuccess;
  }
  return e;
}

Strides st3(const long long* s) { return Strides{s[0], s[1], s[2]}; }

constexpr float SCALE = 0.125f;  // 1 / sqrt(64)

}  // namespace

// q/k/v/o/dout/dq/dk/dv: (b, h, s, 64) bf16 through element strides (b, h,
// s), 3 each in ``strides``, unit stride on d.  q, k, v and dout need
// 16-byte aligned bases and strides (tensor maps; k and v are read by K7
// with 4-byte loads), o 16-byte ones too (16-byte loads), dq/dk/dv 4-byte
// aligned rows.  lse: (b, h, sq) f32 from K1.  stats: (b*h, 2, pitch) f32
// scratch, pitch = sq rounded up to 4, that K8 writes and K7 reads, so K8
// runs first.  prof: null, or int64 PROF_SLOTS per block (grid x fastest)
// of clock64 phases.  Returns the cudaError_t of the launch, or 9001 where
// a tensor map could not be made.

// strides: q, k, v, o, dout, dq.
extern "C" int v3d_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout, const void* lse,
                                     void* stats, void* dq, int b, int heads, int sq, int sk,
                                     const long long* strides, void* prof, void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, sq, heads, b, st3(strides), DQ_BM);
  if (err == 0) err = make_map(&tk, k, sk, heads, b, st3(strides + 3), DQ_BN);
  if (err == 0) err = make_map(&tv, v, sk, heads, b, st3(strides + 6), DQ_BN);
  if (err == 0) err = make_map(&tdo, dout, sq, heads, b, st3(strides + 12), DQ_BM);
  if (err != 0) return err;
  static bool smem_set[64] = {};
  const cudaError_t e = set_smem(flash_bwd_dq_kernel, DQ_SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + DQ_BM - 1) / DQ_BM, b * heads);
  flash_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats), static_cast<bf16*>(dq),
      heads, sq, sk, (sq + 3) / 4 * 4, st3(strides + 9), st3(strides + 12),
      st3(strides + 15), SCALE * LOG2E, SCALE, static_cast<long long*>(prof));
  return (int)cudaGetLastError();
}

// strides: q, k, v, dout, dk, dv.
extern "C" int v3d_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* stats, void* dk, void* dv,
                                      int b, int heads, int sq, int sk,
                                      const long long* strides, void* prof, void* stream) {
  CUtensorMap tq, tdo, tstats;
  int err = make_map(&tq, q, sq, heads, b, st3(strides), DKV_BM);
  if (err == 0) err = make_map(&tdo, dout, sq, heads, b, st3(strides + 9), DKV_BM);
  if (err == 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)sq, 2ull * b * heads};
    const cuuint64_t pitch[1] = {(cuuint64_t)((sq + 3) / 4 * 4) * 4};
    const cuuint32_t box[2] = {(cuuint32_t)DKV_BM, 2};
    err = encode_map(&tstats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, stats, 2, dims, pitch, box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != 0) return err;
  static bool smem_set[64] = {};
  const cudaError_t e = set_smem(flash_bwd_dkv_kernel, DKV_SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sk + DKV_BN - 1) / DKV_BN, b * heads);
  flash_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tdo, tstats, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq, sk, st3(strides + 3),
      st3(strides + 6), st3(strides + 12), st3(strides + 15), SCALE * LOG2E, SCALE,
      static_cast<long long*>(prof));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block, in bytes: kernel 0 K8, 1 K7.
extern "C" long long v3d_flash_attn_bwd_smem(int kernel) {
  return (long long)(kernel == 0 ? DQ_SMEM : DKV_SMEM);
}

// K7's register-A products alone (see wgmma_bwd_probe_kernel): which 0:
// out (64, 64) = a (64, 64) @ b (64, 64)^T (B K-major); which 1: out = a @ b
// (B MN-major).  a, b contiguous bf16, out f32.
extern "C" int v3d_flash_bwd_wgmma_probe(int which, const void* a, const void* b, void* out,
                                         void* stream) {
  CUtensorMap tb;
  const int err = make_map(&tb, b, 64, 1, 1, Strides{64 * 64, 64 * 64, 64}, 64);
  if (err != 0) return err;
  const int smem = DKV_TILE_BYTES + 64 + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_bwd_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_bwd_probe_kernel<<<1, WG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tb, static_cast<const bf16*>(a), static_cast<float*>(out), which);
  return (int)cudaGetLastError();
}
