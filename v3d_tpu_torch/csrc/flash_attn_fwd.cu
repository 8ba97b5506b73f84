// K1: flash attention forward, softmax(Q K^T / sqrt(d)) V, no mask, d = 64.
//
// Replaces: v3d_tpu/ops/attention.py attention_bhsd, "flash_jax" branch
// (:154-168, the stock jax.experimental.pallas TPU flash kernel), and computes
// the math of v3d_tpu/ops/flash_attention.py _flash_forward (:68-94).
// Main path: spatial self-attention of the VideoUNet at ds1 (b*t=36, 5 heads,
// 4096 tokens) and ds2 (36, 10, 1024), 10 calls per UNet forward.
//
// What bounds it on the H100: arithmetic.  One ds1 call (36, 5, 4096, 64) is
// 7.7e11 FLOP over 3.8e8 bytes of q/k/v/o: 0.782 ms at the 989 TFLOP/s bf16
// peak against 0.113 ms of bytes; a ds2 call (36, 10, 1024, 64) 0.098 ms.
// Two variants, picked per call by dtype:
//
// - bf16 (the main path): the forward of FlashAttention-3 on wgmma and TMA.
//   One block of 384 threads per (batch*head, 128 query rows): warpgroups 0
//   and 1 are consumers of 64 query rows each, warpgroup 2 the producer,
//   whose one elected thread issues every load (setmaxnreg gives the
//   producer 40 registers a thread and the consumers 232).  The producer
//   loads the Q tile once, then each 128-key K and V tile (16 KB each)
//   into a ring of STAGES slots, each slot with a K-full, a V-full and an
//   empty mbarrier; every load is one cp.async.bulk.tensor of a 4-D tensor
//   map (d, s, h, b) built per call from the caller's strides, with the
//   128-byte swizzle (one 64-wide bf16 row is 128 bytes), so any (b, h, s)
//   view with 16-byte strides is read in place; rows past the sequence come
//   in as zeros.  A consumer computes S = Q K^T with four
//   wgmma.m64n128k16 (Q and K both K-major from shared memory), runs the
//   online softmax in base 2 on the accumulator registers (a row spans the
//   4 lanes of a quad; keys past sk are set to -inf), converts P to bf16 A
//   fragments in registers (the accumulator layout of two 8-key chunks is
//   the A fragment of one 16-key chunk) and adds P V with eight
//   wgmma.m64n64k16, A from registers and B = V from shared memory,
//   MN-major.  It then releases the slot.  The epilogue divides by the row
//   sum, stores O in bf16 through the caller's strides and writes the
//   log-sum-exp (natural log, f32, contiguous (b, h, sq)) that K7/K8 read.
//   The wrapper (ops/attention.py tma_operand) copies an operand whose base
//   or strides are not 16-byte multiples into an aligned buffer first.
//   Each warpgroup runs its tile's products and softmax in turn (S, wait,
//   softmax, P V, wait); the two warpgroups and the producer overlap one
//   another.  Issuing S of the next tile before P V of this one, and
//   FlashAttention-3's ping-pong of the two warpgroups, measured no faster
//   on the card (PERF.md).
//   The mbarrier, TMA, descriptor and wgmma helpers live in hopper.cuh,
//   shared with K2 (temporal_block.cu).
//   Per block: 384 threads, 168 registers a thread at entry (ptxas, 0
//   spilled; chip_smoke.py phase 2), 115,792 bytes of dynamic shared memory
//   (Q 16 KB + 3 x (K + V) 96 KB + barriers + alignment; phase 3), so one
//   block per SM.
// - f32: the CUDA cores, f32 FMA, described below.
//
// f32 design: one block per (batch*head, 64-row q tile), 256 threads.  The block
// walks the key/value sequence in 64-row tiles staged in shared memory (f32,
// padded rows so the 16 lanes that read 16 different key rows hit 16 banks).
// Each thread owns a 4x4 register tile of the scores and of the output: rows
// 4*(tid/16)+i, columns (tid%16)+16*j.  The 16 lanes that share a row group
// are one half-warp, so the running max and sum of each row are reduced with
// width-16 shuffles and never leave registers; only P goes through shared
// memory for the P V product.  Running max, sum and the output accumulator
// are f32 for both input types.  A ragged last key tile is masked to -inf;
// ragged query rows are loaded as zeros and not stored.
// q/k/v are read and o is written through their (b, h, s) strides (d must be
// unit-stride), so the strided projection output needs no copy, and o lands
// in the (b, s, h, d) order the output projection reads.
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int D = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LD = D + 1;  // padded pitch of the Q/K/P tiles

struct Strides {
  long long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int sq,
                 int sk, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD], pre-scaled
  float* Ks = Qs + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][LD]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = q0 + r;
    Qs[r * LD + c] = row < sq ? to_f(qb[row * qs.s + c]) * scale : 0.f;
  }

  const int rg = tid / 16;  // row group: rows 4*rg .. 4*rg+3
  const int cg = tid % 16;  // column group: cols cg + 16*j
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int row = k0 + r;
      const bool ok = row < sk;
      Ks[r * LD + c] = ok ? to_f(kb[row * ks.s + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f(vb[row * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(4 * rg + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(cg + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + cg + 16 * j >= sk) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * rg + i) * LD + cg + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(4 * rg + i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Vs[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  T* ob = o + bi * os.b + hi * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ob[row * os.s + cg + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (lse != nullptr && cg == 0) lse[(long long)bh * sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int heads, int sq, int sk, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * LD + BK * LD + BK * D + BQ * LD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, b * heads);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, heads, sq, sk, qs, ks, vs, os, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}


// ---- wgmma + TMA variant (bf16) --------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 2;              // warpgroups of 64 query rows
constexpr int BM = 64 * CONSUMERS;        // query rows per block
constexpr int BN = 128;                   // keys per K/V tile
constexpr int STAGES = 3;                 // K/V ring slots
constexpr int WG_THREADS = 128;
constexpr int TC_THREADS = (CONSUMERS + 1) * WG_THREADS;  // the producer last
// registers a thread after setmaxnreg, within the SM's 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert((CONSUMERS * CONSUMER_REGS + PRODUCER_REGS) * WG_THREADS <= 65536,
              "setmaxnreg asks for more registers than an SM has");
constexpr uint32_t TILE_BYTES = BN * D * 2;  // 16 KB: one 128 x 64 bf16 tile
constexpr uint32_t Q_BYTES = BM * D * 2;
// Q, STAGES x (K, V), the barriers, and 1 KB to align the tiles to the
// 1024-byte period of the 128-byte swizzle
constexpr size_t TC_SMEM = Q_BYTES + 2 * STAGES * TILE_BYTES + 8 * (1 + 3 * STAGES) + 1024;

// V read MN-major (keys are the reduction dim; d contiguous): LBO is the
// stride between 64-wide column atoms, of which d = 64 has one.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return sw128_desc(addr, TILE_BYTES);
}

// S(64 x 128) = Q(64 x 64) K^T: four k-steps of 16 head dims, each 32
// bytes further along the swizzled 128-byte rows.
__device__ __forceinline__ void product_qk(float (&s)[64], uint32_t q_addr,
                                           uint32_t k_addr) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(s, desc_k_major(q_addr + 32 * kk),
                        desc_k_major(k_addr + 32 * kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// O(64 x 64) += P(64 x 128) V: eight k-steps of 16 keys, each 16 rows
// (2048 bytes) further down the V tile.
__device__ __forceinline__ void product_pv(float (&o)[32], const uint32_t (&p)[8][4],
                                           uint32_t v_addr) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    wgmma_m64n64k16_rs(o, p[kc], desc_mn_major(v_addr + 2048 * kc));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// P's A fragments for the P V product from the S accumulator: key chunk kc
// (keys 16kc..16kc+15) is S's column chunks 2kc and 2kc + 1.
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    p[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                       float* __restrict__ lse, int heads, int sq, int sk, Strides os,
                       float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* q_tile = base;
  unsigned char* k_tiles = base + Q_BYTES;
  unsigned char* v_tiles = k_tiles + STAGES * TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_tiles + STAGES * TILE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int wg = threadIdx.x / WG_THREADS;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG_THREADS) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load_4d(q_tile, &tq, q_full, 0, q0, hi, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, TILE_BYTES);
        tma_load_4d(k_tiles + s * TILE_BYTES, &tk, k_full + s, 0, j * BN, hi, bi);
        mbar_expect_tx(v_full + s, TILE_BYTES);
        tma_load_4d(v_tiles + s * TILE_BYTES, &tv, v_full + s, 0, j * BN, hi, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, u = lane % 4;
    const uint32_t q_addr = smem_u32(q_tile + wg * (Q_BYTES / CONSUMERS));
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t pa[8][4];
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t parity = (j / STAGES) & 1;
      mbar_wait(k_full + s, parity);
      product_qk(sc, q_addr, smem_u32(k_tiles + s * TILE_BYTES));

      // online softmax in base 2 on raw scores: p = 2^(s * scale_log2 - m),
      // m the running max in scaled units (scale_log2 > 0 keeps the argmax)
      const int k0 = j * BN;
      if (k0 + BN > sk) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (k0 + 8 * (i >> 2) + 2 * u + (i & 1) >= sk) sc[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
        alpha[r] = exp2f(m_r[r] - m_new);
        m_r[r] = m_new;
        neg_m[r] = -m_new;
        l_r[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, neg_m[r]));
        l_r[r] += sc[i];  // this lane's columns; the quad is summed at the end
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p(sc, pa);

      mbar_wait(v_full + s, parity);
      product_pv(acc, pa, smem_u32(v_tiles + s * TILE_BYTES));
      mbar_arrive(empty + s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      const float inv = 1.f / l_r[r];
      // natural log of the row's sum of exp(scaled logits); m_r is in log2
      if (lse != nullptr && u == 0)
        lse[(long long)bh * sq + row] = (m_r[r] + log2f(l_r[r])) * 0.6931471805599453f;
      bf16* orow = o + bi * os.b + hi * os.h + row * os.s;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * u) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
  }
}

// -- host: tensor maps --

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

int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
              int b, int heads, int sq, int sk, Strides qs, Strides ks, Strides vs,
              Strides os, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, sq, heads, b, qs, BM);
  if (err == 0) err = make_map(&tk, k, sk, heads, b, ks, BN);
  if (err == 0) err = make_map(&tv, v, sk, heads, b, vs, BN);
  if (err != 0) return err;
  // the shared-memory attribute once per device, not at every launch
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && !smem_set[dev]) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
    smem_set[dev] = e == cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + BM - 1) / BM, b * heads);
  flash_fwd_wgmma_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, heads, sq, sk, os,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// -- the two products alone, for the card tests --

// which = 0: S (64 x 128, f32, row-major) = Q (64 x 64) K^T (K 128 x 64),
// both bf16 contiguous, loaded by TMA as the kernel loads them.
// which = 1: O (64 x 64, f32) = P (64 x 128, bf16 contiguous, read into A
// fragments) V (128 x 64, bf16 contiguous, loaded by TMA).
__global__ void __launch_bounds__(WG_THREADS)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, const bf16* __restrict__ p,
                   float* __restrict__ out, int which) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* a_tile = base;
  unsigned char* b_tile = base + TILE_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_tile + TILE_BYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, which == 0 ? TILE_BYTES / 2 + TILE_BYTES : TILE_BYTES);
    if (which == 0) tma_load_4d(a_tile, &ta, bar, 0, 0, 0, 0);
    tma_load_4d(b_tile, &tb, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  if (which == 0) {
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    product_qk(s, smem_u32(a_tile), smem_u32(b_tile));
#pragma unroll
    for (int i = 0; i < 64; ++i)
      out[(warp * 16 + g + 8 * ((i >> 1) & 1)) * BN + 8 * (i >> 2) + 2 * u + (i & 1)] = s[i];
  } else {
    float s[64];  // P in the S accumulator layout, then packed as K1 packs it
#pragma unroll
    for (int i = 0; i < 64; ++i)
      s[i] = __bfloat162float(
          p[(warp * 16 + g + 8 * ((i >> 1) & 1)) * BN + 8 * (i >> 2) + 2 * u + (i & 1)]);
    uint32_t pa[8][4];
    pack_p(s, pa);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    product_pv(acc, pa, smem_u32(b_tile));
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[(warp * 16 + g + 8 * ((i >> 1) & 1)) * D + 8 * (i >> 2) + 2 * u + (i & 1)] = acc[i];
  }
}

}  // namespace

// q/k/v/o: (b, h, s, 64) through element strides (b, h, s), unit stride on d.
// lse: null, or (b, h, sq) f32 that receives each row's log-sum-exp of the
// scaled logits (the residual of the backward, K7/K8).  bf16 q/k/v need
// 16-byte aligned bases and (b, h, s) strides in multiples of 8 elements
// (a dim of size 1 may carry any such stride).  Returns the cudaError_t of
// the launch, or 9001 where a tensor map could not be made.
extern "C" int v3d_flash_attn_fwd(int dtype, const void* q, const void* k,
                                  const void* v, void* o, int b, int heads,
                                  int sq, int sk, long long qsb, long long qsh,
                                  long long qss, long long ksb, long long ksh,
                                  long long kss, long long vsb, long long vsh,
                                  long long vss, long long osb, long long osh,
                                  long long oss, void* lse, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == V3D_F32)
    return launch<float>(q, k, v, o, static_cast<float*>(lse), b, heads, sq, sk, qs,
                         ks, vs, os, st);
  if (dtype == V3D_BF16)
    return launch_tc(q, k, v, o, static_cast<float*>(lse), b, heads, sq, sk, qs, ks,
                     vs, os, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one bf16 block, in bytes.
extern "C" long long v3d_flash_attn_fwd_smem() { return (long long)TC_SMEM; }

// One of the bf16 kernel's two products alone (see wgmma_probe_kernel):
// which 0: out (64, 128) = a (64, 64) @ b (128, 64)^T; which 1: out (64, 64)
// = a (64, 128) @ b (128, 64).  a, b contiguous bf16, out f32.
extern "C" int v3d_flash_wgmma_probe(int which, const void* a, const void* b, void* out,
                                     void* stream) {
  CUtensorMap ta, tb;
  int err = 0;
  if (which == 0) err = make_map(&ta, a, 64, 1, 1, Strides{64 * 64, 64 * 64, 64}, 64);
  if (err == 0) err = make_map(&tb, b, BN, 1, 1, Strides{BN * 64, BN * 64, 64}, BN);
  if (err != 0) return err;
  if (which != 0) ta = tb;
  const int smem = 2 * TILE_BYTES + 64 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_probe_kernel<<<1, WG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const bf16*>(a), static_cast<float*>(out), which);
  return (int)cudaGetLastError();
}
