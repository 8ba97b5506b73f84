// K1: flash attention forward, softmax(Q K^T / sqrt(d)) V, no mask, d = 64.
//
// Replaces: v3d_tpu/ops/attention.py attention_bhsd, "flash_jax" branch
// (:154-168, the stock jax.experimental.pallas TPU flash kernel), and computes
// the math of v3d_tpu/ops/flash_attention.py _flash_forward (:68-94).
// Main path: spatial self-attention of the VideoUNet at ds1 (b*t=36, 5 heads,
// 4096 tokens) and ds2 (36, 10, 1024), 10 calls per UNet forward.
//
// What bounds it on the H100: arithmetic.  One ds1 call is ~7.7e11 FLOP over
// 9.4e7 bytes of q/k/v/o, far right of the ~295 FLOP/byte ridge.  Two
// variants, picked per call by dtype:
//
// - bf16 (the main path): both products on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate; no wgmma/TMA yet), in the
//   register layout of FlashAttention-2.  One block of 4 warps per
//   (batch*head, 64-row q tile); each warp owns 16 query rows, holds its Q
//   fragments, the 16 x 64 scores and the 16 x 64 f32 output accumulator in
//   registers.  K and V tiles of 64 keys are copied into shared memory by
//   cp.async in two stages, the next tile's copy overlapping this tile's
//   products, and every fragment is read with ldmatrix (V's transposed).
//   The score accumulators are reused as P's A fragments (packed to bf16),
//   and the online softmax reduces each row over the 4 lanes that share it.
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

#include "common.cuh"

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


// ---- tensor-core variant (bf16) -------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;               // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int LDH = D + 8;                // bf16 row pitch of the smem tiles
constexpr int TILE = 64 * LDH;            // elements of one 64-row tile
constexpr size_t TC_SMEM = 4 * TILE * sizeof(bf16);  // K and V tiles, two stages each

__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long stride, int rows_left,
                                           bool vec) {
  stage_tile64<TC_THREADS, LDH>(dst, src, stride, rows_left, vec);
}

// K and V tiles go through two shared-memory stages: tile kt + 1 is copied
// by cp.async while tile kt is computed.  All fragments come from ldmatrix:
// Q and K non-transposed from their [row][d] tiles, V transposed from its
// [key][d] tile (so V needs no transpose while it is staged).  With the mma
// fragment layout (common.cuh, mma_bf16), the S accumulator of two 8-key
// tiles is already P's A fragment.  Registers are capped so that 4 blocks
// (16 warps) share an SM: at the UNet's (36, 5, 4096, 64) that ran 18%
// faster than 3 blocks without the cap, despite 12 B of spills.
__global__ void __launch_bounds__(TC_THREADS, 4)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int heads, int sq, int sk, Strides qs,
                    Strides ks, Strides vs, Strides os, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Kt = reinterpret_cast<bf16*>(smem_raw);  // [2][64 keys][LDH]
  bf16* Vt = Kt + 2 * TILE;                      // [2][64 keys][LDH]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * 64;
  const bf16* qb = q + bi * qs.b + hi * qs.h;
  const bf16* kb = k + bi * ks.b + hi * ks.h;
  const bf16* vb = v + bi * vs.b + hi * vs.h;
  const bool vec = vec_ok(q, qs.b, qs.h, qs.s) && vec_ok(k, ks.b, ks.h, ks.s) &&
                   vec_ok(v, vs.b, vs.h, vs.s);
  // ldmatrix row addresses of this lane (bytes).  Q: row warp*16 + lane % 16,
  // d half lane / 16.  K: key lane % 8 + 8 * (lane / 16), d half (lane / 8) % 2
  // (registers 0-1 / 2-3: b0, b1 of two 8-key tiles).  V: key lane % 8 +
  // 8 * ((lane / 8) % 2), d half lane / 16 (b0, b1 of two 8-dim tiles).
  const uint32_t k_lane =
      smem_u32(Kt + (lane % 8 + 8 * (lane / 16)) * LDH + 8 * ((lane / 8) % 2));
  const uint32_t v_lane =
      smem_u32(Vt + (lane % 8 + 8 * ((lane / 8) % 2)) * LDH + 8 * (lane / 16));
  constexpr uint32_t TILE_B = TILE * sizeof(bf16);
  // softmax in base 2: scores scaled by log2(e) / sqrt(d), so exp2f (one
  // MUFU.EX2) gives the same probabilities as expf
  const float scale_log2 = scale * 1.4426950408889634f;

  // Q tile through K stage 1 (free until tile 1 is staged), K/V tile 0 into
  // stage 0
  stage_tile(Kt + TILE, qb + q0 * qs.s, qs.s, sq - q0, vec);
  stage_tile(Kt, kb, ks.s, sk, vec);
  stage_tile(Vt, vb, vs.s, sk, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4];
  const uint32_t q_lane =
      smem_u32(Kt + TILE + (warp * 16 + lane % 16) * LDH + 8 * (lane / 16));
#pragma unroll
  for (int ks_ = 0; ks_ < 4; ++ks_) ldmatrix_x4(qa[ks_], q_lane + 32 * ks_);
  __syncthreads();  // Q read by every warp before stage 1 is refilled

  float acc[8][4];  // O: 8 tiles of 8 head dims, rows g and g + 8
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  const int n_tiles = (sk + 63) / 64;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const int nb = (kt + 1) & 1, k0n = (kt + 1) * 64;
      stage_tile(Kt + nb * TILE, kb + k0n * ks.s, ks.s, sk - k0n, vec);
      stage_tile(Vt + nb * TILE, vb + k0n * vs.s, vs.s, sk - k0n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed
    const int k0 = kt * 64;
    const uint32_t kbase = k_lane + (kt & 1) * TILE_B;
    const uint32_t vbase = v_lane + (kt & 1) * TILE_B;

    float sc[8][4];  // S: 8 tiles of 8 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int ks_ = 0; ks_ < 4; ++ks_) {
        uint32_t b[4];
        ldmatrix_x4(b, kbase + (16 * np * LDH + 16 * ks_) * sizeof(bf16));
        mma_bf16(sc[2 * np], qa[ks_], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[ks_], b[2], b[3]);
      }
    }

    // online softmax for rows g (regs 0,1) and g + 8 (regs 2,3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * n + 2 * u + (i & 1);
        sc[n][i] = key < sk ? sc[n][i] * scale_log2 : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[n][i] = exp2f(sc[n][i] - m_r[i >> 1]);
        l_r[i >> 1] += sc[n][i];  // partial over this lane's columns
        acc[n][i] *= alpha[i >> 1];
      }
    }

    // O += P V: P's A fragments straight from the S registers
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      pa[1] = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      pa[2] = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      pa[3] = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vbase + (16 * j * LDH + 16 * dp) * sizeof(bf16));
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // stage kt & 1 is free for tile kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / l_r[r];
    // log-sum-exp of the scaled logits, natural log (m_r is in log2 units)
    if (lse != nullptr && u == 0)
      lse[(long long)bh * sq + row] = (m_r[r] + log2f(l_r[r])) * 0.6931471805599453f;
    bf16* ob = o + bi * os.b + hi * os.h + row * os.s;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n + 2 * u) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
              int b, int heads, int sq, int sk, Strides qs, Strides ks, Strides vs,
              Strides os, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + 63) / 64, b * heads);
  flash_fwd_tc_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, heads, sq, sk, qs,
      ks, vs, os, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/o: (b, h, s, 64) through element strides (b, h, s), unit stride on d.
// lse: null, or (b, h, sq) f32 that receives each row's log-sum-exp of the
// scaled logits (the residual of the backward, K7/K8).  Returns the
// cudaError_t of the launch.
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
