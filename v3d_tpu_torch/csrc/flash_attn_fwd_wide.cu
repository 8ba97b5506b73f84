// K9: flash attention forward for the head widths K1 lacks, d = 80, 128, 512:
// softmax(Q K^T / sqrt(d)) V, no mask.
//
// Replaces: v3d_tpu/ops/flash_attention.py _flash_forward (:68-94, kernel
// _flash_kernel :31, T2) where d != 64, and _flash_packed_forward (:196-235,
// T4), which computes the same function.  Main path: the VAE's single-head
// mid-block attention, d = 512, under the "flash" and "packed" backends
// (encode (1, 4096, 1, 512), the 18-frame decode (18, 4096, 1, 512)); CLIP
// ViT-H's d = 80 under "packed" (1, 257, 16, 80); d = 128 as in the JAX
// package's own flash test.  d = 64 stays on K1.
//
// What bounds it on the H100: arithmetic.  The 18-frame decode is 6.2e11
// FLOP over 3e8 bytes of q/k/v/o, far right of the ~295 FLOP/byte ridge.
//
// Why not K1's layout: K1 keeps each warp's 16 query rows x d of f32 output
// in registers, 32 a lane at d = 64 but 256 at d = 512.  Here the output
// accumulator is split over the d columns instead, and the two products are
// split differently over the warps, with the scores and P passed through
// shared memory:
//
// - bf16 (tensor cores, mma.sync.m16n8k16, f32 accumulate): one block of 8
//   warps per (batch*head, 64-row q tile).  The Q tile stays in shared
//   memory (64 KB at d = 512); K and V come in tiles of 32 keys, two stages
//   each, copied by cp.async while the previous tile is computed (128 KB at
//   d = 512).  S = Q K^T: warp w takes query rows 16 (w % 4) .. +15 against
//   keys 16 (w / 4) .. +15 and writes its scores (log2 units) to shared
//   memory.  Softmax: 4 threads per query row keep the running max and sum
//   in registers and write P as bf16 and the row's rescale factor.  O += P V:
//   warp w owns rows 16 (w % 4) .. +15 and columns (d / 2) (w / 4) .. +d/2 - 1,
//   d / 16 tiles of 8 columns, so the accumulator is d / 4 f32 registers a
//   lane (128 at d = 512).  Every fragment comes from ldmatrix (V's
//   transposed); rows are padded by 16 bytes, so the 8 rows of a matrix hit
//   8 different bank groups.
// - f32 (CUDA cores, FMA): one block of 256 threads per (batch*head, 32-row q
//   tile), K/V tiles of 32 keys in shared memory with odd row pitches; each
//   thread owns 4 scores (row tid / 8) and d / 8 output columns of that row;
//   the running max and sum are reduced over the 8 lanes of a row.
//
// Both: f32 softmax and accumulation; keys past sk are masked to -inf and
// their V rows zeroed, query rows past sq are zero and not stored.  q/k/v are
// read and o is written through their (b, h, s) strides (unit stride on d),
// so the (b, s, h, d) projection output needs no copy and o lands in the
// (b, s, h, d) order.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;
};

// ---- tensor-core variant (bf16) -------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int BQ = 64;       // query rows of a block: 4 groups of 16
constexpr int BK = 32;       // keys of a tile: 2 halves of 16
constexpr int LDS = BK + 1;  // f32 pitch of the score tile
constexpr int LDP = BK + 8;  // bf16 pitch of the P tile (80 bytes)

// shared-memory carve-up of the bf16 kernel, byte offsets
template <int D>
struct TcLayout {
  static constexpr int LDH = D + 8;  // bf16 pitch of the Q/K/V rows
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * BQ * LDH;
  static constexpr size_t V = K + sizeof(bf16) * 2 * BK * LDH;
  static constexpr size_t S = V + sizeof(bf16) * 2 * BK * LDH;
  static constexpr size_t P = S + sizeof(float) * BQ * LDS;
  static constexpr size_t ALPHA = P + sizeof(bf16) * BQ * LDP;
  static constexpr size_t L = ALPHA + sizeof(float) * BQ;
  static constexpr size_t BYTES = L + sizeof(float) * BQ;
};

// Stage ROWS rows of a (rows, D) bf16 matrix (row stride ``stride``) into a
// [ROWS][LDT] shared tile; rows past ``rows_left`` are zero.  With ``vec``,
// 16-byte cp.async copies that the caller commits and waits for; otherwise
// plain element loads.
template <int ROWS, int D, int LDT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride,
                                           int rows_left, bool vec) {
  if (vec) {
    constexpr int CH = D / 8;  // 16-byte chunks of a row
    for (int e = threadIdx.x; e < ROWS * CH; e += TC_THREADS) {
      const int r = e / CH, c = (e % CH) * 8;
      if (r < rows_left)
        cp_async16(dst + r * LDT + c, src + r * stride + c);
      else
        *reinterpret_cast<uint4*>(dst + r * LDT + c) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += TC_THREADS) {
      const int r = e / D, c = e % D;
      dst[r * LDT + c] = r < rows_left ? src[r * stride + c] : __float2bfloat16(0.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_wide_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int heads,
                     int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale_log2) {
  using L = TcLayout<D>;
  constexpr int LDH = L::LDH;
  constexpr int NT = D / 16;  // 8-column output tiles of a warp (half of d)
  static_assert(D % 16 == 0, "d must be a multiple of 16");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);       // [BQ][LDH]
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);       // [2][BK][LDH]
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);       // [2][BK][LDH]
  float* Ss = reinterpret_cast<float*>(smem + L::S);     // [BQ][LDS]
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);       // [BQ][LDP]
  float* alpha_s = reinterpret_cast<float*>(smem + L::ALPHA);
  float* l_s = reinterpret_cast<float*>(smem + L::L);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int rg = warp & 3;     // this warp's 16-row group
  const int half = warp >> 2;  // its key half (S) and column half (P V)
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + bi * qs.b + hi * qs.h;
  const bf16* kb = k + bi * ks.b + hi * ks.h;
  const bf16* vb = v + bi * vs.b + hi * vs.h;
  const bool vec = vec_ok(q, qs.b, qs.h, qs.s) && vec_ok(k, ks.b, ks.h, ks.s) &&
                   vec_ok(v, vs.b, vs.h, vs.s);

  stage_rows<BQ, D, LDH>(Qs, qb + (long long)q0 * qs.s, qs.s, sq - q0, vec);
  stage_rows<BK, D, LDH>(Ks, kb, ks.s, sk, vec);
  stage_rows<BK, D, LDH>(Vs, vb, vs.s, sk, vec);
  cp_async_commit();

  // ldmatrix row addresses of this lane.  Q and P (A operands): row
  // 16 rg + lane % 16, column half lane / 16.  K (non-transposed B of S):
  // key 16 half + lane % 8 + 8 (lane / 16), d half (lane / 8) % 2 (registers
  // 0-1 / 2-3: b0, b1 of two 8-key tiles).  V (transposed B of P V, x2):
  // key lane % 16 of the 16-key step, at this warp's column half.
  const uint32_t q_lane = smem_u32(Qs + (rg * 16 + lane % 16) * LDH + 8 * (lane / 16));
  const uint32_t k_lane = smem_u32(
      Ks + (half * 16 + lane % 8 + 8 * (lane / 16)) * LDH + 8 * ((lane / 8) % 2));
  const uint32_t p_lane = smem_u32(Ps + (rg * 16 + lane % 16) * LDP + 8 * (lane / 16));
  const uint32_t v_lane = smem_u32(Vs + (lane % 16) * LDH + half * (D / 2));
  constexpr uint32_t STAGE_B = sizeof(bf16) * BK * LDH;

  // softmax role: 4 consecutive lanes per query row, 8 keys each
  const int sr = tid / 4, sp = tid % 4;
  float m_run = -INFINITY, l_run = 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int n_tiles = (sk + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_tiles) {
      const int k0n = (kt + 1) * BK;
      stage_rows<BK, D, LDH>(Ks + (st ^ 1) * BK * LDH, kb + (long long)k0n * ks.s, ks.s,
                             sk - k0n, vec);
      stage_rows<BK, D, LDH>(Vs + (st ^ 1) * BK * LDH, vb + (long long)k0n * vs.s, vs.s,
                             sk - k0n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q) have landed

    // S = Q K^T: 16 rows x 16 keys a warp, over d
    {
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
      const uint32_t kbase = k_lane + st * STAGE_B;
#pragma unroll 8
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, q_lane + 32 * kk);
        ldmatrix_x4(b, kbase + 32 * kk);
        mma_bf16(sc[0], a, b[0], b[1]);
        mma_bf16(sc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Ss[(rg * 16 + g + 8 * (i >> 1)) * LDS + half * 16 + 8 * n + 2 * u + (i & 1)] =
              sc[n][i] * scale_log2;
    }
    __syncthreads();

    // online softmax of row sr over this tile's keys (base 2: exp2f)
    {
      const int k0 = kt * BK;
      float s[8], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = sp * 8 + j;
        s[j] = k0 + key < sk ? Ss[sr * LDS + key] : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);  // finite: key k0 < sk is in every tile
      const float alpha = exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[j] - m_new);
        sum += p;
        Ps[sr * LDP + sp * 8 + j] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sp == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V for 16 rows x d / 2 columns a warp
    {
      const float a0 = alpha_s[rg * 16 + g], a1 = alpha_s[rg * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
      const uint32_t vbase = v_lane + st * STAGE_B;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        ldmatrix_x4(pa, p_lane + 32 * kk);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, vbase + sizeof(bf16) * (16 * kk * LDH + 8 * n));
          mma_bf16(acc[n], pa, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // stage st, S, P and alpha are free for the next tile
  }

  if (sp == 0) l_s[sr] = l_run;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = rg * 16 + g + 8 * r;
    const int row = q0 + lr;
    if (row >= sq) continue;
    const float inv = 1.f / l_s[lr];
    bf16* ob = o + bi * os.b + hi * os.h + (long long)row * os.s + half * (D / 2);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * n + 2 * u) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b, int heads,
              int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
              cudaStream_t stream) {
  constexpr size_t smem = TcLayout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, b * heads);
  flash_wide_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), heads, sq, sk, qs, ks, vs, os,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// ---- CUDA-core variant (f32) ----------------------------------------------

constexpr int F_THREADS = 256;
constexpr int FQ = 32;  // query rows of a block: 8 threads a row
constexpr int FK = 32;  // keys of a tile

template <int D>
constexpr size_t f32_smem() {
  return sizeof(float) * (FQ * (D + 1) + FK * (D + 1) + FK * D + FQ * (FK + 1));
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int heads,
                      int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                      float scale_log2) {
  constexpr int LDQ = D + 1;   // odd pitch: 8 lanes on 8 key rows hit 8 banks
  constexpr int NC = D / 8;    // output columns of a thread
  static_assert(D % 8 == 0, "d must be a multiple of 8");
  extern __shared__ float fsm[];
  float* Qs = fsm;              // [FQ][LDQ], pre-scaled (log2 units)
  float* Ks = Qs + FQ * LDQ;    // [FK][LDQ]
  float* Vs = Ks + FK * LDQ;    // [FK][D]
  float* Ps = Vs + FK * D;      // [FQ][FK + 1]

  const int tid = threadIdx.x;
  const int r = tid / 8, c8 = tid % 8;  // row r; keys / columns c8 + 8 j
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * FQ;
  const float* qb = q + bi * qs.b + hi * qs.h;
  const float* kb = k + bi * ks.b + hi * ks.h;
  const float* vb = v + bi * vs.b + hi * vs.h;

  for (int e = tid; e < FQ * D; e += F_THREADS) {
    const int rr = e / D, c = e % D;
    const int row = q0 + rr;
    Qs[rr * LDQ + c] = row < sq ? qb[(long long)row * qs.s + c] * scale_log2 : 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f, acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += FK) {
    __syncthreads();  // the previous tile's K/V/P reads are done (and Q stored)
    for (int e = tid; e < FK * D; e += F_THREADS) {
      const int rr = e / D, c = e % D;
      const int key = k0 + rr;
      const bool ok = key < sk;
      Ks[rr * LDQ + c] = ok ? kb[(long long)key * ks.s + c] : 0.f;
      Vs[rr * D + c] = ok ? vb[(long long)key * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[r * LDQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = fmaf(qv, Ks[(c8 + 8 * j) * LDQ + c], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + c8 + 8 * j >= sk) s[j] = -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 8));
    const float m_new = fmaxf(m_run, mx);  // finite: key k0 < sk is in every tile
    const float alpha = exp2f(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = exp2f(s[j] - m_new);
      Ps[r * (FK + 1) + c8 + 8 * j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off, 8);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] *= alpha;
    __syncthreads();  // P of every row is stored

#pragma unroll 4
    for (int kk = 0; kk < FK; ++kk) {
      const float p = Ps[r * (FK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[j] = fmaf(p, Vs[kk * D + c8 + 8 * j], acc[j]);
    }
  }

  const int row = q0 + r;
  if (row >= sq) return;
  const float inv = 1.f / l_run;
  float* ob = o + bi * os.b + hi * os.h + (long long)row * os.s;
#pragma unroll
  for (int j = 0; j < NC; ++j) ob[c8 + 8 * j] = acc[j] * inv;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int heads,
               int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + FQ - 1) / FQ, b * heads);
  flash_wide_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, sq, sk, qs, ks, vs, os,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int b,
           int heads, int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  if (dtype == V3D_F32) return launch_f32<D>(q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, stream);
  if (dtype == V3D_BF16) return launch_tc<D>(q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/o: (b, h, s, d) through element strides (b, h, s), unit stride on d,
// d one of 80, 128, 512 (anything else: cudaErrorInvalidValue).  o's strides
// must be even (the wrapper allocates it).  Returns the cudaError_t of the
// launch.
extern "C" int v3d_flash_attn_fwd_wide(int dtype, int d, const void* q, const void* k,
                                       const void* v, void* o, int b, int heads, int sq,
                                       int sk, long long qsb, long long qsh, long long qss,
                                       long long ksb, long long ksh, long long kss,
                                       long long vsb, long long vsh, long long vss,
                                       long long osb, long long osh, long long oss,
                                       void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 80:
      return launch<80>(dtype, q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, st);
    case 512:
      return launch<512>(dtype, q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory one block of v3d_flash_attn_fwd_wide takes
// for ``dtype`` and ``d`` (0 for a width it lacks).
extern "C" long long v3d_flash_attn_fwd_wide_smem(int dtype, int d) {
  const bool bf = dtype == V3D_BF16;
  switch (d) {
    case 80:
      return (long long)(bf ? TcLayout<80>::BYTES : f32_smem<80>());
    case 128:
      return (long long)(bf ? TcLayout<128>::BYTES : f32_smem<128>());
    case 512:
      return (long long)(bf ? TcLayout<512>::BYTES : f32_smem<512>());
    default:
      return 0;
  }
}
