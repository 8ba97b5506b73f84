// K7 / K8: flash attention backward, d = 64, bf16 in, f32 accumulation.
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
// What bounds it on the H100: arithmetic, five 64-deep products per (q, k)
// pair where the forward has two (2.5x the forward's FLOPs; 0.98 ms of
// tensor-core time at ds1), with no per-pair bytes.  Design, kept simple
// (speed is later work): the stock split into two kernels, both on
// mma.sync.m16n8k16 with fragments by ldmatrix, as K1's forward:
//
// - K8 flash_bwd_dq_kernel, first: one block of 4 warps per (batch*head,
//   64 query rows); each warp holds its 16 rows' Q and dO fragments and a
//   16 x 64 f32 dQ accumulator in registers and walks all key tiles (K and V
//   staged by cp.async in two stages).  It also computes D for its rows and
//   writes it for K7, so there is no third, preprocessing kernel.
// - K7 flash_bwd_dkv_kernel: one block per (batch*head, 64 keys); each warp
//   holds its 16 keys' K and V fragments and 16 x 64 dK and dV accumulators
//   and walks all query tiles (Q, dO, lse, D staged in two stages), computing
//   S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are A fragments straight
//   from the accumulators (packed to bf16) for dV += P^T dO and dK += dS^T Q.
// Scores use base 2 (lse and scale premultiplied by log2 e), as K1 does.
// Ragged tiles: rows past the end are staged as zeros; P is forced to 0 for
// keys (K8) or queries (K7) past the end, and rows past the end are not
// stored.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int THREADS = 128;              // 4 warps, 16 rows each
constexpr int LDH = D + 8;                // bf16 row pitch of the smem tiles
constexpr int TILE = 64 * LDH;            // elements of one 64-row tile
constexpr uint32_t TILE_B = TILE * sizeof(bf16);
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// ldmatrix lane offsets (elements) inside a [64][LDH] tile.
// A operand, 16 rows of this warp x 16 of the contraction (K1's Q):
__device__ __forceinline__ int a_lane(int warp, int lane) {
  return (warp * 16 + lane % 16) * LDH + 8 * (lane / 16);
}
// B operand from an [n][k] tile, non-transposed (K1's K):
__device__ __forceinline__ int bn_lane(int lane) {
  return (lane % 8 + 8 * (lane / 16)) * LDH + 8 * ((lane / 8) % 2);
}
// B operand from a [k][n] tile, transposed by ldmatrix (K1's V):
__device__ __forceinline__ int bk_lane(int lane) {
  return (lane % 8 + 8 * ((lane / 8) % 2)) * LDH + 8 * (lane / 16);
}

__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long stride,
                                      int rows_left, bool vec) {
  stage_tile64<THREADS, LDH>(dst, src, stride, rows_left, vec);
}

// acc[8][4] (16 rows x 64 cols) += A (16 x 64 as four k-steps of packed
// registers in ``a``) times B, B = 64 x 64 from a tile at lane address
// ``b_lane`` read non-transposed ([n][k] tile).
__device__ __forceinline__ void mma_rows_nt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                            uint32_t b_lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, b_lane + (16 * np * LDH + 16 * ks) * sizeof(bf16));
      mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc[8][4] += P B where P (16 x 64) is the f32 accumulator ``p`` packed to
// bf16 A fragments and B = 64 x 64 from a [k][n] tile at ``b_lane``
// (transposed by ldmatrix).
__device__ __forceinline__ void mma_rows_pn(float (&acc)[8][4], const float (&p)[8][4],
                                            uint32_t b_lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * j][0], p[2 * j][1]);
    pa[1] = pack_bf16(p[2 * j][2], p[2 * j][3]);
    pa[2] = pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    pa[3] = pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_lane + (16 * j * LDH + 16 * dp) * sizeof(bf16));
      mma_bf16(acc[2 * dp], pa, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
}

// Store a warp's 16 x 64 accumulator times ``mul`` as bf16 rows row0 + g and
// row0 + g + 8 (rows past ``rows`` skipped) of a (s, 64) matrix.
__device__ __forceinline__ void store_rows(bf16* base, long long stride, int row0,
                                           int rows, const float (&acc)[8][4],
                                           float mul, int g, int u) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    bf16* p = base + row * stride;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * n + 2 * u) =
          __floats2bfloat162_rn(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
  }
}

constexpr size_t DQ_SMEM = 6 * TILE * sizeof(bf16) + 2 * 64 * sizeof(float);

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dsum, bf16* __restrict__ dq, int heads,
                    int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
                    Strides dos, Strides dqs, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Kt = reinterpret_cast<bf16*>(smem_raw);  // [2][64 keys][LDH]
  bf16* Vt = Kt + 2 * TILE;                      // [2][64 keys][LDH]
  bf16* Qt = Vt + 2 * TILE;                      // [64 rows][LDH]
  bf16* Ot = Qt + TILE;                          // dO, [64 rows][LDH]
  float* Ls = reinterpret_cast<float*>(Ot + TILE);  // lse * log2 e
  float* Ds = Ls + 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * 64;
  const bf16* qb = q + bi * qs.b + hi * qs.h;
  const bf16* kb = k + bi * ks.b + hi * ks.h;
  const bf16* vb = v + bi * vs.b + hi * vs.h;
  const bf16* ob = o + bi * os.b + hi * os.h;
  const bf16* dob = dout + bi * dos.b + hi * dos.h;
  const bool vec = vec_ok(q, qs.b, qs.h, qs.s) && vec_ok(k, ks.b, ks.h, ks.s) &&
                   vec_ok(v, vs.b, vs.h, vs.s) && vec_ok(dout, dos.b, dos.h, dos.s);
  const float scale_log2 = scale * LOG2E;

  stage(Qt, qb + q0 * qs.s, qs.s, sq - q0, vec);
  stage(Ot, dob + q0 * dos.s, dos.s, sq - q0, vec);
  stage(Kt, kb, ks.s, sk, vec);
  stage(Vt, vb, vs.s, sk, vec);
  cp_async_commit();
  {  // D = rowsum(dO o O) and lse of this block's rows, two threads a row
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float acc = 0.f;
    if (row < sq) {
      const bf16* orow = ob + row * os.s + 32 * half;
      const bf16* drow = dob + row * dos.s + 32 * half;
#pragma unroll 8
      for (int c = 0; c < 32; ++c)
        acc = fmaf(__bfloat162float(orow[c]), __bfloat162float(drow[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Ds[r] = acc;
      Ls[r] = row < sq ? lse[(long long)bh * sq + row] * LOG2E : 0.f;
      if (row < sq) dsum[(long long)bh * sq + row] = acc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[4][4], da[4][4];
  const uint32_t qa_lane = smem_u32(Qt + a_lane(warp, lane));
  const uint32_t da_lane = smem_u32(Ot + a_lane(warp, lane));
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    ldmatrix_x4(qa[s], qa_lane + 32 * s);
    ldmatrix_x4(da[s], da_lane + 32 * s);
  }
  const float lr[2] = {Ls[warp * 16 + g], Ls[warp * 16 + g + 8]};
  const float dr[2] = {Ds[warp * 16 + g], Ds[warp * 16 + g + 8]};
  const uint32_t kn_lane = smem_u32(Kt + bn_lane(lane));
  const uint32_t vn_lane = smem_u32(Vt + bn_lane(lane));
  const uint32_t kk_lane = smem_u32(Kt + bk_lane(lane));

  float acc[8][4];
  zero(acc);
  const int n_tiles = (sk + 63) / 64;
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const int nb = (kt + 1) & 1, k0n = (kt + 1) * 64;
      stage(Kt + nb * TILE, kb + k0n * ks.s, ks.s, sk - k0n, vec);
      stage(Vt + nb * TILE, vb + k0n * vs.s, vs.s, sk - k0n, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed
    const uint32_t off = (kt & 1) * TILE_B;
    const int k0 = kt * 64;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows_nt(s, qa, kn_lane + off);   // S = Q K^T
    mma_rows_nt(dp, da, vn_lane + off);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * n + 2 * u + (i & 1);
        const float p = key < sk ? exp2f(s[n][i] * scale_log2 - lr[i >> 1]) : 0.f;
        s[n][i] = p * (dp[n][i] - dr[i >> 1]);  // dS
      }
    }
    mma_rows_pn(acc, s, kk_lane + off);  // dQ += dS K
    __syncthreads();  // stage kt & 1 is free for tile kt + 2
  }
  store_rows(dq + bi * dqs.b + hi * dqs.h, dqs.s, q0 + warp * 16, sq, acc, scale, g, u);
}

constexpr size_t DKV_SMEM = 6 * TILE * sizeof(bf16) + 4 * 64 * sizeof(float);

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq,
                     int sk, Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dks, Strides dvs, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qt = reinterpret_cast<bf16*>(smem_raw);  // [2][64 rows][LDH]
  bf16* Ot = Qt + 2 * TILE;                      // dO, [2][64 rows][LDH]
  bf16* Kt = Ot + 2 * TILE;                      // [64 keys][LDH]
  bf16* Vt = Kt + TILE;                          // [64 keys][LDH]
  float* Ls = reinterpret_cast<float*>(Vt + TILE);  // [2][64] lse * log2 e
  float* Ds = Ls + 2 * 64;                          // [2][64]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, u = lane % 4;
  const int bh = blockIdx.y, bi = bh / heads, hi = bh % heads;
  const int k0 = blockIdx.x * 64;
  const bf16* qb = q + bi * qs.b + hi * qs.h;
  const bf16* kb = k + bi * ks.b + hi * ks.h;
  const bf16* vb = v + bi * vs.b + hi * vs.h;
  const bf16* dob = dout + bi * dos.b + hi * dos.h;
  const float* lb = lse + (long long)bh * sq;
  const float* db = dsum + (long long)bh * sq;
  const bool vec = vec_ok(q, qs.b, qs.h, qs.s) && vec_ok(k, ks.b, ks.h, ks.s) &&
                   vec_ok(v, vs.b, vs.h, vs.s) && vec_ok(dout, dos.b, dos.h, dos.s);
  const float scale_log2 = scale * LOG2E;

  stage(Kt, kb + k0 * ks.s, ks.s, sk - k0, vec);
  stage(Vt, vb + k0 * vs.s, vs.s, sk - k0, vec);
  stage(Qt, qb, qs.s, sq, vec);
  stage(Ot, dob, dos.s, sq, vec);
  for (int r = tid; r < 64; r += THREADS) {
    Ls[r] = r < sq ? lb[r] * LOG2E : 0.f;
    Ds[r] = r < sq ? db[r] : 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t ka[4][4], va[4][4];
  const uint32_t ka_lane = smem_u32(Kt + a_lane(warp, lane));
  const uint32_t va_lane = smem_u32(Vt + a_lane(warp, lane));
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    ldmatrix_x4(ka[s], ka_lane + 32 * s);
    ldmatrix_x4(va[s], va_lane + 32 * s);
  }
  const uint32_t qn_lane = smem_u32(Qt + bn_lane(lane));
  const uint32_t on_lane = smem_u32(Ot + bn_lane(lane));
  const uint32_t qk_lane = smem_u32(Qt + bk_lane(lane));
  const uint32_t ok_lane = smem_u32(Ot + bk_lane(lane));

  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  const int n_tiles = (sq + 63) / 64;
  for (int qt = 0; qt < n_tiles; ++qt) {
    if (qt + 1 < n_tiles) {
      const int nb = (qt + 1) & 1, q0n = (qt + 1) * 64;
      stage(Qt + nb * TILE, qb + q0n * qs.s, qs.s, sq - q0n, vec);
      stage(Ot + nb * TILE, dob + q0n * dos.s, dos.s, sq - q0n, vec);
      for (int r = tid; r < 64; r += THREADS) {
        const int row = q0n + r;
        Ls[nb * 64 + r] = row < sq ? lb[row] * LOG2E : 0.f;
        Ds[nb * 64 + r] = row < sq ? db[row] : 0.f;
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile qt has landed
    const int buf = qt & 1;
    const uint32_t off = buf * TILE_B;
    const int q0 = qt * 64;
    const float* lt = Ls + buf * 64;
    const float* dt = Ds + buf * 64;

    float st[8][4];
    zero(st);
    mma_rows_nt(st, ka, qn_lane + off);  // S^T = K Q^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * u + (i & 1);
        st[n][i] = q0 + c < sq ? exp2f(st[n][i] * scale_log2 - lt[c]) : 0.f;  // P^T
      }
    }
    mma_rows_pn(dva, st, ok_lane + off);  // dV += P^T dO
    float dpt[8][4];
    zero(dpt);
    mma_rows_nt(dpt, va, on_lane + off);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * u + (i & 1);
        st[n][i] *= dpt[n][i] - dt[c];  // dS^T
      }
    }
    mma_rows_pn(dka, st, qk_lane + off);  // dK += dS^T Q
    __syncthreads();  // stage qt & 1 is free for tile qt + 2
  }
  store_rows(dk + bi * dks.b + hi * dks.h, dks.s, k0 + warp * 16, sk, dka, scale, g, u);
  store_rows(dv + bi * dvs.b + hi * dvs.h, dvs.s, k0 + warp * 16, sk, dva, 1.f, g, u);
}

Strides st3(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// All tensors (b, h, s, 64) bf16 through element strides (b, h, s) given in
// ``strides`` (3 each), unit stride on d; lse (b, h, sq) f32 from K1; dsum
// (b, h, sq) f32 scratch that K8 writes and K7 reads, so K8 runs first.
// dq/dk/dv rows must be 4-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int v3d_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* o, const void* dout,
                                     const void* lse, void* dsum, void* dq, int b,
                                     int heads, int sq, int sk,
                                     const long long* strides, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + 63) / 64, b * heads);
  flash_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<bf16*>(dq), heads, sq, sk,
      st3(strides), st3(strides + 3), st3(strides + 6), st3(strides + 9),
      st3(strides + 12), st3(strides + 15), 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// strides: q, k, v, dout, dk, dv, 3 each.
extern "C" int v3d_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* dsum, void* dk, void* dv, int b,
                                      int heads, int sq, int sk,
                                      const long long* strides, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + 63) / 64, b * heads);
  flash_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq, sk, st3(strides),
      st3(strides + 3), st3(strides + 6), st3(strides + 9), st3(strides + 12),
      st3(strides + 15), 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}
