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
// What bounds it on the H100: the projections.  Per pixel they cost
// 4 * 18 * 320 * 320 MACs (~15 MFLOP for ~23 KB of x in and out, ~640
// FLOP/byte in bf16), right of the ridge, so the data moves once and the
// product units set the time.  Two variants, picked per call:
//
// - bf16 with c, dh multiples of 16, t <= 20 and 16-byte aligned weights (the
//   main path): the products run on the tensor cores (mma.sync.m16n8k16, bf16
//   in, f32 accumulate, fragments by ldmatrix; no wgmma yet).  A block of 16
//   warps takes TC_PIX = 4 pixels x t frames (72 rows, pixel-major, padded to
//   80 = 5 row tiles), keeps the x tile and the concatenated head outputs in
//   shared memory as bf16 (rows padded by 16 B so ldmatrix does not
//   conflict), and one head's q/k/v in f32.  The weights (800 KB, L2-resident)
//   stream through shared memory in 32-deep chunks by cp.async,
//   double-buffered (tc_pass); each warp owns one 16-column tile for all 5
//   row tiles.  One pass computes a head's q, k and v together (192
//   columns); the output projection is two passes after all heads, its tile
//   written back through shared memory with 16-byte stores.  The 18-frame
//   softmax runs on the CUDA cores in f32, one warp per pixel.
//   A WMMA version of the same dataflow ran at ~3 ms: its fragment loads were
//   generic loads, one row tile at a time behind a branch, so each warp waited
//   on every load (clock64 per phase: the products took ~75% of the cycles).
// - otherwise (f32, other widths): the same dataflow with f32 FMA products,
//   described below.
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

#include "common.cuh"

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


// ---- tensor-core variant (bf16) -------------------------------------------

constexpr int TC_WARPS = 16;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_PIX = 4;    // pixels per block
constexpr int MT = 5;        // row tiles: t * TC_PIX <= 16 * MT
constexpr int RP = 16 * MT;  // token rows, zero-padded
constexpr int ROW_PAD = 8;   // bf16 elements (16 B) of padding per smem row
constexpr int KCH = 32;      // depth of a staged weight chunk
constexpr int LDW = KCH + ROW_PAD;
constexpr int PASS_COLS = TC_WARPS * 16;  // columns of one product pass

struct TcLayout {
  int ldx, ldo, ldq;
  size_t off_os, off_qkv, off_ps, off_w, total;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ inline TcLayout tc_layout(int t, int c, int inner, int dh) {
  TcLayout L;
  L.ldx = c + ROW_PAD;
  L.ldo = inner + ROW_PAD;
  L.ldq = dh + 4;
  size_t off = align128((size_t)RP * L.ldx * sizeof(bf16));
  L.off_os = off;
  off = align128(off + (size_t)RP * L.ldo * sizeof(bf16));
  L.off_qkv = off;
  off = align128(off + (size_t)3 * RP * L.ldq * sizeof(float));
  L.off_ps = off;
  off = align128(off + (size_t)TC_PIX * t * (t + 1) * sizeof(float));
  L.off_w = off;
  L.total = off + (size_t)2 * PASS_COLS * LDW * sizeof(bf16);
  return L;
}

// One block-wide product: C[0:RP, 0:ncol] = A[0:RP, 0:K] B, where column j
// of B is the bf16 row wrow(j) in global memory (torch Linear layout, length
// K).  ncol <= PASS_COLS and K are multiples of 16.  The weight rows are
// staged in shared memory in KCH-deep chunks by cp.async into two buffers, so
// the next chunk's copy overlaps this chunk's products and every weight byte
// is read from L2 once per block, in 16-byte pieces.  Warp w owns column
// tile w for all MT row tiles: its B fragment feeds MT products, and the MT
// A fragments are all loaded before the first product.  epi(row, col, c0, c1)
// takes the results of columns col and col + 1 of one row.
template <typename RowFn, typename Epi>
__device__ __forceinline__ void tc_pass(const bf16* A, int lda, int K, int ncol,
                                        RowFn wrow, bf16* wbuf, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool active = warp * 16 < ncol;
  const int nk = (K + KCH - 1) / KCH;
  float acc[MT][2][4] = {};
  // ldmatrix row addresses of this lane (bytes in the shared window): A rows
  // lane % 16, column half lane / 16; B (weight) rows lane % 8 + 8 * (lane / 16),
  // k half (lane / 8) % 2, so registers 0-1 / 2-3 are the b0/b1 of the two
  // 8-column halves of the warp's tile.
  const uint32_t a_base = smem_u32(A + (lane % 16) * lda + 8 * (lane / 16));
  const uint32_t b_base = smem_u32(
      wbuf + (warp * 16 + lane % 8 + 8 * (lane / 16)) * LDW + 8 * ((lane / 8) % 2));
  auto stage = [&](int kc) {
    bf16* dst = wbuf + (kc & 1) * PASS_COLS * LDW;
    const int k0 = kc * KCH, vpr = min(KCH, K - k0) / 8;  // 16-byte pieces per row
    for (int e = tid; e < ncol * vpr; e += TC_THREADS) {
      const int j = e / vpr, kk = (e % vpr) * 8;
      cp_async16(dst + j * LDW + kk, wrow(j) + k0 + kk);
    }
    cp_async_commit();
  };
  stage(0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      stage(kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk kc has landed for every thread's copies
    const int k0 = kc * KCH, kch = min(KCH, K - k0);
    if (active) {
      const uint32_t bb = b_base + (kc & 1) * PASS_COLS * LDW * sizeof(bf16);
      for (int kk = 0; kk < kch; kk += 16) {
        uint32_t b[4], a[MT][4];
        ldmatrix_x4(b, bb + kk * sizeof(bf16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], a_base + (mt * 16 * lda + k0 + kk) * sizeof(bf16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][0], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffer kc & 1 is free for chunk kc + 2
  }
  if (active) {
    const int g = lane / 4, u = lane % 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = warp * 16 + 8 * j + 2 * u;
        epi(mt * 16 + g, col, acc[mt][j][0], acc[mt][j][1]);
        epi(mt * 16 + g + 8, col, acc[mt][j][2], acc[mt][j][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
temporal_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                         const bf16* __restrict__ wk, const bf16* __restrict__ wv,
                         const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                         bf16* __restrict__ out, int t, int s, int c, int heads,
                         int dh, long long xsb, long long xst, long long xss,
                         float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int inner = heads * dh;
  const int R = t * TC_PIX;
  const TcLayout L = tc_layout(t, c, inner, dh);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                 // [RP][ldx]
  bf16* os = reinterpret_cast<bf16*>(smem_raw + L.off_os);      // [RP][ldo]
  float* qkv = reinterpret_cast<float*>(smem_raw + L.off_qkv);  // [3][RP][ldq]
  float* ps = reinterpret_cast<float*>(smem_raw + L.off_ps);    // [PIX][t][t+1]
  bf16* wbuf = reinterpret_cast<bf16*>(smem_raw + L.off_w);     // [2][PASS_COLS][LDW]

  const int tid = threadIdx.x, warp = tid / 32;
  const int n_sb = (s + TC_PIX - 1) / TC_PIX;
  const int bi = blockIdx.x / n_sb;
  const int s0 = (blockIdx.x % n_sb) * TC_PIX;
  const bf16* xb = x + bi * xsb;
  const bf16 zero = __float2bfloat16(0.f);

  // token row r <-> (pixel s0 + r / t, frame r % t): a pixel's frames are
  // consecutive rows.  Padding rows and pixels past s are zero.  16-byte
  // loads where the layout allows.
  const bool vec = ((xsb | xst | xss | c) % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (vec) {
    const int cv = c / 8;
    for (int e = tid; e < RP * cv; e += TC_THREADS) {
      const int r = e / cv, cc = (e % cv) * 8;
      const int f = r % t, si = s0 + r / t;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < R && si < s)
        val = *reinterpret_cast<const uint4*>(xb + f * xst + si * xss + cc);
      *reinterpret_cast<uint4*>(xs + r * L.ldx + cc) = val;
    }
  } else {
    for (int e = tid; e < RP * c; e += TC_THREADS) {
      const int r = e / c, cc = e % c;
      const int f = r % t, si = s0 + r / t;
      xs[r * L.ldx + cc] = (r < R && si < s) ? xb[f * xst + si * xss + cc] : zero;
    }
  }
  for (int e = tid; e < (RP - R) * inner; e += TC_THREADS)
    os[(R + e / inner) * L.ldo + e % inner] = zero;
  __syncthreads();

  for (int h = 0; h < heads; ++h) {
    // q | k | v of head h side by side: 3 * dh columns, one pass
    tc_pass(xs, L.ldx, c, 3 * dh,
            [&](int j) {
              const int m = j / dh;
              return (m == 0 ? wq : m == 1 ? wk : wv) + (long long)(h * dh + j % dh) * c;
            },
            wbuf,
            [&](int row, int col, float c0, float c1) {
              const int m = col / dh;
              const float sc = m == 0 ? scale : 1.f;
              *reinterpret_cast<float2*>(qkv + (m * RP + row) * L.ldq + col % dh) =
                  make_float2(c0 * sc, c1 * sc);
            });
    __syncthreads();
    if (warp < TC_PIX) {
      const int p = warp;
      const int r0 = p * t;
      warp_frame_attention(qkv + r0 * L.ldq, qkv + (RP + r0) * L.ldq,
                           qkv + (2 * RP + r0) * L.ldq, 1, L.ldq,
                           ps + p * t * (t + 1), t, dh,
                           [&](int i, int cc, float val) {
                             os[(r0 + i) * L.ldo + h * dh + cc] =
                                 __float2bfloat16(val);
                           });
    }
    __syncthreads();
  }

  // output projection + bias into the x tile (free now), then one coalesced
  // store of the tile
  bf16* ys = xs;
  for (int n0 = 0; n0 < c; n0 += PASS_COLS) {
    tc_pass(os, L.ldo, inner, min(PASS_COLS, c - n0),
            [&](int j) { return wo + (long long)(n0 + j) * inner; }, wbuf,
            [&](int row, int col, float c0, float c1) {
              const int n = n0 + col;
              *reinterpret_cast<__nv_bfloat162*>(ys + row * L.ldx + n) =
                  __floats2bfloat162_rn(c0 + __bfloat162float(bo[n]),
                                        c1 + __bfloat162float(bo[n + 1]));
            });
  }
  __syncthreads();
  bf16* ob = out + (long long)bi * t * s * c;
  const int cv = c / 8;
  for (int e = tid; e < R * cv; e += TC_THREADS) {
    const int r = e / cv, cc = (e % cv) * 8;
    const int f = r % t, si = s0 + r / t;
    if (si < s)
      *reinterpret_cast<uint4*>(ob + ((long long)f * s + si) * c + cc) =
          *reinterpret_cast<const uint4*>(ys + r * L.ldx + cc);
  }
}

bool tc_eligible(int dtype, int t, int c, int heads, int dh) {
  return dtype == V3D_BF16 && c % 16 == 0 && dh % 16 == 0 && t * TC_PIX <= RP &&
         tc_layout(t, c, heads * dh, dh).total <= 232448;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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

// Shared memory the launch needs (bytes) with 16-byte aligned weights; the
// wrapper refuses shapes over the card's per-block limit before launching.
extern "C" long long v3d_temporal_block_smem(int dtype, int t, int c, int heads,
                                             int dh) {
  if (tc_eligible(dtype, t, c, heads, dh))
    return (long long)tc_layout(t, c, heads * dh, dh).total;
  return (long long)smem_bytes(t, c, heads, dh, dtype == V3D_F32 ? 4 : 2);
}

// x: (b, t, s, c) through element strides (b, t, s), unit channel stride.
// wq/wk/wv: (heads*dh, c), wo: (c, heads*dh), bo: (c,), all contiguous, torch
// Linear layout.  out: contiguous (b, t, s, c).  t * 2 <= 64, dh <= 64.
// Returns the launch's cudaError_t.
extern "C" int v3d_temporal_block(int dtype, const void* x, const void* wq,
                                  const void* wk, const void* wv, const void* wo,
                                  const void* bo, void* out, int b, int t, int s,
                                  int c, int heads, int dh, long long xsb,
                                  long long xst, long long xss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_eligible(dtype, t, c, heads, dh) && aligned16(wq) && aligned16(wk) &&
      aligned16(wv) && aligned16(wo) && aligned16(out)) {
    const size_t smem = tc_layout(t, c, heads * dh, dh).total;
    cudaError_t err = cudaFuncSetAttribute(
        temporal_block_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)b * ((s + TC_PIX - 1) / TC_PIX);
    temporal_block_tc_kernel<<<blocks, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
        static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
        static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
        static_cast<bf16*>(out), t, s, c, heads, dh, xsb, xst, xss,
        1.f / sqrtf((float)dh));
    return (int)cudaGetLastError();
  }
  if (dtype == V3D_F32)
    return launch<float>(x, wq, wk, wv, wo, bo, out, b, t, s, c, heads, dh, xsb,
                         xst, xss, st);
  if (dtype == V3D_BF16)
    return launch<__nv_bfloat16>(x, wq, wk, wv, wo, bo, out, b, t, s, c, heads,
                                 dh, xsb, xst, xss, st);
  return (int)cudaErrorInvalidValue;
}
