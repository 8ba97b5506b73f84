// K6: GroupNorm(G) in float32 + optional SiLU, output in the input's dtype.
//
// Replaces: v3d_tpu/ops/fused_groupnorm.py _pallas_group_norm (:90-138), its
// two pallas_calls _stats_kernel (:65) and _norm_kernel (:82) and the XLA
// group combine between them (:113-124).  Main path: every GroupNorm32 of
// the VideoUNet (36 or 18 frames, 320-2560 channels, 64^2-8^2), of its
// temporal stacks ((b, C, 18, h, w), B*G only 64) and of the VAE (up to
// (18, 128, 512, 512), 1.2 GB in bf16), in generation and in training.
//
// Input: channels-last memory viewed as (B, L, C): NCHW in channels_last
// (L = h*w) or NCTHW in channels_last_3d (L = t*h*w).  Math, as the Pallas
// kernel: per-(sample, channel) sum and sum of squares in f32; group combine;
// mean = s1 / n, var = max(s2 / n - mean^2, 0), inv = rsqrt(var + eps);
// y = x * a + b with a = inv * scale, b = bias - mean * a; SiLU in f32
// before the cast.
//
// What bounds it on the H100: bytes.  Two reads and one write of x (the
// two-pass optimum: a sample's slice is up to 66 MB, no SM holds it), e.g.
// 283 MB at (36, 320, 64, 64) bf16, ~85 us at 3.35 TB/s.  Design:
//
// 1. gn_stats_kernel, grid (splits, B): the TPU grid carried the sums from
//    one row block to the next in its output; Hopper's blocks run in no
//    order, so each block sums its own contiguous run of rows into partials
//    (B, splits, C) and nothing carries.  The splits are chosen so that
//    about 1024 blocks run even where B*G is 64.  Each thread owns 16 bytes
//    of channels (8 bf16 or 4 f32, one vector load per row) and walks the
//    rows with the block's other row groups; the row groups are then summed
//    through shared memory.
// 2. gn_finalize_kernel, grid B: sums the partials over the splits, then
//    over each group's channels, and folds mean, inv, scale and bias into
//    the per-(sample, channel) a and b.
// 3. gn_norm_kernel, grid (vectors / 256, B): one 16-byte vector per thread,
//    a and b from L1, y = fma(x, a, b), SiLU, one vector store.
// The partials and a/b are small f32 scratch the wrapper allocates.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NORM_THREADS = 256;
constexpr int STATS_TARGET_THREADS = 256;

template <typename T>
struct Pack;  // 16 bytes of T <-> VEC floats

template <>
struct Pack<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// blockDim.x = rps * (C / VEC): rps rows per step, one vector column each.
// part: s1 at [(b * splits + split) * C + c], s2 after B * splits * C.
template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                                int B, int L, int C, int splits, int rows_per_split) {
  constexpr int VEC = Pack<T>::VEC;
  extern __shared__ float sm[];  // [rps][C] of s1, then [rps][C] of s2
  const int ncv = C / VEC;
  const int rps = blockDim.x / ncv;
  const int tid = threadIdx.x;
  const int cv = tid % ncv, r = tid / ncv;
  const int split = blockIdx.x, b = blockIdx.y;
  const long long l0 = (long long)split * rows_per_split;
  const long long l1 = min((long long)L, l0 + rows_per_split);
  const T* xb = x + (long long)b * L * C + cv * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  for (long long l = l0 + r; l < l1; l += rps) {
    float v[VEC];
    Pack<T>::load(xb + l * C, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sm[r * C + cv * VEC + i] = s1[i];
    sm[(rps + r) * C + cv * VEC + i] = s2[i];
  }
  __syncthreads();
  const long long row = (long long)b * splits + split;
  for (int c = tid; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < rps; ++rr) {
      a += sm[rr * C + c];
      q += sm[(rps + rr) * C + c];
    }
    part[row * C + c] = a;
    part[((long long)B * splits + row) * C + c] = q;
  }
}

// ab: a at [b * C + c], b after B * C.  scale/bias f32 (sdt 0) or bf16 (1).
__global__ void gn_finalize_kernel(const float* __restrict__ part, int B, int C,
                                   int G, int splits, float n,
                                   const void* scale, const void* bias, int sdt,
                                   float eps, float* __restrict__ ab) {
  extern __shared__ float sm[];  // s1[C], s2[C], mean[G], inv[G]
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int c = tid; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int s = 0; s < splits; ++s) {
      const long long row = (long long)b * splits + s;
      a += part[row * C + c];
      q += part[((long long)B * splits + row) * C + c];
    }
    sm[c] = a;
    sm[C + c] = q;
  }
  __syncthreads();
  const int cpg = C / G;
  for (int g = tid; g < G; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += sm[g * cpg + j];
      q += sm[C + g * cpg + j];
    }
    const float mean = a / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    sm[2 * C + g] = mean;
    sm[2 * C + G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const int g = c / cpg;
    const float sc = sdt ? __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[c])
                         : static_cast<const float*>(scale)[c];
    const float bi = sdt ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c])
                         : static_cast<const float*>(bias)[c];
    const float a = sm[2 * C + G + g] * sc;
    ab[b * C + c] = a;
    ab[B * C + b * C + c] = bi - sm[2 * C + g] * a;
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(NORM_THREADS)
gn_norm_kernel(const T* __restrict__ x, T* __restrict__ y,
               const float* __restrict__ ab, long long vecs_per_sample, int ncv,
               int B, int C) {
  constexpr int VEC = Pack<T>::VEC;
  const long long i = (long long)blockIdx.x * NORM_THREADS + threadIdx.x;
  if (i >= vecs_per_sample) return;
  const int b = blockIdx.y;
  const int c0 = (int)(i % ncv) * VEC;
  const float4* a4 = reinterpret_cast<const float4*>(ab + b * C + c0);
  const float4* b4 = reinterpret_cast<const float4*>(ab + (long long)B * C + b * C + c0);
  const long long off = ((long long)b * vecs_per_sample + i) * VEC;
  float v[VEC];
  Pack<T>::load(x + off, v);
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j) {
    const float4 a = __ldg(a4 + j), bb = __ldg(b4 + j);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t = fmaf(v[4 * j + k], av[k], bv[k]);
      if (SILU) t = t / (1.f + expf(-t));
      v[4 * j + k] = t;
    }
  }
  Pack<T>::store(y + off, v);
}

template <typename T>
int launch(const void* x, void* y, const void* scale, const void* bias, int sdt,
           float* scratch, int B, int L, int C, int G, int splits, float eps,
           int silu, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::VEC;
  const int ncv = C / VEC;
  const int rps = ncv >= STATS_TARGET_THREADS ? 1 : STATS_TARGET_THREADS / ncv;
  const int threads = rps * ncv;
  const int rows_per_split = (L + splits - 1) / splits;
  float* part = scratch;
  float* ab = scratch + 2LL * B * splits * C;
  gn_stats_kernel<T><<<dim3(splits, B), threads, 2 * rps * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), part, B, L, C, splits, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float n = (float)L * (float)(C / G);
  gn_finalize_kernel<<<B, 256, (2 * C + 2 * G) * sizeof(float), stream>>>(
      part, B, C, G, splits, n, scale, bias, sdt, eps, ab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long vecs = (long long)L * ncv;
  const dim3 grid((unsigned)((vecs + NORM_THREADS - 1) / NORM_THREADS), B);
  if (silu)
    gn_norm_kernel<T, true><<<grid, NORM_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), ab, vecs, ncv, B, C);
  else
    gn_norm_kernel<T, false><<<grid, NORM_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), ab, vecs, ncv, B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x/y: (B, L, C) contiguous, 16-byte aligned, C a multiple of G and of the
// 16-byte vector; scale/bias (C,) in f32 (sdt 0) or bf16 (sdt 1); scratch
// 2 * B * splits * C + 2 * B * C floats.  Returns the cudaError_t of the
// launches.
extern "C" int v3d_group_norm(int dtype, const void* x, void* y, const void* scale,
                              const void* bias, int sdt, void* scratch, int B,
                              int L, int C, int G, int splits, float eps, int silu,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scratch);
  if (dtype == V3D_F32)
    return launch<float>(x, y, scale, bias, sdt, s, B, L, C, G, splits, eps, silu, st);
  if (dtype == V3D_BF16)
    return launch<__nv_bfloat16>(x, y, scale, bias, sdt, s, B, L, C, G, splits, eps,
                                 silu, st);
  return (int)cudaErrorInvalidValue;
}
