// K6: GroupNorm(G) in float32 + optional SiLU, output in the input's dtype.
//
// Replaces: v3d_tpu/ops/fused_groupnorm.py _pallas_group_norm (:90-138), its
// two pallas_calls _stats_kernel (:65) and _norm_kernel (:82) and the XLA
// group combine between them (:113-124).  Main path: every GroupNorm32 of
// the VideoUNet (36 or 18 frames, 320-2560 channels, 64^2-8^2), of its
// temporal stacks ((b, C, 18, h, w), B*G only 64) and of the VAE (up to
// (18, 128, 512, 512), 1.2 GB in bf16), in generation and in training:
// 105 calls a UNet forward, 18 shapes.
//
// Input: channels-last memory viewed as (B, L, C): NCHW in channels_last
// (L = h*w) or NCTHW in channels_last_3d (L = t*h*w).  Math, as the Pallas
// kernel: per-(sample, channel) sum and sum of squares in f32; group combine;
// mean = s1 / n, var = max(s2 / n - mean^2, 0), inv = rsqrt(var + eps);
// y = x * a + b with a = inv * scale, b = bias - mean * a; SiLU in f32
// before the cast.
//
// What bounds it on the H100: bytes, at best one read and one write of x
// (56 us at (36, 320, 64, 64) bf16; 2.97 ms over a forward's 105 calls).
// The host plans each call (ops/group_norm.py group_norm_plan); two paths:
//
// 1. One launch (gn_slice_kernel), where a slice fits on chip.  A slice is
//    one sample's rows of a range of whole groups (gpc groups, W = gpc * C/G
//    channels, rows of W * elem >= 64 contiguous bytes): a group's
//    statistics need nothing outside it.  A thread-block cluster of cs <= 8
//    blocks (16, the card's non-portable size, where no slicing fits 8)
//    holds one slice in shared memory, each block ~1/cs of its rows (<= 100
//    KB, two blocks an SM; up to 227 KB, one an SM, in clusters of 16 where
//    nothing fits 100 KB: the temporal stack's bf16 ds2).  A block loads its
//    rows once with 16-byte cp.async (all in flight at once); each thread
//    owns a 16-byte column and every rstep-th row, sums its 8 channels from
//    shared memory, the block adds the row steps and then each group's
//    channels in a fixed order (deterministic) and publishes its group sums;
//    after a cluster barrier every block adds the cluster's sums in rank
//    order through distributed shared memory, computes mean / inv, and each
//    thread folds scale and bias into its columns' a / b (registers) and
//    writes y from shared memory once.  x is read once.
// 2. Two launches (gn_stats_kernel, gn_norm_kernel) otherwise: the temporal
//    stack at ds1 (a slice of 4 groups is 5.9 MB) and the VAE's two largest
//    maps.  Stats: grid (splits, B), ~4 blocks an SM in all; each thread
//    owns 16 bytes of channels and walks rows (4 loads in flight), the block
//    reduces to its group partials; the last block of a sample to finish (an
//    atomic ticket after a __threadfence) combines that sample's partials,
//    spread over the block's threads (<= ~70 partials each), into mean /
//    inv.  The tickets lie in the call's scratch, zeroed on the launch
//    stream before the statistics kernel, so calls on other streams share
//    nothing.  Norm: the same grid; each block walks its rows from the last
//    one down, so it first reads the rows the statistics pass read last,
//    still in L2; a and b of a thread's 8 channels once, then y = fma(x, a,
//    b) row by row.  All blocks of both kernels are resident at once (B *
//    splits <= 4 an SM): no tail wave.  Two reads and one write; never
//    three launches, never a combine by B blocks walking every split
//    serially.
//
// 3. Split statistics (v3d_group_norm_stats, v3d_group_norm_apply): the
//    two launches of path 2 as two entries, for a sample whose rows lie on
//    several ranks (the frame-parallel VideoUNet's temporal GroupNorms, each
//    rank holding a strip of pixels of every frame; parallel/frames.py).
//    The statistics entry is gn_stats_kernel whose last block writes the
//    sample's per-group (sum x, sum x^2) in f32 and stops; the caller
//    all-reduces those sums over the ranks; the apply entry is
//    gn_norm_kernel, each thread turning the global sums of its channels'
//    groups and the global element count into mean / inv in its prologue.
//    These are T9's own two pallas_calls (_stats_kernel :100, _norm_kernel
//    :126) with the collective between them.  Bound: bytes, x read twice
//    and y written once, as path 2.
//
// With a non-null ``prof`` the one-launch kernel's thread 0 records
// clock64 deltas per block: load, statistics + cluster combine, normalise +
// store (chip_smoke.py phase 3 prints their means).
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GN_THREADS = 256;
constexpr int GN_PROF_SLOTS = 4;

template <typename T>
struct Pack;  // 16 bytes of T <-> VEC floats

template <>
struct Pack<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void unpack(const uint4& q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
};

__device__ __forceinline__ float load_param(const void* p, int sdt, int c) {
  return sdt ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
             : static_cast<const float*>(p)[c];
}

// SiLU with the fast exponential and division (ex2.approx, rcp.approx:
// ~2 ulp), a few instructions an element instead of ~40; 0 where exp(-t)
// overflows.
__device__ __forceinline__ float act(float t, bool silu) {
  return silu ? __fdividef(t, 1.f + __expf(-t)) : t;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Threads of the one-launch kernel: each owns one 16-byte column of the
// slice's W channels (vpr columns) and every rstep-th row.
__host__ __device__ inline int slice_row_step(int vpr) {
  return vpr >= GN_THREADS ? 1 : GN_THREADS / vpr;
}

// Dynamic shared memory of gn_slice_kernel: the rows, the (row step,
// channel) partials (later a / b), the group sums the cluster reads, mean /
// inv.
__host__ __device__ inline size_t slice_smem(int W, int gpc, int rows, int elem) {
  const int vpr = W * elem / 16;
  return align16((size_t)rows * W * elem) +
         (size_t)slice_row_step(vpr) * W * 2 * sizeof(float) + 4 * gpc * sizeof(float);
}

// grid cs * B * (G / gpc), cluster (cs, 1, 1), cs <= MAXCS; block = rank
// of one slice.  MAXCS 16 only for clusters of 16: the portable instance
// keeps 8 remote sums in flight and launches without the non-portable
// cluster attribute (one instance for both sizes cost the small calls 2-5
// us).
template <typename T, bool SILU, int MAXCS>
__global__ void __launch_bounds__(GN_THREADS)
gn_slice_kernel(const T* __restrict__ x, T* __restrict__ y, const void* scale,
                const void* bias, int sdt, int L, int C, int G, int gpc, int cs,
                int rows_per_block, float eps, long long* prof) {
  constexpr int VEC = Pack<T>::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cpg = C / G, W = gpc * cpg;
  const int vpr = W / VEC;  // 16-byte columns of a slice row
  const int rstep = slice_row_step(vpr);
  T* data = reinterpret_cast<T*>(smem_raw);
  float* part = reinterpret_cast<float*>(
      smem_raw + align16((size_t)rows_per_block * W * sizeof(T)));  // [rstep][W][2]
  float* grp = part + (size_t)rstep * W * 2;                         // [gpc][2]
  float* mi = grp + 2 * gpc;                                         // [gpc][2]

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % cs, slice = blockIdx.x / cs;
  const int slices_per_sample = G / gpc;
  const int b = slice / slices_per_sample;
  const int c0 = (slice % slices_per_sample) * W;
  const int r0 = rank * rows_per_block;
  const int nrows = max(0, min(rows_per_block, L - r0));
  const long long row0 = (long long)b * L + r0;
  long long t0 = 0;
  if (prof != nullptr && tid == 0) t0 = clock64();

  // 1. the block's rows, once, all copies in flight together
  for (int e = tid; e < nrows * vpr; e += GN_THREADS) {
    const int r = e / vpr, v = e % vpr;
    cp_async16(data + (size_t)e * VEC, x + (row0 + r) * C + c0 + v * VEC);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  long long t1 = 0;
  if (prof != nullptr && tid == 0) t1 = clock64();

  // 2. per-channel sums: thread (column v, row r) over rows r, r + rstep, ...
  //    from 16-byte reads, then over the row steps, then over each group's
  //    channels, in a fixed order
  for (int q = tid; q < vpr * rstep; q += GN_THREADS) {
    const int v = q % vpr, r = q / vpr;
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
    for (int row = r; row < nrows; row += rstep) {
      float f[VEC];
      Pack<T>::unpack(*reinterpret_cast<const uint4*>(data + ((size_t)row * vpr + v) * VEC), f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[i] += f[i];
        s2[i] = fmaf(f[i], f[i], s2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      *reinterpret_cast<float2*>(part + ((size_t)r * W + v * VEC + i) * 2) =
          make_float2(s1[i], s2[i]);
  }
  __syncthreads();
  for (int c = tid; c < W; c += GN_THREADS) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < rstep; ++r) {
      const float2 p = *reinterpret_cast<const float2*>(part + ((size_t)r * W + c) * 2);
      a += p.x;
      q += p.y;
    }
    part[2 * c] = a;  // row step 0 is read only by this thread
    part[2 * c + 1] = q;
  }
  __syncthreads();
  for (int g = tid; g < gpc; g += GN_THREADS) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += part[2 * (g * cpg + j)];
      q += part[2 * (g * cpg + j) + 1];
    }
    grp[2 * g] = a;
    grp[2 * g + 1] = q;
  }

  // 3. the cluster's group sums, in rank order, through distributed shared
  //    memory; then a / b per channel
  cluster_arrive();
  cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  const float n = (float)L * (float)cpg;
  for (int g = tid; g < gpc; g += GN_THREADS) {
    float2 part_r[MAXCS];  // all remote loads in flight before the sums
#pragma unroll
    for (int r = 0; r < MAXCS; ++r)
      if (r < cs)
        part_r[r] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(grp, r) + 2 * g);
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < MAXCS; ++r) {
      if (r < cs) {
        a += part_r[r].x;
        q += part_r[r].y;
      }
    }
    const float mean = a / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    mi[2 * g] = mean;
    mi[2 * g + 1] = rsqrtf(var + eps);
  }
  cluster_arrive();  // this block is done reading the others' sums
  __syncthreads();
  long long t2 = 0;
  if (prof != nullptr && tid == 0) t2 = clock64();

  // 4. y from shared memory: each thread's column keeps a / b in registers
  for (int q = tid; q < vpr * rstep; q += GN_THREADS) {
    const int v = q % vpr;
    float a[VEC], sh[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = v * VEC + i, g = c / cpg;
      a[i] = mi[2 * g + 1] * load_param(scale, sdt, c0 + c);
      sh[i] = load_param(bias, sdt, c0 + c) - mi[2 * g] * a[i];
    }
    for (int row = q / vpr; row < nrows; row += rstep) {
      float f[VEC];
      Pack<T>::unpack(*reinterpret_cast<const uint4*>(data + ((size_t)row * vpr + v) * VEC), f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = act(fmaf(f[i], a[i], sh[i]), SILU);
      *reinterpret_cast<uint4*>(y + (row0 + row) * C + c0 + v * VEC) = Pack<T>::pack(f);
    }
  }
  if (prof != nullptr && tid == 0) {
    long long* p = prof + (long long)blockIdx.x * GN_PROF_SLOTS;
    p[0] = t1 - t0;
    p[1] = t2 - t1;
    p[2] = clock64() - t2;
    p[3] = nrows;
  }
  cluster_wait();  // no block leaves while another may read its sums
}

// ---- two launches -----------------------------------------------------------

constexpr int UNROLL = 4;

// Threads of a (splits, B) block: rps rows at a time, one 16-byte column of
// channels each.
__host__ __device__ inline int rows_per_step(int ncv) {
  return ncv >= GN_THREADS ? 1 : GN_THREADS / ncv;
}

// part: [B][splits][G][2]; stats: [B][G][2] (mean, inv), or with ``raw``
// the sums (sum x, sum x^2) themselves; tickets: [B] ints, 0 on entry.
template <typename T>
__global__ void __launch_bounds__(1024)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                float* __restrict__ stats, int* __restrict__ tickets, int L, int C,
                int G, int splits, int rows_per_split, float eps, int raw) {
  constexpr int VEC = Pack<T>::VEC;
  extern __shared__ float sm[];  // [rps][C] of s1, then [rps][C] of s2
  __shared__ int is_last;
  const int ncv = C / VEC, rps = rows_per_step(ncv);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cv = tid % ncv, r = tid / ncv;
  const int split = blockIdx.x, b = blockIdx.y;
  const long long l0 = (long long)split * rows_per_split;
  const long long l1 = min((long long)L, l0 + rows_per_split);
  const T* xb = x + (long long)b * L * C + cv * VEC;
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  long long l = l0 + r;
  for (; l + (UNROLL - 1) * rps < l1; l += UNROLL * rps) {
    uint4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      q[u] = __ldg(reinterpret_cast<const uint4*>(xb + (l + u * rps) * C));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float v[VEC];
      Pack<T>::unpack(q[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    }
  }
  for (; l < l1; l += rps) {
    float v[VEC];
    Pack<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xb + l * C)), v);
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
  for (int c = tid; c < C; c += nthreads) {
    float a = 0.f, q = 0.f;
    for (int rr = 1; rr < rps; ++rr) {
      a += sm[rr * C + c];
      q += sm[(rps + rr) * C + c];
    }
    sm[c] += a;
    sm[rps * C + c] += q;
  }
  __syncthreads();
  const int cpg = C / G;
  float* pb = part + ((long long)b * splits + split) * G * 2;
  for (int g = tid; g < G; g += nthreads) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += sm[g * cpg + j];
      q += sm[rps * C + g * cpg + j];
    }
    pb[2 * g] = a;
    pb[2 * g + 1] = q;
  }
  // the last block of sample b to get here combines its partials
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + b, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int J = max(1, nthreads / G);
  const int g = tid % G, j = tid / G;
  float* red = sm;  // [J][G][2]
  if (j < J) {
    float a[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
    int k = 0;
    for (int s = j; s < splits; s += J, ++k) {
      const float* p = part + (((long long)b * splits + s) * G + g) * 2;
      a[k & 1] += __ldcg(p);
      q[k & 1] += __ldcg(p + 1);
    }
    red[(j * G + g) * 2] = a[0] + a[1];
    red[(j * G + g) * 2 + 1] = q[0] + q[1];
  }
  __syncthreads();
  if (tid < G) {
    float a = 0.f, q = 0.f;
    for (int jj = 0; jj < J; ++jj) {
      a += red[(jj * G + tid) * 2];
      q += red[(jj * G + tid) * 2 + 1];
    }
    if (raw) {
      stats[((long long)b * G + tid) * 2] = a;
      stats[((long long)b * G + tid) * 2 + 1] = q;
      return;
    }
    const float n = (float)L * (float)cpg;
    const float mean = a / n;
    const float var = fmaxf(q / n - mean * mean, 0.f);
    stats[((long long)b * G + tid) * 2] = mean;
    stats[((long long)b * G + tid) * 2 + 1] = rsqrtf(var + eps);
  }
}

// stats: [B][G][2] (mean, inv); with count > 0 the sums (sum x, sum x^2)
// of count elements a group, turned into mean / inv here (eps).
template <typename T, bool SILU>
__global__ void __launch_bounds__(1024)
gn_norm_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ stats,
               const void* scale, const void* bias, int sdt, int L, int C,
               int G, int rows_per_split, float count, float eps) {
  constexpr int VEC = Pack<T>::VEC;
  const int ncv = C / VEC, rps = rows_per_step(ncv);
  const int tid = threadIdx.x;
  const int cv = tid % ncv, r = tid / ncv;
  const int split = blockIdx.x, b = blockIdx.y;
  const int cpg = C / G;
  float a[VEC], sh[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = cv * VEC + i, g = c / cpg;
    float mean = stats[((long long)b * G + g) * 2];
    float inv = stats[((long long)b * G + g) * 2 + 1];
    if (count > 0.f) {
      mean = mean / count;
      inv = rsqrtf(fmaxf(inv / count - mean * mean, 0.f) + eps);
    }
    a[i] = inv * load_param(scale, sdt, c);
    sh[i] = load_param(bias, sdt, c) - mean * a[i];
  }
  // the split's rows from its last one down: the statistics pass read them
  // upwards, so the first rows read here are the ones still in L2
  const long long l0 = (long long)split * rows_per_split;
  const long long l1 = min((long long)L, l0 + rows_per_split);
  const long long base = (long long)b * L * C + cv * VEC;
  long long l = l1 - 1 - r;
  for (; l - (UNROLL - 1) * rps >= l0; l -= UNROLL * rps) {
    uint4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      q[u] = __ldg(reinterpret_cast<const uint4*>(x + base + (l - u * rps) * C));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float v[VEC];
      Pack<T>::unpack(q[u], v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = act(fmaf(v[i], a[i], sh[i]), SILU);
      *reinterpret_cast<uint4*>(y + base + (l - u * rps) * C) = Pack<T>::pack(v);
    }
  }
  for (; l >= l0; l -= rps) {
    float v[VEC];
    Pack<T>::unpack(__ldg(reinterpret_cast<const uint4*>(x + base + l * C)), v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = act(fmaf(v[i], a[i], sh[i]), SILU);
    *reinterpret_cast<uint4*>(y + base + l * C) = Pack<T>::pack(v);
  }
}

size_t stats_smem(int C, int elem) {
  const int ncv = C / (16 / elem);
  return (size_t)2 * rows_per_step(ncv) * C * sizeof(float);
}

// Raise a slice kernel's dynamic shared-memory cap to the card's per-block
// limit (a cap, not a request: a launch takes what it asks for; valid for a
// kernel without static shared memory) and, for the MAXCS 16 instance,
// allow clusters of 16; once per kernel and device.  One flag per kernel:
// kernels of one signature share a type.
template <auto KERNEL, bool WIDE>
cudaError_t set_slice_attrs() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64 || done[dev]) return e;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (e == cudaSuccess && WIDE)
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done[dev] = e == cudaSuccess;
  return e;
}

template <typename T, bool SILU, int MAXCS>
int launch_slice(const void* x, void* y, const void* scale, const void* bias, int sdt,
                 int B, int L, int C, int G, int gpc, int cs, int rows_per_block,
                 float eps, long long* prof, cudaStream_t stream) {
  const size_t smem = slice_smem(gpc * (C / G), gpc, rows_per_block, sizeof(T));
  cudaError_t err = set_slice_attrs<gn_slice_kernel<T, SILU, MAXCS>, (MAXCS > 8)>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cs * B * (G / gpc)));
  cfg.blockDim = dim3(GN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gn_slice_kernel<T, SILU, MAXCS>,
                                 static_cast<const T*>(x), static_cast<T*>(y), scale, bias,
                                 sdt, L, C, G, gpc, cs, rows_per_block, eps, prof);
}

template <typename T, bool SILU>
int launch_two(const void* x, void* y, const void* scale, const void* bias, int sdt,
               float* scratch, int B, int L, int C, int G, int splits, float eps,
               cudaStream_t stream) {
  constexpr int VEC = Pack<T>::VEC;
  const int ncv = C / VEC, threads = rows_per_step(ncv) * ncv;
  const int rows_per_split = (L + splits - 1) / splits;
  float* part = scratch;
  float* stats = part + 2LL * B * splits * G;
  int* tickets = reinterpret_cast<int*>(stats + 2LL * B * G);
  cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(int) * B, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = stats_smem(C, sizeof(T));  // <= 32 KB: no attribute needed
  gn_stats_kernel<T><<<dim3(splits, B), threads, smem, stream>>>(
      static_cast<const T*>(x), part, stats, tickets, L, C, G, splits, rows_per_split, eps,
      0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_norm_kernel<T, SILU><<<dim3(splits, B), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), stats, scale, bias, sdt, L, C, G,
      rows_per_split, 0.f, eps);
  return (int)cudaGetLastError();
}

// Path 3's statistics entry: the (B, G, 2) sums of x into ``sums``.
template <typename T>
int launch_stats(const void* x, float* sums, float* scratch, int B, int L, int C, int G,
                 int splits, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::VEC;
  const int ncv = C / VEC, threads = rows_per_step(ncv) * ncv;
  const int rows_per_split = (L + splits - 1) / splits;
  int* tickets = reinterpret_cast<int*>(scratch + 2LL * B * splits * G);
  cudaError_t err = cudaMemsetAsync(tickets, 0, sizeof(int) * B, stream);
  if (err != cudaSuccess) return (int)err;
  gn_stats_kernel<T><<<dim3(splits, B), threads, stats_smem(C, sizeof(T)), stream>>>(
      static_cast<const T*>(x), scratch, sums, tickets, L, C, G, splits, rows_per_split,
      0.f, 1);
  return (int)cudaGetLastError();
}

// Path 3's apply entry: y from x and the global sums of ``count`` elements a
// group.
template <typename T, bool SILU>
int launch_apply(const void* x, void* y, const float* sums, const void* scale,
                 const void* bias, int sdt, int B, int L, int C, int G, int splits,
                 float count, float eps, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::VEC;
  const int ncv = C / VEC, threads = rows_per_step(ncv) * ncv;
  const int rows_per_split = (L + splits - 1) / splits;
  gn_norm_kernel<T, SILU><<<dim3(splits, B), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), sums, scale, bias, sdt, L, C, G,
      rows_per_split, count, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, const void* scale, const void* bias, int sdt,
           float* scratch, int B, int L, int C, int G, float eps, int silu, int gpc,
           int cs, int rows_per_block, int splits, long long* prof, cudaStream_t st) {
  if (splits > 0)
    return silu ? launch_two<T, true>(x, y, scale, bias, sdt, scratch, B, L, C, G, splits,
                                      eps, st)
                : launch_two<T, false>(x, y, scale, bias, sdt, scratch, B, L, C, G, splits,
                                       eps, st);
  if (cs > 8)
    return silu ? launch_slice<T, true, 16>(x, y, scale, bias, sdt, B, L, C, G, gpc, cs,
                                            rows_per_block, eps, prof, st)
                : launch_slice<T, false, 16>(x, y, scale, bias, sdt, B, L, C, G, gpc, cs,
                                             rows_per_block, eps, prof, st);
  return silu ? launch_slice<T, true, 8>(x, y, scale, bias, sdt, B, L, C, G, gpc, cs,
                                         rows_per_block, eps, prof, st)
              : launch_slice<T, false, 8>(x, y, scale, bias, sdt, B, L, C, G, gpc, cs,
                                          rows_per_block, eps, prof, st);
}

}  // namespace

// Dynamic shared memory of one block (bytes): the one-launch kernel at
// (gpc groups a slice, rows_per_block) when splits == 0, else the two-launch
// statistics kernel.  ops/group_norm.py group_norm_plan computes the same.
extern "C" long long v3d_group_norm_smem(int dtype, int C, int G, int gpc,
                                         int rows_per_block, int splits) {
  const int elem = dtype == V3D_F32 ? 4 : 2;
  if (splits > 0) return (long long)stats_smem(C, elem);
  return (long long)slice_smem(gpc * (C / G), gpc, rows_per_block, elem);
}

// x/y: (B, L, C) contiguous, 16-byte aligned, C a multiple of G and of the
// 16-byte vector; scale/bias (C,) in f32 (sdt 0) or bf16 (sdt 1).  splits
// == 0: one launch of clusters of cs blocks over slices of gpc groups,
// rows_per_block rows a block (prof: null or B * (G / gpc) * cs * 4 int64).
// splits > 0: two launches; scratch 2 * B * splits * G + 2 * B * G floats
// (partials, mean / inv) and B ints (tickets, zeroed here on ``stream``).
// Returns the cudaError_t of the launches.
extern "C" int v3d_group_norm(int dtype, const void* x, void* y, const void* scale,
                              const void* bias, int sdt, void* scratch, int B, int L,
                              int C, int G, float eps, int silu, int gpc, int cs,
                              int rows_per_block, int splits, void* prof, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scratch);
  long long* pr = static_cast<long long*>(prof);
  if (dtype == V3D_F32)
    return launch<float>(x, y, scale, bias, sdt, s, B, L, C, G, eps, silu, gpc, cs,
                         rows_per_block, splits, pr, st);
  if (dtype == V3D_BF16)
    return launch<__nv_bfloat16>(x, y, scale, bias, sdt, s, B, L, C, G, eps, silu, gpc,
                                 cs, rows_per_block, splits, pr, st);
  return (int)cudaErrorInvalidValue;
}

// Split statistics, the first entry: x (B, L, C) as v3d_group_norm takes it;
// sums (B, G, 2) f32 receives each sample's per-group (sum x, sum x^2) over
// its L rows; scratch 2 * B * splits * G floats (partials) and B ints
// (tickets, zeroed here on ``stream``); grid (splits, B).
extern "C" int v3d_group_norm_stats(int dtype, const void* x, void* sums, void* scratch,
                                    int B, int L, int C, int G, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sums);
  float* s = static_cast<float*>(scratch);
  if (dtype == V3D_F32) return launch_stats<float>(x, out, s, B, L, C, G, splits, st);
  if (dtype == V3D_BF16)
    return launch_stats<__nv_bfloat16>(x, out, s, B, L, C, G, splits, st);
  return (int)cudaErrorInvalidValue;
}

// Split statistics, the second entry: y = GroupNorm(x) (+ SiLU) from sums
// (B, G, 2) f32 of ``count`` elements a group (all ranks' rows), scale /
// bias as v3d_group_norm takes them; grid (splits, B).
extern "C" int v3d_group_norm_apply(int dtype, const void* x, void* y, const void* sums,
                                    const void* scale, const void* bias, int sdt, int B,
                                    int L, int C, int G, float count, float eps, int silu,
                                    int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sm = static_cast<const float*>(sums);
  if (!(count > 0.f)) return (int)cudaErrorInvalidValue;
  if (dtype == V3D_F32)
    return silu ? launch_apply<float, true>(x, y, sm, scale, bias, sdt, B, L, C, G, splits,
                                            count, eps, st)
                : launch_apply<float, false>(x, y, sm, scale, bias, sdt, B, L, C, G, splits,
                                             count, eps, st);
  if (dtype == V3D_BF16)
    return silu ? launch_apply<__nv_bfloat16, true>(x, y, sm, scale, bias, sdt, B, L, C, G,
                                                    splits, count, eps, st)
                : launch_apply<__nv_bfloat16, false>(x, y, sm, scale, bias, sdt, B, L, C, G,
                                                     splits, count, eps, st);
  return (int)cudaErrorInvalidValue;
}
