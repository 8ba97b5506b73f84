// K10: LayerNorm over the last dim in float32, output in the input's dtype.
//
// Replaces no TPU kernel: the JAX package leaves LayerNormF32
// (v3d_tpu/models/layers.py) to XLA, which fuses its upcast, the f32
// LayerNorm and the downcast into one pass.  Eager PyTorch ran the same
// module as five launches (x upcast, two parameter casts, F.layer_norm in
// f32, the downcast): 20 bytes moved for each bf16 element where one pass
// needs 4.  K10 is that one pass.  Main path: every LayerNormF32 that wants
// no gradient (ops/layer_norm.py layer_norm_route): 112 a V3D-512 UNet
// forward (rows x C from 147,456 x 320 at ds1 to 2,304 x 1,280 in the
// middle block), 48 an SD 2.1 UNet2D forward, 66 a CLIP ViT-H/14 forward
// (257 x 1,280 at batch 1).
//
// What bounds it on the H100: bytes, one read of x and one write of y
// (0.0563 ms at ds1 in bf16 over 3.35 TB/s; ~10 f32 operations an element).
// So every choice serves bandwidth:
// - a row lives in the registers of LANES threads (8, 16 or 32 of a warp:
//   the group), each holding SLOTS packs of W elements; lane g holds packs
//   g, g + LANES, ..., so each load instruction of a group reads LANES
//   contiguous packs.  W is 16 bytes of elements wherever C, the row stride
//   and the base allow (ld/st.global.v4), else one element;
// - statistics as F.layer_norm computes them: the mean, then the sum of
//   squared deviations from it, both over the registers, each reduced over
//   the group by shuffles in a fixed order (deterministic); rstd =
//   rsqrt(var + eps);
// - y = (x - mean) * rstd * w + b in f32, rounded once to x's dtype and
//   stored once;
// - weight and bias, f32 or bf16 as stored, are converted to f32 into
//   shared memory once a block (1.3-5 KB from L2 against a block's 20-40 KB
//   of x);
// - one warp task (32 / LANES rows) a warp, 8 a block, and as many blocks
//   as tasks: the block scheduler refills each SM as blocks retire, so
//   every SM stays at its residency (4 or 3 blocks of 256, the instances'
//   launch bounds; 32 or 24 warps, each with 4-10 loads of 16 bytes a lane
//   in flight) until the last short wave.  A grid of the resident blocks
//   only, each warp walking every (warps in the grid)-th task, read 77%
//   of the bound at V3D's ds1 and 72% at SD's against 85% and 80% this
//   way (H100, 700 W): its last round of tasks ran on a fraction of the
//   warps.  A lane holds 4-5 packs (bf16) or 5-10 (f32): 10 bf16 packs
//   spilled and halved the rate.
// Widths the models use (320, 640, 1024, 1280) are compiled with the row
// length fixed (no predicates); any other C up to LN_MAX_C takes the
// generic instance: one warp a row, predicated slots.  The host plans each
// call (ops/layer_norm.py layer_norm_plan) and refuses C above LN_MAX_C.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_MAX_C = 4096;   // ops/layer_norm.py LN_MAX_C

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

// A pack from / to global memory: one 16-byte access where it is 16 bytes.
template <typename T, int W>
__device__ __forceinline__ Pack<T, W> load_pack(const T* p) {
  Pack<T, W> out;
  if constexpr (sizeof(out) == 16)
    *reinterpret_cast<uint4*>(&out) = *reinterpret_cast<const uint4*>(p);
  else
    out = *reinterpret_cast<const Pack<T, W>*>(p);
  return out;
}
template <typename T, int W>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, W>& v) {
  if constexpr (sizeof(v) == 16)
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&v);
  else
    *reinterpret_cast<Pack<T, W>*>(p) = v;
}

// LANES threads a row, SLOTS packs of W elements a thread.  FIXED: C ==
// LANES * SLOTS * W; otherwise slots past C are skipped (W divides C).
// Rows r of x start at x + r * ldx; y is (rows, C) contiguous.  Warp w of
// the grid takes rows w * 32 / LANES onwards, 32 / LANES of them.
// Blocks resident an SM an instance is built for: 4 of 256 threads (<= 64
// registers) where a lane's part of a row fits 20 registers, 3 (<= 85) up to
// 40; the generic instance (128 elements a lane) 1.
template <typename T, int LANES, int W, int SLOTS, bool FIXED>
__global__ void __launch_bounds__(LN_THREADS,
                                  FIXED ? (SLOTS * W * sizeof(T) <= 80 ? 4 : 3) : 1)
k10_layer_norm_rows(const T* __restrict__ x, T* __restrict__ y, const void* weight,
                    const void* bias, int pdt, long long rows, int C, long long ldx,
                    float eps) {
  extern __shared__ float sp[];  // weight then bias, f32, C each
  float* sw = sp;
  float* sb = sp + C;
  for (int i = threadIdx.x; i < C; i += LN_THREADS) {
    if (pdt == V3D_F32) {
      sw[i] = static_cast<const float*>(weight)[i];
      sb[i] = static_cast<const float*>(bias)[i];
    } else {
      sw[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(weight)[i]);
      sb[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[i]);
    }
  }
  __syncthreads();

  constexpr int GROUPS = 32 / LANES;            // rows a warp task
  constexpr int WARPS = LN_THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane % LANES;
  const long long first = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * GROUPS;
  if (first >= rows) return;  // warp-uniform: the shuffles below take the whole warp
  // a row past the end is read as zeros and not stored
  const long long r = first + lane / LANES;
  const bool live = r < rows;
  const T* xr = x + (live ? r : 0) * ldx;
  Pack<T, W> v[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int e = (s * LANES + g) * W;
    if (live && (FIXED || e < C)) {
      v[s] = load_pack<T, W>(xr + e);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[s].v[k] = from_f<T>(0.f);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
#pragma unroll
    for (int k = 0; k < W; ++k) sum += to_f(v[s].v[k]);
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    if (FIXED || (s * LANES + g) * W < C) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float d = to_f(v[s].v[k]) - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / (float)C + eps);
  if (!live) return;
  T* yr = y + r * C;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int e = (s * LANES + g) * W;
    if (FIXED || e < C) {
      Pack<T, W> out;
#pragma unroll
      for (int k = 0; k < W; ++k)
        out.v[k] = from_f<T>(fmaf((to_f(v[s].v[k]) - mean) * rstd, sw[e + k], sb[e + k]));
      store_pack<T, W>(yr + e, out);
    }
  }
}

template <typename T, int LANES, int W, int SLOTS, bool FIXED>
cudaError_t run(const void* x, void* y, const void* w, const void* b, int pdt,
                long long rows, int C, long long ldx, float eps, int grid, cudaStream_t st) {
  k10_layer_norm_rows<T, LANES, W, SLOTS, FIXED>
      <<<grid, LN_THREADS, 2 * C * sizeof(float), st>>>(
          static_cast<const T*>(x), static_cast<T*>(y), w, b, pdt, rows, C, ldx, eps);
  return cudaGetLastError();
}

// The instance of (C, lanes, vec, fixed) as layer_norm_plan picks it; an
// unknown combination is refused.
template <typename T>
cudaError_t dispatch(const void* x, void* y, const void* w, const void* b, int pdt,
                     long long rows, int C, long long ldx, float eps, int lanes, int vec,
                     int fixed, int grid, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  if (fixed) {
    if (vec != V || lanes > 32) return cudaErrorInvalidValue;
    const int slots = C / (lanes * V);
    if (slots * lanes * V != C) return cudaErrorInvalidValue;
#define K10_FIXED(L, S)                                                                \
  if (lanes == L && slots == S)                                                        \
    return run<T, L, V, S, true>(x, y, w, b, pdt, rows, C, ldx, eps, grid, st);
    if constexpr (V == 8) {  // bf16: 320, 640, 1024, 1280
      K10_FIXED(8, 5)
      K10_FIXED(16, 5)
      K10_FIXED(32, 4)
      K10_FIXED(32, 5)
    } else {                 // f32: 320, 640, 1024, 1280
      K10_FIXED(16, 5)
      K10_FIXED(32, 5)
      K10_FIXED(32, 8)
      K10_FIXED(32, 10)
    }
#undef K10_FIXED
    return cudaErrorInvalidValue;
  }
  if (lanes != 32 || C > LN_MAX_C || C % vec) return cudaErrorInvalidValue;
  if (vec == V)
    return run<T, 32, V, LN_MAX_C / (32 * V), false>(x, y, w, b, pdt, rows, C, ldx, eps,
                                                     grid, st);
  if (vec == 1)
    return run<T, 32, 1, LN_MAX_C / 32, false>(x, y, w, b, pdt, rows, C, ldx, eps, grid,
                                               st);
  return cudaErrorInvalidValue;
}

}  // namespace

// y (rows, C) contiguous = LayerNorm over C of x's rows (row r at x + r *
// ldx elements, unit stride on C) in f32, in x's dtype (0 f32, 1 bf16);
// weight / bias (C,) in f32 (pdt 0) or bf16 (pdt 1).  lanes / vec / fixed /
// grid: ops/layer_norm.py layer_norm_plan (vec 16 bytes of elements needs
// x, ldx and C 16-byte aligned).  Returns the launch's cudaError_t.
extern "C" int v3d_layer_norm(int dtype, int pdt, const void* x, void* y,
                              const void* weight, const void* bias, long long rows, int C,
                              long long ldx, float eps, int lanes, int vec, int fixed,
                              int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((pdt != V3D_F32 && pdt != V3D_BF16) || rows <= 0 || C <= 0 || lanes <= 0 ||
      vec <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == V3D_F32)
    return (int)dispatch<float>(x, y, weight, bias, pdt, rows, C, ldx, eps, lanes, vec,
                                fixed, grid, st);
  if (dtype == V3D_BF16)
    return (int)dispatch<__nv_bfloat16>(x, y, weight, bias, pdt, rows, C, ldx, eps,
                                        lanes, vec, fixed, grid, st);
  return (int)cudaErrorInvalidValue;
}
