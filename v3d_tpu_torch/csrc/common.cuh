// Shared helpers for the v3d_tpu_torch kernels (plain C interface, loaded
// with ctypes; see v3d_tpu_torch/kernels/build.py).
#pragma once

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (v3d_tpu_torch/ops/_dispatch.py DTYPE_CODES)
enum V3dDtype { V3D_F32 = 0, V3D_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// mma.sync.m16n8k16, bf16 in, f32 accumulate: d += a b.  Fragment layout
// (g = lane / 4, u = lane % 4): a regs hold (row g | g+8, cols 2u..2u+1 |
// 2u+8..2u+9); b regs (k 2u..2u+1 | 2u+8..2u+9, col g); d regs (row g,
// cols 2u, 2u+1), (row g+8, same cols).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16-byte aligned).  Register i receives matrix i
// in the mma fragment layout (row g, cols 2u..2u+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The transposing form: register i receives matrix i transposed, so from a
// row-major [k][n] tile it gives the mma b fragment (k 2u..2u+1, col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int MAX_T = 32;  // frames a warp attends over (one lane per query)

// Softmax attention over the t frames of one (pixel, head), run by ONE warp:
// lane i owns query row i (t <= 32).  q is pre-scaled by 1/sqrt(dh).  Row f
// of the q/k/v buffers starts at f * row_mult * ld floats.  The scores of a
// row, and later the t outputs of one channel, are held in registers as t
// independent accumulators (no dependent FMA chain over the head dim); p is
// the warp's t x (t + 1) scratch.  ``out(i, c, value)`` stores one output.
template <int TMAX, typename Store>
__device__ __forceinline__ void warp_frame_attention_t(
    const float* q, const float* k, const float* v, int row_mult, int ld,
    float* p, int t, int dh, Store out) {
  const int lane = threadIdx.x & 31;
  const int lp = t + 1;
  const int rs = row_mult * ld;
  if (lane < t) {
    const float* qi = q + lane * rs;
    float s[TMAX];
#pragma unroll
    for (int j = 0; j < TMAX; ++j) s[j] = 0.f;
    for (int c = 0; c < dh; ++c) {
      const float qc = qi[c];
#pragma unroll
      for (int j = 0; j < TMAX; ++j)
        if (j < t) s[j] = fmaf(qc, k[j * rs + c], s[j]);  // broadcast read
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < TMAX; ++j)
      if (j < t) m = fmaxf(m, s[j]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < t) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < TMAX; ++j)
      if (j < t) p[lane * lp + j] = s[j] * inv;
  }
  __syncwarp();
  for (int c = lane; c < dh; c += 32) {
    float o[TMAX];
#pragma unroll
    for (int i = 0; i < TMAX; ++i) o[i] = 0.f;
    for (int j = 0; j < t; ++j) {
      const float vj = v[j * rs + c];
#pragma unroll
      for (int i = 0; i < TMAX; ++i)
        if (i < t) o[i] = fmaf(p[i * lp + j], vj, o[i]);  // broadcast read
    }
#pragma unroll
    for (int i = 0; i < TMAX; ++i)
      if (i < t) out(i, c, o[i]);
  }
  __syncwarp();
}

// t = 18 (the V3D orbit) gets its own unrolling; any other t <= 32 the
// generic one.
template <typename Store>
__device__ __forceinline__ void warp_frame_attention(
    const float* q, const float* k, const float* v, int row_mult, int ld,
    float* p, int t, int dh, Store out) {
  if (t == 18)
    warp_frame_attention_t<18>(q, k, v, row_mult, ld, p, t, dh, out);
  else
    warp_frame_attention_t<MAX_T>(q, k, v, row_mult, ld, p, t, dh, out);
}
