// K3: temporal attention core, softmax over the t frames for every
// (video, pixel, head).
//
// Replaces: v3d_tpu/ops/temporal_attention.py _pallas_core (:198-214, kernel
// _kernel :36), reached through temporal_core (:218).  Main path: the
// VideoUNet's temporal self-attention at ds2, ds4 and ds8 (10 or 20 heads,
// over the fused block's head limit), 11 calls per UNet forward.
//
// What bounds it on the H100: memory.  An 18x18x64 attention is ~83 kFLOP
// against 4 * 18 * 64 elements moved, ~80 FLOP per bf16 byte: under the
// ridge, so the floor is one read of q, k, v and one write of o (~190 MB at
// the ds2 shape, ~57 us at 3.35 TB/s).
//
// Design: q, k, v are read straight from the (b, t, s, heads*dh) layout that
// the projection matmul writes (any b/t/s strides, unit channel stride), and
// o is written in the same layout, so no permute copies surround the call
// (the TPU's (t, d, n) lane layout is not carried over).  One warp per
// (b, pixel, head); neighbouring warps take neighbouring heads of a pixel, so
// a block reads contiguous channel runs.  The warp stages its t x dh slabs in
// shared memory as f32 (q pre-scaled, odd row pitch so lane i reading row i
// hits its own bank); lane i computes query row i's scores, softmax and
// normalisation in f32, then the lanes split the dh output channels.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
temporal_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int b, int t,
                     int s, int heads, int dh, long long sb, long long st,
                     long long ss, long long ksb, long long kst, long long kss,
                     long long vsb, long long vst, long long vss, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = dh + 1;
  const int per_warp = 3 * t * ld + t * (t + 1);
  float* qs = smem + warp * per_warp;
  float* ks = qs + t * ld;
  float* vs = ks + t * ld;
  float* ps = vs + t * ld;

  const long long col = (long long)blockIdx.x * WARPS + warp;
  if (col >= (long long)b * s * heads) return;
  const int hi = (int)(col % heads);
  const long long pix = col / heads;
  const int si = (int)(pix % s), bi = (int)(pix / s);
  const int c0 = hi * dh;
  const T* qb = q + bi * sb + si * ss + c0;
  const T* kb = k + bi * ksb + si * kss + c0;
  const T* vb = v + bi * vsb + si * vss + c0;

  for (int f = 0; f < t; ++f) {
    for (int c = lane; c < dh; c += 32) {
      qs[f * ld + c] = to_f(qb[f * st + c]) * scale;
      ks[f * ld + c] = to_f(kb[f * kst + c]);
      vs[f * ld + c] = to_f(vb[f * vst + c]);
    }
  }
  __syncwarp();

  const int hd = heads * dh;
  T* ob = o + (((long long)bi * t) * s + si) * hd + c0;
  warp_frame_attention(qs, ks, vs, 1, ld, ps, t, dh,
                       [&](int i, int c, float val) {
                         ob[(long long)i * s * hd + c] = from_f<T>(val);
                       });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int t,
           int s, int heads, int dh, const long long* qst, const long long* kst,
           const long long* vst, cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * (3 * t * (dh + 1) + t * (t + 1));
  cudaError_t err = cudaFuncSetAttribute(
      temporal_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long cols = (long long)b * s * heads;
  const unsigned blocks = (unsigned)((cols + WARPS - 1) / WARPS);
  temporal_core_kernel<T><<<blocks, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), b, t, s, heads, dh, qst[0], qst[1], qst[2], kst[0],
      kst[1], kst[2], vst[0], vst[1], vst[2], 1.f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v: (b, t, s, heads*dh) through element strides (b, t, s), unit channel
// stride; o: contiguous (b, t, s, heads*dh).  t <= 32.  Returns the launch's
// cudaError_t.
extern "C" int v3d_temporal_core(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int b, int t, int s,
                                 int heads, int dh, long long qsb, long long qst,
                                 long long qss, long long ksb, long long kst,
                                 long long kss, long long vsb, long long vst,
                                 long long vss, void* stream) {
  const long long qs[3] = {qsb, qst, qss}, ks[3] = {ksb, kst, kss},
                  vs[3] = {vsb, vst, vss};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (dtype == V3D_F32)
    return launch<float>(q, k, v, o, b, t, s, heads, dh, qs, ks, vs, sm);
  if (dtype == V3D_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, b, t, s, heads, dh, qs, ks, vs, sm);
  return (int)cudaErrorInvalidValue;
}
