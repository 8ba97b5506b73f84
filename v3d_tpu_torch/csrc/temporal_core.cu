// K3: temporal attention core, softmax over the t frames for every
// (video, pixel, head).
//
// Replaces: v3d_tpu/ops/temporal_attention.py _pallas_core (:198-214, kernel
// _kernel :36), reached through temporal_core (:218); also the batched APIs
// temporal_attention (:50-77, T5) and temporal_attention_mxu (:137-168, T6)
// on a (B, t, 1, h*d) view.  Main path: the VideoUNet's temporal
// self-attention at ds2, ds4 and ds8 (10 or 20 heads, over the fused
// block's head limit), 11 calls per UNet forward.
//
// What bounds it on the H100: memory.  An 18x18x64 attention is ~83 kFLOP
// against 4 * 18 * 64 elements moved, ~80 FLOP per bf16 byte: under the
// ridge, so the floor is one read of q, k, v and one write of o (189 MB at
// the ds2 shape, n = 20480 (pixel, head) items: 0.0563 ms at 3.35 TB/s).
//
// Design (bf16, the main path): q, k, v are read straight from the
// (b, t, s, heads*dh) layout that the projection matmul writes (any b/t/s
// strides, unit channel stride), and o is written contiguous in the same
// layout, so no permute copies surround the call.  An item is one (b,
// pixel, head): three t x dh slabs.  The grid is what fits on the card at
// once (3 blocks of 4 warps an SM at t = 18, dh = 64), and each warp walks
// the items warp_id, warp_id + warps, ... (neighbouring warps on
// neighbouring heads of a pixel, so reads are contiguous channel runs)
// through a ring of two shared-memory slots: while it computes one item,
// the next item's slabs are in flight as 16-byte cp.async copies (element
// loads where a base or stride is not a multiple of 8 elements), kept in
// bf16 (~83 KB of loads in flight per SM).  A warp computes S = Q K^T (t
// padded to 32) and O = P V on mma.sync.m16n8k16 with ldmatrix fragments
// (frames past t read a shared zero row), the softmax in f32 on the S
// registers (base 2, a row over the 4 lanes of a quad), P normalised and
// packed to bf16 in registers as the plain version rounds it; O goes
// through the slot's Q slab to 16-byte coalesced stores.  Head widths are
// padded to a multiple of 32 with zero channels (the wrapper takes dh <=
// 128, t <= 32; dh = 64, the only width the port's models pass, is
// compiled apart).
// f32 (off the main path): one warp per item, slabs staged in f32 with an
// odd row pitch, lane i computes query row i on the CUDA cores
// (warp_frame_attention, common.cuh).
// Per bf16 block: 128 threads, 79 registers a thread at dh = 64 (80 for
// the other widths; ptxas, 0 spilled; chip_smoke.py phase 2), 62,352 bytes
// of dynamic shared memory at t = 18, dh = 64 (phase 3), so 3 blocks an SM.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int SLOTS = 2;  // bf16 kernel: items a warp holds in shared memory

struct Strides3 {
  long long b, t, s;
};

__host__ __device__ constexpr int padded_dh(int dh) { return (dh + 31) / 32 * 32; }
__host__ __device__ constexpr int slab_pitch(int dh) { return padded_dh(dh) + 8; }

// bytes of dynamic shared memory of one bf16 block: a zero row, then per
// warp SLOTS items of three t x pitch slabs
__host__ __device__ constexpr long long mma_smem(int t, int dh) {
  return 2LL * slab_pitch(dh) * (1 + WARPS * SLOTS * 3 * t);
}

// DHC: the head width at compile time (64, the main path's), or 0 for dh
// at run time.
template <int DHC>
__global__ void __launch_bounds__(WARPS * 32)
temporal_core_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o, int t,
                         int s, int heads, int dh_arg, long long n_items, Strides3 qs,
                         Strides3 ks, Strides3 vs, float scale_log2, int vec_in,
                         int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dh = DHC ? DHC : dh_arg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, u = lane % 4;
  const int dhp = padded_dh(dh), pitch = slab_pitch(dh), slab = t * pitch;
  bf16* zero_row = reinterpret_cast<bf16*>(smem_raw);
  bf16* region = zero_row + pitch + warp * SLOTS * 3 * slab;
  for (int c = threadIdx.x; c < pitch; c += blockDim.x) zero_row[c] = __float2bfloat16(0.f);
  __syncthreads();

  const int hd = heads * dh;
  const bf16* src[3] = {q, k, v};
  const Strides3 st[3] = {qs, ks, vs};

  // q, k, v slabs of item ``col`` into ring slot ``slot`` (nothing past
  // the end); the caller commits one cp.async group per call
  auto stage = [&](long long col, int slot) {
    if (col >= n_items) return;
    const int hi = (int)(col % heads);
    const long long pix = col / heads;
    const int si = (int)(pix % s), bi = (int)(pix / s);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const bf16* from = src[m] + bi * st[m].b + si * st[m].s + hi * dh;
      bf16* dst = region + (slot * 3 + m) * slab;
      const int pad = dhp - dh;
      for (int e = lane; e < t * pad; e += 32)  // zero channels dh..dhp
        dst[(e / pad) * pitch + dh + e % pad] = __float2bfloat16(0.f);
      if (vec_in) {
        const int chunks = dh / 8;
        for (int e = lane; e < t * chunks; e += 32) {
          const int f = e / chunks, c = (e % chunks) * 8;
          cp_async16(dst + f * pitch + c, from + f * st[m].t + c);
        }
      } else {
        for (int e = lane; e < t * dh; e += 32) {
          const int f = e / dh, c = e % dh;
          dst[f * pitch + c] = from[f * st[m].t + c];
        }
      }
    }
  };

  // each warp walks items warp_id, warp_id + n_warps, ... with the next
  // SLOTS - 1 items' copies in flight while one is computed
  const long long first = (long long)blockIdx.x * WARPS + warp;
  const long long n_warps = (long long)gridDim.x * WARPS;
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) {
    stage(first + i * n_warps, i);
    cp_async_commit();
  }
  int slot = 0;
  for (long long col = first; col < n_items; col += n_warps) {
    stage(col + (SLOTS - 1) * n_warps, (slot + SLOTS - 1) % SLOTS);
    cp_async_commit();
    cp_async_wait<SLOTS - 1>();
    __syncwarp();
    bf16* Qs = region + slot * 3 * slab;
    const bf16* Ks = Qs + slab;
    const bf16* Vs = Ks + slab;
    // ldmatrix row address: rows past t read the zero row
    auto addr = [&](const bf16* base, int row, int c) {
      return smem_u32((row < t ? base + row * pitch : zero_row) + c);
    };

    // S (32 x 32) = Q K^T over dhp channels
    float sc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < dhp / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], addr(Qs, 16 * mt + lane % 16, 16 * kk + 8 * (lane / 16)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, addr(Ks, 16 * np + lane % 8 + 8 * (lane / 16),
                            16 * kk + 8 * ((lane / 8) % 2)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(sc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(sc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // softmax over the t key frames; P normalised, then bf16 A fragments
    uint32_t pa[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[mt][nt][2 * r + e];
            x = 8 * nt + 2 * u + e < t ? x * scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[mt][nt][2 * r + e];
            x = exp2f(x - mx);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) sc[mt][nt][2 * r + e] *= inv;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pa[mt][j][0] = pack_bf16(sc[mt][2 * j][0], sc[mt][2 * j][1]);
        pa[mt][j][1] = pack_bf16(sc[mt][2 * j][2], sc[mt][2 * j][3]);
        pa[mt][j][2] = pack_bf16(sc[mt][2 * j + 1][0], sc[mt][2 * j + 1][1]);
        pa[mt][j][3] = pack_bf16(sc[mt][2 * j + 1][2], sc[mt][2 * j + 1][3]);
      }
    }
    __syncwarp();  // every lane is done reading Q: its slab now stages O

    // O (32 x dhp) = P V, 32 channels at a time, into the Q slab
#pragma unroll
    for (int c32 = 0; c32 < dhp / 32; ++c32) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, addr(Vs, 16 * j + lane % 8 + 8 * ((lane / 8) % 2),
                                    32 * c32 + 16 * dp + 8 * (lane / 16)));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt][j], b[0], b[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt][j], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mt + g + 8 * r;
          if (row >= t) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<__nv_bfloat162*>(Qs + row * pitch + 32 * c32 + 8 * nt +
                                               2 * u) =
                __floats2bfloat162_rn(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        }
    }
    __syncwarp();

    const int hi = (int)(col % heads);
    const long long pix = col / heads;
    const int si = (int)(pix % s), bi = (int)(pix / s);
    bf16* ob = o + (((long long)bi * t) * s + si) * hd + hi * dh;
    const long long frame = (long long)s * hd;
    if (vec_out) {
      const int chunks = dh / 8;
      for (int e = lane; e < t * chunks; e += 32) {
        const int f = e / chunks, c = (e % chunks) * 8;
        *reinterpret_cast<uint4*>(ob + f * frame + c) =
            *reinterpret_cast<const uint4*>(Qs + f * pitch + c);
      }
    } else {
      for (int e = lane; e < t * dh; e += 32) {
        const int f = e / dh, c = e % dh;
        ob[f * frame + c] = Qs[f * pitch + c];
      }
    }
    __syncwarp();  // the slot is read out before the next copies land
    slot = (slot + 1) % SLOTS;
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(WARPS * 32)
temporal_core_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int t,
                         int s, int heads, int dh, long long n_items, Strides3 qs,
                         Strides3 ks, Strides3 vs, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = dh + 1;
  float* qw = smem + warp * (3 * t * ld + t * (t + 1));
  float* kw = qw + t * ld;
  float* vw = kw + t * ld;
  float* pw = vw + t * ld;

  const long long col = (long long)blockIdx.x * WARPS + warp;
  if (col >= n_items) return;
  const int hi = (int)(col % heads);
  const long long pix = col / heads;
  const int si = (int)(pix % s), bi = (int)(pix / s);
  const int c0 = hi * dh;
  const float* qb = q + bi * qs.b + si * qs.s + c0;
  const float* kb = k + bi * ks.b + si * ks.s + c0;
  const float* vb = v + bi * vs.b + si * vs.s + c0;
  for (int f = 0; f < t; ++f) {
    for (int c = lane; c < dh; c += 32) {
      qw[f * ld + c] = qb[f * qs.t + c] * scale;
      kw[f * ld + c] = kb[f * ks.t + c];
      vw[f * ld + c] = vb[f * vs.t + c];
    }
  }
  __syncwarp();
  const int hd = heads * dh;
  float* ob = o + (((long long)bi * t) * s + si) * hd + c0;
  warp_frame_attention(qw, kw, vw, 1, ld, pw, t, dh, [&](int i, int c, float val) {
    ob[(long long)i * s * hd + c] = val;
  });
}

bool aligned8(const void* p, const Strides3& st, int dh, int heads) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % 8 == 0 && st.t % 8 == 0 &&
         st.s % 8 == 0 && dh % 8 == 0 && (long long)heads * dh % 8 == 0;
}

// The bf16 grid: every block that fits on the card at once (occupancy
// times SMs), or fewer where the items run out first (SLOTS a warp).  The
// attribute and the occupancy are set and asked once per device, kernel and
// size, not at every launch.
template <typename Kernel>
cudaError_t mma_grid(Kernel kernel, int smem, long long n_items, int* blocks) {
  struct Entry {
    int dev, smem, resident;
    const void* fn;
  };
  static Entry cache[16];
  static int n_cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int resident = 0;
  for (int i = 0; i < n_cached; ++i)
    if (cache[i].dev == dev && cache[i].smem == smem &&
        cache[i].fn == reinterpret_cast<const void*>(kernel))
      resident = cache[i].resident;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32,
                                                          smem);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    if (n_cached < 16)
      cache[n_cached++] = {dev, smem, resident, reinterpret_cast<const void*>(kernel)};
  }
  const long long needed = (n_items + WARPS * SLOTS - 1) / (WARPS * SLOTS);
  *blocks = (int)(needed < resident ? needed : resident);
  return cudaSuccess;
}

}  // namespace

// q/k/v: (b, t, s, heads*dh) through element strides (b, t, s), unit channel
// stride; o: contiguous (b, t, s, heads*dh).  t <= 32, dh <= 128.  Returns
// the launch's cudaError_t.
extern "C" int v3d_temporal_core(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int b, int t, int s,
                                 int heads, int dh, long long qsb, long long qst,
                                 long long qss, long long ksb, long long kst,
                                 long long kss, long long vsb, long long vst,
                                 long long vss, void* stream) {
  const Strides3 qs{qsb, qst, qss}, ks{ksb, kst, kss}, vs{vsb, vst, vss};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const long long n = (long long)b * s * heads;
  const float scale = 1.f / sqrtf((float)dh);
  if (dtype == V3D_F32) {
    const size_t smem = sizeof(float) * WARPS * (3 * t * (dh + 1) + t * (t + 1));
    cudaError_t err = cudaFuncSetAttribute(
        temporal_core_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    temporal_core_f32_kernel<<<(unsigned)((n + WARPS - 1) / WARPS), WARPS * 32, smem, sm>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), t, s, heads, dh, n, qs,
        ks, vs, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == V3D_BF16) {
    const int smem = (int)mma_smem(t, dh);
    const auto kernel =
        dh == 64 ? temporal_core_mma_kernel<64> : temporal_core_mma_kernel<0>;
    int blocks = 0;
    cudaError_t err = mma_grid(kernel, smem, n, &blocks);
    if (err != cudaSuccess) return (int)err;
    const int vec_in = aligned8(q, qs, dh, heads) && aligned8(k, ks, dh, heads) &&
                       aligned8(v, vs, dh, heads);
    const int vec_out = (reinterpret_cast<uintptr_t>(o) & 15) == 0 && dh % 8 == 0;
    kernel<<<blocks, WARPS * 32, smem, sm>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), t, s, heads, dh, n, qs, ks,
        vs, scale * 1.4426950408889634f, vec_in, vec_out);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one bf16 block at (t, dh), in bytes.
extern "C" long long v3d_temporal_core_smem(int t, int dh) { return mma_smem(t, dh); }

// Blocks of the bf16 launch for ``n_items`` (pixel, head) items at (t, dh)
// on the current device, or -1 on an error.
extern "C" long long v3d_temporal_core_grid(int t, int dh, long long n_items) {
  int blocks = 0;
  const cudaError_t err =
      mma_grid(dh == 64 ? temporal_core_mma_kernel<64> : temporal_core_mma_kernel<0>,
               (int)mma_smem(t, dh), n_items, &blocks);
  return err == cudaSuccess ? blocks : -1;
}
