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
// - bf16: K1's shape of kernel (FlashAttention-3's forward).  A producer
//   warpgroup, whose one elected thread issues every TMA load, keeps a ring
//   of K and V tiles full (separate K-full / V-full / K-empty / V-empty
//   mbarriers, so a K slot is refilled as soon as S is taken from it);
//   consumer warpgroups run wgmma with S and O in registers and the online
//   softmax on the S accumulator, with no trip through shared memory and no
//   block-wide barrier in the key loop.  Each (d, s, h, b) tensor map reads
//   one 64-column atom of 128-byte rows with the 128-byte swizzle, so a
//   tile of width d is d / 64 boxes; d = 80's last 16 columns come through
//   a second map of 32-byte rows with the 32-byte swizzle.  Per width
//   (``Wide<D>``):
//   - d = 80 (CLIP): one consumer warpgroup of 64 query rows, 128-key
//     tiles.  S = Q K^T is 4 + 1 k-steps of m64n128k16 (four from the
//     128-byte atom, one from the 32-byte one); O = P V an m64n64k16 on V's
//     128-byte atom and an m64n16k16 on its 32-byte atom (both MN-major).
//     CLIP's 16 heads x 257 tokens make 5 q tiles a head, 80 blocks in one
//     partial wave: 64 rows is wgmma's least height, and a split over the
//     three key tiles would need a combine launch (not tried).
//   - d = 128: two consumer warpgroups of 64 rows each (128 a block), 128-key
//     tiles, S as at d = 80 over two atoms, O = P V one m64n128k16 a k-step
//     over V's two atoms (LBO apart).  64 registers of O a thread.
//   - d = 512 (the VAE): a 64 x 512 f32 O needs 256 registers a thread, so
//     two consumer warpgroups share the same 64 query rows and split O's
//     columns (256 each, one m64n256k16 a k-step: 128 registers).  S (64 x
//     32 keys) is computed by warpgroup 0 alone (32 k-steps of m64n32k16),
//     which runs the softmax and hands P's bf16 fragments and the rows'
//     rescale factors to warpgroup 1 through shared memory (two buffers by
//     tile parity, one named barrier of the two warpgroups a tile); warpgroup
//     1's P V then runs beside warpgroup 0's next S.  Splitting S's depth
//     instead (each warpgroup half the columns of Q and K, the halves added
//     through shared memory, both running the softmax) keeps the two in
//     lockstep and measured 15% slower, and clusters of two blocks sharing
//     each K/V tile by TMA multicast 2.3x slower (PERF.md).  Shared memory:
//     Q 64 KB, a 2-slot ring of 32-key K and V tiles (128 KB), the
//     hand-over buffers 11 KB.
//   The scores are masked to -inf past sk (the maps zero-fill those keys),
//   query rows past sq are zero-filled and not stored.  The wrapper
//   (ops/attention.py tma_ready) copies an operand whose base or strides
//   are not 16-byte multiples first.
// - f32 (the CUDA cores, FMA; a TF32 product misses the 1e-4 tolerance):
//   register-tiled as a SIMT GEMM.  One block of 256 threads per
//   (batch*head, 64-row q tile); Q (pre-scaled, log2 units) stays in shared
//   memory; each 64-key tile streams through a 3-slot cp.async ring (one
//   barrier a chunk) in chunks of 16-17 KB: d / 64 K chunks of 64 keys x 64
//   columns, then V chunks of 4096 / d keys x d (d = 80: one chunk of each;
//   V chunks past sk are skipped).  Thread t owns query rows 4 (t / 16) ..
//   +3 and, of S, keys t % 16 + 16 j (4 x 4), of O, the columns 4 (t % 16)
//   + 64 j .. +3 (4 x d / 16), so one 16-byte shared load feeds 4 FMAs of S
//   and one of P feeds 4 x d / 16 of O; the row max and sum are reduced over
//   the 16 lanes of a row group with shuffles, and only P goes through
//   shared memory (transposed, for the P V loads).  246 registers a thread
//   at d = 512 (O alone takes 128): one block of 8 warps an SM.
//
// Both: f32 softmax and accumulation; q/k/v are read and o is written
// through their (b, h, s) strides (unit stride on d), so the (b, s, h, d)
// projection output needs no copy and o lands in the (b, s, h, d) order.
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;
};

// ---- wgmma + TMA variant (bf16) -------------------------------------------

constexpr int WG_THREADS = 128;
constexpr int PRODUCER_REGS = 40;   // registers a thread after setmaxnreg
constexpr int CONSUMER_REGS = 232;  // (two consumer warpgroups)
static_assert((2 * CONSUMER_REGS + PRODUCER_REGS) * WG_THREADS <= 65536,
              "setmaxnreg asks for more registers than an SM has");

// CONS consumer warpgroups; BM query rows a block (SPLIT: the warpgroups
// share the rows and split O's d columns, and warpgroup 0 computes S and
// hands P over); BN keys a K/V tile; STAGES ring slots.
template <int D>
struct Wide;
template <>
struct Wide<80> {
  static constexpr int CONS = 1, BM = 64, BN = 128, STAGES = 2;
  static constexpr bool SPLIT = false;
};
template <>
struct Wide<128> {
  static constexpr int CONS = 2, BM = 128, BN = 128, STAGES = 2;
  static constexpr bool SPLIT = false;
};
template <>
struct Wide<512> {
  static constexpr int CONS = 2, BM = 64, BN = 32, STAGES = 2;
  static constexpr bool SPLIT = true;
};

// Shared-memory carve-up (bytes from the 1024-aligned base).  A tile of R
// rows is its 64-column atoms of R x 128 bytes, then d = 80's 16-column
// tail of R x 32 bytes.
template <int D>
struct WideLayout {
  using C = Wide<D>;
  static constexpr int ATOMS = D / 64;
  static constexpr int TAIL = D % 64;  // 0, or 16 at d = 80
  static_assert(TAIL == 0 || TAIL == 16, "d must be 64 a + 0 or 16");
  static constexpr int THREADS = (C::CONS + 1) * WG_THREADS;
  static constexpr int NS = C::BN / 2;             // S registers a thread
  static constexpr int NO = (C::SPLIT ? D / C::CONS : D) / 2;  // O registers
  static constexpr uint32_t Q_ATOM = C::BM * 128;
  static constexpr uint32_t KV_ATOM = C::BN * 128;
  static constexpr uint32_t Q_BYTES = C::BM * D * 2;
  static constexpr uint32_t KV_BYTES = C::BN * D * 2;  // one K or V tile
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + Q_BYTES;
  static constexpr uint32_t V = K + C::STAGES * KV_BYTES;
  // SPLIT: the hand-over, two tile parities of P's fragments and the two
  // rescale factors (NS / 2 + 2 words a thread, [word][thread]), then the
  // two final row sums a thread
  static constexpr uint32_t X = V + C::STAGES * KV_BYTES;
  static constexpr uint32_t X_TILE = (NS / 2 + 2) * WG_THREADS * 4;
  static constexpr uint32_t BARS = X + (C::SPLIT ? 2 * X_TILE + 2 * WG_THREADS * 4 : 0);
  static constexpr int NBARS = 1 + 4 * C::STAGES;
  static constexpr size_t SMEM = BARS + 8 * NBARS + 1024;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles must stay aligned");
};

// All boxes of one Q / K / V tile at row ``row`` (``main``: 64-column boxes,
// ``tail``: d = 80's 16-column box) into ``dst``; completion to ``bar``.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, uint32_t atom_bytes,
                                          const CUtensorMap* main, const CUtensorMap* tail,
                                          uint64_t* bar, int row, int hi, int bi) {
  constexpr int ATOMS = WideLayout<D>::ATOMS;
#pragma unroll
  for (int a = 0; a < ATOMS; ++a) tma_load_4d(dst + a * atom_bytes, main, bar, 64 * a, row, hi, bi);
  if constexpr (WideLayout<D>::TAIL != 0)
    tma_load_4d(dst + ATOMS * atom_bytes, tail, bar, 64 * ATOMS, row, hi, bi);
}

// S (64 x BN, f32) of one consumer warpgroup over the whole depth.  q / k:
// shared addresses of the warpgroup's 64 Q rows and of the K tile (atom 0;
// atoms ``q_atom`` / ``k_atom`` bytes apart, then the tail).  d = 512: 32
// k-steps of m64n32k16.
template <int D>
__device__ __forceinline__ void product_s(float (&s)[WideLayout<D>::NS], uint32_t q,
                                          uint32_t q_atom, uint32_t k, uint32_t k_atom) {
  using L = WideLayout<D>;
  fence_regs(s);
  wgmma_fence();
  if constexpr (Wide<D>::SPLIT) {
#pragma unroll
    for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32k16_ss(s, desc_k_major(q + a * q_atom + 32 * kk),
                           desc_k_major(k + a * k_atom + 32 * kk), a + kk);
  } else {
#pragma unroll
    for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_ss(s, desc_k_major(q + a * q_atom + 32 * kk),
                            desc_k_major(k + a * k_atom + 32 * kk), a + kk);
    if constexpr (L::TAIL != 0)
      wgmma_m64n128k16_ss(s, sw32_desc_k_major(q + L::ATOMS * q_atom),
                          sw32_desc_k_major(k + L::ATOMS * k_atom), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// P's A fragments for P V from the S accumulator: key chunk kc (keys
// 16 kc .. +15) is S's column chunks 2 kc and 2 kc + 1.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS], uint32_t (&p)[NS / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < NS / 8; ++kc) {
    p[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
    p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// O (64 x this warpgroup's columns) += P V.  v: the V tile (atom 0, atoms
// ``v_atom`` bytes apart, then the tail); each 16-key k-step is 16 rows
// further down every atom (2048 bytes of an atom, 512 of the tail).
template <int D>
__device__ __forceinline__ void product_pv(float (&o)[WideLayout<D>::NO],
                                           const uint32_t (&p)[WideLayout<D>::NS / 8][4],
                                           uint32_t v, uint32_t v_atom, int wg) {
  using L = WideLayout<D>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < Wide<D>::BN / 16; ++kc) {
    if constexpr (D == 80) {
      wgmma_m64n64k16_rs(*reinterpret_cast<float(*)[32]>(o), p[kc],
                         sw128_desc(v + 2048 * kc, v_atom));
      wgmma_m64n16k16_rs(*reinterpret_cast<float(*)[8]>(o + 32), p[kc],
                         sw32_desc_mn_major(v + L::ATOMS * v_atom + 512 * kc), 1);
    } else if constexpr (D == 128) {
      wgmma_m64n128k16_rs(o, p[kc], sw128_desc(v + 2048 * kc, v_atom), 1);
    } else {
      wgmma_m64n256k16_rs(o, p[kc], sw128_desc(v + wg * 4 * v_atom + 2048 * kc, v_atom), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// The online softmax of one key tile in base 2 on the raw scores ``sc`` (as
// K1): keys k0 + column past sk masked to -inf, the running max ``m_r`` and
// this lane's part of the sum ``l_r`` of rows g and g + 8 updated, ``sc``
// replaced by P, and each row's rescale factor of O returned in ``alpha``.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[NS], float (&m_r)[2],
                                               float (&l_r)[2], float (&alpha)[2], int k0,
                                               int sk, int u, float scale_log2) {
  if (k0 + 2 * NS > sk) {  // a ragged last tile (2 NS = BN keys)
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (k0 + 8 * (i >> 2) + 2 * u + (i & 1) >= sk) sc[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, neg_m[2];
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);  // finite: key k0 < sk
    alpha[r] = exp2f(m_r[r] - m_new);
    m_r[r] = m_new;
    neg_m[r] = -m_new;
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], scale_log2, neg_m[r]));
    l_r[r] += sc[i];  // this lane's columns; the quad is summed at the end
  }
}

// SPLIT (d = 512): warpgroup 0 computes all of S and the softmax and hands
// P and the rescale factors to warpgroup 1 through shared memory, which
// then runs its P V beside warpgroup 0's next S.
template <int D>
__global__ void __launch_bounds__(WideLayout<D>::THREADS, 1)
flash_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tq_tail,
                        const __grid_constant__ CUtensorMap tk_tail,
                        const __grid_constant__ CUtensorMap tv_tail, bf16* __restrict__ o,
                        int heads, int sq, int sk, Strides os, float scale_log2) {
  using C = Wide<D>;
  using L = WideLayout<D>;
  constexpr int CONS = C::CONS, BN = C::BN, STAGES = C::STAGES, NS = L::NS, NO = L::NO;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int wg = threadIdx.x / WG_THREADS;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * C::BM;
  const int n_tiles = (sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONS * WG_THREADS);
      mbar_init(v_empty + s, CONS * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONS) {
    // producer: one thread keeps the ring full
    if constexpr (CONS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONS * WG_THREADS) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      load_tile<D>(base + L::Q, L::Q_ATOM, &tq, &tq_tail, q_full, q0, hi, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        if (j >= STAGES) mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, L::KV_BYTES);
        load_tile<D>(base + L::K + s * L::KV_BYTES, L::KV_ATOM, &tk, &tk_tail, k_full + s,
                     j * BN, hi, bi);
        if (j >= STAGES) mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, L::KV_BYTES);
        load_tile<D>(base + L::V + s * L::KV_BYTES, L::KV_ATOM, &tv, &tv_tail, v_full + s,
                     j * BN, hi, bi);
      }
    }
  } else {
    if constexpr (CONS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, u = lane % 4;
    const int rq = C::SPLIT ? 0 : 64 * wg;  // this warpgroup's rows in the Q tile
    // atoms of Q start at rq rows (128-byte rows; the tail has 32-byte rows,
    // which only d = 80 has, with one warpgroup)
    const uint32_t q_addr = smem_u32(base + L::Q) + rq * 128;
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float sc[NS];
    uint32_t pa[NS / 8][4];
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t parity = (j / STAGES) & 1;
      const uint32_t k_addr = smem_u32(base + L::K + s * L::KV_BYTES);
      float alpha[2];
      if constexpr (C::SPLIT) {
        uint32_t* xh = reinterpret_cast<uint32_t*>(base + L::X + (j & 1) * L::X_TILE);
        if (wg == 0) {
          mbar_wait(k_full + s, parity);
          product_s<D>(sc, q_addr, L::Q_ATOM, k_addr, L::KV_ATOM);
          mbar_arrive(k_empty + s);
          online_softmax(sc, m_r, l_r, alpha, j * BN, sk, u, scale_log2);
          pack_p(sc, pa);
#pragma unroll
          for (int i = 0; i < NS / 2; ++i) xh[i * WG_THREADS + tid] = pa[i / 4][i % 4];
          xh[(NS / 2) * WG_THREADS + tid] = __float_as_uint(alpha[0]);
          xh[(NS / 2 + 1) * WG_THREADS + tid] = __float_as_uint(alpha[1]);
          named_barrier(1, 2 * WG_THREADS);
        } else {
          named_barrier(1, 2 * WG_THREADS);
          mbar_arrive(k_empty + s);
#pragma unroll
          for (int i = 0; i < NS / 2; ++i) pa[i / 4][i % 4] = xh[i * WG_THREADS + tid];
          alpha[0] = __uint_as_float(xh[(NS / 2) * WG_THREADS + tid]);
          alpha[1] = __uint_as_float(xh[(NS / 2 + 1) * WG_THREADS + tid]);
        }
      } else {
        mbar_wait(k_full + s, parity);
        product_s<D>(sc, q_addr, L::Q_ATOM, k_addr, L::KV_ATOM);
        mbar_arrive(k_empty + s);
        online_softmax(sc, m_r, l_r, alpha, j * BN, sk, u, scale_log2);
        pack_p(sc, pa);
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      mbar_wait(v_full + s, parity);
      product_pv<D>(acc, pa, smem_u32(base + L::V + s * L::KV_BYTES), L::KV_ATOM, wg);
      mbar_arrive(v_empty + s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    if constexpr (C::SPLIT) {  // warpgroup 1 takes the row sums from warpgroup 0
      float* xl = reinterpret_cast<float*>(base + L::X + 2 * L::X_TILE);
      if (wg == 0) {
        xl[tid] = l_r[0];
        xl[WG_THREADS + tid] = l_r[1];
      }
      named_barrier(1, 2 * WG_THREADS);
      l_r[0] = xl[tid];
      l_r[1] = xl[WG_THREADS + tid];
    }
    const int c0 = C::SPLIT ? wg * (D / CONS) : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rq + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      const float inv = 1.f / l_r[r];
      bf16* orow = o + bi * os.b + hi * os.h + row * os.s + c0;
#pragma unroll
      for (int n = 0; n < NO / 4; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * u) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
  }
}

// -- host: tensor maps --

// A 4-D map (d, s, h, b) of a bf16 (b, h, s, d) view with element strides
// ``st``; boxes of ``box_rows`` x ``box_cols`` (64 with the 128-byte
// swizzle, or 16 with the 32-byte one).
int make_map(CUtensorMap* map, const void* ptr, int d, int s, int heads, int b, Strides st,
             int box_rows, int box_cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  return encode_bf16_map(map, ptr, 4, dims, strides, box,
                         box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
}

// The main and tail maps of one operand (the tail map only where d has a
// 16-column tail; else a copy of the main one, never read).
template <int D>
int make_maps(CUtensorMap* main, CUtensorMap* tail, const void* ptr, int s, int heads, int b,
              Strides st, int box_rows) {
  int err = make_map(main, ptr, D, s, heads, b, st, box_rows, 64);
  if (err == 0 && WideLayout<D>::TAIL != 0)
    err = make_map(tail, ptr, D, s, heads, b, st, box_rows, 16);
  else
    *tail = *main;
  return err;
}

// The shared-memory attribute of ``Kernel`` once per device, not at every
// launch.
template <auto Kernel>
cudaError_t set_smem_once(size_t smem) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !done[dev])) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (dev < 64) done[dev] = e == cudaSuccess;
  }
  return e;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b, int heads, int sq,
              int sk, Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  using C = Wide<D>;
  using L = WideLayout<D>;
  CUtensorMap m[6];
  int err = make_maps<D>(&m[0], &m[3], q, sq, heads, b, qs, C::BM);
  if (err == 0) err = make_maps<D>(&m[1], &m[4], k, sk, heads, b, ks, C::BN);
  if (err == 0) err = make_maps<D>(&m[2], &m[5], v, sk, heads, b, vs, C::BN);
  if (err != 0) return err;
  const cudaError_t e = set_smem_once<flash_wide_wgmma_kernel<D>>(L::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + C::BM - 1) / C::BM, b * heads);
  flash_wide_wgmma_kernel<D><<<grid, L::THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<bf16*>(o), heads, sq, sk, os,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// -- the products alone, for the card tests and chip_smoke.py --

// which = 0: S (64 x BN, f32, row-major) = Q (64 x D) K^T (K BN x D), both
// bf16 contiguous, loaded and multiplied as the kernel does (at d = 512 by
// warpgroup 0 alone).  which = 1: O (64 x D, f32) = P (64 x BN, bf16
// contiguous, read into A fragments) V (BN x D, loaded by TMA), at d = 512
// half the columns a warpgroup.
template <int D>
__global__ void __launch_bounds__(WG_THREADS * (Wide<D>::SPLIT ? 2 : 1))
wide_probe_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap ta_tail,
                  const __grid_constant__ CUtensorMap tb_tail, const bf16* __restrict__ p,
                  float* __restrict__ out, int which) {
  using L = WideLayout<D>;
  constexpr int BN = Wide<D>::BN, NS = L::NS, NO = L::NO;
  constexpr uint32_t A_BYTES = 64 * D * 2, B_BYTES = L::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* a_tile = base;
  unsigned char* b_tile = base + A_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_tile + B_BYTES);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, u = lane % 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, which == 0 ? A_BYTES + B_BYTES : B_BYTES);
    if (which == 0) load_tile<D>(a_tile, 64 * 128, &ta, &ta_tail, bar, 0, 0, 0);
    load_tile<D>(b_tile, L::KV_ATOM, &tb, &tb_tail, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[NS];
  if (which == 0) {
    if (wg == 0) {
      product_s<D>(s, smem_u32(a_tile), 64 * 128, smem_u32(b_tile), L::KV_ATOM);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        out[(warp * 16 + g + 8 * ((i >> 1) & 1)) * BN + 8 * (i >> 2) + 2 * u + (i & 1)] = s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      s[i] = __bfloat162float(
          p[(warp * 16 + g + 8 * ((i >> 1) & 1)) * BN + 8 * (i >> 2) + 2 * u + (i & 1)]);
    uint32_t pa[NS / 8][4];
    pack_p(s, pa);
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    product_pv<D>(acc, pa, smem_u32(b_tile), L::KV_ATOM, wg);
    const int c0 = Wide<D>::SPLIT ? wg * (D / 2) : 0;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      out[(warp * 16 + g + 8 * ((i >> 1) & 1)) * D + c0 + 8 * (i >> 2) + 2 * u + (i & 1)] =
          acc[i];
  }
}

template <int D>
int launch_probe(int which, const void* a, const void* b, void* out, cudaStream_t stream) {
  using L = WideLayout<D>;
  constexpr int BN = Wide<D>::BN;
  CUtensorMap m[4];
  int err = 0;
  if (which == 0) err = make_maps<D>(&m[0], &m[2], a, 64, 1, 1, Strides{64 * D, 64 * D, D}, 64);
  if (err == 0) err = make_maps<D>(&m[1], &m[3], b, BN, 1, 1, Strides{BN * D, BN * D, D}, BN);
  if (err != 0) return err;
  if (which != 0) {
    m[0] = m[1];
    m[2] = m[3];
  }
  const int smem = 64 * D * 2 + L::KV_BYTES + 64 + 1024;
  cudaError_t e = cudaFuncSetAttribute(wide_probe_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wide_probe_kernel<D><<<1, WG_THREADS * (Wide<D>::SPLIT ? 2 : 1), smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const bf16*>(a), static_cast<float*>(out), which);
  return (int)cudaGetLastError();
}

// ---- register-tiled CUDA-core variant (f32) --------------------------------

constexpr int F_THREADS = 256;
constexpr int FQ = 64;  // query rows of a block: 16 row groups of 4
constexpr int FK = 64;  // keys of a tile: 4 keys a thread, 16 apart

template <int D>
struct F32 {
  static constexpr bool VEC = D % 64 == 0;       // float4 output columns
  static constexpr int DC = VEC ? 64 : D;        // columns of a K chunk
  static constexpr int VK = VEC ? 4096 / D : FK;  // keys of a V chunk
  static constexpr int KCH = D / DC, VCH = FK / VK;  // chunks of a tile
  static constexpr int LDQ = D + 4, LDK = DC + 4, LDP = FQ + 4;  // pitches (floats)
  static constexpr int SLOT = FK * LDK > VK * D ? FK * LDK : VK * D;  // floats
  static constexpr int NC = D / 16;              // output columns of a thread
  static constexpr int SLOTS = 3;  // ring slots: chunk c + 2 loads while c is used
  static constexpr size_t SMEM = sizeof(float) * (FQ * LDQ + SLOTS * SLOT + FK * LDP);
  static_assert(D % 16 == 0 && FK % VK == 0, "bad f32 tiling");
};

// Stage chunk ``c`` of the key sequence into ``slot``: K chunk (keys of
// tile c / (KCH + VCH), columns DC (c % ...) .. +DC - 1) as [FK][LDK], or V
// chunk ([VK][D]); rows past sk are zero.  ``vec``: 16-byte cp.async copies
// (committed by the caller), else plain loads.
template <int D>
__device__ __forceinline__ void f32_stage(float* slot, int c, const float* kb, const float* vb,
                                          long long kss, long long vss, int sk, bool vec) {
  using F = F32<D>;
  const int t = c / (F::KCH + F::VCH), idx = c % (F::KCH + F::VCH);
  const bool is_k = idx < F::KCH;
  const int rows = is_k ? FK : F::VK, cols = is_k ? F::DC : D, ld = is_k ? F::LDK : D;
  const int key0 = t * FK + (is_k ? 0 : (idx - F::KCH) * F::VK);
  const float* src = is_k ? kb + (long long)key0 * kss + idx * F::DC : vb + (long long)key0 * vss;
  const long long st = is_k ? kss : vss;
  if (vec) {
    const int ch = cols / 4;
    for (int e = threadIdx.x; e < rows * ch; e += F_THREADS) {
      const int r = e / ch, cc = (e % ch) * 4;
      if (key0 + r < sk)
        cp_async16(slot + r * ld + cc, src + r * st + cc);
      else
        *reinterpret_cast<float4*>(slot + r * ld + cc) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += F_THREADS) {
      const int r = e / cols, cc = e % cols;
      slot[r * ld + cc] = key0 + r < sk ? src[r * st + cc] : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int heads, int sq,
                      int sk, Strides qs, Strides ks, Strides vs, Strides os, float scale_log2) {
  using F = F32<D>;
  constexpr int NC = F::NC;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                      // [FQ][LDQ], pre-scaled (log2 units)
  float* ring = Qs + FQ * F::LDQ;       // SLOTS x SLOT
  float* Pt = ring + F::SLOTS * F::SLOT;  // [FK][LDP], P transposed

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = blockIdx.x * FQ;
  const float* qb = q + bi * qs.b + hi * qs.h;
  const float* kb = k + bi * ks.b + hi * ks.h;
  const float* vb = v + bi * vs.b + hi * vs.h;
  const bool vec = ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
                   ks.b % 4 == 0 && ks.h % 4 == 0 && ks.s % 4 == 0 && vs.b % 4 == 0 &&
                   vs.h % 4 == 0 && vs.s % 4 == 0;

  // chunks in all: the last tile's V chunks stop at sk (keys past sk have
  // P = 0), so sk = 1 reads one V chunk, not FK / VK
  const int n_tiles = (sk + FK - 1) / FK;
  const int total = (n_tiles - 1) * (F::KCH + F::VCH) + F::KCH +
                    (sk - (n_tiles - 1) * FK + F::VK - 1) / F::VK;
  f32_stage<D>(ring, 0, kb, vb, ks.s, vs.s, sk, vec);
  cp_async_commit();
  if (total > 1) f32_stage<D>(ring + F::SLOT, 1, kb, vb, ks.s, vs.s, sk, vec);
  cp_async_commit();
  for (int e = tid; e < FQ * D; e += F_THREADS) {
    const int r = e / D, c = e % D;
    const int row = q0 + r;
    Qs[r * F::LDQ + c] = row < sq ? qb[(long long)row * qs.s + c] * scale_log2 : 0.f;
  }

  float m_r[4], l_r[4], s[4][4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int c = 0; c < total; ++c) {
    // one group committed an iteration (empty past the end): chunk c is the
    // older of the two in flight
    cp_async_wait<1>();
    __syncthreads();  // chunk c, Q and this tile's P are in place; chunk c - 1's slot is read
    if (c + 2 < total)
      f32_stage<D>(ring + ((c + 2) % F::SLOTS) * F::SLOT, c + 2, kb, vb, ks.s, vs.s, sk, vec);
    cp_async_commit();
    const float* slot = ring + (c % F::SLOTS) * F::SLOT;
    const int idx = c % (F::KCH + F::VCH);
    if (idx < F::KCH) {
      // S += Q[:, chunk] K[keys, chunk]^T: rows 4 tr + i, keys tc + 16 j
      if (idx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      const float* qr = Qs + 4 * tr * F::LDQ + idx * F::DC;
      const float* kr = slot + tc * F::LDK;
#pragma unroll 4
      for (int d4 = 0; d4 < F::DC; d4 += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * F::LDQ + d4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(kr + 16 * j * F::LDK + d4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }
      if (idx == F::KCH - 1) {
        // online softmax of rows 4 tr + i over this tile's keys (base 2)
        const int k0 = (c / (F::KCH + F::VCH)) * FK;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k0 + tc + 16 * j >= sk) s[i][j] = -INFINITY;
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
          const float m_new = fmaxf(m_r[i], mx);  // finite: key k0 < sk is in every tile
          const float alpha = exp2f(m_r[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = exp2f(s[i][j] - m_new);
            Pt[(tc + 16 * j) * F::LDP + 4 * tr + i] = p;
            sum += p;
          }
          l_r[i] = l_r[i] * alpha + sum;  // this lane's keys; summed at the end
          m_r[i] = m_new;
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
        }
      }
    } else {
      // O += P[:, chunk keys] V[chunk keys, :]
      const int kbase = (idx - F::KCH) * F::VK;
#pragma unroll 2
      for (int kk = 0; kk < F::VK; ++kk) {
        const float4 p = *reinterpret_cast<const float4*>(Pt + (kbase + kk) * F::LDP + 4 * tr);
        const float pr[4] = {p.x, p.y, p.z, p.w};
        const float* vr = slot + kk * D;
        if constexpr (F::VEC) {
#pragma unroll
          for (int jv = 0; jv < D / 64; ++jv) {
            const float4 w = *reinterpret_cast<const float4*>(vr + 64 * jv + 4 * tc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][4 * jv] = fmaf(pr[i], w.x, acc[i][4 * jv]);
              acc[i][4 * jv + 1] = fmaf(pr[i], w.y, acc[i][4 * jv + 1]);
              acc[i][4 * jv + 2] = fmaf(pr[i], w.z, acc[i][4 * jv + 2]);
              acc[i][4 * jv + 3] = fmaf(pr[i], w.w, acc[i][4 * jv + 3]);
            }
          }
        } else {
#pragma unroll
          for (int jv = 0; jv < NC; ++jv) {
            const float w = vr[16 * jv + tc];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][jv] = fmaf(pr[i], w, acc[i][jv]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], off, 16);
    const int row = q0 + 4 * tr + i;
    if (row >= sq) continue;
    const float inv = 1.f / l_r[i];
    float* orow = o + bi * os.b + hi * os.h + (long long)row * os.s;
    if constexpr (F::VEC) {
#pragma unroll
      for (int jv = 0; jv < D / 64; ++jv)
        *reinterpret_cast<float4*>(orow + 64 * jv + 4 * tc) =
            make_float4(acc[i][4 * jv] * inv, acc[i][4 * jv + 1] * inv,
                        acc[i][4 * jv + 2] * inv, acc[i][4 * jv + 3] * inv);
    } else {
#pragma unroll
      for (int jv = 0; jv < NC; ++jv) orow[16 * jv + tc] = acc[i][jv] * inv;
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b, int heads, int sq,
               int sk, Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  if (F32<D>::VEC && (((uintptr_t)o & 15) != 0 || os.b % 4 || os.h % 4 || os.s % 4))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = set_smem_once<flash_wide_f32_kernel<D>>(F32<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + FQ - 1) / FQ, b * heads);
  flash_wide_f32_kernel<D><<<grid, F_THREADS, F32<D>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, sq, sk, qs, ks, vs, os,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int b, int heads,
           int sq, int sk, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  if (dtype == V3D_F32) return launch_f32<D>(q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, stream);
  if (dtype == V3D_BF16) return launch_tc<D>(q, k, v, o, b, heads, sq, sk, qs, ks, vs, os, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/o: (b, h, s, d) through element strides (b, h, s), unit stride on d,
// d one of 80, 128, 512 (anything else: cudaErrorInvalidValue).  bf16 q/k/v
// need 16-byte aligned bases and (b, h, s) strides in multiples of 8
// elements (a dim of size 1 may carry any such stride); o's strides must be
// even, and in f32 at d = 128 / 512 multiples of 4 with a 16-byte base (the
// wrapper allocates it).  Returns the cudaError_t of the launch, or 9001
// where a tensor map could not be made.
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
      return (long long)(bf ? WideLayout<80>::SMEM : F32<80>::SMEM);
    case 128:
      return (long long)(bf ? WideLayout<128>::SMEM : F32<128>::SMEM);
    case 512:
      return (long long)(bf ? WideLayout<512>::SMEM : F32<512>::SMEM);
    default:
      return 0;
  }
}

// One of the bf16 kernel's two products alone at width d (see
// wide_probe_kernel): which 0: out (64, BN) = a (64, d) @ b (BN, d)^T;
// which 1: out (64, d) = a (64, BN) @ b (BN, d); BN = 128 at d = 80 / 128,
// 32 at d = 512.  a, b contiguous bf16, out f32.
extern "C" int v3d_flash_wide_probe(int d, int which, const void* a, const void* b, void* out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 80:
      return launch_probe<80>(which, a, b, out, st);
    case 128:
      return launch_probe<128>(which, a, b, out, st);
    case 512:
      return launch_probe<512>(which, a, b, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
