// K5: flash self-attention forward, out = softmax(q k^T * scale) v.
//
// Replaces the JAX package's guidance/unet2d.py::_flash_self_attention, which
// calls the library Pallas TPU kernel jax.experimental.pallas.ops.tpu.
// flash_attention._flash_attention_kernel (non-causal, no mask).  Inputs and
// output keep that function's [B, L, H, D] layout: the kernels index
// [b, l, h, d] directly (row stride H*D), so no transposes are made around
// them.
//
// One pass over the keys (FlashAttention online softmax; nothing of size
// L x L leaves the SM): each query row keeps a running max m, a running sum
// l and an unnormalised output accumulator, all fp32; a new key tile
// rescales them by exp(m_old - m_new).  The output is divided by l once at
// the end and written in the input type.  When the caller differentiates,
// the kernel also writes lse = m + log(l) per query row in fp32 ([B, H, L],
// as the library saves l and m), from which the backward kernels K6/K7
// (flash_attn_bwd.cu) recompute P exactly.
//
// Bound on this card: operations.  At SD 2.1's level 0, [8, 4096, 5, 64],
// the two products are 4 B H L^2 D = 172 GFLOP against 84 MB of q/k/v/o
// (0.174 ms at 989 TFLOP/s bf16 vs 0.025 ms at 3.35 TB/s).  Three instances:
//
//  * bf16, D <= 64 (SD 2.1 everywhere, SD 1.5's level 0): wgmma fed by TMA.
//    One CTA per (128-query tile, head, batch): two consumer warpgroups of
//    64 query rows and a producer warpgroup, one thread of which loads the
//    Q tile once and
//    K/V tiles of 128 keys through a 3-stage ring (mbarrier full/empty
//    pairs), all by TMA in the 128-byte swizzle; TMA zero-fills head dims
//    past D (D = 40 needs no padding pass).  S = Q K^T is an SS wgmma
//    (m64n128k16, both K-major); P is rounded to bf16 in registers straight
//    from the S accumulator as the A operand of O += P V, an RS wgmma with V
//    as an MN-major B (tnspB).  l sums the rounded P, so the weights that
//    multiply V sum to exactly l.  Scores are scaled by scale * log2(e) in
//    one multiply and exponentiated with exp2f.  setmaxnreg moves
//    registers inside the CTA's allocation (168 a thread at launch): the
//    producer drops to 40, the consumers rise to 232.  The two warpgroups
//    overlap each other (one's softmax with the other's products); a
//    warpgroup's own products do not overlap its softmax (issuing the next
//    tile's S first needs a second S accumulator, and ptxas compiles the
//    consumers at the launch's 168 registers, so it spilled).
//  * bf16, 64 < D <= 160 (no full-width path reaches it): mma.sync m16n8k16
//    from shared memory, 4 warps of 16 query rows (the first design).
//  * fp32 (the VSD path): 3xTF32 on the tensor cores.  Each operand x is
//    split at fragment load into hi = tf32(x) and lo = tf32(x - hi); each
//    product is lo_a hi_b + hi_a lo_b + hi_a hi_b on mma.sync m16n8k8 tf32
//    with fp32 accumulate: about 2^-21 relative per product, the level of
//    fp32 summation order.  4 warps of 32 query rows (two m16 tiles, which
//    share every K and V fragment a warp loads and splits: half the shared
//    loads and split instructions per product of 16-row warps); K/V tiles
//    of 32 keys double-buffered by cp.async, so copies overlap the
//    products.  Each term is issued for 4 accumulators before the next, so
//    the accumulation chains interleave.  Each tile's P V goes to partial
//    sums folded into O by one rounded fp32 FMA (D <= 64): the tensor
//    cores' accumulation does not round to nearest, and over 4096 keys its
//    bias was about ten times the folded error.  P (fp32)
//    becomes the A operand of P V without leaving registers by pairing the
//    score fragment's keys (2t, 2t + 1) with k = (t, t + 4), the same
//    permutation applied to V's rows.  Bound at the rate this design can
//    reach: 3 x 4 B H L^2 D / 495 TFLOP/s (1.04 ms at [8, 4096, 5, 64]).
#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

#include <math.h>

namespace {

constexpr int kWgTile = 128 * 128;  // bytes of a 128-row bf16 TMA tile
constexpr int kWgRows = 128;        // queries per CTA, keys per ring stage
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;     // two consumer warpgroups + producer
// dynamic shared memory: Q, the K and V rings, the barriers, and the slack
// that aligns the base to 1024 bytes
constexpr int kWgSmem =
    (1 + 2 * kWgStages) * kWgTile + 8 * (1 + 2 * kWgStages) + 1024;
constexpr int kTfQ = 128;  // queries per block (fp32): 4 warps x 32
constexpr int kTfK = 32;  // keys per double-buffered tile (fp32)

// The mma.sync instance (bf16, D > 64).  KT_MAX: head dim in units of 16
// that the registers are sized for (10: D <= 160); fragment layouts in
// flash_attn_common.cuh.
template <int KT_MAX>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int L, int H, int D,
                          float scale) {
  constexpr int kStride = KT_MAX * 16 + 8;  // smem row stride (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int KT = (D + 15) / 16;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const int q0 = blockIdx.x * kBlockQ + warp * 16;

  // zero the tiles once: columns >= D stay zero (the D -> 16k padding)
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int i = tid; i < kBlockK * kStride; i += blockDim.x) {
    ks[i] = zero;
    vs[i] = zero;
  }

  // this warp's 16 query rows as A fragments, straight from device memory
  uint32_t qf[KT_MAX][4];
#pragma unroll
  for (int kt = 0; kt < KT_MAX; ++kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + (r & 1) * 8;
      const int col = kt * 16 + 2 * t + (r >> 1) * 8;
      qf[kt][r] = (kt < KT && col < D)
                      ? *reinterpret_cast<const uint32_t*>(
                            q + base + row * row_stride + col)
                      : 0u;
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float acc[2 * KT_MAX][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  }

  const int chunks = D / 8;  // 16-byte vectors per row
  for (int j0 = 0; j0 < L; j0 += kBlockK) {
    __syncthreads();
    for (int i = tid; i < kBlockK * chunks; i += blockDim.x) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 8;
      const long off = base + (j0 + r) * row_stride + c;
      *reinterpret_cast<uint4*>(ks + r * kStride + c) =
          *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(vs + r * kStride + c) =
          *reinterpret_cast<const uint4*>(v + off);
    }
    __syncthreads();

    // S = Q K^T for 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT_MAX; ++kt) {
        if (kt < KT) {
          const __nv_bfloat16* kp =
              ks + (nt * 8 + g) * kStride + kt * 16 + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
          mma_bf16(s[nt], qf[kt], b0, b1);
        }
      }
    }

    // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3); the 4 lanes
    // of a quad hold the same two rows
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // P in bf16 as A fragments of P V (k = keys): key step kk takes score
    // tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16 p0 = __float2bfloat16(expf(s[nt][0] - m[0]));
      const __nv_bfloat16 p1 = __float2bfloat16(expf(s[nt][1] - m[0]));
      const __nv_bfloat16 p2 = __float2bfloat16(expf(s[nt][2] - m[1]));
      const __nv_bfloat16 p3 = __float2bfloat16(expf(s[nt][3] - m[1]));
      l[0] += __bfloat162float(p0) + __bfloat162float(p1);
      l[1] += __bfloat162float(p2) + __bfloat162float(p3);
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V: B[key][d] = V[key][d], 8 head dims per tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
        if (nd * 8 < D) {
          const __nv_bfloat16* vp = vs + key * kStride + nd * 8 + g;
          const uint32_t b0 = pack_bf16(vp[0], vp[kStride]);
          const uint32_t b1 = pack_bf16(vp[8 * kStride], vp[9 * kStride]);
          mma_bf16(acc[nd], pa[kk], b0, b1);
        }
      }
    }
  }

  // the quad's partial row sums, then normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (lse != nullptr && t == 0) {
    const long lrow =
        (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L + q0 + g;
    lse[lrow] = m[0] + logf(l[0]);
    lse[lrow + 8] = m[1] + logf(l[1]);
  }
  const float inv0 = 1.0f / l[0];
  const float inv1 = 1.0f / l[1];
#pragma unroll
  for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (nd * 8 < D) {
      __nv_bfloat16* o0 = o + base + (q0 + g) * row_stride + col;
      __nv_bfloat16* o1 = o + base + (q0 + g + 8) * row_stride + col;
      *reinterpret_cast<uint32_t*>(o0) =
          pack_bf16(__float2bfloat16(acc[nd][0] * inv0),
                    __float2bfloat16(acc[nd][1] * inv0));
      *reinterpret_cast<uint32_t*>(o1) =
          pack_bf16(__float2bfloat16(acc[nd][2] * inv1),
                    __float2bfloat16(acc[nd][3] * inv1));
    }
  }
}

// ---- bf16, D <= 64: wgmma + TMA --------------------------------------------
// Threads 0-255: the consumer warpgroups (queries 64 wg .. of the tile);
// threads 256-383: the producer warpgroup (thread 256 issues the copies).  Shared memory (1024-aligned): Q [128 rows], K ring
// [kWgStages][128 rows], V ring, then the barriers q_full, full[s], empty[s].
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int L, int H, int D,
                           float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks0 = qs + kWgTile;
  const uint32_t vs0 = ks0 + kWgStages * kWgTile;
  const uint32_t q_full = vs0 + kWgStages * kWgTile;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kWgStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kWgRows;
  const int n_tiles = L / kWgRows;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<40>();  // 128 x (168 - 40) registers to the consumers
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kWgTile);
      tma_load_4d(qs, &tq, q_full, 0, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) {
          mbar_wait(empty0 + 8 * s, ((it / kWgStages) - 1) & 1);
        }
        mbar_expect_tx(full0 + 8 * s, 2 * kWgTile);
        tma_load_4d(ks0 + s * kWgTile, &tk, full0 + 8 * s, 0, h,
                    it * kWgRows, b);
        tma_load_4d(vs0 + s * kWgTile, &tv, full0 + 8 * s, 0, h,
                    it * kWgRows, b);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<232>();  // 256 x (232 - 168): what the producer gave
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int KT = (D + 15) / 16;
    const float sl2 = scale * kLog2e;
    const uint32_t qa = qs + wg * (kWgTile / 2);  // this warpgroup's rows

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
    float l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kWgStages;
      mbar_wait(full0 + 8 * s, (it / kWgStages) & 1);
      const uint32_t kb = ks0 + s * kWgTile;
      const uint32_t vb = vs0 + s * kWgTile;

      // S = Q K^T: 64 queries x 128 keys
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_n128_ss(sc, desc_sw128(qa + 32 * kt),
                        desc_sw128(kb + 32 * kt), kt);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3); the 4
      // lanes of a quad hold the same two rows
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i] * sl2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // P in bf16 as the A operand of P V (k = keys): key step kk takes
      // score columns 16kk.. (n8 chunks 2kk and 2kk + 1)
      uint32_t pa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat16 p0 =
            __float2bfloat16(exp2f(fmaf(sc[4 * j + 0], sl2, -m[0])));
        const __nv_bfloat16 p1 =
            __float2bfloat16(exp2f(fmaf(sc[4 * j + 1], sl2, -m[0])));
        const __nv_bfloat16 p2 =
            __float2bfloat16(exp2f(fmaf(sc[4 * j + 2], sl2, -m[1])));
        const __nv_bfloat16 p3 =
            __float2bfloat16(exp2f(fmaf(sc[4 * j + 3], sl2, -m[1])));
        l[0] += __bfloat162float(p0) + __bfloat162float(p1);
        l[1] += __bfloat162float(p2) + __bfloat162float(p3);
        pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P V: V's rows (keys) are k, its head dims N (MN-major)
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_n64_rs(acc, pa[kk], desc_sw128(vb + 2048 * kk));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // the quad's partial row sums, then normalise and store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row = q0 + wg * 64 + warp * 16 + g;
    if (lse != nullptr && t == 0) {
      const long lrow = (static_cast<long>(b) * H + h) * L + row;
      lse[lrow] = (m[0] + log2f(l[0])) * kLn2;
      lse[lrow + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
    const float inv0 = 1.0f / l[0];
    const float inv1 = 1.0f / l[1];
    const long row_stride = static_cast<long>(H) * D;
    __nv_bfloat16* o0 =
        o + (static_cast<long>(b) * L + row) * row_stride + h * D + 2 * t;
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 < D) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_f32_bf16(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_f32_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// ---- fp32: 3xTF32 on mma.sync ----------------------------------------------
// NTD: D/8 that the registers are sized for (8: D <= 64, 20: D <= 160).
// Each warp owns 32 query rows, two m16 tiles (mt) that share every K and V
// fragment it loads and splits.  Shared memory: Q [128][D + 4], K and V
// [2][32][D + 4] (rows padded by 4 floats: the fragment loads below are
// free of bank conflicts).
template <int NTD>
__global__ void __launch_bounds__(128, NTD <= 8 ? 2 : 1)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int L, int H, int D,
                          float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int ds = D + 4;
  float* qs = smem_f;
  float* ks = qs + kTfQ * ds;
  float* vs = ks + 2 * kTfK * ds;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ND = D / 8;
  const float sl2 = scale * kLog2e;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const int i0 = blockIdx.x * kTfQ;
  const int n_tiles = L / kTfK;

  load_rows_async(qs, ds, q, base, row_stride, i0, kTfQ, D);
  load_rows_async(ks, ds, k, base, row_stride, 0, kTfK, D);
  load_rows_async(vs, ds, v, base, row_stride, 0, kTfK, D);
  cp_async_commit();

  const float* qw = qs + warp * 32 * ds;
  // each tile's P V goes to partial sums folded into O (D <= 64; the
  // D <= 160 instance adds into O, its registers would not hold both)
  constexpr bool kFold = NTD <= 8;
  float acc[2][NTD][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.0f;
    }
  }
  // running max (log2 units) and sum of rows g, g + 8 of each m16 tile
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  float l[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nb = (buf ^ 1) * kTfK * ds;
      load_rows_async(ks + nb, ds, k, base, row_stride, (it + 1) * kTfK, kTfK,
                      D);
      load_rows_async(vs + nb, ds, v, base, row_stride, (it + 1) * kTfK, kTfK,
                      D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * kTfK * ds;
    const float* vt = vs + buf * kTfK * ds;

    // S = Q K^T: the warp's 32 queries x 32 keys (2 x 4 tiles of 16 x 8)
    float s[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NTD; ++kk) {
      if (kk < ND) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* kp = kt + (8 * nt + g) * ds + 8 * kk + t;
          split_tf32(kp[0], bh[nt][0], bl[nt][0]);
          split_tf32(kp[4], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* qp = qw + (16 * mt + g) * ds + 8 * kk + t;
          const float a[4] = {qp[0], qp[8 * ds], qp[4], qp[8 * ds + 4]};
          uint32_t ah[4], al[4];
          split_frag(a, ah, al);
          mma_3xtf32(s[mt], 0, ah, al, bh, bl);
        }
      }
    }

    // online softmax per m16 tile: rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float alpha[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e] * sl2);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[mt][r] = exp2f(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
        l[mt][r] *= alpha[mt][r];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = exp2f(fmaf(s[mt][nt][e], sl2, -m[mt][e >> 1]));
          l[mt][e >> 1] += s[mt][nt][e];
        }
      }
    }

    if constexpr (!kFold) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nd][e] *= alpha[mt][e >> 1];
        }
      }
    }

    // this tile's P V into partial sums (few tensor-core additions), folded
    // into O by one rounded fp32 FMA: key step kk covers keys 8kk..8kk+7;
    // this lane's keys 8kk + 2t, + 1 stand at k = t, t + 4
    float part[2][kFold ? NTD : 1][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nd = 0; nd < (kFold ? NTD : 1); ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nd][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float a[4] = {s[mt][kk][0], s[mt][kk][2], s[mt][kk][1],
                            s[mt][kk][3]};
        split_frag(a, ah[mt], al[mt]);
      }
      const float* vp = vt + (8 * kk + 2 * t) * ds + g;
#pragma unroll
      for (int n0 = 0; n0 < NTD; n0 += 4) {
        if (n0 < ND) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nd = n0 + i < ND ? n0 + i : n0;
            split_tf32(vp[8 * nd], bh[i][0], bl[i][0]);
            split_tf32(vp[ds + 8 * nd], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (kFold) {
              mma_3xtf32(part[mt], n0, ah[mt], al[mt], bh, bl);
            } else {
              mma_3xtf32(acc[mt], n0, ah[mt], al[mt], bh, bl);
            }
          }
        }
      }
    }
    if constexpr (kFold) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nd][e] =
                fmaf(acc[mt][nd][e], alpha[mt][e >> 1], part[mt][nd][e]);
          }
        }
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const int row = i0 + warp * 32 + mt * 16 + g;
    if (lse != nullptr && t == 0) {
      const long lrow =
          (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L + row;
      lse[lrow] = (m[mt][0] + log2f(l[mt][0])) * kLn2;
      lse[lrow + 8] = (m[mt][1] + log2f(l[mt][1])) * kLn2;
    }
    const float inv0 = 1.0f / l[mt][0];
    const float inv1 = 1.0f / l[mt][1];
    float* o0 = o + base + row * row_stride + 2 * t;
    float* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
      if (nd < ND) {
        *reinterpret_cast<float2*>(o0 + 8 * nd) =
            make_float2(acc[mt][nd][0] * inv0, acc[mt][nd][1] * inv0);
        *reinterpret_cast<float2*>(o1 + 8 * nd) =
            make_float2(acc[mt][nd][2] * inv1, acc[mt][nd][3] * inv1);
      }
    }
  }
}

}  // namespace

// q, k, v, o: [B, L, H, D] contiguous, 16-byte aligned; D % 8 == 0,
// D <= 160; L % 128 == 0 (L % 64 == 0 for bf16 with D > 64).
// is_bf16: 1 for bfloat16, 0 for float32.  lse: null, or [B, H, L] fp32
// for the log-sum-exp of each query's scaled scores (what the backward
// K6/K7 recomputes P from).
extern "C" int gsgen_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int L, int H, int D, float scale,
                                    int is_bf16, void* stream) {
  if (L % kBlockQ != 0 || D % 8 != 0 || D <= 0 || D > kMaxD || B <= 0 ||
      H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* lf = static_cast<float*>(lse);
  if (is_bf16 && D <= 64) {
    if (L % kWgRows != 0) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tq, tk, tv;
    if (!bf16_rows_map(&tq, q, B, L, H, D, kWgRows) ||
        !bf16_rows_map(&tk, k, B, L, H, D, kWgRows) ||
        !bf16_rows_map(&tv, v, B, L, H, D, kWgRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch(flash_fwd_wgmma_kernel, dim3(L / kWgRows, H, B),
                       kWgThreads, kWgSmem, s, tq, tk, tv,
                       static_cast<__nv_bfloat16*>(o), lf, L, H, D, scale);
  }
  if (is_bf16) {
    flash_fwd_bf16_kernel<10><<<dim3(L / kBlockQ, H, B), 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lf, L, H, D, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (L % kTfQ != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(L / kTfQ, H, B);
  const size_t smem = sizeof(float) * (kTfQ + 4 * kTfK) * (D + 4);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (D <= 64) {
    return launch(flash_fwd_tf32_kernel<8>, grid, 128, smem, s, qf, kf,
                       vf, of, lf, L, H, D, scale);
  }
  return launch(flash_fwd_tf32_kernel<kMaxD / 8>, grid, 128, smem, s,
                     qf, kf, vf, of, lf, L, H, D, scale);
}
