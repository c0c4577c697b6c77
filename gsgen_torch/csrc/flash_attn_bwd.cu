// K6 and K7: flash self-attention backward, the gradients of
// out = softmax(q k^T * scale) v with respect to q, k and v.
//
// Replace the two Pallas kernels of the library flash attention's VJP
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd
// runs _flash_attention_dkv_kernel, then _flash_attention_dq_kernel), which
// the JAX package reaches through guidance/unet2d.py::_flash_self_attention
// when VSD differentiates the UNet.  Layout as K5: q, k, v, dout and the
// gradients are [B, L, H, D], indexed directly (row stride H * D).
//
// Both kernels recompute P = exp(q k^T * scale - lse) from the lse K5 saved
// (exact in fp32, nothing of size L x L in device memory) and take
// Di = sum_d(out * dout) [B, H, L] from the caller (a torch reduction, as
// the library computes it outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Di),
//   dK = dS^T Q * scale (K6),  dQ = dS K * scale (K7).
// K6 takes one block per key tile and walks every query tile; K7 one block
// per query tile and walks every key tile.  Each block owns its output
// rows, so there are no atomics and the sums run in a fixed order: the
// results are deterministic, as the library's are.
//
// Bound on this card: operations.  At the VSD path's [4, 4096, 5, 64] the
// backward needs 10 B H L^2 D = 215 GFLOP (the library's count: S, dP, dV,
// dK, dQ; the kernels do 14 B H L^2 D, recomputing S and dP in both) against
// 42 MB of inputs and outputs.  K6 alone does 8 B H L^2 D = 172 GFLOP.
//
//  * K6 bf16, D <= 64: wgmma fed by TMA.  One CTA per (128-key tile, head,
//    batch): two consumer warpgroups of 64 keys and a producer warpgroup
//    (one thread issues the copies).  The
//    CTA's K and V tiles stay resident in shared memory; Q and dO tiles of
//    64 queries, with their lse and Di rows, stream through a 3-stage TMA
//    ring (mbarrier full/empty pairs, 128-byte swizzle, zero fill past D).
//    Per query tile: S^T = K Q^T and dP^T = V dO^T as SS wgmma (K-major);
//    P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - Di),
//    rounded to bf16 in registers as the A operands of dV += P^T dO and
//    dK += dS^T Q, RS wgmma with dO and Q as MN-major B (tnspB).  dK * scale
//    and dV go to bf16 at the end.  setmaxnreg moves registers inside the
//    CTA's allocation (168 a thread): producer 40, consumers 232.
//  * K6 fp32 (the VSD path: the JAX VSD UNet runs in fp32): 3xTF32 on
//    mma.sync m16n8k8 (flash_attn_sm90.cuh), about 2^-21 relative per
//    product.  4 warps of 16 keys; Q, dO, lse and Di tiles of 32 queries
//    double-buffered by cp.async; terms interleaved over 4 accumulators;
//    each tile's dV and dK go to partial sums folded in by rounded fp32
//    adds (D <= 64; the D <= 160 instance adds into the totals, its
//    registers would not hold both).  P^T and dS^T stay in registers: the
//    score fragment's queries (2t, 2t + 1) stand at k = (t, t + 4) of the
//    next products, the same permutation applied to dO's and Q's rows.
//    Bound at the rate this design can reach: 3 x 8 B H L^2 D / 495
//    TFLOP/s (1.04 ms at [4, 4096, 5, 64]).
//  * K7 bf16, D <= 64: K6's design with the roles swapped.  One CTA per
//    (128-query tile, head, batch): two consumer warpgroups of 64 queries
//    and a producer warpgroup.  Q and dO stay resident (lse and Di rows in
//    registers); K and V tiles of 64 keys stream through a 3-stage TMA
//    ring.  Per key tile: S = Q K^T and dP = dO V^T as SS wgmma; dS =
//    exp2(S scale log2e - lse log2e) (dP - Di) rounded to bf16 in registers
//    as the A operand of dQ += dS K, an RS wgmma reading K's tile MN-major
//    (tnspB) from the same swizzled bytes the score product read K-major.
//  * K7 fp32: 3xTF32 on mma.sync m16n8k8 as K6 fp32.  4 warps of 32
//    queries (two m16 tiles sharing every K / V fragment; 16 queries for
//    D <= 160); the CTA's Q and dO stay resident, K and V stream in tiles
//    of 32 keys double-buffered by cp.async (two CTAs an SM); dS stays in
//    registers as the A operand of dQ += dS K (keys (2t, 2t + 1) at
//    k = (t, t + 4), K's rows permuted the same way); each tile's dS K goes
//    to partial sums folded into dQ by rounded fp32 adds.  Each warp splits
//    the fragments it loads, as K5 and K6 do.  Splitting each landed K / V
//    tile once into TF32 hi and lo planes was 2% faster at 16-key tiles,
//    but its planes leave no room for 32-key tiles at two CTAs an SM, which
//    cut the Q / dO splits per key by half: PERF.md.
//    Bound at the rate this design can reach: 3 x 6 B H L^2 D / 495
//    TFLOP/s (0.78 ms at [4, 4096, 5, 64]).
//  * K6 bf16, D > 64, and K7 bf16, D > 64: 4 warps of mma.sync m16n8k16
//    (bf16 in, fp32 accumulate), each warp 16 keys (K6) or 16 queries (K7);
//    the score accumulators become the A operands of the second products in
//    registers, as in K5.  P and dS are rounded to bf16 for those products.
#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

#include <math.h>

namespace {

constexpr int kDkvKeys = 128;      // keys per CTA (K6 wgmma)
constexpr int kDkvQ = 64;          // queries per ring stage (K6 wgmma)
constexpr int kDkvStages = 3;
constexpr int kDkvTile = 64 * 128;  // bytes of a 64-row bf16 TMA tile
constexpr int kWgThreads = 384;     // two consumer warpgroups + producer
// dynamic shared memory: K and V, the Q / dO / lse / Di ring, the barriers,
// and the slack that aligns the base to 1024 bytes
constexpr int kDkvSmem = 4 * kDkvTile + kDkvStages * (2 * kDkvTile + 512) +
                         8 * (1 + 2 * kDkvStages) + 1024;
constexpr int kTfQ = 32;  // queries per streamed tile (K6 fp32)
constexpr int kDqQ = 128;          // queries per CTA (K7 wgmma)
constexpr int kDqKeys = 64;        // keys per ring stage (K7 wgmma)
constexpr int kDqStages = 3;
// dynamic shared memory (K7 wgmma): Q and dO, the K / V ring, the barriers,
// the alignment slack
constexpr int kDqSmem = 4 * kDkvTile + kDqStages * 2 * kDkvTile +
                        8 * (1 + 2 * kDqStages) + 1024;
constexpr int kDqTfKeys = 32;  // keys per streamed tile (K7 fp32)

// ---- bf16 (mma.sync) -------------------------------------------------------
// Registers are sized for D <= 160: kKtMax head-dim steps of 16.  Tiles in
// shared memory are zero-padded from D to a multiple of 16; row stride
// kStride elements (conflict-free fragment loads).
constexpr int kKtMax = 10;
constexpr int kStride = kKtMax * 16 + 8;

// S = X Y^T and dP = U W^T for the warp's 16 rows r0.. (X, U) against the
// tile's 64 rows (Y, W): 8 n-tiles of 8 columns each.
__device__ __forceinline__ void score_tiles_bf16(
    const __nv_bfloat16* xs, const __nv_bfloat16* us,
    const __nv_bfloat16* ys, const __nv_bfloat16* ws, int r0, int KT, int g,
    int t, float (&s)[8][4], float (&dp)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = 0.0f;
      dp[nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int kt = 0; kt < kKtMax; ++kt) {
    if (kt < KT) {
      uint32_t xa[4], ua[4];
      load_a_frag(xa, xs, kStride, r0, kt, g, t);
      load_a_frag(ua, us, kStride, r0, kt, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int off = (nt * 8 + g) * kStride + kt * 16 + 2 * t;
        mma_bf16(s[nt], xa, *reinterpret_cast<const uint32_t*>(ys + off),
                 *reinterpret_cast<const uint32_t*>(ys + off + 8));
        mma_bf16(dp[nt], ua, *reinterpret_cast<const uint32_t*>(ws + off),
                 *reinterpret_cast<const uint32_t*>(ws + off + 8));
      }
    }
  }
}

// B fragment of a product whose k runs over tile rows k0.. and n over head
// dims n0..: b0 = (T[k0 + 2t][n0 + g], T[k0 + 2t + 1][n0 + g]), b1 the same
// 8 rows on.
__device__ __forceinline__ void gather_b_frag(const __nv_bfloat16* tile,
                                              int stride, int k0, int n0,
                                              int g, int t, uint32_t& b0,
                                              uint32_t& b1) {
  const __nv_bfloat16* p = tile + (k0 + 2 * t) * stride + n0 + g;
  b0 = pack_bf16(p[0], p[stride]);
  b1 = pack_bf16(p[8 * stride], p[9 * stride]);
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int L, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // this block's
  __nv_bfloat16* vs = ks + kBlockK * kStride;
  __nv_bfloat16* qs = vs + kBlockK * kStride;              // current tile
  __nv_bfloat16* dos = qs + kBlockQ * kStride;
  auto* lse_s = reinterpret_cast<float*>(dos + kBlockQ * kStride);
  float* di_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int KT = (D + 15) / 16;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int j0 = blockIdx.x * kBlockK;
  const int kr = warp * 16;  // the warp's first key row in the tile

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int i = tid; i < 4 * kBlockK * kStride; i += blockDim.x) ks[i] = zero;
  __syncthreads();
  load_rows(ks, kStride, k, base, row_stride, j0, D);
  load_rows(vs, kStride, v, base, row_stride, j0, D);

  float acc_v[2 * kKtMax][4], acc_k[2 * kKtMax][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kKtMax; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_v[nd][e] = 0.0f;
      acc_k[nd][e] = 0.0f;
    }
  }

  for (int i0 = 0; i0 < L; i0 += kBlockQ) {
    __syncthreads();
    load_rows(qs, kStride, q, base, row_stride, i0, D);
    load_rows(dos, kStride, dout, base, row_stride, i0, D);
    if (tid < kBlockQ) {
      lse_s[tid] = lse[lbase + i0 + tid];
      di_s[tid] = delta[lbase + i0 + tid];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows = the warp's 16 keys, columns =
    // the tile's 64 queries
    float st[8][4], dpt[8][4];
    score_tiles_bf16(ks, vs, qs, dos, kr, KT, g, t, st, dpt);

    // P^T and dS^T as A fragments (k = queries) of the two sums
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int qc = nt * 8 + 2 * t;
      const float l0 = lse_s[qc], l1 = lse_s[qc + 1];
      const float d0 = di_s[qc], d1 = di_s[qc + 1];
      const float p0 = expf(st[nt][0] * scale - l0);
      const float p1 = expf(st[nt][1] * scale - l1);
      const float p2 = expf(st[nt][2] * scale - l0);
      const float p3 = expf(st[nt][3] * scale - l1);
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f32_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f32_bf16(p2, p3);
      da[nt >> 1][(nt & 1) * 2 + 0] =
          pack_f32_bf16(p0 * (dpt[nt][0] - d0), p1 * (dpt[nt][1] - d1));
      da[nt >> 1][(nt & 1) * 2 + 1] =
          pack_f32_bf16(p2 * (dpt[nt][2] - d0), p3 * (dpt[nt][3] - d1));
    }

    // dV += P^T dO, dK += dS^T Q: B[query][d] gathered from the tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < 2 * kKtMax; ++nd) {
        if (nd * 8 < D) {
          uint32_t b0, b1;
          gather_b_frag(dos, kStride, kk * 16, nd * 8, g, t, b0, b1);
          mma_bf16(acc_v[nd], pa[kk], b0, b1);
          gather_b_frag(qs, kStride, kk * 16, nd * 8, g, t, b0, b1);
          mma_bf16(acc_k[nd], da[kk], b0, b1);
        }
      }
    }
  }

  const long row0 = base + (j0 + kr + g) * row_stride;
  const long row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int nd = 0; nd < 2 * kKtMax; ++nd) {
    if (nd * 8 < D) {
      const int col = nd * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dv + row0 + col) =
          pack_f32_bf16(acc_v[nd][0], acc_v[nd][1]);
      *reinterpret_cast<uint32_t*>(dv + row1 + col) =
          pack_f32_bf16(acc_v[nd][2], acc_v[nd][3]);
      *reinterpret_cast<uint32_t*>(dk + row0 + col) =
          pack_f32_bf16(acc_k[nd][0] * scale, acc_k[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dk + row1 + col) =
          pack_f32_bf16(acc_k[nd][2] * scale, acc_k[nd][3] * scale);
    }
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int L,
    int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // this block's
  __nv_bfloat16* dos = qs + kBlockQ * kStride;
  __nv_bfloat16* ks = dos + kBlockQ * kStride;             // current tile
  __nv_bfloat16* vs = ks + kBlockK * kStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int KT = (D + 15) / 16;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int i0 = blockIdx.x * kBlockQ;
  const int qr = warp * 16;  // the warp's first query row in the tile

  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int i = tid; i < 4 * kBlockQ * kStride; i += blockDim.x) qs[i] = zero;
  __syncthreads();
  load_rows(qs, kStride, q, base, row_stride, i0, D);
  load_rows(dos, kStride, dout, base, row_stride, i0, D);
  // this lane's two query rows (g and g + 8 of the warp's 16)
  const float l0 = lse[lbase + i0 + qr + g], l1 = lse[lbase + i0 + qr + g + 8];
  const float d0 = delta[lbase + i0 + qr + g];
  const float d1 = delta[lbase + i0 + qr + g + 8];

  float acc[2 * kKtMax][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kKtMax; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  }

  for (int j0 = 0; j0 < L; j0 += kBlockK) {
    __syncthreads();
    load_rows(ks, kStride, k, base, row_stride, j0, D);
    load_rows(vs, kStride, v, base, row_stride, j0, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows = the warp's 16 queries, columns =
    // the tile's 64 keys
    float s[8][4], dp[8][4];
    score_tiles_bf16(qs, dos, ks, vs, qr, KT, g, t, s, dp);

    uint32_t da[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] * scale - l0);
      const float p1 = expf(s[nt][1] * scale - l0);
      const float p2 = expf(s[nt][2] * scale - l1);
      const float p3 = expf(s[nt][3] * scale - l1);
      da[nt >> 1][(nt & 1) * 2 + 0] =
          pack_f32_bf16(p0 * (dp[nt][0] - d0), p1 * (dp[nt][1] - d0));
      da[nt >> 1][(nt & 1) * 2 + 1] =
          pack_f32_bf16(p2 * (dp[nt][2] - d1), p3 * (dp[nt][3] - d1));
    }

    // dQ += dS K: B[key][d] gathered from the key tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < 2 * kKtMax; ++nd) {
        if (nd * 8 < D) {
          uint32_t b0, b1;
          gather_b_frag(ks, kStride, kk * 16, nd * 8, g, t, b0, b1);
          mma_bf16(acc[nd], da[kk], b0, b1);
        }
      }
    }
  }

  const long row0 = base + (i0 + qr + g) * row_stride;
  const long row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int nd = 0; nd < 2 * kKtMax; ++nd) {
    if (nd * 8 < D) {
      const int col = nd * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dq + row0 + col) =
          pack_f32_bf16(acc[nd][0] * scale, acc[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(dq + row1 + col) =
          pack_f32_bf16(acc[nd][2] * scale, acc[nd][3] * scale);
    }
  }
}

// ---- K6, bf16, D <= 64: wgmma + TMA ----------------------------------------
// Threads 0-255: two consumer warpgroups, each owning 64 of the CTA's 128
// keys; threads 256-383: the producer warpgroup (thread 256 issues the
// copies).  Shared memory (1024-aligned): K, V [128 rows]
// (resident), the ring of Q and dO tiles [kDkvStages][64 rows] and of
// their lse / Di rows [kDkvStages][64 + 64 floats], then the barriers
// kv_full, full[s], empty[s].
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int L, int H,
                               int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + 2 * kDkvTile;
  const uint32_t qs0 = vs + 2 * kDkvTile;
  const uint32_t dos0 = qs0 + kDkvStages * kDkvTile;
  const uint32_t rows0 = dos0 + kDkvStages * kDkvTile;  // lse, Di per stage
  const uint32_t kv_full = rows0 + kDkvStages * 512;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * kDkvStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kDkvKeys;
  const int n_tiles = L / kDkvQ;
  const long lbase = (static_cast<long>(b) * H + h) * L;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
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
      mbar_expect_tx(kv_full, 4 * kDkvTile);
      tma_load_4d(ks, &tk, kv_full, 0, h, j0, b);
      tma_load_4d(vs, &tv, kv_full, 0, h, j0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDkvStages;
        const uint32_t bar = full0 + 8 * s;
        if (it >= kDkvStages) {
          mbar_wait(empty0 + 8 * s, ((it / kDkvStages) - 1) & 1);
        }
        mbar_expect_tx(bar, 2 * kDkvTile + 512);
        tma_load_4d(qs0 + s * kDkvTile, &tq, bar, 0, h, it * kDkvQ, b);
        tma_load_4d(dos0 + s * kDkvTile, &tdo, bar, 0, h, it * kDkvQ, b);
        bulk_load(rows0 + s * 512, lse + lbase + it * kDkvQ, 256, bar);
        bulk_load(rows0 + s * 512 + 256, delta + lbase + it * kDkvQ, 256,
                  bar);
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
    const uint32_t ka = ks + wg * kDkvTile;  // this warpgroup's 64 keys
    const uint32_t va = vs + wg * kDkvTile;

    float acc_v[32], acc_k[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_v[i] = 0.0f;
      acc_k[i] = 0.0f;
    }

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDkvStages;
      mbar_wait(full0 + 8 * s, (it / kDkvStages) & 1);
      const uint32_t qb = qs0 + s * kDkvTile;
      const uint32_t db = dos0 + s * kDkvTile;
      const float* lse_s =
          reinterpret_cast<const float*>(smem_raw + (rows0 + s * 512 - raw));
      const float* di_s = lse_s + kDkvQ;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(st, desc_sw128(ka + 32 * kt), desc_sw128(qb + 32 * kt),
                   kt);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(dpt, desc_sw128(va + 32 * kt), desc_sw128(db + 32 * kt),
                   kt);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - Di), in
      // bf16 as the A operands (k = queries) of the two sums
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float l0 = lse_s[qc] * kLog2e, l1 = lse_s[qc + 1] * kLog2e;
        const float d0 = di_s[qc], d1 = di_s[qc + 1];
        const float p0 = exp2f(fmaf(st[4 * j + 0], sl2, -l0));
        const float p1 = exp2f(fmaf(st[4 * j + 1], sl2, -l1));
        const float p2 = exp2f(fmaf(st[4 * j + 2], sl2, -l0));
        const float p3 = exp2f(fmaf(st[4 * j + 3], sl2, -l1));
        pa[j >> 1][(j & 1) * 2 + 0] = pack_f32_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_f32_bf16(p2, p3);
        da[j >> 1][(j & 1) * 2 + 0] = pack_f32_bf16(
            p0 * (dpt[4 * j + 0] - d0), p1 * (dpt[4 * j + 1] - d1));
        da[j >> 1][(j & 1) * 2 + 1] = pack_f32_bf16(
            p2 * (dpt[4 * j + 2] - d0), p3 * (dpt[4 * j + 3] - d1));
      }

      // dV += P^T dO, dK += dS^T Q: dO's and Q's rows (queries) are k,
      // their head dims N (MN-major)
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc_v, pa[kk], desc_sw128(db + 2048 * kk));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc_k, da[kk], desc_sw128(qb + 2048 * kk));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    const long row_stride = static_cast<long>(H) * D;
    const int row = j0 + wg * 64 + warp * 16 + g;
    const long off0 =
        (static_cast<long>(b) * L + row) * row_stride + h * D + 2 * t;
    const long off1 = off0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 < D) {
        *reinterpret_cast<uint32_t*>(dv + off0 + 8 * j) =
            pack_f32_bf16(acc_v[4 * j + 0], acc_v[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dv + off1 + 8 * j) =
            pack_f32_bf16(acc_v[4 * j + 2], acc_v[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dk + off0 + 8 * j) = pack_f32_bf16(
            acc_k[4 * j + 0] * scale, acc_k[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dk + off1 + 8 * j) = pack_f32_bf16(
            acc_k[4 * j + 2] * scale, acc_k[4 * j + 3] * scale);
      }
    }
  }
}

// ---- K7, bf16, D <= 64: wgmma + TMA ----------------------------------------
// K6's structure with the roles swapped.  Threads 0-255: two consumer
// warpgroups, each owning 64 of the CTA's 128 queries; threads 256-383: the
// producer warpgroup (thread 256 issues the copies).  Shared memory
// (1024-aligned): Q, dO [128 rows] (resident), the ring of K and V tiles
// [kDqStages][64 rows], then the barriers q_full, full[s], empty[s].
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int L, int H,
                              int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + 2 * kDkvTile;
  const uint32_t ks0 = dos + 2 * kDkvTile;
  const uint32_t vs0 = ks0 + kDqStages * kDkvTile;
  const uint32_t q_full = vs0 + kDqStages * kDkvTile;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kDqStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * kDqQ;
  const int n_tiles = L / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      mbar_expect_tx(q_full, 4 * kDkvTile);
      tma_load_4d(qs, &tq, q_full, 0, h, i0, b);
      tma_load_4d(dos, &tdo, q_full, 0, h, i0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDqStages;
        const uint32_t bar = full0 + 8 * s;
        if (it >= kDqStages) {
          mbar_wait(empty0 + 8 * s, ((it / kDqStages) - 1) & 1);
        }
        mbar_expect_tx(bar, 2 * kDkvTile);
        tma_load_4d(ks0 + s * kDkvTile, &tk, bar, 0, h, it * kDqKeys, b);
        tma_load_4d(vs0 + s * kDkvTile, &tv, bar, 0, h, it * kDqKeys, b);
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
    const uint32_t qa = qs + wg * kDkvTile;  // this warpgroup's 64 queries
    const uint32_t da = dos + wg * kDkvTile;
    // this lane's two query rows: g and g + 8 of its warp's 16
    const int row = i0 + wg * 64 + warp * 16 + g;
    const long lrow = (static_cast<long>(b) * H + h) * L + row;
    const float l0 = lse[lrow] * kLog2e, l1 = lse[lrow + 8] * kLog2e;
    const float d0 = delta[lrow], d1 = delta[lrow + 8];

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDqStages;
      mbar_wait(full0 + 8 * s, (it / kDqStages) & 1);
      const uint32_t kb = ks0 + s * kDkvTile;
      const uint32_t vb = vs0 + s * kDkvTile;

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(sc, desc_sw128(qa + 32 * kt), desc_sw128(kb + 32 * kt),
                   kt);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(dp, desc_sw128(da + 32 * kt), desc_sw128(vb + 32 * kt),
                   kt);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp2(S scale log2e - lse log2e), dS = P (dP - Di), in bf16 as
      // the A operand (k = keys) of dQ += dS K
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(fmaf(sc[4 * j + 0], sl2, -l0));
        const float p1 = exp2f(fmaf(sc[4 * j + 1], sl2, -l0));
        const float p2 = exp2f(fmaf(sc[4 * j + 2], sl2, -l1));
        const float p3 = exp2f(fmaf(sc[4 * j + 3], sl2, -l1));
        dsa[j >> 1][(j & 1) * 2 + 0] =
            pack_f32_bf16(p0 * (dp[4 * j + 0] - d0), p1 * (dp[4 * j + 1] - d0));
        dsa[j >> 1][(j & 1) * 2 + 1] =
            pack_f32_bf16(p2 * (dp[4 * j + 2] - d1), p3 * (dp[4 * j + 3] - d1));
      }

      // dQ += dS K: K's rows (keys) are k, its head dims N (MN-major)
      fence_regs(acc);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc, dsa[kk], desc_sw128(kb + 2048 * kk));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    const long row_stride = static_cast<long>(H) * D;
    const long off0 =
        (static_cast<long>(b) * L + row) * row_stride + h * D + 2 * t;
    const long off1 = off0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 < D) {
        *reinterpret_cast<uint32_t*>(dq + off0 + 8 * j) = pack_f32_bf16(
            acc[4 * j + 0] * scale, acc[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dq + off1 + 8 * j) = pack_f32_bf16(
            acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
      }
    }
  }
}

// ---- K6, fp32: 3xTF32 on mma.sync ------------------------------------------
// 4 warps of 16 keys (64 keys a block); Q, dO, lse and Di stream in tiles of
// 32 queries, double-buffered by cp.async.  NTD: D/8 that the registers are
// sized for (8: D <= 64, 20: D <= 160).  Shared memory: K, V [64][D + 4],
// Q, dO [2][32][D + 4], lse, Di [2][32].
template <int NTD>
__global__ void __launch_bounds__(128, NTD <= 8 ? 2 : 1)
    flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int L, int H, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ds = D + 4;
  float* ks = smem;
  float* vs = ks + kBlockK * ds;
  float* qs = vs + kBlockK * ds;
  float* dos = qs + 2 * kTfQ * ds;
  float* ls = dos + 2 * kTfQ * ds;
  float* dis = ls + 2 * kTfQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ND = D / 8;
  const float sl2 = scale * kLog2e;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int j0 = blockIdx.x * kBlockK;
  const int n_tiles = L / kTfQ;

  // tile `it` of Q, dO, lse and Di into buffer `buf` (not committed)
  auto load_tile = [&](int it, int buf) {
    load_rows_async(qs + buf * kTfQ * ds, ds, q, base, row_stride,
                    it * kTfQ, kTfQ, D);
    load_rows_async(dos + buf * kTfQ * ds, ds, dout, base, row_stride,
                    it * kTfQ, kTfQ, D);
    if (tid < kTfQ / 4) {
      cp_async16(ls + buf * kTfQ + 4 * tid, lse + lbase + it * kTfQ + 4 * tid);
    } else if (tid < kTfQ / 2) {
      const int c = 4 * (tid - kTfQ / 4);
      cp_async16(dis + buf * kTfQ + c, delta + lbase + it * kTfQ + c);
    }
  };
  load_rows_async(ks, ds, k, base, row_stride, j0, kBlockK, D);
  load_rows_async(vs, ds, v, base, row_stride, j0, kBlockK, D);
  load_tile(0, 0);
  cp_async_commit();

  const float* kw = ks + warp * 16 * ds;
  const float* vw = vs + warp * 16 * ds;
  constexpr bool kFold = NTD <= 8;
  float acc_v[NTD][4], acc_k[NTD][4];
  float part_v[kFold ? NTD : 1][4], part_k[kFold ? NTD : 1][4];
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_v[nd][e] = 0.0f;
      acc_k[nd][e] = 0.0f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + buf * kTfQ * ds;
    const float* dot = dos + buf * kTfQ * ds;
    const float* lt = ls + buf * kTfQ;
    const float* dit = dis + buf * kTfQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nt][e] = 0.0f;
        dpt[nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NTD; ++kk) {
      if (kk < ND) {
        const int c = g * ds + 8 * kk + t;
        const float ak[4] = {kw[c], kw[c + 8 * ds], kw[c + 4],
                             kw[c + 8 * ds + 4]};
        const float av[4] = {vw[c], vw[c + 8 * ds], vw[c + 4],
                             vw[c + 8 * ds + 4]};
        uint32_t kh[4], kl[4], vh[4], vl[4];
        split_frag(ak, kh, kl);
        split_frag(av, vh, vl);
        uint32_t qh[4][2], ql[4][2], oh[4][2], ol[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = (8 * nt + g) * ds + 8 * kk + t;
          split_tf32(qt[r], qh[nt][0], ql[nt][0]);
          split_tf32(qt[r + 4], qh[nt][1], ql[nt][1]);
          split_tf32(dot[r], oh[nt][0], ol[nt][0]);
          split_tf32(dot[r + 4], oh[nt][1], ol[nt][1]);
        }
        mma_3xtf32(st, 0, kh, kl, qh, ql);
        mma_3xtf32(dpt, 0, vh, vl, oh, ol);
      }
    }

    // P^T and dS^T: rows = keys g, g + 8; columns = queries 8nt + 2t, + 1
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * t + (e & 1);
        const float p = exp2f(fmaf(st[nt][e], sl2, -lt[qc] * kLog2e));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dit[qc]);
      }
    }

    // dV += P^T dO, dK += dS^T Q (into this tile's partial sums when they
    // fit): query step kk covers queries 8kk..8kk+7; this lane's queries
    // 8kk + 2t, + 1 stand at k = t, t + 4
#pragma unroll
    for (int nd = 0; nd < (kFold ? NTD : 1); ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part_v[nd][e] = 0.0f;
        part_k[nd][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float ap[4] = {st[kk][0], st[kk][2], st[kk][1], st[kk][3]};
      const float ad[4] = {dpt[kk][0], dpt[kk][2], dpt[kk][1], dpt[kk][3]};
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_frag(ap, ph, pl);
      split_frag(ad, dh, dl);
      const int r = (8 * kk + 2 * t) * ds + g;
#pragma unroll
      for (int n0 = 0; n0 < NTD; n0 += 4) {
        if (n0 < ND) {
          uint32_t oh[4][2], ol[4][2], qh[4][2], ql[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = r + 8 * (n0 + i < ND ? n0 + i : n0);
            split_tf32(dot[c], oh[i][0], ol[i][0]);
            split_tf32(dot[c + ds], oh[i][1], ol[i][1]);
            split_tf32(qt[c], qh[i][0], ql[i][0]);
            split_tf32(qt[c + ds], qh[i][1], ql[i][1]);
          }
          if constexpr (kFold) {
            mma_3xtf32(part_v, n0, ph, pl, oh, ol);
            mma_3xtf32(part_k, n0, dh, dl, qh, ql);
          } else {
            mma_3xtf32(acc_v, n0, ph, pl, oh, ol);
            mma_3xtf32(acc_k, n0, dh, dl, qh, ql);
          }
        }
      }
    }
    if constexpr (kFold) {
#pragma unroll
      for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_v[nd][e] += part_v[nd][e];
          acc_k[nd][e] += part_k[nd][e];
        }
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

  const long row0 = base + (j0 + warp * 16 + g) * row_stride + 2 * t;
  const long row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd) {
    if (nd < ND) {
      *reinterpret_cast<float2*>(dv + row0 + 8 * nd) =
          make_float2(acc_v[nd][0], acc_v[nd][1]);
      *reinterpret_cast<float2*>(dv + row1 + 8 * nd) =
          make_float2(acc_v[nd][2], acc_v[nd][3]);
      *reinterpret_cast<float2*>(dk + row0 + 8 * nd) =
          make_float2(acc_k[nd][0] * scale, acc_k[nd][1] * scale);
      *reinterpret_cast<float2*>(dk + row1 + 8 * nd) =
          make_float2(acc_k[nd][2] * scale, acc_k[nd][3] * scale);
    }
  }
}

// ---- K7, fp32: 3xTF32 on mma.sync ------------------------------------------
// 4 warps of 16 MT queries (MT m16 tiles share every K fragment a warp
// loads); the CTA's Q and dO rows stay resident, their lse and Di in
// registers; K and V stream in tiles of KEYS keys, double-buffered by
// cp.async.  NTD: D/8 that the registers are sized for (8: D <= 64, 20:
// D <= 160).  Each warp splits the K / V fragments it loads into TF32 hi
// and lo.  Shared memory (rows padded to D + 4 floats: conflict-free
// fragment loads): Q, dO [64 MT], K, V [2][KEYS].
template <int NTD, int MT>
__global__ void __launch_bounds__(128, NTD <= 8 ? 2 : 1)
    flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int L, int H, int D,
                             float scale) {
  constexpr int kQ = 64 * MT;  // queries per block
  constexpr int KEYS = kDqTfKeys;
  constexpr int NT = KEYS / 8;  // key n-tiles of the score products
  extern __shared__ __align__(16) float smem[];
  const int ds = D + 4;
  float* qs = smem;
  float* dos = qs + kQ * ds;
  float* ks = dos + kQ * ds;
  float* vs = ks + 2 * KEYS * ds;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ND = D / 8;
  const float sl2 = scale * kLog2e;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int i0 = blockIdx.x * kQ;
  const int n_tiles = L / KEYS;

  load_rows_async(qs, ds, q, base, row_stride, i0, kQ, D);
  load_rows_async(dos, ds, dout, base, row_stride, i0, kQ, D);
  load_rows_async(ks, ds, k, base, row_stride, 0, KEYS, D);
  load_rows_async(vs, ds, v, base, row_stride, 0, KEYS, D);
  cp_async_commit();

  // this lane's query rows: g and g + 8 of each of the warp's m16 tiles
  const int r0 = warp * 16 * MT;
  float l2[MT][2], di[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long row = lbase + i0 + r0 + 16 * mt + 8 * r + g;
      l2[mt][r] = lse[row] * kLog2e;
      di[mt][r] = delta[row];
    }
  }
  // dQ, and this key tile's part of it (folded in by a rounded fp32 add)
  float acc[MT][NTD][4], part[MT][NTD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.0f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nb = (buf ^ 1) * KEYS * ds;
      load_rows_async(ks + nb, ds, k, base, row_stride, (it + 1) * KEYS,
                      KEYS, D);
      load_rows_async(vs + nb, ds, v, base, row_stride, (it + 1) * KEYS,
                      KEYS, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * KEYS * ds;
    const float* vt = vs + buf * KEYS * ds;

    // S = Q K^T and dP = dO V^T: the warp's 16 MT queries x the tile's
    // KEYS keys (NT n-tiles of 8)
    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = 0.0f;
          dp[mt][nt][e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < NTD; ++kk) {
      if (kk < ND) {
        uint32_t kh[NT][2], kl[NT][2], vh[NT][2], vl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int off = (8 * nt + g) * ds + 8 * kk + t;
          split_tf32(kt[off], kh[nt][0], kl[nt][0]);
          split_tf32(kt[off + 4], kh[nt][1], kl[nt][1]);
          split_tf32(vt[off], vh[nt][0], vl[nt][0]);
          split_tf32(vt[off + 4], vh[nt][1], vl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int c = (r0 + 16 * mt + g) * ds + 8 * kk + t;
          const float aq[4] = {qs[c], qs[c + 8 * ds], qs[c + 4],
                               qs[c + 8 * ds + 4]};
          const float ao[4] = {dos[c], dos[c + 8 * ds], dos[c + 4],
                               dos[c + 8 * ds + 4]};
          uint32_t qh[4], ql[4], oh[4], ol[4];
          split_frag(aq, qh, ql);
          split_frag(ao, oh, ol);
          mma_3xtf32(s[mt], 0, qh, ql, kh, kl);
          mma_3xtf32(dp[mt], 0, oh, ol, vh, vl);
        }
      }
    }

    // dS = P (dP - Di), P = exp2(S scale log2e - lse log2e): rows g (e = 0,
    // 1) and g + 8 (e = 2, 3), keys 8nt + 2t, + 1; into s
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[mt][nt][e], sl2, -l2[mt][e >> 1]));
          s[mt][nt][e] = p * (dp[mt][nt][e] - di[mt][e >> 1]);
        }
      }
    }

    // this tile's dS K into the partial sums: key step kk covers keys
    // 8kk..8kk+7; this lane's keys 8kk + 2t, + 1 stand at k = t, t + 4, the
    // same permutation applied to K's rows
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nd][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float a[4] = {s[mt][kk][0], s[mt][kk][2], s[mt][kk][1],
                            s[mt][kk][3]};
        split_frag(a, ah[mt], al[mt]);
      }
      const int r = (8 * kk + 2 * t) * ds + g;
#pragma unroll
      for (int n0 = 0; n0 < NTD; n0 += 4) {
        if (n0 < ND) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = r + 8 * (n0 + i < ND ? n0 + i : n0);
            split_tf32(kt[c], bh[i][0], bl[i][0]);
            split_tf32(kt[c + ds], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_3xtf32(part[mt], n0, ah[mt], al[mt], bh, bl);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nd][e] += part[mt][nd][e];
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long row0 = base + (i0 + r0 + 16 * mt + g) * row_stride + 2 * t;
    const long row1 = row0 + 8 * row_stride;
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
      if (nd < ND) {
        *reinterpret_cast<float2*>(dq + row0 + 8 * nd) =
            make_float2(acc[mt][nd][0] * scale, acc[mt][nd][1] * scale);
        *reinterpret_cast<float2*>(dq + row1 + 8 * nd) =
            make_float2(acc[mt][nd][2] * scale, acc[mt][nd][3] * scale);
      }
    }
  }
}

bool bad_shape(int B, int L, int H, int D) {
  return L % kBlockQ != 0 || L <= 0 || D % 8 != 0 || D <= 0 || D > kMaxD ||
         B <= 0 || H <= 0 || B > 65535 || H > 65535;
}

size_t bf16_smem(int extra_floats) {
  return 4 * 64 * kStride * sizeof(__nv_bfloat16) +
         sizeof(float) * extra_floats;
}

template <int NTD, int MT>
int launch_dq_tf32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dq, int B, int L, int H, int D, float scale,
                   cudaStream_t s) {
  if (L % (64 * MT) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (D + 4) * (2 * 64 * MT + 4 * kDqTfKeys);
  return launch(flash_bwd_dq_tf32_kernel<NTD, MT>,
                dim3(L / (64 * MT), H, B), 128, smem, s, q, k, v, dout, lse,
                delta, dq, L, H, D, scale);
}

}  // namespace

// q, k, v, dout, dk, dv: [B, L, H, D] contiguous, 16-byte aligned, all
// bf16 (is_bf16 = 1) or fp32 (0); lse, delta: [B, H, L] fp32, 16-byte
// aligned.  L % 64 == 0 (L % 128 == 0 for bf16 with D <= 64), D % 8 == 0,
// D <= 160.
extern "C" int gsgen_flash_attn_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int L,
                                        int H, int D, float scale,
                                        int is_bf16, void* stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / kBlockK, H, B);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const auto* qb = static_cast<const T*>(q);
    const auto* kb = static_cast<const T*>(k);
    const auto* vb = static_cast<const T*>(v);
    const auto* ob = static_cast<const T*>(dout);
    auto* dkb = static_cast<T*>(dk);
    auto* dvb = static_cast<T*>(dv);
    if (D <= 64) {
      if (L % kDkvKeys != 0) return static_cast<int>(cudaErrorInvalidValue);
      CUtensorMap tq, tdo, tk, tv;
      if (!bf16_rows_map(&tq, q, B, L, H, D, kDkvQ) ||
          !bf16_rows_map(&tdo, dout, B, L, H, D, kDkvQ) ||
          !bf16_rows_map(&tk, k, B, L, H, D, kDkvKeys) ||
          !bf16_rows_map(&tv, v, B, L, H, D, kDkvKeys)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return launch(flash_bwd_dkv_wgmma_kernel, dim3(L / kDkvKeys, H, B),
                    kWgThreads, kDkvSmem, s, tq, tdo, tk, tv, lf, df, dkb,
                    dvb, L, H, D, scale);
    }
    return launch(flash_bwd_dkv_bf16_kernel, grid, 128,
                  bf16_smem(128), s, qb, kb, vb, ob, lf, df, dkb, dvb, L,
                  H, D, scale);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(dout);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  const size_t smem =
      sizeof(float) * ((2 * kBlockK + 4 * kTfQ) * (D + 4) + 4 * kTfQ);
  if (D <= 64) {
    return launch(flash_bwd_dkv_tf32_kernel<8>, grid, 128, smem, s, qf, kf,
                  vf, of, lf, df, dkf, dvf, L, H, D, scale);
  }
  return launch(flash_bwd_dkv_tf32_kernel<kMaxD / 8>, grid, 128, smem, s, qf,
                kf, vf, of, lf, df, dkf, dvf, L, H, D, scale);
}

// As above, for dq.
extern "C" int gsgen_flash_attn_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int B, int L, int H, int D,
                                       float scale, int is_bf16,
                                       void* stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  if (!is_bf16) {
    // 32 queries a warp for D <= 64, 16 for D <= 160 (whose registers hold
    // one m16 tile's 20 accumulators and parts)
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    const auto* of = static_cast<const float*>(dout);
    auto* dqf = static_cast<float*>(dq);
    if (D <= 64) {
      return launch_dq_tf32<8, 2>(qf, kf, vf, of, lf, df, dqf, B, L, H, D,
                                  scale, s);
    }
    return launch_dq_tf32<kMaxD / 8, 1>(qf, kf, vf, of, lf, df, dqf, B, L, H,
                                        D, scale, s);
  }
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  if (D <= 64) {
    if (L % kDqQ != 0) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tq, tdo, tk, tv;
    if (!bf16_rows_map(&tq, q, B, L, H, D, kDqQ) ||
        !bf16_rows_map(&tdo, dout, B, L, H, D, kDqQ) ||
        !bf16_rows_map(&tk, k, B, L, H, D, kDqKeys) ||
        !bf16_rows_map(&tv, v, B, L, H, D, kDqKeys)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch(flash_bwd_dq_wgmma_kernel, dim3(L / kDqQ, H, B),
                  kWgThreads, kDqSmem, s, tq, tdo, tk, tv, lf, df, dqb, L, H,
                  D, scale);
  }
  using T = __nv_bfloat16;
  return launch(flash_bwd_dq_bf16_kernel, dim3(L / kBlockQ, H, B), 128,
                bf16_smem(0), s, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lf, df, dqb, L, H, D, scale);
}
