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
// per 64-query tile and walks every key tile.  Each block owns its output
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
//  * K6 bf16, D > 64, and K7 (bf16: every D): 4 warps of mma.sync m16n8k16
//    (bf16 in, fp32 accumulate), each warp 16 keys (K6) or 16 queries (K7);
//    the score accumulators become the A operands of the second products in
//    registers, as in K5.  P and dS are rounded to bf16 for those products.
//  * K7 fp32: scalar FMAs, 256 threads.  The two score products (S, dP)
//    give each thread a 4 x 4 block of (query, key) pairs with rows 16 apart
//    (conflict-free float4 reads of rows padded to D + 4 floats); dS goes
//    through shared memory to the accumulation product, where a thread owns
//    4 rows x 4 head dims per 64.  Bound 6 B H L^2 D / 67 TFLOP/s.
#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

#include <math.h>

namespace {

constexpr int kPS = 80;  // row stride (floats) of the fp32 dS tile (K7)
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float s, float4 x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

__device__ __forceinline__ float4 scaled4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// S = X Y^T and dP = U W^T for rows r0 + 16a (of X, U) and c0 + 16b (of
// Y, W), a, b < 4: the score products of K7 fp32.  Tiles are
// row-major with stride D + 4.
__device__ __forceinline__ void score_blocks_f32(
    const float* xs, const float* us, const float* ys, const float* ws,
    int ds, int D, int r0, int c0, float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = 0.0f;
      dp[a][b] = 0.0f;
    }
  }
  for (int d = 0; d < D; d += 4) {
    float4 x[4], u[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = *reinterpret_cast<const float4*>(xs + (r0 + 16 * a) * ds + d);
      u[a] = *reinterpret_cast<const float4*>(us + (r0 + 16 * a) * ds + d);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 y =
          *reinterpret_cast<const float4*>(ys + (c0 + 16 * b) * ds + d);
      const float4 w =
          *reinterpret_cast<const float4*>(ws + (c0 + 16 * b) * ds + d);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        s[a][b] = dot4(x[a], y, s[a][b]);
        dp[a][b] = dot4(u[a], w, dp[a][b]);
      }
    }
  }
}

// ---- K7, fp32: dQ for 64 queries -------------------------------------------
template <int NCH>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int L, int H, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ds = D + 4;
  float* qs = smem;                      // [64 queries][ds], this block's
  float* dos = qs + kBlockQ * ds;
  float* ks = dos + kBlockQ * ds;        // [64 keys][ds], current tile
  float* vs = ks + kBlockK * ds;
  float* dst = vs + kBlockK * ds;        // [64 keys][kPS]: dS transposed

  const int tid = threadIdx.x;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int i0 = blockIdx.x * kBlockQ;
  // scores: queries ti + 16a, keys tj + 16b; sums: queries 4qb + a, dims
  // 4td + 64c .. + 3
  const int ti = tid & 15, tj = tid >> 4;
  const int td = tid & 15, qb = tid >> 4;

  load_rows(qs, ds, q, base, row_stride, i0, D);
  load_rows(dos, ds, dout, base, row_stride, i0, D);
  float lse_r[4], di_r[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    lse_r[a] = lse[lbase + i0 + ti + 16 * a];
    di_r[a] = delta[lbase + i0 + ti + 16 * a];
  }

  float4 acc[4][NCH];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[a][c] = make_float4(0.0f, 0.0f, 0.0f,
                                                          0.0f);
  }

  for (int j0 = 0; j0 < L; j0 += kBlockK) {
    __syncthreads();
    load_rows(ks, ds, k, base, row_stride, j0, D);
    load_rows(vs, ds, v, base, row_stride, j0, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_blocks_f32(qs, dos, ks, vs, ds, D, ti, tj, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] * scale - lse_r[a]);
        dst[(tj + 16 * b) * kPS + ti + 16 * a] = p * (dp[a][b] - di_r[a]);
      }
    }
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j]
    for (int j = 0; j < kBlockK; ++j) {
      const float4 d4 =
          *reinterpret_cast<const float4*>(dst + j * kPS + 4 * qb);
      const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = 4 * td + 64 * c;
        if (col < D) {
          const float4 x = *reinterpret_cast<const float4*>(ks + j * ds + col);
#pragma unroll
          for (int a = 0; a < 4; ++a) axpy4(acc[a][c], dsv[a], x);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long row = base + (i0 + 4 * qb + a) * row_stride;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * td + 64 * c;
      if (col < D) {
        *reinterpret_cast<float4*>(dq + row + col) = scaled4(acc[a][c], scale);
      }
    }
  }
}

// ---- bf16 (mma.sync) -------------------------------------------------------
// KT_MAX: head dim in units of 16 the registers are sized for (4: D <= 64,
// 10: D <= 160).  Tiles in shared memory are zero-padded from D to a
// multiple of 16; row stride KT_MAX * 16 + 8 elements (conflict-free
// fragment loads).

// S = X Y^T and dP = U W^T for the warp's 16 rows r0.. (X, U) against the
// tile's 64 rows (Y, W): 8 n-tiles of 8 columns each.
template <int KT_MAX>
__device__ __forceinline__ void score_tiles_bf16(
    const __nv_bfloat16* xs, const __nv_bfloat16* us,
    const __nv_bfloat16* ys, const __nv_bfloat16* ws, int r0, int KT, int g,
    int t, float (&s)[8][4], float (&dp)[8][4]) {
  constexpr int kStride = KT_MAX * 16 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = 0.0f;
      dp[nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int kt = 0; kt < KT_MAX; ++kt) {
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

template <int KT_MAX>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int L, int H, int D, float scale) {
  constexpr int kStride = KT_MAX * 16 + 8;
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

  float acc_v[2 * KT_MAX][4], acc_k[2 * KT_MAX][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
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
    score_tiles_bf16<KT_MAX>(ks, vs, qs, dos, kr, KT, g, t, st, dpt);

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
      for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
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
  for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
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

template <int KT_MAX>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int L,
    int H, int D, float scale) {
  constexpr int kStride = KT_MAX * 16 + 8;
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

  float acc[2 * KT_MAX][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
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
    score_tiles_bf16<KT_MAX>(qs, dos, ks, vs, qr, KT, g, t, s, dp);

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
      for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
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
  for (int nd = 0; nd < 2 * KT_MAX; ++nd) {
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
          wgmma_n64_ss(st, desc_sw128(ka + 32 * kt),
                       desc_sw128(qb + 32 * kt), kt);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_n64_ss(dpt, desc_sw128(va + 32 * kt),
                       desc_sw128(db + 32 * kt), kt);
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
        wgmma_n64_rs(acc_v, pa[kk], desc_sw128(db + 2048 * kk));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_n64_rs(acc_k, da[kk], desc_sw128(qb + 2048 * kk));
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

bool bad_shape(int B, int L, int H, int D) {
  return L % kBlockQ != 0 || L <= 0 || D % 8 != 0 || D <= 0 || D > kMaxD ||
         B <= 0 || H <= 0 || B > 65535 || H > 65535;
}

size_t f32_smem(int D, int extra_floats) {
  return sizeof(float) * (4 * 64 * static_cast<size_t>(D + 4) + extra_floats);
}

template <int KT_MAX>
size_t bf16_smem(int extra_floats) {
  return 4 * 64 * (KT_MAX * 16 + 8) * sizeof(__nv_bfloat16) +
         sizeof(float) * extra_floats;
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
    return launch(flash_bwd_dkv_bf16_kernel<10>, grid, 128,
                  bf16_smem<10>(128), s, qb, kb, vb, ob, lf, df, dkb, dvb, L,
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
  const dim3 grid(L / kBlockQ, H, B);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const auto* qb = static_cast<const T*>(q);
    const auto* kb = static_cast<const T*>(k);
    const auto* vb = static_cast<const T*>(v);
    const auto* ob = static_cast<const T*>(dout);
    auto* dqb = static_cast<T*>(dq);
    if (D <= 64) {
      return launch(flash_bwd_dq_bf16_kernel<4>, grid, 128, bf16_smem<4>(0),
                    s, qb, kb, vb, ob, lf, df, dqb, L, H, D, scale);
    }
    return launch(flash_bwd_dq_bf16_kernel<10>, grid, 128, bf16_smem<10>(0),
                  s, qb, kb, vb, ob, lf, df, dqb, L, H, D, scale);
  }
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(dout);
  auto* dqf = static_cast<float*>(dq);
  const size_t smem = f32_smem(D, 64 * kPS);
  if (D <= 64) {
    return launch(flash_bwd_dq_f32_kernel<1>, grid, 256, smem, s, qf, kf, vf,
                  of, lf, df, dqf, L, H, D, scale);
  }
  return launch(flash_bwd_dq_f32_kernel<3>, grid, 256, smem, s, qf, kf, vf,
                of, lf, df, dqf, L, H, D, scale);
}
