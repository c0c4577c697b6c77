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
// K6 takes one block per (64-key tile, head, batch) and walks every query
// tile; K7 one block per (64-query tile, head, batch) and walks every key
// tile.  Each block owns its output rows, so there are no atomics and the
// sums run in a fixed order: the results are deterministic, as the
// library's are.
//
//  * fp32 (the VSD path: the JAX VSD UNet runs in fp32): scalar FMAs, 256
//    threads.  The two score products (S, dP) give each thread a 4 x 4 block
//    of (query, key) pairs with rows 16 apart (conflict-free float4 reads of
//    rows padded to D + 4 floats); P and dS go through shared memory to the
//    accumulation products, where a thread owns 4 rows x 4 head dims per 64.
//  * bf16: 4 warps of mma.sync m16n8k16 (bf16 in, fp32 accumulate), each warp
//    16 keys (K6) or 16 queries (K7); the score accumulators become the A
//    operands of the second products in registers, as in K5.  P and dS are
//    rounded to bf16 for those products.
//
// Bound on this card: operations.  At the VSD path's [4, 4096, 5, 64] the
// backward needs 10 B H L^2 D = 215 GFLOP (the library's count: S, dP, dV,
// dK, dQ; the kernels do 14 B H L^2 D, recomputing S and dP in both) against
// 42 MB of inputs and outputs: 3.2 ms at 67 TFLOP/s fp32, 0.217 ms at 989
// TFLOP/s bf16.  This first version has no cp.async pipelining, ldmatrix,
// wgmma or TMA; those are later work.
#include "flash_attn_common.cuh"

#include <math.h>

namespace {

constexpr int kPS = 80;  // row stride (floats) of the fp32 P / dS tiles

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
// Y, W), a, b < 4: the score products of both fp32 kernels.  Tiles are
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

// ---- K6, fp32: dK, dV for 64 keys ------------------------------------------
// NCH: float4 chunks of 64 head dims a thread accumulates (1: D <= 64,
// 3: D <= 160).
template <int NCH>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int L, int H, int D,
    float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ds = D + 4;
  float* ks = smem;                      // [64 keys][ds], this block's
  float* vs = ks + kBlockK * ds;
  float* qs = vs + kBlockK * ds;         // [64 queries][ds], current tile
  float* dos = qs + kBlockQ * ds;
  float* ps = dos + kBlockQ * ds;        // [64 queries][kPS]: P
  float* dss = ps + kBlockQ * kPS;       // [64 queries][kPS]: dS
  float* lse_s = dss + kBlockQ * kPS;    // [64]
  float* di_s = lse_s + kBlockQ;         // [64]

  const int tid = threadIdx.x;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int j0 = blockIdx.x * kBlockK;
  // scores: queries ti + 16a, keys tj + 16b; sums: keys 4kb + b, dims
  // 4td + 64c .. + 3
  const int tj = tid & 15, ti = tid >> 4;
  const int td = tid & 15, kb = tid >> 4;

  load_rows(ks, ds, k, base, row_stride, j0, D);
  load_rows(vs, ds, v, base, row_stride, j0, D);

  float4 acc_v[4][NCH], acc_k[4][NCH];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      acc_v[b][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc_k[b][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  for (int i0 = 0; i0 < L; i0 += kBlockQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(qs, ds, q, base, row_stride, i0, D);
    load_rows(dos, ds, dout, base, row_stride, i0, D);
    if (tid < kBlockQ) {
      lse_s[tid] = lse[lbase + i0 + tid];
      di_s[tid] = delta[lbase + i0 + tid];
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_blocks_f32(qs, dos, ks, vs, ds, D, ti, tj, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ti + 16 * a;
      const float l = lse_s[row];
      const float di = di_s[row];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] * scale - l);
        ps[row * kPS + tj + 16 * b] = p;
        dss[row * kPS + tj + 16 * b] = p * (dp[a][b] - di);
      }
    }
    __syncthreads();

    // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
    for (int i = 0; i < kBlockQ; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kPS + 4 * kb);
      const float4 d4 =
          *reinterpret_cast<const float4*>(dss + i * kPS + 4 * kb);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = 4 * td + 64 * c;
        if (col < D) {
          const float4 o = *reinterpret_cast<const float4*>(dos + i * ds + col);
          const float4 x = *reinterpret_cast<const float4*>(qs + i * ds + col);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            axpy4(acc_v[b][c], pv[b], o);
            axpy4(acc_k[b][c], dv4[b], x);
          }
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long row = base + (j0 + 4 * kb + b) * row_stride;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * td + 64 * c;
      if (col < D) {
        *reinterpret_cast<float4*>(dv + row + col) = acc_v[b][c];
        *reinterpret_cast<float4*>(dk + row + col) = scaled4(acc_k[b][c], scale);
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

bool bad_shape(int B, int L, int H, int D) {
  return L % kBlockQ != 0 || L <= 0 || D % 8 != 0 || D <= 0 || D > kMaxD ||
         B <= 0 || H <= 0 || B > 65535 || H > 65535;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory (above the
// 48 KB default only after the attribute is raised).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
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
// bf16 (is_bf16 = 1) or fp32 (0); lse, delta: [B, H, L] fp32.  L % 64 == 0,
// D % 8 == 0, D <= 160.
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
      return launch(flash_bwd_dkv_bf16_kernel<4>, grid, 128, bf16_smem<4>(128),
                    s, qb, kb, vb, ob, lf, df, dkb, dvb, L, H, D, scale);
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
  const size_t smem = f32_smem(D, 2 * 64 * kPS + 128);
  if (D <= 64) {
    return launch(flash_bwd_dkv_f32_kernel<1>, grid, 256, smem, s, qf, kf, vf,
                  of, lf, df, dkf, dvf, L, H, D, scale);
  }
  return launch(flash_bwd_dkv_f32_kernel<3>, grid, 256, smem, s, qf, kf, vf,
                of, lf, df, dkf, dvf, L, H, D, scale);
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
