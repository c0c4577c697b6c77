// K5: flash self-attention forward, out = softmax(q k^T * scale) v.
//
// Replaces the JAX package's guidance/unet2d.py::_flash_self_attention, which
// calls the library Pallas TPU kernel jax.experimental.pallas.ops.tpu.
// flash_attention (non-causal, no mask).  Inputs and output keep that
// function's [B, L, H, D] layout: the kernel indexes [b, l, h, d] directly
// (row stride H*D), so no transposes are made around it.
//
// Design (FlashAttention-2 style, one pass over the keys, nothing of size
// L x L ever leaves the SM): one block per (64-query tile, head, batch);
// K and V tiles are staged in shared memory; each query row keeps a running
// max m, a running sum l and an unnormalised output accumulator, all fp32;
// a new key tile rescales them by exp(m_old - m_new).  The output is divided
// by l once at the end and written in the input type.  When the caller
// differentiates, the kernel also writes lse = m + log(l) per query row in
// fp32 ([B, H, L], as the library saves l and m), from which the backward
// kernels K6/K7 (flash_attn_bwd.cu) recompute P exactly.
//
//  * bf16: 4 warps, 16 query rows each.  S = Q K^T and O += P V run on the
//    tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
//    score fragment becomes the A operand of P V in registers (FA2's layout
//    trick).  P is rounded to bf16 for the product and l sums the rounded
//    values, so the weights that multiply V sum to exactly l.  D is padded
//    to a multiple of 16 with zeros in shared memory (D = 40 -> 48).
//  * fp32: scalar FMAs, 4 threads per query row, each owning D/4 of the
//    head dimensions (interleaved pairs); the partial dot products of q.k
//    meet by two warp shuffles.
//
// Bound on this card: operations.  At SD 2.1's level 0, [8, 4096, 5, 64],
// the two products are 4 B H L^2 D = 172 GFLOP against 84 MB of q/k/v/o
// (0.174 ms at 989 TFLOP/s bf16 vs 0.025 ms at 3.35 TB/s).  This first
// version uses mma.sync from shared memory without cp.async pipelining or
// wgmma/TMA, so it reaches a fraction of the bf16 peak; those are later work.
#include "flash_attn_common.cuh"

#include <math.h>

namespace {

constexpr int kBlockKF = 32;  // keys per shared-memory tile (fp32)

// KT_MAX: head dim in units of 16 that the registers are sized for
// (4: D <= 64, 10: D <= 160); fragment layouts in flash_attn_common.cuh.
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

// fp32: 256 threads = 64 query rows x 4 lanes; lane p of a row owns head
// dims 8i + 2p + {0, 1}, i < D/8.  kPairs: D/8 that the registers are
// sized for (8: D <= 64, 20: D <= 160).
template <int kPairs>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int L, int H, int D,
                         float scale) {
  __shared__ __align__(16) float ks[kBlockKF * kMaxD];
  __shared__ __align__(16) float vs[kBlockKF * kMaxD];

  const int tid = threadIdx.x;
  const int p = tid & 3;
  const int np = D / 8;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long qrow = base + (blockIdx.x * kBlockQ + (tid >> 2)) * row_stride;

  float2 qv[kPairs];
  float2 acc[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    qv[i] = i < np ? *reinterpret_cast<const float2*>(q + qrow + 8 * i + 2 * p)
                   : make_float2(0.0f, 0.0f);
    acc[i] = make_float2(0.0f, 0.0f);
  }
  float m = -INFINITY;
  float l = 0.0f;

  const int vec = D / 4;  // float4 per row
  for (int j0 = 0; j0 < L; j0 += kBlockKF) {
    __syncthreads();
    for (int i = tid; i < kBlockKF * vec; i += blockDim.x) {
      const int r = i / vec;
      const int c = (i - r * vec) * 4;
      const long off = base + (j0 + r) * row_stride + c;
      *reinterpret_cast<float4*>(ks + r * D + c) =
          *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<float4*>(vs + r * D + c) =
          *reinterpret_cast<const float4*>(v + off);
    }
    __syncthreads();

    // partial dots for the whole tile first, then the quad reductions:
    // independent shuffles overlap instead of serialising per key
    float s[kBlockKF];
#pragma unroll
    for (int j = 0; j < kBlockKF; ++j) {
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (i < np) {
          const float2 kv =
              *reinterpret_cast<const float2*>(ks + j * D + 8 * i + 2 * p);
          d += qv[i].x * kv.x + qv[i].y * kv.y;
        }
      }
      s[j] = d;
    }
#pragma unroll
    for (int j = 0; j < kBlockKF; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBlockKF; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
      s[j] *= scale;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlockKF; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        if (i < np) {
          const float2 vv =
              *reinterpret_cast<const float2*>(vs + j * D + 8 * i + 2 * p);
          acc[i].x += pj * vv.x;
          acc[i].y += pj * vv.y;
        }
      }
    }
  }

  if (lse != nullptr && p == 0) {
    lse[(static_cast<long>(blockIdx.z) * H + blockIdx.y) * L +
        blockIdx.x * kBlockQ + (tid >> 2)] = m + logf(l);
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (i < np) {
      *reinterpret_cast<float2*>(o + qrow + 8 * i + 2 * p) =
          make_float2(acc[i].x * inv, acc[i].y * inv);
    }
  }
}

}  // namespace

// q, k, v, o: [B, L, H, D] contiguous, 16-byte aligned; L % 64 == 0,
// D % 8 == 0, D <= 160.  is_bf16: 1 for bfloat16, 0 for float32.  lse:
// null, or [B, H, L] fp32 for the log-sum-exp of each query's scaled
// scores (what the backward K6/K7 recomputes P from).
extern "C" int gsgen_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int L, int H, int D, float scale,
                                    int is_bf16, void* stream) {
  if (L % kBlockQ != 0 || D % 8 != 0 || D <= 0 || D > kMaxD || B <= 0 ||
      H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / kBlockQ, H, B);
  auto* lf = static_cast<float*>(lse);
  if (is_bf16) {
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    if (D <= 64) {
      flash_fwd_bf16_kernel<4><<<grid, 128, 0, s>>>(qb, kb, vb, ob, lf, L, H,
                                                    D, scale);
    } else {
      flash_fwd_bf16_kernel<10><<<grid, 128, 0, s>>>(qb, kb, vb, ob, lf, L, H,
                                                     D, scale);
    }
  } else {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    if (D <= 64) {
      flash_fwd_f32_kernel<8><<<grid, 256, 0, s>>>(qf, kf, vf, of, lf, L, H,
                                                   D, scale);
    } else {
      flash_fwd_f32_kernel<kMaxD / 8><<<grid, 256, 0, s>>>(qf, kf, vf, of, lf,
                                                           L, H, D, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
