// Conv2d in fp32 on the tensor cores: an implicit-GEMM convolution in
// 3xTF32 on wgmma fed by TMA, for the UNet's fp32 convolutions (VSD runs
// the SD UNet in fp32).
//
//   y[n, co, oh, ow] = b[co] + sum_{ci, r, s} w[co, ci, r, s]
//                      x[n, ci, oh * stride - pad + r, ow * stride - pad + s]
//
// NCHW in and out, as nn.Conv2d; R x R kernels with R = 1 or 3, any stride
// and symmetric zero padding (the VAE's asymmetric stride-2 padding is an
// F.pad before a pad-0 call).  Replaces no kernel of the JAX package: there
// XLA's convolution computes this (guidance/unet2d.py's nn.Conv), and the
// port ran it on cuDNN in IEEE fp32, whose kernels use the CUDA cores' FFMA
// (67 TFLOP/s).  gsgen_torch/ops/conv.py wraps it; it takes a call only
// where that module's `supported` says so, and nothing tries it and falls
// back.
//
// Bound on this card: operations, 2 N Ho Wo Cout Cin R^2 at the rate of the
// design, 495 / 3 TFLOP/s (three TF32 products a product).  SD 2.1's 3x3
// convolutions do 2-15 GFLOP an image against 5-50 MB of operands, far
// above the 3.35 TB/s line.
//
// GEMM view: M = N Ho Wo output pixels, N = Cout, K = Cin R R in the
// weight's own (ci, r, s) order, so the weight [Cout, K] is the K-major B
// operand as it lies in device memory.  Each operand splits into hi and lo
// = tf32(x - hi), and each product is lo_a hi_b + hi_a lo_b + hi_a hi_b
// with fp32 accumulation, about 2^-21 relative: the port's fp32, as K5-K7's
// fp32 instances.  The activations' hi is tf32(x) rounded to nearest
// (tf32_rna); the weights' hi is the raw fp32 tile as TMA lands it, which
// the tensor cores read truncated to TF32 (its top 19 bits), so lo =
// tf32(w - trunc(w)).
//
//  * One CTA per (128-pixel tile, 160-channel tile, K split): two
//    warpgroups of 64 pixels that both gather and both multiply, 256
//    threads (ptxas gives a 384-thread CTA 168 registers a thread whatever
//    setmaxnreg says; a warpgroup here holds 80 sums and 80 partial sums).
//    160 divides the UNets' 320, 640 and 1280.  K walks in chunks of 32 (one
//    128-byte swizzled row of fp32).
//  * Weights: thread 0 streams each chunk's [160 x 32] tile by TMA (box {32,
//    160}, 128-byte swizzle, zero-filled past K and Cout) into a ring of 4
//    stages, 3 chunks ahead.  All threads split a tile once it lands into
//    one of two lo planes; the landed tile is hi as it is.  Nothing of the
//    weights outlives a call, at the cost of 2 shared-memory passes over
//    each tile in each CTA that streams it (rounding hi in place as well
//    took 2-3% longer at SD 2.1's largest shapes on an H100).
//  * Activations: no im2col in device memory.  Each thread gathers 2 pixels
//    x 8 k of the next chunk's [128 x 32] tile straight from x (__ldg; the
//    9 taps of a pixel and its neighbours' rows meet in L1), zero where the
//    tap falls in the padding or past K, two chunks ahead in registers, and
//    splits them into K-major hi / lo planes (128-byte swizzle, double
//    buffered): 8 lanes of a warp take 8 consecutive pixels of one 4-k
//    group, so loads take whole 32-byte sectors and the 16-byte stores hit
//    every bank once.  wgmma reads 32-bit operands K-major only and NCHW
//    has the pixels contiguous: the transposition is this register pass,
//    which the split needs anyway.
//  * Products: per chunk each warpgroup issues 4 k-steps of three SS wgmma
//    m64n160k8 against the chunk's planes, then splits and stores the next
//    chunk while they run, waits, and the CTA meets at one barrier (which
//    also hands over the planes).  Two alternatives measured on an H100 at
//    SD 2.1's largest shapes did not pay for their code: warpgroups that
//    run free of each other (mbarriers a stage, each warpgroup splitting
//    half of each weight tile) were 0-4% faster, and the activations as
//    the register A operand (gathered straight into fragments, no
//    activation planes) no faster.  The tensor cores' sums do not round
//    to nearest: over the thousands of k-steps of K = 2,880-23,040 their
//    bias would pass the gate.  So each pair of chunks goes to partial
//    sums, folded into the totals by a rounded fp32 add.
//  * K split: where the tiles would fill few of the card's SMs (8^2 and
//    16^2 levels), the wrapper splits K into `splits` ranges of whole
//    chunks; each CTA writes its partial sums into scratch ([splits] x the
//    output, under 64 MB) and conv_splitk_reduce_kernel adds them in a
//    fixed order with the bias: deterministic.
//  * Epilogue: each thread's sums are 2 pixels x 40 channels; 8 lanes hold
//    8 consecutive pixels of one channel, so the NCHW stores take whole
//    sectors.
#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

#include <limits.h>

namespace {

constexpr int kCvBM = 128;       // output pixels a CTA
constexpr int kCvBN = 160;       // output channels a CTA
constexpr int kCvBK = 32;        // k a chunk: one 128-byte row of fp32
constexpr int kCvStages = 4;     // weight tiles in the TMA ring
constexpr int kCvThreads = 256;  // two warpgroups
constexpr int kCvFold = 2;       // chunks a partial sum holds
constexpr int kCvWTile = kCvBN * 128;  // bytes of a weight tile (plane)
constexpr int kCvATile = kCvBM * 128;  // bytes of an activation plane
// shared memory from the 1024-aligned base: weight stages (hi as landed),
// two weight lo planes, two activation hi planes, two lo planes, barriers
constexpr int kCvWlo = kCvStages * kCvWTile;
constexpr int kCvAhi = kCvWlo + 2 * kCvWTile;
constexpr int kCvAlo = kCvAhi + 2 * kCvATile;
constexpr int kCvBar = kCvAlo + 2 * kCvATile;
constexpr int kCvSmem = kCvBar + 8 * kCvStages + 1024;

#define CV_ACC4(d, o) \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
#define CV_ACC8(d, o) CV_ACC4(d, o), CV_ACC4(d, o + 4)
#define CV_ACC40(d, o)                                                  \
  CV_ACC8(d, o), CV_ACC8(d, o + 8), CV_ACC8(d, o + 16), CV_ACC8(d, o + 24), \
      CV_ACC8(d, o + 32)

// d[64 x 160] (+)= A[64 x 8] B[8 x 160] in TF32 with fp32 accumulate, A
// and B K-major in shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss160(float (&d)[80], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1;\n}\n"
      : CV_ACC40(d, 0), CV_ACC40(d, 40)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef CV_ACC40
#undef CV_ACC8
#undef CV_ACC4

// One box of a 2-D map at coordinates (c0, c1) into shared memory;
// completion (the box's bytes) is reported to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// This thread's 2 pixels x 8 k of the chunk at k0 (k = k0 + 4 c + j for c
// in {c0, c0 + 4}, j < 4) into raw[8 pp + 4 h + j], zero in the padding
// and past K.  xoff: the offset of (n, 0, ih0, iw0) in x.
template <int R>
__device__ __forceinline__ void gather(float (&raw)[16],
                                       const float* __restrict__ x,
                                       const int (&xoff)[2],
                                       const int (&ih0)[2],
                                       const int (&iw0)[2], int k0, int c0,
                                       int K, int H, int W) {
  const int HW = H * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * (c0 + 4 * h) + j;
      const int ci = k / (R * R);
      const int rs = k - ci * (R * R);
      const int r = rs / R;
      const int s = rs - r * R;
      const int koff = ci * HW + r * W + s;
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const bool ok = k < K &&
                        static_cast<unsigned>(ih0[pp] + r) <
                            static_cast<unsigned>(H) &&
                        static_cast<unsigned>(iw0[pp] + s) <
                            static_cast<unsigned>(W);
        raw[8 * pp + 4 * h + j] = ok ? __ldg(x + xoff[pp] + koff) : 0.0f;
      }
    }
  }
}

// tf32(w - trunc(w)): the lo of a raw fp32 hi.
__device__ __forceinline__ uint32_t lo_of_raw(uint32_t w) {
  return tf32_rna(__uint_as_float(w) - __uint_as_float(w & 0xffffe000u));
}

// raw split into the activation planes: row prow[pp], 16-byte group c0 +
// 4 h of its 8, at (group ^ (row & 7)) in the 128-byte swizzle.
__device__ __forceinline__ void store_a(const float (&raw)[16],
                                        unsigned char* hi, unsigned char* lo,
                                        const int (&prow)[2], int c0) {
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = prow[pp];
      const int off = row * 128 + (((c0 + 4 * h) ^ (row & 7)) << 4);
      const int v = 8 * pp + 4 * h;
      uint4 a, b;
      split_tf32(raw[v + 0], a.x, b.x);
      split_tf32(raw[v + 1], a.y, b.y);
      split_tf32(raw[v + 2], a.z, b.z);
      split_tf32(raw[v + 3], a.w, b.w);
      *reinterpret_cast<uint4*>(hi + off) = a;
      *reinterpret_cast<uint4*>(lo + off) = b;
    }
  }
}

// A landed weight tile's lo plane, 16 bytes a thread a step: lo =
// tf32(w - trunc(w)), trunc(w) being what the tensor cores read of w.
__device__ __forceinline__ void split_w(const unsigned char* hi,
                                        unsigned char* lo, int tid) {
  static_assert(kCvBN * 8 % kCvThreads == 0, "whole steps");
#pragma unroll
  for (int u = 0; u < kCvBN * 8 / kCvThreads; ++u) {
    const int i = tid + u * kCvThreads;
    const uint4 a = *reinterpret_cast<const uint4*>(hi + 16 * i);
    uint4 b;
    b.x = lo_of_raw(a.x);
    b.y = lo_of_raw(a.y);
    b.z = lo_of_raw(a.z);
    b.w = lo_of_raw(a.w);
    *reinterpret_cast<uint4*>(lo + 16 * i) = b;
  }
}

// One chunk's products for one warpgroup: 4 k-steps of lo_a hi_w, hi_a
// lo_w, hi_a hi_w into part (overwritten at the first when `fresh`).
// Issued and committed.
__device__ __forceinline__ void issue_chunk(float (&part)[80], uint32_t a_hi,
                                            uint32_t a_lo, uint32_t w_hi,
                                            uint32_t w_lo, int fresh) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kCvBK / 8; ++kk) {
    const uint32_t o = 32 * kk;
    wgmma_tf32_ss160(part, desc_sw128(a_lo + o), desc_sw128(w_hi + o),
                     kk == 0 ? !fresh : 1);
    wgmma_tf32_ss160(part, desc_sw128(a_hi + o), desc_sw128(w_lo + o), 1);
    wgmma_tf32_ss160(part, desc_sw128(a_hi + o), desc_sw128(w_hi + o), 1);
  }
  wgmma_commit();
}

// Grid (M tiles, Cout tiles, K splits); the split z walks chunks [z cps,
// min((z + 1) cps, chunks)) and writes out + z M Cout (bias null when the
// wrapper splits K: the reduce adds it).
template <int R>
__global__ void __launch_bounds__(kCvThreads, 1)
    conv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                           const float* __restrict__ x,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int Cin, int H, int W,
                           int Cout, int Ho, int Wo, int stride, int pad,
                           int K, int M, int chunks, int cps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw_base);
  const uint32_t full0 = base + kCvBar;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kCvBM;
  const int n0 = blockIdx.y * kCvBN;
  const int first = blockIdx.z * cps;
  const int n = min(cps, chunks - first);

  if (tid == 0) {
    for (int s = 0; s < kCvStages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kCvStages - 1 && s < n; ++s) {
      mbar_expect_tx(full0 + 8 * s, kCvWTile);
      tma_load_2d(base + s * kCvWTile, &tw, full0 + 8 * s,
                  (first + s) * kCvBK, n0);
    }
  }

  // this thread's gather: pixels prow[pp] of the tile, 4-k groups c0, c0 + 4
  const int HWo = Ho * Wo;
  const int c0 = lane >> 3;
  int prow[2], xoff[2], ih0[2], iw0[2];
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    prow[pp] = (lane & 7) + 8 * warp + 64 * pp;
    const int m = m0 + prow[pp];
    if (m < M) {
      const int nn = m / HWo;
      const int rem = m - nn * HWo;
      const int oh = rem / Wo;
      const int ow = rem - oh * Wo;
      ih0[pp] = oh * stride - pad;
      iw0[pp] = ow * stride - pad;
      xoff[pp] = nn * Cin * H * W + ih0[pp] * W + iw0[pp];
    } else {
      ih0[pp] = INT_MIN / 2;  // every tap out of bounds
      iw0[pp] = 0;
      xoff[pp] = 0;
    }
  }

  float raw[16];
  gather<R>(raw, x, xoff, ih0, iw0, first * kCvBK, c0, K, H, W);
  store_a(raw, sm + kCvAhi, sm + kCvAlo, prow, c0);
  mbar_wait(full0, 0);
  split_w(sm, sm + kCvWlo, tid);
  if (n > 1) {
    gather<R>(raw, x, xoff, ih0, iw0, (first + 1) * kCvBK, c0, K, H, W);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = warp >> 2;
  float acc[80], part[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = part[i] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int s = i % kCvStages;
    const int b = i & 1;
    const uint32_t a_off = b * kCvATile + wg * 64 * 128;
    issue_chunk(part, base + kCvAhi + a_off, base + kCvAlo + a_off,
                base + s * kCvWTile, base + kCvWlo + b * kCvWTile,
                i % kCvFold == 0);
    // the stage of chunk i - 1 is free: its products ended before the
    // last barrier
    if (tid == 0 && i + kCvStages - 1 < n) {
      const int t = (i + kCvStages - 1) % kCvStages;
      mbar_expect_tx(full0 + 8 * t, kCvWTile);
      tma_load_2d(base + t * kCvWTile, &tw, full0 + 8 * t,
                  (first + i + kCvStages - 1) * kCvBK, n0);
    }
    if (i + 1 < n) {
      store_a(raw, sm + kCvAhi + (b ^ 1) * kCvATile,
              sm + kCvAlo + (b ^ 1) * kCvATile, prow, c0);
      if (i + 2 < n) {
        gather<R>(raw, x, xoff, ih0, iw0, (first + i + 2) * kCvBK, c0, K, H,
                  W);
      }
      const int s1 = (i + 1) % kCvStages;
      mbar_wait(full0 + 8 * s1, ((i + 1) / kCvStages) & 1);
      split_w(sm + s1 * kCvWTile, sm + kCvWlo + (b ^ 1) * kCvWTile, tid);
      fence_proxy_async();
    }
    wgmma_wait0();
    fence_regs(part);
    if (i % kCvFold == kCvFold - 1 || i == n - 1) {
#pragma unroll
      for (int j = 0; j < 80; ++j) acc[j] += part[j];
    }
    __syncthreads();
  }

  // register 4 j + e: column 8 j + 2 t + (e & 1), row + 8 when e >= 2
  const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int t4 = lane & 3;
  float* dst = out + static_cast<long>(blockIdx.z) * M * Cout;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = m0 + row0 + 8 * rr;
    if (m >= M) continue;
    const int nn = m / HWo;
    float* o = dst + static_cast<long>(nn) * Cout * HWo + (m - nn * HWo);
#pragma unroll
    for (int j = 0; j < kCvBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + 8 * j + 2 * t4 + e;
        if (co < Cout) {
          const float v = acc[4 * j + 2 * rr + e];
          o[static_cast<long>(co) * HWo] =
              bias != nullptr ? v + __ldg(bias + co) : v;
        }
      }
    }
  }
}

// out[i] = sum_z ws[z numel + i] (z in order) + bias[channel of i].
__global__ void conv_splitk_reduce_kernel(const float* __restrict__ ws,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, long numel,
                                          int splits, int Cout, int HWo) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < numel; i += static_cast<long>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int z = 1; z < splits; ++z) v += ws[z * numel + i];
    if (bias != nullptr) v += __ldg(bias + (i / HWo) % Cout);
    out[i] = v;
  }
}

// The map of the weight as a [Cout, K] fp32 matrix with box {32, 160}: a
// chunk of 32 k (one 128-byte swizzled row) for 160 output channels,
// zero-filled past K and Cout.
bool weight_map(CUtensorMap* map, const void* w, int K, int Cout) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(Cout)};
  const cuuint64_t strides[1] = {4ull * K};
  const cuuint32_t box[2] = {kCvBK, kCvBN};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [N, Cin, H, W], w [Cout, Cin, R, R], bias [Cout] or null, out [N, Cout,
// Ho, Wo]: fp32, contiguous, w 16-byte aligned (its TMA map; the others are
// read and written a float at a time).  R 1 or 3, stride >= 1, pad
// >= 0, Cin R R % 4 == 0 (the weight map's row stride), x and out under
// 2^31 elements.  splits: K ranges of ceil(chunks / splits) chunks of 32,
// each non-empty (ops/conv.py::split_k); above 1, ws holds splits x the
// output's floats.
extern "C" int gsgen_conv2d_3xtf32(const void* x, const void* w,
                                   const void* bias, void* out, void* ws,
                                   int N, int Cin, int H, int W, int Cout,
                                   int R, int stride, int pad, int splits,
                                   void* stream) {
  if ((R != 1 && R != 3) || stride < 1 || pad < 0 || N <= 0 || Cin <= 0 ||
      Cout <= 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Ho = (H + 2 * pad - R) / stride + 1;
  const int Wo = (W + 2 * pad - R) / stride + 1;
  const long K = static_cast<long>(Cin) * R * R;
  const long M = static_cast<long>(N) * Ho * Wo;
  if (H + 2 * pad < R || W + 2 * pad < R || K % 4 != 0 ||
      static_cast<long>(N) * Cin * H * W >= INT_MAX ||
      M * Cout >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = static_cast<int>((K + kCvBK - 1) / kCvBK);
  const int cps = (chunks + splits - 1) / splits;
  if (static_cast<long>(splits - 1) * cps >= chunks ||
      (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long m_tiles = (M + kCvBM - 1) / kCvBM;
  const int n_tiles = (Cout + kCvBN - 1) / kCvBN;
  if (m_tiles > INT_MAX || n_tiles > 65535 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tw;
  if (!weight_map(&tw, w, static_cast<int>(K), Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* dst = static_cast<float*>(splits > 1 ? ws : out);
  const auto* b = splits > 1 ? nullptr : static_cast<const float*>(bias);
  const dim3 grid(static_cast<unsigned>(m_tiles), n_tiles, splits);
  auto* kernel =
      R == 3 ? &conv_tf32_wgmma_kernel<3> : &conv_tf32_wgmma_kernel<1>;
  const int err = launch(
      kernel, grid, kCvThreads, kCvSmem, s, tw, static_cast<const float*>(x),
      b, dst, Cin, H, W, Cout, Ho, Wo, stride, pad, static_cast<int>(K),
      static_cast<int>(M), chunks, cps);
  if (err != 0 || splits == 1) return err;
  const long numel = M * Cout;
  const long blocks = (numel + 255) / 256 < 2048 ? (numel + 255) / 256 : 2048;
  return launch(conv_splitk_reduce_kernel,
                dim3(static_cast<unsigned>(blocks)), 256, 0, s,
                static_cast<const float*>(ws),
                static_cast<const float*>(bias), static_cast<float*>(out),
                numel, splits, Cout, Ho * Wo);
}
