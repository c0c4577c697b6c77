// Helpers shared by the flash-attention kernels K5 (flash_attn_fwd.cu) and
// K6/K7 (flash_attn_bwd.cu): bf16 packing, the mma.sync m16n8k16 product,
// and tile copies from [B, L, H, D] rows into shared memory.  The Hopper
// blocks (TMA, mbarrier, wgmma, 3xTF32) are in flash_attn_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // queries per tile (mma.sync kernels, K7)
constexpr int kBlockK = 64;   // keys per tile (mma.sync kernels, K6 fp32)
constexpr int kMaxD = 160;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col).  Fragment
// layouts (lane = 4g + t):
//   A: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//      a3 = A[g+8][2t+8..];   B: b0 = B[2t..2t+1][g], b1 = B[2t+8..][g];
//   C: c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows row0..row0+15, head dims kt*16.. of a bf16 tile in
// shared memory (row stride `stride` elements).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* tile,
                                            int stride, int row0, int kt,
                                            int g, int t) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + g + (r & 1) * 8;
    const int col = kt * 16 + 2 * t + (r >> 1) * 8;
    a[r] = *reinterpret_cast<const uint32_t*>(tile + row * stride + col);
  }
}

// 64 rows x D of a [B, L, H, D] tensor (row `row0` on, `base` the offset of
// (b, 0, h, 0), `row_stride` = H * D) into shared memory rows of `stride`
// elements, 16 bytes a copy.  T is float or __nv_bfloat16.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int stride, const T* src,
                                          long base, long row_stride,
                                          int row0, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = D / kVec;
  for (int i = threadIdx.x; i < kBlockQ * vec; i += blockDim.x) {
    const int r = i / vec;
    const int c = (i - r * vec) * kVec;
    *reinterpret_cast<uint4*>(dst + r * stride + c) =
        *reinterpret_cast<const uint4*>(src + base + (row0 + r) * row_stride +
                                        c);
  }
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

}  // namespace
