// Helpers shared by the flash-attention kernels K5 (flash_attn_fwd.cu) and
// K6/K7 (flash_attn_bwd.cu): tile sizes, bf16 packing and the launch.  The
// Hopper blocks (TMA, mbarrier, wgmma, 3xTF32) are in flash_attn_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBlockK = 64;   // keys per block (K6 fp32 mma.sync)
constexpr int kMaxD = 160;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
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
