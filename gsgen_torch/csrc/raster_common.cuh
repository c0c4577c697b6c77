// Shared definitions of the tile compositing kernels (raster_fwd.cu,
// raster_bwd.cu).
//
// Layouts (kept from the TPU kernels, the JAX package's ops/pallas_raster.py:27-30):
//   dup  [16, cap]               rows: mx my ca cb cc alpha f0..f9
//   out  [n_tiles, ch_out, P]    rows: F features, then T at row F, then the
//                                processed-chunk count at row ch_out-1
//   grad [16, cap]               same rows as dup
// P = tile_size^2 pixels per tile; one thread per pixel, one block per tile.
//
// One walk serves both binning layouts.  Tile t owns the rows [starts[t],
// ends[t]) of dup and walks counts[t] K-aligned windows from
// floor(start/K)*K; in window i only the lanes [k_lo, k_hi) hold its rows.
// Padded layout (K1, K2): starts are chunk-aligned and counts are
// ceil((end - start)/K), so k_lo = 0 and k_hi = min(K, end - wbase): the
// lanes at or past ends[t] (sentinel rows, alpha 0) are never walked.
// Compact layout (K8, K9): counts are the window counts, and a boundary
// window's lanes outside [k_lo, k_hi) are a neighbour's rows.
//
// Staging: a ring of two [6+F, K] stages in dynamic shared memory, each with
// an mbarrier.  One thread issues window i+1's bulk copies (one per row,
// lanes [k_lo & ~3, (k_hi + 3) & ~3): 16-byte aligned since cap and K are
// multiples of 4 and a window starts at a multiple of K) right after the
// barrier that ends window i-1's reads, so the copy runs while the block
// composites window i.
#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_async.cuh"

#define GSGEN_D_ROWS 16
#define GSGEN_MAX_F 10

namespace {

// float32(0.99) and float32(1/255), bit-exact with the Python side.
__device__ __forceinline__ float alpha_clamp() { return __int_as_float(0x3f7d70a4); }
__device__ __forceinline__ float min_render_alpha() { return __int_as_float(0x3b808081); }

// Camera-plane position of this thread's pixel (same rounding order as the
// plain version: topleft + float(global_pixel) * pixel_size).
__device__ __forceinline__ void pixel_coords(int t, int p, int n_tiles_w,
                                             int tile_size,
                                             const float* __restrict__ geom,
                                             float* pixx, float* pixy) {
  const int ty = t / n_tiles_w;
  const int tx = t - ty * n_tiles_w;
  const int px = p % tile_size + tx * tile_size;
  const int py = p / tile_size + ty * tile_size;
  *pixx = geom[0] + static_cast<float>(px) * geom[2];
  *pixy = geom[1] + static_cast<float>(py) * geom[3];
}

// Lanes [k_lo, k_hi) of the window starting at row wbase that hold rows of
// [start, end); empty when the window holds none of them.
__device__ __forceinline__ void window_lanes(long long start, long long end,
                                             long long wbase, int K,
                                             int* k_lo, int* k_hi) {
  const long long lo = start - wbase;
  const long long hi = end - wbase;
  *k_lo = lo > 0 ? static_cast<int>(lo) : 0;
  *k_hi = hi < K ? static_cast<int>(hi) : K;
}

// Dynamic shared memory of the stage ring, in floats.
__host__ __device__ __forceinline__ int ring_floats(int K, int F) {
  return 2 * (6 + F) * K;
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The ring's mbarriers, in static shared memory.
struct Ring {
  uint64_t bar[2];
};

__device__ __forceinline__ void ring_init(Ring* ring) {
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&ring->bar[0]), 1);
    mbar_init(smem_u32(&ring->bar[1]), 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// One thread: copy lanes [k_lo, k_hi) (widened to 16 bytes) of the window
// at row wbase into stage i & 1 of the ring `sm` and arm its barrier.
__device__ __forceinline__ void ring_issue(Ring* ring, float* sm, int i,
                                           const float* __restrict__ dup,
                                           long long cap, long long wbase,
                                           int k_lo, int k_hi, int nrows,
                                           int K) {
  const int c0 = k_lo & ~3;
  const int c1 = (k_hi + 3) & ~3;
  const uint32_t row_bytes = k_hi > k_lo ? 4u * (c1 - c0) : 0u;
  const uint32_t bar = smem_u32(&ring->bar[i & 1]);
  float* stage = sm + (i & 1) * nrows * K;
  mbar_expect_tx(bar, row_bytes * nrows);
  if (row_bytes == 0) return;
  for (int r = 0; r < nrows; ++r)
    bulk_load(smem_u32(stage + r * K + c0),
              dup + static_cast<long long>(r) * cap + wbase + c0, row_bytes,
              bar);
}

// Wait for window i's copy; returns its stage.
__device__ __forceinline__ const float* ring_wait(Ring* ring, const float* sm,
                                                  int i, int nrows, int K) {
  mbar_wait(smem_u32(&ring->bar[i & 1]), (i >> 1) & 1);
  return sm + (i & 1) * nrows * K;
}

// Per-lane Gaussian weight: returns aG (zeroed below 1/255) and writes the
// intermediates the backward needs.
__device__ __forceinline__ float gauss_weight(float mx, float my, float ca,
                                              float cb, float cc, float al,
                                              float pixx, float pixy,
                                              float* dx, float* dy,
                                              float* radial, float* G,
                                              float* a_cl) {
  *dx = pixx - mx;
  *dy = pixy - my;
  float r = ca * *dx * *dx + 2.0f * cb * *dx * *dy + cc * *dy * *dy;
  r = fmaxf(r, 0.0f);
  *radial = r;
  *G = expf(-0.5f * r);
  *a_cl = fminf(al, alpha_clamp());
  float aG = *a_cl * *G;
  if (aG < min_render_alpha()) aG = 0.0f;
  return aG;
}

}  // namespace
