// Shared definitions of the tile compositing kernels (raster_fwd.cu,
// raster_bwd.cu).
//
// Layouts (kept from the TPU kernels, the JAX package's ops/pallas_raster.py:27-30):
//   dup  [16, cap]               rows: mx my ca cb cc alpha f0..f9
//   out  [n_tiles, ch_out, P]    rows: F features, then T at row F, then the
//                                processed-chunk count at row ch_out-1
//   grad [16, cap]               same rows as dup
// P = tile_size^2 pixels per tile; one thread per pixel, one block per tile.
// Padded layout (K1, K2): tile t owns the chunk-aligned rows [starts[t],
// starts[t] + nchunks[t]*K).  Compact layout (K8, K9): tile t owns the rows
// [starts[t], ends[t]) and walks the K-aligned windows that cover them.
#pragma once

#include <cuda_runtime.h>

#define GSGEN_D_ROWS 16
#define GSGEN_MAX_F 10

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

// Copy chunk rows 0..nrows-1 (columns [base, base+K)) of dup into shared
// memory as [nrows, K].  Caller synchronises.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ dup,
                                            long long cap, long long base,
                                            int nrows, int K, float* sm) {
  for (int idx = threadIdx.x; idx < nrows * K; idx += blockDim.x) {
    const int r = idx / K;
    const int c = idx - r * K;
    sm[idx] = dup[static_cast<long long>(r) * cap + base + c];
  }
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

// Per-lane Gaussian weight: returns aG (zeroed below 1/255) and writes the
// intermediates the backward needs.
__device__ __forceinline__ float lane_weight(const float* sm, int K, int k,
                                             float pixx, float pixy,
                                             float* dx, float* dy,
                                             float* radial, float* G,
                                             float* a_cl) {
  const float mx = sm[k];
  const float my = sm[K + k];
  const float ca = sm[2 * K + k];
  const float cb = sm[3 * K + k];
  const float cc = sm[4 * K + k];
  const float al = sm[5 * K + k];
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
