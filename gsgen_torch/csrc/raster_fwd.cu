// K1 and K8: tile compositing forward.
//
// K1 replaces the JAX package's ops/pallas_raster.py::_fwd_kernel (padded
// layout, built by _make_core); K8, the kCompact instance of the same
// template, replaces _fwd_kernel(compact=True) (built by _make_core_compact).
// The TPU kernel
// turns each pixel's front-to-back recurrence into an exclusive cumprod over
// a [P, K] chunk (lane rolls) plus one matmul; here each thread walks its
// pixel's lanes sequentially, which is the exact scan (the fast_fwd_cumprod
// matmul approximation is not ported: the flag is accepted and ignored).
//
// Per chunk of K depth-sorted rows: T_run = T * cp (cp the running product of
// 1 - aG within the chunk), a lane counts while T_run >= T_thresh ("check
// before, update after"), and at the chunk's end T *= min(1, min over counted
// lanes of cp*om) -- the TPU kernel's _update_T, which equals the product
// through the last counted lane.  Counted lanes form a prefix, so a thread
// stops at its first uncounted lane.  The block leaves between chunks once
// no pixel has T >= T_thresh (__syncthreads_or) and writes the number of
// chunks it processed to row ch_out-1: the backward walks only those.
//
// K8 (compact layout): tile t owns the unaligned rows [starts[t], ends[t]) of
// the sorted table and walks the K-aligned windows from floor(start/K)*K,
// wcount = ceil(end/K) - floor(start/K) of them.  A boundary window also
// holds a neighbour's rows; those lanes are masked (aG = 0: they change
// neither T nor the features), so the walk covers only lanes [k_lo, k_hi)
// of each window.  An empty tile whose start is not a multiple of K has
// wcount 1: it walks one all-masked window and writes 1 to the count row,
// as the TPU kernel does.
//
// Bound on this card: with one block of P threads per tile and the chunk
// staged once in shared memory (16 x K floats, read by all P threads), dup is
// read from device memory once; the work is P*K lanes of ~20 flops and an
// exp per processed chunk, so the kernel is bound by operations (fp32 and
// SFU), and by the serial lane walk of each pixel.
#include "raster_common.cuh"

namespace {

template <bool kCompact>
__global__ void raster_fwd_kernel(const float* __restrict__ dup, long long cap,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ ends,
                                  const int* __restrict__ nchunks,
                                  const float* __restrict__ geom,
                                  float* __restrict__ out, int n_tiles_w,
                                  int tile_size, int K, int F, int ch_out,
                                  float T_thresh) {
  extern __shared__ float sm[];  // [6 + F, K]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  float pixx, pixy;
  pixel_coords(t, p, n_tiles_w, tile_size, geom, &pixx, &pixy);
  const long long start = starts[t];
  const long long end = kCompact ? ends[t] : 0;
  const long long base = kCompact ? start / K * K : start;
  const int nck = nchunks[t];
  const int nrows = 6 + F;

  float T = 1.0f;
  float acc[GSGEN_MAX_F];
#pragma unroll
  for (int f = 0; f < GSGEN_MAX_F; ++f) acc[f] = 0.0f;

  int i = 0;
  while (true) {
    // a full barrier: also keeps the previous chunk's readers ahead of the
    // next chunk's stage
    const int alive = __syncthreads_or(T >= T_thresh);
    if (i >= nck || !alive) break;
    const long long wbase = base + static_cast<long long>(i) * K;
    stage_chunk(dup, cap, wbase, nrows, K, sm);
    __syncthreads();
    // lanes of this tile in the window (all of them in the padded layout)
    int k_lo = 0, k_hi = K;
    if (kCompact) window_lanes(start, end, wbase, K, &k_lo, &k_hi);

    float cp = 1.0f;
    float qmin = __int_as_float(0x7f800000);  // +inf
    float part[GSGEN_MAX_F];
#pragma unroll
    for (int f = 0; f < GSGEN_MAX_F; ++f) part[f] = 0.0f;
    for (int k = k_lo; k < k_hi; ++k) {
      const float T_run = T * cp;
      if (!(T_run >= T_thresh)) break;
      float dx, dy, radial, G, a_cl;
      const float aG = lane_weight(sm, K, k, pixx, pixy, &dx, &dy, &radial,
                                   &G, &a_cl);
      const float om = 1.0f - aG;
      const float w = aG * T_run;
#pragma unroll
      for (int f = 0; f < GSGEN_MAX_F; ++f)
        if (f < F) part[f] += sm[(6 + f) * K + k] * w;
      qmin = fminf(qmin, cp * om);
      cp = cp * om;
    }
#pragma unroll
    for (int f = 0; f < GSGEN_MAX_F; ++f) acc[f] += part[f];
    T = T * fminf(qmin, 1.0f);
    ++i;
  }

  float* o = out + static_cast<long long>(t) * ch_out * P;
#pragma unroll
  for (int f = 0; f < GSGEN_MAX_F; ++f)
    if (f < F) o[f * P + p] = acc[f];
  o[F * P + p] = T;
  for (int r = F + 1; r < ch_out - 1; ++r) o[r * P + p] = 0.0f;
  o[(ch_out - 1) * P + p] = static_cast<float>(i);
}

}  // namespace

extern "C" int gsgen_raster_fwd(const float* dup, long long cap,
                                const int* starts, const int* nchunks,
                                const float* geom, float* out, int n_tiles,
                                int n_tiles_w, int tile_size, int K, int F,
                                int ch_out, float T_thresh, void* stream) {
  const int P = tile_size * tile_size;
  const size_t smem = sizeof(float) * (6 + F) * K;
  raster_fwd_kernel<false>
      <<<n_tiles, P, smem, static_cast<cudaStream_t>(stream)>>>(
          dup, cap, starts, nullptr, nchunks, geom, out, n_tiles_w, tile_size,
          K, F, ch_out, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

// K8: starts/ends are the compact segments, wcount the window counts.
extern "C" int gsgen_raster_fwd_compact(const float* dup, long long cap,
                                        const int* starts, const int* ends,
                                        const int* wcount, const float* geom,
                                        float* out, int n_tiles,
                                        int n_tiles_w, int tile_size, int K,
                                        int F, int ch_out, float T_thresh,
                                        void* stream) {
  const int P = tile_size * tile_size;
  const size_t smem = sizeof(float) * (6 + F) * K;
  raster_fwd_kernel<true>
      <<<n_tiles, P, smem, static_cast<cudaStream_t>(stream)>>>(
          dup, cap, starts, ends, wcount, geom, out, n_tiles_w, tile_size, K,
          F, ch_out, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gsgen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
