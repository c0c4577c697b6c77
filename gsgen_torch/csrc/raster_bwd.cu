// K2 and K9: tile compositing backward.
//
// Replaces the JAX package's ops/pallas_raster.py::_bwd_kernel_v2 (resident
// cotangents) and ::_bwd_kernel (streaming, above the TPU's VMEM budget):
// both compute the same gradient, and the VMEM budget that picks between them
// has no meaning here, so one kernel serves both call conditions.
//
// One block per tile, one thread per pixel.  The block walks the tile's
// min(nchunks, processed-chunk count of the forward) chunks; chunks the
// forward skipped have exactly-zero gradient and the wrapper's zero-filled
// buffer already holds it.  Each thread recomputes its pixel's forward lane
// by lane (same recurrence as raster_fwd.cu) with per-pixel carries T and S
// (the running dot(g, accumulated features)), and takes d/d(aG) by the
// suffix trick of the reference CUDA backward (vol_render.h:383-399):
//   daG = gof*T_run - (dotfinal - accum_dot + g_T*T_final) / max(1-aG, 1e-6)
// dotfinal = dot(g, final features) and g_T*T_final are formed per pixel
// from the forward output and its cotangent at the tile's start.
//
// Per-Gaussian gradients are sums over the tile's P pixels: for each lane a
// warp reduces its 32 pixels with shuffles (skipped when no pixel of the
// warp touches the lane), the warp sums land in shared memory, and after
// every 32 lanes the block adds the warps' partial sums and writes the
// tile's own rows of grad.  The padded layout gives every tile exclusive
// chunks, so no atomics are needed and the result is deterministic.
//
// K9, the kCompact instance, replaces ops/pallas_raster.py::_bwd_kernel_v3
// (compact layout).  The TPU kernel runs a strictly sequential grid of
// (tile, window) steps and merges a boundary window that two tiles share by
// revisiting its output block.  Blocks here run in no order, so K9 keeps one
// block per tile and relies on the rows instead: tile t's rows [starts[t],
// ends[t]) are disjoint from every other tile's.  The block walks
// min(wcount, processed count of the forward) windows from floor(start/K)*K,
// masks the lanes outside its rows (aG = 0, exactly zero gradient) and
// stores only its own lanes, so two blocks sharing a window write disjoint
// rows of the zero-filled buffer: no atomics, deterministic.
//
// Bound on this card: operations -- per lane and pixel ~60 flops, an exp and
// 5*(6+F) shuffle steps; bytes are dup read once and grad written once.  The
// shuffles are the cost this simple design accepts; a later version can
// transpose-reduce 32 lanes at once.
#include "raster_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <bool kCompact>
__global__ void raster_bwd_kernel(const float* __restrict__ dup, long long cap,
                                  const float* __restrict__ out,
                                  const float* __restrict__ g,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ ends,
                                  const int* __restrict__ nchunks,
                                  const float* __restrict__ geom,
                                  float* __restrict__ grad, int n_tiles_w,
                                  int tile_size, int K, int F, int ch_out,
                                  float T_thresh) {
  extern __shared__ float sm[];  // chunk [6 + F, K], then red [NW, 6 + F, 32]
  const int nrows = 6 + F;
  float* red = sm + nrows * K;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int NW = P >> 5;
  const int warp = p >> 5;
  const int lane = p & 31;
  float pixx, pixy;
  pixel_coords(t, p, n_tiles_w, tile_size, geom, &pixx, &pixy);

  const float* o = out + static_cast<long long>(t) * ch_out * P;
  const float* gt = g + static_cast<long long>(t) * ch_out * P;
  const int nckeff = static_cast<int>(o[(ch_out - 1) * P]);
  const int nck = min(nchunks[t], nckeff);
  const long long start = starts[t];
  const long long end = kCompact ? ends[t] : 0;
  const long long first = kCompact ? start / K * K : start;

  float gfe[GSGEN_MAX_F];
  float dotfinal = 0.0f;
#pragma unroll
  for (int f = 0; f < GSGEN_MAX_F; ++f) {
    gfe[f] = f < F ? gt[f * P + p] : 0.0f;
    if (f < F) dotfinal += gfe[f] * o[f * P + p];
  }
  const float gT_Tf = gt[F * P + p] * o[F * P + p];

  float T = 1.0f;
  float S = 0.0f;
  for (int i = 0; i < nck; ++i) {
    const long long base = first + static_cast<long long>(i) * K;
    __syncthreads();  // previous chunk's readers are done with sm
    stage_chunk(dup, cap, base, nrows, K, sm);
    __syncthreads();
    // lanes of this tile in the window (all of them in the padded layout)
    int k_lo = 0, k_hi = K;
    if (kCompact) window_lanes(start, end, base, K, &k_lo, &k_hi);

    float cp = 1.0f;
    float qmin = __int_as_float(0x7f800000);  // +inf
    float incl = 0.0f;
    for (int kb = 0; kb < K; kb += 32) {
      // groups with no lane of this tile: nothing to compute or store
      if (kCompact && (kb + 32 <= k_lo || kb >= k_hi)) continue;
      // lanes past every pixel's cutoff have zero gradient (buffer is zero)
      if (!__syncthreads_or(T * cp >= T_thresh)) break;
      const int nl = min(32, K - kb);
      for (int kk = 0; kk < nl; ++kk) {
        const int k = kb + kk;
        const float T_run = T * cp;
        const bool processed = T_run >= T_thresh;
        float c[GSGEN_D_ROWS];
#pragma unroll
        for (int r = 0; r < GSGEN_D_ROWS; ++r) c[r] = 0.0f;
        bool nz = false;
        float om = 1.0f;
        if (processed) {
          float dx = 0.0f, dy = 0.0f, radial = 0.0f, G = 0.0f, a_cl = 0.0f;
          // a masked lane (another tile's row) is aG = 0: no gradient
          const float aG = (!kCompact || (k >= k_lo && k < k_hi))
                               ? lane_weight(sm, K, k, pixx, pixy, &dx, &dy,
                                             &radial, &G, &a_cl)
                               : 0.0f;
          om = 1.0f - aG;
          const float w = aG * T_run;
          float gof = 0.0f;
#pragma unroll
          for (int f = 0; f < GSGEN_MAX_F; ++f)
            if (f < F) gof += gfe[f] * sm[(6 + f) * K + k];
          incl += w * gof;
          if (aG > 0.0f) {
            nz = true;
            const float accum_dot = S + incl;
            const float suffix = dotfinal - accum_dot;
            const float daG =
                gof * T_run - (suffix + gT_Tf) / fmaxf(om, 1e-6f);
            const float dG = daG * a_cl;
            const float dr = radial > 0.0f ? -0.5f * G * dG : 0.0f;
            const float ca = sm[2 * K + k];
            const float cb = sm[3 * K + k];
            const float cc = sm[4 * K + k];
            c[0] = dr * -(2.0f * ca * dx + 2.0f * cb * dy);
            c[1] = dr * -(2.0f * cb * dx + 2.0f * cc * dy);
            c[2] = dr * dx * dx;
            c[3] = dr * 2.0f * dx * dy;
            c[4] = dr * dy * dy;
            c[5] = daG * G;
#pragma unroll
            for (int f = 0; f < GSGEN_MAX_F; ++f)
              if (f < F) c[6 + f] = gfe[f] * w;
          }
          qmin = fminf(qmin, cp * om);
          cp = cp * om;
        }
        float* rw = red + warp * nrows * 32 + kk;
        if (__any_sync(kFull, nz)) {
#pragma unroll
          for (int r = 0; r < GSGEN_D_ROWS; ++r) {
            if (r < nrows) {
              const float v = warp_sum(c[r]);
              if (lane == 0) rw[r * 32] = v;
            }
          }
        } else if (lane == 0) {
          for (int r = 0; r < nrows; ++r) rw[r * 32] = 0.0f;
        }
      }
      __syncthreads();
      for (int idx = p; idx < nrows * nl; idx += P) {
        const int r = idx / nl;
        const int kk = idx - r * nl;
        // K9 stores only its own lanes: the others belong to a neighbour
        if (kCompact && (kb + kk < k_lo || kb + kk >= k_hi)) continue;
        float s = 0.0f;
        for (int wi = 0; wi < NW; ++wi) s += red[(wi * nrows + r) * 32 + kk];
        if (r == 5) s = s * (sm[5 * K + kb + kk] < alpha_clamp() ? 1.0f : 0.0f);
        grad[static_cast<long long>(r) * cap + base + kb + kk] = s;
      }
    }
    T = T * fminf(qmin, 1.0f);
    S = S + incl;
  }
}

}  // namespace

extern "C" int gsgen_raster_bwd(const float* dup, long long cap,
                                const float* out, const float* g,
                                const int* starts, const int* nchunks,
                                const float* geom, float* grad, int n_tiles,
                                int n_tiles_w, int tile_size, int K, int F,
                                int ch_out, float T_thresh, void* stream) {
  const int P = tile_size * tile_size;
  const size_t smem = sizeof(float) * (6 + F) * (K + (P / 32) * 32);
  raster_bwd_kernel<false>
      <<<n_tiles, P, smem, static_cast<cudaStream_t>(stream)>>>(
          dup, cap, out, g, starts, nullptr, nchunks, geom, grad, n_tiles_w,
          tile_size, K, F, ch_out, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

// K9: starts/ends are the compact segments, wcount the window counts; grad
// must be zero-filled (rows no block owns stay zero).
extern "C" int gsgen_raster_bwd_compact(const float* dup, long long cap,
                                        const float* out, const float* g,
                                        const int* starts, const int* ends,
                                        const int* wcount, const float* geom,
                                        float* grad, int n_tiles,
                                        int n_tiles_w, int tile_size, int K,
                                        int F, int ch_out, float T_thresh,
                                        void* stream) {
  const int P = tile_size * tile_size;
  const size_t smem = sizeof(float) * (6 + F) * (K + (P / 32) * 32);
  raster_bwd_kernel<true>
      <<<n_tiles, P, smem, static_cast<cudaStream_t>(stream)>>>(
          dup, cap, out, g, starts, ends, wcount, geom, grad, n_tiles_w,
          tile_size, K, F, ch_out, T_thresh);
  return static_cast<int>(cudaGetLastError());
}
