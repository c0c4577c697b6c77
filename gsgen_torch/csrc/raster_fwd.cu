// K1 and K8: tile compositing forward.
//
// K1 replaces the JAX package's ops/pallas_raster.py::_fwd_kernel (padded
// layout, built by _make_core); K8, the same kernel on the compact layout,
// replaces _fwd_kernel(compact=True) (built by _make_core_compact).  The TPU
// kernel turns each pixel's front-to-back recurrence into an exclusive
// cumprod over a [P, K] chunk (lane rolls) plus one matmul; here each thread
// walks its pixel's lanes sequentially, which is the exact scan (the
// fast_fwd_cumprod matmul approximation is not ported: the flag is accepted
// and ignored).
//
// Per window of K depth-sorted rows: T_run = T * cp (cp the running product
// of 1 - aG within the window), a lane counts while T_run >= T_thresh
// ("check before, update after"), and at the window's end T *= min(1, min
// over counted lanes of cp*om) -- the TPU kernel's _update_T, which equals
// the product through the last counted lane.  Counted lanes form a prefix,
// so a thread stops at its first uncounted lane.  A lane with aG = 0 changes
// neither cp, the features nor that minimum, so only lanes with aG > 0 do
// the update.  The block leaves between windows once no pixel has T >=
// T_thresh (__syncthreads_or) and writes the number of windows it processed
// to row ch_out-1: the backward walks only those.  An empty compact tile
// whose start is not a multiple of K has one window: it walks no lane and
// writes 1, as the TPU kernel does.
//
// The walk (raster_common.cuh) covers only the tile's own rows: in the
// padded layout it ends at ends[t], so the padding lanes of a tile's last
// chunk -- ~94% of the lanes at configs/base.yaml's sparse render -- cost
// nothing.  Windows arrive by bulk copy into a two-stage ring, the next one
// in flight while this one is composited; a block that leaves early waits
// for its copy in flight before it exits.
//
// Bound on this card: dup is read from device memory once; the work is a
// serial fp32 recurrence per pixel, ~23+2F flops and an exp a lane, so it is
// bound by operations (fp32 and SFU) and by each pixel's serial walk.
// Tensor cores do not apply: nothing here is a product of matrices.  With
// one scalar shared load per row and lane the shared-memory pipe (one warp
// instruction a clock an SM, against four for fp32) set the pace, so each
// thread reads four lanes of the six geometry rows with one 16-byte load
// each (the stage is row-major), and a lane's F feature values only where
// its aG > 0: 6/4 shared loads a lane, plus F where the Gaussian covers the
// pixel.
#include "raster_common.cuh"

namespace {

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__global__ void raster_fwd_kernel(const float* __restrict__ dup, long long cap,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ ends,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ geom,
                                  float* __restrict__ out, int n_tiles_w,
                                  int tile_size, int K, int F, int ch_out,
                                  float T_thresh) {
  extern __shared__ __align__(16) float sm[];  // ring [2][6 + F][K]
  __shared__ Ring ring;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  float pixx, pixy;
  pixel_coords(t, p, n_tiles_w, tile_size, geom, &pixx, &pixy);
  const long long start = starts[t];
  const long long end = ends[t];
  const long long first = start / K * K;
  const int nck = counts[t];
  const int nrows = 6 + F;

  ring_init(&ring);
  if (p == 0 && nck > 0) {
    int k_lo, k_hi;
    window_lanes(start, end, first, K, &k_lo, &k_hi);
    ring_issue(&ring, sm, 0, dup, cap, first, k_lo, k_hi, nrows, K);
  }

  float T = 1.0f;
  float acc[GSGEN_MAX_F];
#pragma unroll
  for (int f = 0; f < GSGEN_MAX_F; ++f) acc[f] = 0.0f;

  int i = 0;
  while (true) {
    // a full barrier: every thread is done with window i-1's stage, which
    // window i+1's copy overwrites
    const int alive = __syncthreads_or(T >= T_thresh);
    if (i >= nck || !alive) break;
    if (p == 0 && i + 1 < nck) {
      const long long nbase = first + static_cast<long long>(i + 1) * K;
      int k_lo, k_hi;
      window_lanes(start, end, nbase, K, &k_lo, &k_hi);
      ring_issue(&ring, sm, i + 1, dup, cap, nbase, k_lo, k_hi, nrows, K);
    }
    int k_lo, k_hi;
    window_lanes(start, end, first + static_cast<long long>(i) * K, K, &k_lo,
                 &k_hi);
    const float* st = ring_wait(&ring, sm, i, nrows, K);

    float cp = 1.0f;
    float qmin = __int_as_float(0x7f800000);  // +inf
    float part[GSGEN_MAX_F];
#pragma unroll
    for (int f = 0; f < GSGEN_MAX_F; ++f) part[f] = 0.0f;
    bool stop = false;
    for (int kb = k_lo & ~3; kb < k_hi && !stop; kb += 4) {
      const float4 mx = lds4(st + kb);
      const float4 my = lds4(st + K + kb);
      const float4 ca = lds4(st + 2 * K + kb);
      const float4 cb = lds4(st + 3 * K + kb);
      const float4 cc = lds4(st + 4 * K + kb);
      const float4 al = lds4(st + 5 * K + kb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kb + j;
        if (k < k_lo || k >= k_hi) continue;
        const float T_run = T * cp;
        if (!(T_run >= T_thresh)) {
          stop = true;
          break;
        }
        float dx, dy, radial, G, a_cl;
        const float aG = gauss_weight(at(mx, j), at(my, j), at(ca, j),
                                      at(cb, j), at(cc, j), at(al, j), pixx,
                                      pixy, &dx, &dy, &radial, &G, &a_cl);
        if (aG > 0.0f) {
          const float om = 1.0f - aG;
          const float w = aG * T_run;
#pragma unroll
          for (int f = 0; f < GSGEN_MAX_F; ++f)
            if (f < F) part[f] += st[(6 + f) * K + k] * w;
          qmin = fminf(qmin, cp * om);
          cp = cp * om;
        }
      }
    }
#pragma unroll
    for (int f = 0; f < GSGEN_MAX_F; ++f) acc[f] += part[f];
    T = T * fminf(qmin, 1.0f);
    ++i;
  }
  // a block that left early has window i's copy in flight
  if (p == 0 && i < nck) ring_wait(&ring, sm, i, nrows, K);

  float* o = out + static_cast<long long>(t) * ch_out * P;
#pragma unroll
  for (int f = 0; f < GSGEN_MAX_F; ++f)
    if (f < F) o[f * P + p] = acc[f];
  o[F * P + p] = T;
  for (int r = F + 1; r < ch_out - 1; ++r) o[r * P + p] = 0.0f;
  o[(ch_out - 1) * P + p] = static_cast<float>(i);
}

int launch_fwd(const float* dup, long long cap, const int* starts,
               const int* ends, const int* counts, const float* geom,
               float* out, int n_tiles, int n_tiles_w, int tile_size, int K,
               int F, int ch_out, float T_thresh, void* stream) {
  const int P = tile_size * tile_size;
  const size_t smem = sizeof(float) * ring_floats(K, F);
  const cudaError_t e = smem_opt_in(raster_fwd_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  raster_fwd_kernel<<<n_tiles, P, smem, static_cast<cudaStream_t>(stream)>>>(
      dup, cap, starts, ends, counts, geom, out, n_tiles_w, tile_size, K, F,
      ch_out, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: starts/ends are the padded layout's, nchunks its chunk counts.
extern "C" int gsgen_raster_fwd(const float* dup, long long cap,
                                const int* starts, const int* ends,
                                const int* nchunks, const float* geom,
                                float* out, int n_tiles, int n_tiles_w,
                                int tile_size, int K, int F, int ch_out,
                                float T_thresh, void* stream) {
  return launch_fwd(dup, cap, starts, ends, nchunks, geom, out, n_tiles,
                    n_tiles_w, tile_size, K, F, ch_out, T_thresh, stream);
}

// K8: starts/ends are the compact segments, wcount the window counts.
extern "C" int gsgen_raster_fwd_compact(const float* dup, long long cap,
                                        const int* starts, const int* ends,
                                        const int* wcount, const float* geom,
                                        float* out, int n_tiles,
                                        int n_tiles_w, int tile_size, int K,
                                        int F, int ch_out, float T_thresh,
                                        void* stream) {
  return launch_fwd(dup, cap, starts, ends, wcount, geom, out, n_tiles,
                    n_tiles_w, tile_size, K, F, ch_out, T_thresh, stream);
}

extern "C" const char* gsgen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
