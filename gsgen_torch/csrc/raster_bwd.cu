// K2 and K9: tile compositing backward.
//
// K2 replaces the JAX package's ops/pallas_raster.py::_bwd_kernel_v2
// (resident cotangents) and ::_bwd_kernel (streaming, above the TPU's VMEM
// budget): both compute the same gradient, and the VMEM budget that picks
// between them has no meaning here, so one kernel serves both call
// conditions.  K9, the same kernel on the compact layout, replaces
// ::_bwd_kernel_v3.
//
// One block per tile, one thread per pixel.  The block walks the tile's
// min(counts, processed count of the forward) windows (raster_common.cuh:
// only the tile's own lanes [k_lo, k_hi) of each, so in the padded layout
// the walk ends at ends[t]); windows and lanes it skips have exactly-zero
// gradient, which the wrapper's zero-filled buffer already holds.  Each
// thread recomputes its pixel's forward lane by lane (same recurrence as
// raster_fwd.cu) with per-pixel carries T and S (the running dot(g,
// accumulated features)), and takes d/d(aG) by the suffix trick of the
// reference CUDA backward (vol_render.h:383-399):
//   daG = gof*T_run - (dotfinal - accum_dot + g_T*T_final) / max(1-aG, 1e-6)
// dotfinal = dot(g, final features) and g_T*T_final are formed per pixel
// from the forward output and its cotangent at the tile's start.
//
// Per-Gaussian gradients are sums over the tile's P pixels.  For each lane a
// warp reduces its 32 pixels' 6+F values (padded to 16) by a transpose-
// reduce: four halving exchanges with xor partners 16, 8, 4 and 2 (8 + 4 +
// 2 + 1 shuffles, each lane keeping the half its partner gives away), then
// one add across xor 1, after which lane l holds the warp's sum of row
// l >> 1 -- 16 shuffles instead of 5 per row.  A lane no pixel of the warp
// touches is skipped (__any_sync).  The warp sums land in shared memory
// ([warp][lane][17], conflict-free both ways), and after every 32 lanes the
// block adds the warps in fixed order and writes the tile's own rows of
// grad.  Tiles own disjoint rows (the padded layout's chunks are exclusive;
// a compact boundary window's lanes outside [k_lo, k_hi) are never stored),
// so no atomics are needed and two runs give bitwise-equal results.
//
// Bound on this card: operations -- per lane and pixel ~60 flops and an exp,
// a serial recurrence per pixel; bytes are dup read once and grad written
// once.  Tensor cores do not apply: nothing here is a product of matrices.
// Windows arrive by bulk copy into a two-stage ring, the next in flight
// while this one is walked.
#include "raster_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRedStride = 17;  // floats per (warp, lane) row sum slot

__host__ __device__ __forceinline__ int red_floats(int P) {
  return (P / 32) * 32 * kRedStride;
}

// One halving exchange with the xor partner 2H: a lane whose bit 2H is set
// keeps rows [H, 2H) of v, its partner rows [0, H); each gives the other
// half away and adds the half it receives.  The kept rows move to v[0, H).
template <int H>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = (lane & (2 * H)) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float give = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, give, 2 * H);
  }
}

// The warp's sums of the 16 rows of v over its 32 lanes: lane l returns the
// sum of row l >> 1 (lanes l and l ^ 1 hold the same sum).  v is consumed.
__device__ __forceinline__ float transpose_reduce16(float (&v)[16],
                                                    int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

__global__ void raster_bwd_kernel(const float* __restrict__ dup, long long cap,
                                  const float* __restrict__ out,
                                  const float* __restrict__ g,
                                  const int* __restrict__ starts,
                                  const int* __restrict__ ends,
                                  const int* __restrict__ counts,
                                  const float* __restrict__ geom,
                                  float* __restrict__ grad, int n_tiles_w,
                                  int tile_size, int K, int F, int ch_out,
                                  float T_thresh) {
  // ring [2][6 + F][K], then red [NW][32][kRedStride]
  extern __shared__ __align__(16) float sm[];
  __shared__ Ring ring;
  const int nrows = 6 + F;
  float* red = sm + ring_floats(K, F);
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
  const int nck = min(counts[t], nckeff);
  const long long start = starts[t];
  const long long end = ends[t];
  const long long first = start / K * K;

  ring_init(&ring);
  if (p == 0 && nck > 0) {
    int k_lo, k_hi;
    window_lanes(start, end, first, K, &k_lo, &k_hi);
    ring_issue(&ring, sm, 0, dup, cap, first, k_lo, k_hi, nrows, K);
  }

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
    // every thread is done with window i-1's stage (which window i+1's copy
    // overwrites) and with red
    __syncthreads();
    if (p == 0 && i + 1 < nck) {
      int k_lo, k_hi;
      window_lanes(start, end, base + K, K, &k_lo, &k_hi);
      ring_issue(&ring, sm, i + 1, dup, cap, base + K, k_lo, k_hi, nrows, K);
    }
    int k_lo, k_hi;
    window_lanes(start, end, base, K, &k_lo, &k_hi);
    const float* st = ring_wait(&ring, sm, i, nrows, K);

    float cp = 1.0f;
    float qmin = __int_as_float(0x7f800000);  // +inf
    float incl = 0.0f;
    for (int kb = k_lo; kb < k_hi; kb += 32) {
      // lanes past every pixel's cutoff have zero gradient (buffer is zero)
      if (!__syncthreads_or(T * cp >= T_thresh)) break;
      const int nl = min(32, k_hi - kb);
      for (int kk = 0; kk < nl; ++kk) {
        const int k = kb + kk;
        const float T_run = T * cp;
        float c[GSGEN_D_ROWS];
#pragma unroll
        for (int r = 0; r < GSGEN_D_ROWS; ++r) c[r] = 0.0f;
        bool nz = false;
        if (T_run >= T_thresh) {
          const float ca = st[2 * K + k];
          const float cb = st[3 * K + k];
          const float cc = st[4 * K + k];
          float dx, dy, radial, G, a_cl;
          const float aG =
              gauss_weight(st[k], st[K + k], ca, cb, cc, st[5 * K + k], pixx,
                           pixy, &dx, &dy, &radial, &G, &a_cl);
          // aG = 0 leaves cp, qmin, S and the gradient as they are
          if (aG > 0.0f) {
            nz = true;
            const float om = 1.0f - aG;
            const float w = aG * T_run;
            float gof = 0.0f;
#pragma unroll
            for (int f = 0; f < GSGEN_MAX_F; ++f)
              if (f < F) gof += gfe[f] * st[(6 + f) * K + k];
            incl += w * gof;
            const float accum_dot = S + incl;
            const float suffix = dotfinal - accum_dot;
            const float daG =
                gof * T_run - (suffix + gT_Tf) / fmaxf(om, 1e-6f);
            const float dG = daG * a_cl;
            const float dr = radial > 0.0f ? -0.5f * G * dG : 0.0f;
            c[0] = dr * -(2.0f * ca * dx + 2.0f * cb * dy);
            c[1] = dr * -(2.0f * cb * dx + 2.0f * cc * dy);
            c[2] = dr * dx * dx;
            c[3] = dr * 2.0f * dx * dy;
            c[4] = dr * dy * dy;
            c[5] = daG * G;
#pragma unroll
            for (int f = 0; f < GSGEN_MAX_F; ++f)
              if (f < F) c[6 + f] = gfe[f] * w;
            qmin = fminf(qmin, cp * om);
            cp = cp * om;
          }
        }
        const float v = __any_sync(kFull, nz) ? transpose_reduce16(c, lane)
                                              : 0.0f;
        if ((lane & 1) == 0)
          red[(warp * 32 + kk) * kRedStride + (lane >> 1)] = v;
      }
      __syncthreads();
      for (int idx = p; idx < nrows * nl; idx += P) {
        const int r = idx / nl;
        const int kk = idx - r * nl;
        float s = 0.0f;
        for (int wi = 0; wi < NW; ++wi)
          s += red[(wi * 32 + kk) * kRedStride + r];
        if (r == 5) s = s * (st[5 * K + kb + kk] < alpha_clamp() ? 1.0f : 0.0f);
        grad[static_cast<long long>(r) * cap + base + kb + kk] = s;
      }
    }
    T = T * fminf(qmin, 1.0f);
    S = S + incl;
  }
}

int launch_bwd(const float* dup, long long cap, const float* out,
               const float* g, const int* starts, const int* ends,
               const int* counts, const float* geom, float* grad, int n_tiles,
               int n_tiles_w, int tile_size, int K, int F, int ch_out,
               float T_thresh, void* stream) {
  const int P = tile_size * tile_size;
  const size_t smem = sizeof(float) * (ring_floats(K, F) + red_floats(P));
  const cudaError_t e = smem_opt_in(raster_bwd_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  raster_bwd_kernel<<<n_tiles, P, smem, static_cast<cudaStream_t>(stream)>>>(
      dup, cap, out, g, starts, ends, counts, geom, grad, n_tiles_w,
      tile_size, K, F, ch_out, T_thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: starts/ends are the padded layout's, nchunks its chunk counts; grad
// must be zero-filled (padding lanes and chunks the forward skipped stay
// zero).
extern "C" int gsgen_raster_bwd(const float* dup, long long cap,
                                const float* out, const float* g,
                                const int* starts, const int* ends,
                                const int* nchunks, const float* geom,
                                float* grad, int n_tiles, int n_tiles_w,
                                int tile_size, int K, int F, int ch_out,
                                float T_thresh, void* stream) {
  return launch_bwd(dup, cap, out, g, starts, ends, nchunks, geom, grad,
                    n_tiles, n_tiles_w, tile_size, K, F, ch_out, T_thresh,
                    stream);
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
  return launch_bwd(dup, cap, out, g, starts, ends, wcount, geom, grad,
                    n_tiles, n_tiles_w, tile_size, K, F, ch_out, T_thresh,
                    stream);
}
