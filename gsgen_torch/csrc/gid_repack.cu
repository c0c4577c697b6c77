// K4: sorted Gaussian ids -> chunk-aligned padded layout.
//
// Replaces the JAX package's ops/gid_repack.py::_kernel.  Padded row r lies in chunk
// slot s = r / K owned by tile t = chunk_tile[s]; it copies the compact
// sorted id at clip(s*K - offset_t[t], 0, cap-1) + r % K, where gid_s is
// followed by K sentinels, and rows at or past the tile's segment end get
// the sentinel N.  The TPU kernel does this with two aligned block loads and
// a lane roll over an 8-row broadcast of gid_s (a Mosaic tiling minimum);
// here one thread per padded row gathers one int32, with no broadcast.
//
// Bound on this card: bytes -- cap_padded int32 written and about as many
// read; consecutive threads read consecutive ids, so the gather coalesces.
#include <cuda_runtime.h>

namespace {

__global__ void gid_repack_kernel(const int* __restrict__ gid_s, int cap,
                                  const int* __restrict__ chunk_tile,
                                  const int* __restrict__ offset_t,
                                  const int* __restrict__ ends,
                                  int* __restrict__ out, int cap_padded, int K,
                                  int sentinel) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= cap_padded) return;
  const int s = r / K;
  const int t = chunk_tile[s];
  int src0 = s * K - offset_t[t];
  src0 = min(max(src0, 0), cap - 1);
  const int src = src0 + (r - s * K);
  const int v = src < cap ? gid_s[src] : sentinel;
  out[r] = r < ends[t] ? v : sentinel;
}

}  // namespace

extern "C" int gsgen_gid_repack(const int* gid_s, int cap,
                                const int* chunk_tile, const int* offset_t,
                                const int* ends, int* out, int cap_padded,
                                int K, int sentinel, void* stream) {
  const int threads = 256;
  const int blocks = (cap_padded + threads - 1) / threads;
  gid_repack_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      gid_s, cap, chunk_tile, offset_t, ends, out, cap_padded, K, sentinel);
  return static_cast<int>(cudaGetLastError());
}
