// K3: duplicate-slot -> Gaussian id expansion.
//
// Replaces the JAX package's ops/expansion_rank.py::_kernel.  For every duplicate
// slot d < cap:  gid[d] = #{g : cum[g] <= d}  (cum = inclusive cumsum of the
// per-Gaussian duplicate counts, non-decreasing and non-negative), which is
// exactly cumsum(zeros(cap).at[cum].add(1, mode="drop")): values >= cap can
// never be <= d.  The TPU kernel merges blocks of slots against a window of
// cum values on the matrix unit, with a scatter fallback when a window
// overflows; here one thread per slot runs an upper-bound binary search over
// cum, which needs no window and no fallback.
//
// Bound on this card: bytes -- cap int32 written once; the log2(N) probes
// per slot read cum (N*4 bytes, at most a few hundred KB) from L2, where
// neighbouring slots probe the same addresses.
#include <cuda_runtime.h>

namespace {

__global__ void expansion_rank_kernel(const int* __restrict__ cum, int n,
                                      int* __restrict__ gid, int cap) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= cap) return;
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  gid[d] = lo;
}

}  // namespace

extern "C" int gsgen_expansion_rank(const int* cum, int n, int* gid, int cap,
                                    void* stream) {
  const int threads = 256;
  const int blocks = (cap + threads - 1) / threads;
  expansion_rank_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(cum, n, gid,
                                                               cap);
  return static_cast<int>(cudaGetLastError());
}
