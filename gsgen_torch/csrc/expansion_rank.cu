// K3: duplicate-slot -> Gaussian id expansion.
//
// Replaces the JAX package's ops/expansion_rank.py::_kernel.  For every
// duplicate slot d < cap:  gid[d] = #{g : cum[g] <= d}  (cum = inclusive
// cumsum of the per-Gaussian duplicate counts, non-decreasing and
// non-negative), which is exactly cumsum(zeros(cap).at[cum].add(1,
// mode="drop")): values >= cap can never be <= d.
//
// Bound on this card: bytes -- N int32 of cum read once, cap int32 of gid
// written once.  One thread a slot running a binary search over cum (the
// first port) was bound instead by the latency of its log2(N)-deep chain of
// dependent loads, walked in full even by the slots past cum[N-1].
//
// Design: merge path.  gid is the merge of two sorted sequences, the N
// values of cum and the slots 0..cap-1, where cum[g] goes before slot d iff
// cum[g] <= d; gid[d] is the number of cum entries merged before slot d.
// Entry g goes before merged position k iff key(g) = cum[g] + g + 1 <= k,
// and key is strictly increasing, so the number of cum entries among the
// first k merged items is a search over key.  The N + cap merged items are
// cut into equal shares of kItems a block, so a block's work does not
// depend on the counts: a run of zero-count Gaussians (a repeated cum
// value, as inactive and culled rows give) is a run of cum items in the
// merge, and a share never holds more than kItems cum entries, so the
// shared-memory window cannot overflow and no fallback is needed.
//   - A block finds where its share starts by one search over key that the
//     whole block runs together, 512 probes a round (two a thread): up to
//     N = 263,168 one round in global memory, loaded beside cum[N-1], and
//     a last round in shared memory, where the first port took log2(N)
//     dependent loads a slot.
//   - It stages that last round's entries and the cum entries its share
//     can reach (at most kItems) in shared memory, every load of a thread
//     in flight at once; each thread finds its own start there by a binary
//     search and merges its kPerThread items serially, writing each slot's
//     gid into a shared output buffer; the block stores that buffer with
//     16-byte stores.
//   - The tail: from merged position N + cum[N-1] on, every item is a slot
//     with gid N.  A block whose share starts there reads cum[N-1] only and
//     stores N with 16-byte stores.  At configs/base.yaml's render (N
//     65,536, cap 2^20, 15,841 real duplicates) that is 98.5% of the slots.
// What is left is latency: a head block's chain is two dependent trips to
// L2 (cum[N-1] with the first probes, then the window), the search and the
// merge in shared memory, and four barriers.  On the H100 that chain, not
// the bytes, sets the time at both render shapes (PERF.md, section 6),
// where the first port's per-slot searches hit L1 in their top levels: it
// stays ahead when nearly every slot is real (the bench render).  Marking
// run ends and taking a block prefix max instead of the serial merge
// measured no faster.  The shares are small (2,048 items) so that the
// bench render's head (345K items) spreads over 169 blocks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kItems = kThreads * kPerThread;  // merged items a block
constexpr int kProbes = 2 * kThreads;          // search probes a round
constexpr int kWindow = kItems + kProbes;      // cum entries staged

__device__ __forceinline__ long long key_of(int c, long long g) {
  return static_cast<long long>(c) + g + 1;
}

struct Fill {
  int v;
  __device__ __forceinline__ int operator()(long long) const { return v; }
};

struct FromShared {
  const int* buf;
  long long base;
  __device__ __forceinline__ int operator()(long long j) const {
    return buf[j - base];
  }
};

// gid[j] = val(j) for j in [j0, j1): 16-byte stores over the aligned quads,
// scalar stores at the two ragged ends.
template <class Val>
__device__ __forceinline__ void store_range(int* __restrict__ gid,
                                            long long j0, long long j1,
                                            Val val) {
  long long a0 = (j0 + 3) & ~3LL;
  long long a1 = j1 & ~3LL;
  if (a0 >= a1) {  // no whole quad: every slot scalar
    a0 = j1;
    a1 = j1;
  }
  const int t = threadIdx.x;
  if (j0 + t < a0) gid[j0 + t] = val(j0 + t);
  if (a1 + t < j1) gid[a1 + t] = val(a1 + t);
  for (long long q = a0 + 4LL * t; q < a1; q += 4LL * kThreads) {
    *reinterpret_cast<int4*>(gid + q) =
        make_int4(val(q), val(q + 1), val(q + 2), val(q + 3));
  }
}

__global__ void __launch_bounds__(kThreads)
    expansion_rank_kernel(const int* __restrict__ cum, int n,
                          int* __restrict__ gid, int cap) {
  __shared__ int win[kWindow];
  __shared__ int out[kItems];
  __shared__ long long s_i1;
  const int t = threadIdx.x;
  const long long k0 = static_cast<long long>(blockIdx.x) * kItems;
  const long long k1 =
      min(k0 + kItems, static_cast<long long>(n) + cap);

  // i0 = #{g : key(g) <= k0} lies in [lo, hi].  Rounds of kProbes probes
  // in global memory narrow the range to kProbes entries (one round up to
  // N = 263,168, its probes loaded beside cum[N-1], which decides the
  // tail); the last round is done in shared memory, on the window.
  long long lo = 0;
  long long hi = n;
  long long s0 = hi * (t + 1) / (kProbes + 1);
  long long s1 = hi * (t + 1 + kThreads) / (kProbes + 1);
  int v0 = n > kProbes ? cum[s0] : 0;
  int v1 = n > kProbes ? cum[s1] : 0;
  const int last = n > 0 ? cum[n - 1] : -1;
  if (k0 >= static_cast<long long>(n) + last) {  // the tail
    store_range(gid, k0 - n, k1 - n, Fill{n});
    return;
  }
  while (hi - lo > kProbes) {
    const long long len = hi - lo;
    const int c = __syncthreads_count(key_of(v0, s0) <= k0) +
                  __syncthreads_count(key_of(v1, s1) <= k0);
    const long long nlo = c > 0 ? lo + len * c / (kProbes + 1) + 1 : lo;
    hi = c == kProbes ? hi : lo + len * (c + 1) / (kProbes + 1);
    lo = nlo;
    if (hi - lo > kProbes) {
      s0 = lo + (hi - lo) * (t + 1) / (kProbes + 1);
      s1 = lo + (hi - lo) * (t + 1 + kThreads) / (kProbes + 1);
      v0 = cum[s0];
      v1 = cum[s1];
    }
  }

  // The window: cum[lo, lo + w), the last round's <= kProbes entries and
  // the <= kItems a share can reach past i0 (key(i0) > k0, so none at or
  // past i0 + kItems); a thread's loads are all in flight at once.
  const int w = static_cast<int>(min(static_cast<long long>(kWindow),
                                     static_cast<long long>(n) - lo));
  int staged[kWindow / kThreads];
#pragma unroll
  for (int r = 0; r < kWindow / kThreads; ++r) {
    const int q = t + r * kThreads;
    staged[r] = q < w ? cum[lo + q] : 0;
  }
#pragma unroll
  for (int r = 0; r < kWindow / kThreads; ++r) {
    const int q = t + r * kThreads;
    if (q < w) win[q] = staged[r];
  }
  __syncthreads();
  const int len = static_cast<int>(hi - lo);
  const int c = __syncthreads_count(t < len && key_of(win[t], lo + t) <= k0) +
                __syncthreads_count(t + kThreads < len &&
                                    key_of(win[t + kThreads],
                                           lo + t + kThreads) <= k0);
  // a share past the last slot (all its items cum entries >= cap) writes
  // nothing
  if (k0 - cap >= lo + c) return;
  const long long i0 = lo + c;
  const long long j0 = k0 - i0;  // the share's first slot
  const int* share = win + (i0 - lo);
  const int ws = static_cast<int>(min(static_cast<long long>(kItems),
                                      static_cast<long long>(n) - i0));

  const long long kt = k0 + static_cast<long long>(t) * kPerThread;
  if (kt < k1) {
    int a = 0;
    int b = ws;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (key_of(share[m], i0 + m) <= kt) {
        a = m + 1;
      } else {
        b = m;
      }
    }
    long long i = max(i0 + a, kt - cap);
    long long j = kt - i;
    const long long ke = min(kt + kPerThread, k1);
    for (long long k = kt; k < ke; ++k) {
      if (i < n && (j >= cap || share[i - i0] <= j)) {
        ++i;
      } else {
        out[j - j0] = static_cast<int>(i);
        ++j;
      }
    }
    if (ke == k1) s_i1 = i;  // the thread that holds the share's last item
  }
  __syncthreads();
  store_range(gid, j0, k1 - s_i1, FromShared{out, j0});
}

}  // namespace

extern "C" int gsgen_expansion_rank(const int* cum, int n, int* gid, int cap,
                                    void* stream) {
  const long long items = static_cast<long long>(n) + cap;
  const int blocks = static_cast<int>((items + kItems - 1) / kItems);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  expansion_rank_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(cum, n, gid,
                                                               cap);
  return static_cast<int>(cudaGetLastError());
}

