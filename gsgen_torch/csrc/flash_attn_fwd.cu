// K5: flash self-attention forward, out = softmax(q k^T * scale) v.
//
// Replaces the JAX package's guidance/unet2d.py::_flash_self_attention, which
// calls the library Pallas TPU kernel jax.experimental.pallas.ops.tpu.
// flash_attention._flash_attention_kernel (non-causal, no mask).  Inputs and
// output keep that function's [B, L, H, D] layout: the kernels index
// [b, l, h, d] directly (row stride H*D), so no transposes are made around
// them.
//
// One pass over the keys (FlashAttention online softmax; nothing of size
// L x L leaves the SM): each query row keeps a running max m, a running sum
// l and an unnormalised output accumulator, all fp32; a new key tile
// rescales them by exp(m_old - m_new).  The output is divided by l once at
// the end and written in the input type.  When the caller differentiates,
// the kernel also writes lse = m + log(l) per query row in fp32 ([B, H, L],
// as the library saves l and m), from which the backward kernels K6/K7
// (flash_attn_bwd.cu) recompute P exactly.
//
// Bound on this card: the largest of three times.  The two products are
// 4 B H L^2 D operations (989 TFLOP/s bf16); q, k, v and o are 4 B L H D
// values, each moved once (3.35 TB/s); and the online softmax takes one
// exp2 a score, B H L^2 of them, on the SFU's 16 a clock per SM (132 SMs at
// the 1.98 GHz at which the 67 TFLOP/s fp32 peak is stated: 4.18e12 a
// second; gsgen_torch/tools/k5_bench.py::bound_ms).  Below D = 59 the
// exponentials set the pace.  In bf16: SD 2.1's level 0 [8, 4096, 5, 64]
// 0.174 ms (operations; the exponentials 0.160); SD 1.5's [8, 4096, 8, 40]
// 0.257 ms (exponentials), [8, 1024, 8, 80] 0.0217 ms (operations), [8,
// 256, 8, 160] 0.0063 ms (bytes).  Three designs:
//
//  * bf16, every D (D % 8 == 0, D <= 160): wgmma fed by TMA.  One CTA per
//    (128-query tile, head, batch): two consumer warpgroups of 64 query
//    rows and a producer warpgroup, one thread of which loads the Q tile
//    once and K/V tiles through a 3-stage ring (mbarrier full/empty
//    pairs), all by TMA in the 128-byte swizzle.  A box in that swizzle is
//    at most 64 bf16 wide, so a tile of D > 64 is ceil(D / 64) boxes side
//    by side (atom columns of rows x 128 bytes), and TMA zero-fills head
//    dims past D (no D needs a padding pass).  S = Q K^T is an SS wgmma
//    (m64nBKk16, both K-major: a k-step moves 32 bytes along the row, and
//    every fourth one to the next atom column); P is rounded to bf16 in
//    registers straight from the S accumulator as the A operand of O +=
//    P V, an RS wgmma as wide as the instance with V as an MN-major B
//    (tnspB: past 64 head dims N continues in the next atom column, the
//    descriptor's LBO further on).  l sums the rounded P, so the weights
//    that multiply V sum to exactly l.  The max is taken over the raw
//    scores and scaled by scale * log2(e) once; P = exp2(fma(s, scale *
//    log2(e), -m)) on the SFU (ex2.approx.ftz).
//    The two warpgroups take the tensor core in turns (named barriers): in
//    its turn a warpgroup issues S of its next tile and P V of its last
//    one together, then hands over, waits for both and runs the next
//    tile's softmax beside the other's products.  Issued together, the two
//    products leave the tensor core no gap between them; a second S
//    accumulator (S of tile j + 1 during the softmax of tile j) is not
//    needed.
//    Instances: P V width DN = D rounded up to 40, 64, 80 or 160 (the
//    SD 1.5 and SD 2.1 widths; flash_attention.py::fwd_tiles picks it),
//    BK = 128 keys a tile up to DN = 80 and 64 at 160.  Registers: ptxas sizes every thread by the
//    launch bounds (384 threads: 168 registers; 288 threads, one producer
//    warp, are rounded up to 12 warps and get no more); setmaxnreg moves
//    registers inside the CTA's allocation at run time (producer 40,
//    consumers 232) but does not raise what ptxas allocates for the
//    consumer code.  A consumer thread holds DN / 2 accumulators, BK / 2
//    scores and BK / 4 packed P, all three live while the products are
//    issued: 136 values at DN = 80, BK = 128; at DN = 160 128-key tiles
//    would need 176 and 64-key ones hold 128.  Shared memory (of 227 KB):
//    Q plus 3 stages of K and V, 112 KB up to DN = 64, 224 KB at DN = 80
//    (the barriers and the 1024-byte alignment slack fit beside them; 3
//    stages keep two tiles in flight while the consumers read the third),
//    192 KB at DN = 160.
//  * fp32, D <= 64 (the VSD path at D = 64, IF-II at 16 and 32): 3xTF32 on
//    wgmma fed by TMA.  Each operand x splits into hi = tf32(x) and lo =
//    tf32(x - hi), both rounded to nearest (tf32_rna; the raw fp32 as hi,
//    which the tensor cores truncate, had 1.4x the error in K6 / K7); each
//    product is lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32 accumulate,
//    about 2^-21 relative.  Bound at the rate this design can reach:
//    3 x 4 B H L^2 D / 495 TFLOP/s (1.04 ms at [8, 4096, 5, 64]).
//    - Majorness.  For 32-bit types wgmma reads shared memory K-major
//      only.  S = Q K^T contracts over head dims, contiguous in both [B, L,
//      H, D] tiles: an SS wgmma.  P V contracts over keys, which V's rows
//      are not: P stays in registers as the RS form's A operand and V goes
//      in transposed, as [d][key] planes.  The score accumulator holds keys
//      2t, 2t + 1 of each 8 where the A fragment wants k = t, t + 4, so
//      V^T's columns are permuted the same way (key 8a + r at column 8a +
//      (r >> 1) + 4 (r & 1)) and P needs no shuffle.
//    - Who splits.  A split pass (flash_fwd_split_kernel) writes K's hi /
//      lo planes in K's layout and V^T's [B, H, D, L] once per call, into
//      scratch the wrapper allocates (4 B L H D floats); the attention
//      kernel streams the four planes of each 64-key tile by TMA (boxes of
//      32 fp32, zero-filled past D).  Splitting each tile in the attention
//      kernel, by the producer warpgroup's three idle warps, took 2.05 ms
//      at [8, 4096, 5, 64] on an H100 against 1.59 ms: every one of the
//      L / 128 CTAs that streams a tile split it again, and the splits'
//      shared-memory traffic slowed the consumers' products (loading more
//      chunks at once made it slower still).  The producer's three warps
//      now split Q only, once a CTA, into resident hi / lo planes.
//    - One CTA per (128-query tile, head, batch): two consumer warpgroups
//      of 64 queries, one producer thread for TMA.  Per 64-key tile a
//      warpgroup issues S (DN / 8 k-steps of three SS wgmma m64n64k8),
//      waits, runs the online softmax and splits P into hi / lo A
//      fragments, issues P V (8 k-steps of three RS wgmma m64nDNk8) into
//      partial sums, waits, frees the stage and folds.
//    - Registers (168 a thread at 384 threads, whatever setmaxnreg says):
//      S 32, P's fragments 64, O and the partial sums DN / 2 each: 128 at
//      DN = 64, so S of the next tile cannot be in flight beside P V.  The
//      two warpgroups run free, one's softmax beside the other's products;
//      taking the tensor core in turns (named barriers, S of the next tile
//      issued with P V where DN <= 32 leaves room) measured no faster at D
//      = 64 and slower at D = 16 and 32.
//    - Shared memory: Q's hi / lo planes (64 KB at DN = 64) and a ring of
//      stages of K hi / lo and V^T hi / lo (64 KB): 2 stages at DN = 64
//      (197.7 of 227 KB; a third does not fit), 4 below.
//    - Accuracy: each tile's P V goes to partial sums folded into O by one
//      rounded fp32 FMA that takes the rescale: the tensor cores' sums do
//      not round to nearest, and over 4096 keys their bias was about ten
//      times the folded error.  l sums the P that multiplies V.
//    - Instances at P V width DN = 16, 32, 64 (D rounded up, TMA
//      zero-filling the rest): the k-steps of S and the width of P V are
//      known at compile time (a run-time k-step count made ptxas serialise
//      every wgmma in K6 / K7); IF-II's D = 16 at width 64 would take 4x
//      the products.
//    - Proxy fences: the Q planes written by threads are fenced
//      (fence.proxy.async) before the barrier the consumers wait on.
//  * fp32, D = 72-160 (only SD 1.5 under `fused_attention: on` reaches
//    it; no shipped config does in fp32): 3xTF32 on mma.sync m16n8k8 tf32,
//    each operand split at fragment load.  4 warps of 32 query rows (two
//    m16 tiles, which share every K and V fragment a warp loads and
//    splits); K/V tiles of 32 keys double-buffered by cp.async.  Each term
//    is issued for 4 accumulators before the next, so the accumulation
//    chains interleave.  P becomes the A operand of P V without leaving
//    registers by the same key permutation, applied to V's rows.  The
//    tile's P V adds into O: the registers hold no second set of sums.
#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

#include <math.h>

namespace {

constexpr int kWgRows = 128;     // queries per CTA (wgmma instances)
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;  // two consumer warpgroups + producer
constexpr int kTfKeys = 64;      // keys per tile (fp32 wgmma)
constexpr int kSplitters = 96;   // producer threads that split Q (fp32 wgmma)
constexpr int kTfQ = 128;  // queries per block (fp32 mma.sync): 4 warps x 32
constexpr int kTfK = 32;   // keys per double-buffered tile (fp32 mma.sync)
constexpr int kTfNd = kMaxD / 8;  // head-dim steps of 8 (fp32 mma.sync)

// The bf16 instance of P V width DN (>= D) and BK keys a tile: sizes in
// bytes.  A tile is kAtoms atom columns of rows x 128 bytes (64 head dims).
template <int DN, int BK>
struct WgTile {
  static constexpr int kAtoms = (DN + 63) / 64;
  static constexpr int kQCol = kWgRows * 128;
  static constexpr int kKCol = BK * 128;
  static constexpr int kQ = kAtoms * kQCol;
  static constexpr int kKV = kAtoms * kKCol;  // a K or a V tile
  // dynamic shared memory: Q, the K and V rings, the barriers, and the
  // slack that aligns the base to 1024 bytes
  static constexpr int kSmem =
      kQ + 2 * kWgStages * kKV + 8 * (1 + 2 * kWgStages) + 1024;
};

// ---- bf16: wgmma + TMA -----------------------------------------------------
// S = Q K^T for one warpgroup: 64 queries x BK keys, issued and committed
// (not waited for); k-step kt reads 16 head dims of atom column kt / 4.
template <int DN, int BK>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             uint32_t qa, uint32_t kb,
                                             int KT) {
  using T = WgTile<DN, BK>;
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < (DN + 15) / 16; ++kt) {
    if (kt < KT) {
      const uint32_t col = 32 * (kt & 3);
      wgmma_ss(sc, desc_sw128(qa + (kt >> 2) * T::kQCol + col),
               desc_sw128(kb + (kt >> 2) * T::kKCol + col), kt);
    }
  }
  wgmma_commit();
}

// O += P V: V's rows (keys) are k, its head dims N (MN-major); N past 64
// runs on into the next atom column, kKCol bytes on.  Issued and
// committed (not waited for).
template <int DN, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DN / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         uint32_t vb) {
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs(acc, pa[kk], desc_sw128(vb + 2048 * kk, WgTile<DN, BK>::kKCol));
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile: rows g (e = 0, 1) and g + 8 (e =
// 2, 3), the 4 lanes of a quad holding the same two rows.  m (log2 units)
// and l are the quad's running max and this lane's part of the row sum;
// acc is rescaled by exp2(m_old - m_new), and P, rounded to bf16, lands in
// the A fragments of P V (key step kk: n8 chunks 2kk and 2kk + 1).  The
// max is taken over the raw scores and scaled once (sl2 > 0, and rounding
// keeps order).
template <int DN, int BK>
__device__ __forceinline__ void softmax_tile(const float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[DN / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = exp2_ftz(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const __nv_bfloat162 p01 = __floats2bfloat162_rn(
        exp2_ftz(fmaf(sc[4 * j + 0], sl2, -m[0])),
        exp2_ftz(fmaf(sc[4 * j + 1], sl2, -m[0])));
    const __nv_bfloat162 p23 = __floats2bfloat162_rn(
        exp2_ftz(fmaf(sc[4 * j + 2], sl2, -m[1])),
        exp2_ftz(fmaf(sc[4 * j + 3], sl2, -m[1])));
    ls[0] += __low2float(p01) + __high2float(p01);
    ls[1] += __low2float(p23) + __high2float(p23);
    pa[j >> 1][(j & 1) * 2 + 0] = bf162_bits(p01);
    pa[j >> 1][(j & 1) * 2 + 1] = bf162_bits(p23);
  }
  l[0] = l[0] * alpha[0] + ls[0];
  l[1] = l[1] * alpha[1] + ls[1];
}

__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Threads 0-255: the consumer warpgroups (queries 64 wg .. of the tile);
// threads 256-383: the producer warpgroup (thread 256 issues the copies).
// Shared memory (1024-aligned): Q [atoms][128 rows], K ring
// [kWgStages][atoms][BK rows], V ring, then the barriers q_full, full[s],
// empty[s].  The consumers take the tensor core in turns (named barriers
// 1 and 2, one a warpgroup: its own sync and the other's arrive): in its
// turn a warpgroup issues S of its next tile and P V of its last one
// together, hands the turn over, waits for both and runs the next tile's
// softmax beside the other warpgroup's products.
template <int DN, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int L, int H, int D,
                           float scale) {
  using T = WgTile<DN, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks0 = qs + T::kQ;
  const uint32_t vs0 = ks0 + kWgStages * T::kKV;
  const uint32_t q_full = vs0 + kWgStages * T::kKV;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kWgStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kWgRows;
  const int n_tiles = L / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<40>();  // 128 x (168 - 40) registers to the consumers
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, T::kQ);
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        tma_load_4d(qs + a * T::kQCol, &tq, q_full, 64 * a, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) {
          mbar_wait(empty0 + 8 * s, ((it / kWgStages) - 1) & 1);
        }
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * T::kKV);
#pragma unroll
        for (int a = 0; a < T::kAtoms; ++a) {
          const uint32_t off = s * T::kKV + a * T::kKCol;
          tma_load_4d(ks0 + off, &tk, full, 64 * a, h, it * BK, b);
          tma_load_4d(vs0 + off, &tv, full, 64 * a, h, it * BK, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<232>();  // 256 x (232 - 168): what the producer gave
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int KT = (D + 15) / 16;
    const float sl2 = scale * kLog2e;
    const uint32_t qa = qs + wg * (T::kQCol / 2);  // this warpgroup's rows

    float acc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
    float l[2] = {0.0f, 0.0f};
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];

    // the tensor core in turns (see above); warpgroup 0 goes first
    mbar_wait(q_full, 0);
    if (wg == 1) named_bar_arrive(1);
    named_bar_sync(1 + wg);
    mbar_wait(full0, 0);
    issue_scores<DN, BK>(sc, qa, ks0, KT);
    named_bar_arrive(2 - wg);
    wgmma_wait0();
    fence_regs(sc);
    softmax_tile<DN, BK>(sc, m, l, acc, pa, sl2);
    for (int it = 0; it < n_tiles; ++it) {
      // S of the next tile and P V of this one, issued together
      const int s = it % kWgStages;
      const bool more = it + 1 < n_tiles;
      named_bar_sync(1 + wg);
      if (more) {
        const int s1 = (it + 1) % kWgStages;
        mbar_wait(full0 + 8 * s1, ((it + 1) / kWgStages) & 1);
        issue_scores<DN, BK>(sc, qa, ks0 + s1 * T::kKV, KT);
      }
      issue_pv<DN, BK>(acc, pa, vs0 + s * T::kKV);
      // the last turn of all (warpgroup 1's last) hands over to no one
      if (more || wg == 0) named_bar_arrive(2 - wg);
      wgmma_wait0();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (more) {
        fence_regs(sc);
        softmax_tile<DN, BK>(sc, m, l, acc, pa, sl2);
      }
    }

    // the quad's partial row sums, then normalise and store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row = q0 + wg * 64 + warp * 16 + g;
    if (lse != nullptr && t == 0) {
      const long lrow = (static_cast<long>(b) * H + h) * L + row;
      lse[lrow] = (m[0] + log2f(l[0])) * kLn2;
      lse[lrow + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
    const float inv0 = 1.0f / l[0];
    const float inv1 = 1.0f / l[1];
    const long row_stride = static_cast<long>(H) * D;
    __nv_bfloat16* o0 =
        o + (static_cast<long>(b) * L + row) * row_stride + h * D + 2 * t;
    __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      if (j * 8 < D) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_f32_bf16(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_f32_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// ---- fp32, D <= 64: 3xTF32 on wgmma + TMA ---------------------------------
// The instance of P V width DN (16, 32 or 64; DN >= D): sizes in bytes.  A
// Q or K plane is kAtoms atom columns of rows x 128 bytes (32 fp32 head
// dims a row, the TMA box); a V^T plane has DN rows (head dims) and two
// atom columns of 32 keys.  A stage holds K's and V^T's hi and lo planes.
template <int DN>
struct TfTile {
  static constexpr int kAtoms = (DN + 31) / 32;
  static constexpr int kStages = DN == 64 ? 2 : 4;
  static constexpr int kQCol = kWgRows * 128;
  static constexpr int kKCol = kTfKeys * 128;
  static constexpr int kVtCol = DN * 128;
  static constexpr int kQ = kAtoms * kQCol;  // a Q plane
  static constexpr int kK = kAtoms * kKCol;  // a K plane
  static constexpr int kVt = 2 * kVtCol;     // a V^T plane
  static constexpr int kStage = 2 * kK + 2 * kVt;
  // dynamic shared memory: Q's hi and lo planes, the stages, the barriers
  // (q_full, q_ready, full[s], empty[s]) and the slack that aligns the
  // base to 1024 bytes (DN = 64: 197,680 bytes)
  static constexpr int kSmem =
      2 * kQ + kStages * kStage + 8 * (2 + 2 * kStages) + 1024;
};

// The split pass: K into TF32 hi and lo planes in K's layout, and V into
// V^T's hi and lo planes [B, H, D, L] (K-major for P V: a head dim's keys
// contiguous), each 8-key group's keys in the order of P's A fragment: key
// 8a + r at column 8a + (r >> 1) + 4 (r & 1), so that a lane's keys 2t,
// 2t + 1 of the score accumulator meet V at k = t, t + 4.  One CTA per
// (64-key tile, head, batch); V's tile passes through shared memory (rows
// of 65 floats: both the row writes and the column reads are free of bank
// conflicts).  Each key tile is split once here, not once by each of the
// L / 128 CTAs of the main kernel that stream it.
__global__ void __launch_bounds__(256)
    flash_fwd_split_kernel(const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ kh, float* __restrict__ kl,
                           float* __restrict__ vh, float* __restrict__ vl,
                           int L, int H, int D) {
  __shared__ float vs[kTfKeys][kTfKeys + 1];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * kTfKeys;
  const long row_stride = static_cast<long>(H) * D;
  const long base = (static_cast<long>(b) * L + l0) * row_stride +
                    static_cast<long>(h) * D;
  for (int i = threadIdx.x; i < kTfKeys * D; i += blockDim.x) {
    const int key = i / D;
    const int d = i - key * D;
    const long at = base + key * row_stride + d;
    uint32_t hi, lo;
    split_tf32(k[at], hi, lo);
    kh[at] = __uint_as_float(hi);
    kl[at] = __uint_as_float(lo);
    vs[key][d] = v[at];
  }
  __syncthreads();
  const long vbase = (static_cast<long>(b) * H + h) * D * L + l0;
  for (int i = threadIdx.x; i < kTfKeys * D; i += blockDim.x) {
    const int d = i / kTfKeys;
    const int col = i % kTfKeys;
    const int r = col & 7;
    const int key = (col & ~7) | (r < 4 ? 2 * r : 2 * r - 7);
    uint32_t hi, lo;
    split_tf32(vs[key][d], hi, lo);
    vh[vbase + static_cast<long>(d) * L + col] = __uint_as_float(hi);
    vl[vbase + static_cast<long>(d) * L + col] = __uint_as_float(lo);
  }
}

// The first DN columns of 128 rows of a swizzled fp32 tile (Q) split into
// TF32 hi (in place) and lo (the same offsets in `lo`) by kSplitters
// threads, 16 bytes a step: 8 threads cover a 128-byte row, so a phase of
// shared accesses touches every bank once.
template <int DN>
__device__ __forceinline__ void split_q(unsigned char* hi, unsigned char* lo,
                                        int tid) {
  constexpr int kC = DN / 4;  // 16-byte chunks a row
  for (int i = tid; i < kWgRows * kC; i += kSplitters) {
    const int row = i / kC;
    const int c = i % kC;
    const uint32_t off = (c >> 3) * TfTile<DN>::kQCol + row * 128 +
                         (((c & 7) ^ (row & 7)) << 4);
    uint4 x = *reinterpret_cast<uint4*>(hi + off), y;
    split_tf32(__uint_as_float(x.x), x.x, y.x);
    split_tf32(__uint_as_float(x.y), x.y, y.y);
    split_tf32(__uint_as_float(x.z), x.z, y.z);
    split_tf32(__uint_as_float(x.w), x.w, y.w);
    *reinterpret_cast<uint4*>(hi + off) = x;
    *reinterpret_cast<uint4*>(lo + off) = y;
  }
}

// S = Q K^T for one warpgroup: 64 queries x 64 keys, SS wgmma against Q's
// resident hi / lo planes (this warpgroup's rows at qh, ql) and the stage's
// K planes at st; k-step kk reads 8 head dims (32 bytes) of atom column
// kk / 4: lo_q hi_k, hi_q lo_k, hi_q hi_k.  Issued and committed.
template <int DN>
__device__ __forceinline__ void issue_s_tf32(float (&sc)[32], uint32_t qh,
                                             uint32_t ql, uint32_t st) {
  using T = TfTile<DN>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DN / 8; ++kk) {
    const uint32_t oq = (kk >> 2) * T::kQCol + 32 * (kk & 3);
    const uint32_t ok = (kk >> 2) * T::kKCol + 32 * (kk & 3);
    wgmma_tf32_ss(sc, desc_sw128(ql + oq), desc_sw128(st + ok), kk);
    wgmma_tf32_ss(sc, desc_sw128(qh + oq), desc_sw128(st + T::kK + ok), 1);
    wgmma_tf32_ss(sc, desc_sw128(qh + oq), desc_sw128(st + ok), 1);
  }
  wgmma_commit();
}

// part = P V for one warpgroup: 64 queries x DN head dims, P's hi / lo A
// fragments against the stage's V^T planes; k-step j reads 8 keys (32
// bytes) of atom column j / 4.  Issued and committed.
template <int DN>
__device__ __forceinline__ void issue_pv_tf32(float (&part)[DN / 2],
                                              uint32_t (&ph)[8][4],
                                              uint32_t (&pl)[8][4],
                                              uint32_t st) {
  using T = TfTile<DN>;
  const uint32_t vh = st + 2 * T::kK, vl = vh + T::kVt;
  fence_regs(ph);
  fence_regs(pl);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t ov = (j >> 2) * T::kVtCol + 32 * (j & 3);
    wgmma_tf32(part, pl[j], desc_sw128(vh + ov), j);
    wgmma_tf32(part, ph[j], desc_sw128(vl + ov), 1);
    wgmma_tf32(part, ph[j], desc_sw128(vh + ov), 1);
  }
  wgmma_commit();
}

// The online softmax of one score tile: rows g (e = 0, 1) and g + 8 (e =
// 2, 3) of the warp's 16, the quad's 4 lanes holding the same two rows.
// m (log2 units) and l are the quad's running max and this lane's part of
// the row sum; alpha = exp2(m_old - m_new) rescales O.  P lands split in
// the A fragments of key step j (keys 8j..8j+7): a0 = P[g][2t], a1 =
// P[g + 8][2t], a2 = P[g][2t + 1], a3 = P[g + 8][2t + 1] (keys 2t and
// 2t + 1 at k = t and t + 4, as V^T's columns are ordered).  The max is
// taken over the raw scores and scaled once (sl2 > 0, and rounding keeps
// order); l sums the P that multiplies V.
__device__ __forceinline__ void softmax_tf32(const float (&sc)[32],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             uint32_t (&ph)[8][4],
                                             uint32_t (&pl)[8][4],
                                             float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  float ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r] * sl2);
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2f(fmaf(sc[4 * j + e], sl2, -m[e >> 1]));
      ls[e >> 1] += p[e];
    }
    split_tf32(p[0], ph[j][0], pl[j][0]);
    split_tf32(p[2], ph[j][1], pl[j][1]);
    split_tf32(p[1], ph[j][2], pl[j][2]);
    split_tf32(p[3], ph[j][3], pl[j][3]);
  }
  l[0] = l[0] * alpha[0] + ls[0];
  l[1] = l[1] * alpha[1] + ls[1];
}

// One CTA per (128-query tile, head, batch).  Threads 0-255: the consumer
// warpgroups (queries 64 wg ..); thread 256 issues the TMA copies: Q once,
// then each 64-key tile's four planes (K hi / lo, V^T hi / lo, written by
// the split pass) into the stage ring; threads 288-383 (the producer
// warpgroup's other three warps) split Q into hi / lo planes once.
// Barriers: q_full and full[s] count TMA bytes, q_ready the splitters'
// arrivals, empty[s] one arrival per consumer warp.  Per tile a consumer
// warpgroup takes S = Q K^T, the online softmax in registers, and the
// tile's P V into partial sums, folded into O by one rounded fp32 FMA that
// takes the rescale.  The two warpgroups run free: one's softmax runs
// beside the other's products.
template <int DN>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tkh,
                                const __grid_constant__ CUtensorMap tkl,
                                const __grid_constant__ CUtensorMap tvh,
                                const __grid_constant__ CUtensorMap tvl,
                                float* __restrict__ o,
                                float* __restrict__ lse, int L, int H, int D,
                                float scale) {
  using T = TfTile<DN>;
  constexpr int S = T::kStages;
  constexpr int kSt0 = 2 * T::kQ;
  constexpr int kVh = 2 * T::kK, kVl = kVh + T::kVt;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t q_full = base + kSt0 + S * T::kStage;
  const uint32_t q_ready = q_full + 8;
  const uint32_t full0 = q_ready + 8;
  const uint32_t empty0 = full0 + 8 * S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kWgRows;
  const int n_tiles = L / kTfKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, kSplitters);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<56>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, T::kQ);
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        tma_load_4d(base + a * T::kQCol, &tq, q_full, 32 * a, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = base + kSt0 + s * T::kStage;
        const int key0 = it * kTfKeys;
        mbar_expect_tx(full, T::kStage);
#pragma unroll
        for (int a = 0; a < T::kAtoms; ++a) {
          tma_load_4d(st + a * T::kKCol, &tkh, full, 32 * a, h, key0, b);
          tma_load_4d(st + T::kK + a * T::kKCol, &tkl, full, 32 * a, h,
                      key0, b);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          tma_load_4d(st + kVh + a * T::kVtCol, &tvh, full, key0 + 32 * a,
                      0, h, b);
          tma_load_4d(st + kVl + a * T::kVtCol, &tvl, full, key0 + 32 * a,
                      0, h, b);
        }
      }
    } else if (threadIdx.x >= 288) {
      mbar_wait(q_full, 0);
      split_q<DN>(sm, sm + T::kQ, threadIdx.x - 288);
      fence_proxy_async();
      mbar_arrive(q_ready);
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<224>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float sl2 = scale * kLog2e;
  const uint32_t qh = base + wg * 64 * 128;  // this warpgroup's 64 rows
  const uint32_t ql = qh + T::kQ;

  float acc[DN / 2], part[DN / 2], sc[32];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.0f, 0.0f};
  float alpha[2];
  uint32_t ph[8][4], pl[8][4];  // P's A fragments, hi and lo

  mbar_wait(q_ready, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % S;
    const uint32_t st = base + kSt0 + s * T::kStage;
    mbar_wait(full0 + 8 * s, (it / S) & 1);
    issue_s_tf32<DN>(sc, qh, ql, st);
    wgmma_wait0();
    fence_regs(sc);
    softmax_tf32(sc, m, l, alpha, ph, pl, sl2);
    issue_pv_tf32<DN>(part, ph, pl, st);
    wgmma_wait0();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    // the tensor cores' sums do not round to nearest: over thousands of
    // keys their bias would pass the folded error tenfold
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
    }
  }

  // the quad's partial row sums, then normalise and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = q0 + wg * 64 + warp * 16 + g;
  if (lse != nullptr && t == 0) {
    const long lrow = (static_cast<long>(b) * H + h) * L + row;
    lse[lrow] = (m[0] + log2f(l[0])) * kLn2;
    lse[lrow + 8] = (m[1] + log2f(l[1])) * kLn2;
  }
  const float inv0 = 1.0f / l[0];
  const float inv1 = 1.0f / l[1];
  const long row_stride = static_cast<long>(H) * D;
  float* o0 =
      o + (static_cast<long>(b) * L + row) * row_stride + h * D + 2 * t;
  float* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    if (j * 8 < D) {
      *reinterpret_cast<float2*>(o0 + 8 * j) =
          make_float2(acc[4 * j + 0] * inv0, acc[4 * j + 1] * inv0);
      *reinterpret_cast<float2*>(o1 + 8 * j) =
          make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ---- fp32, D = 72-160: 3xTF32 on mma.sync ---------------------------------
// Registers sized for D <= 160 (kTfNd steps of 8 head dims).  Each warp owns
// 32 query rows, two m16 tiles (mt) that share every K and V fragment it
// loads and splits.  Shared memory: Q [128][D + 4], K and V [2][32][D + 4]
// (rows padded by 4 floats: the fragment loads below are free of bank
// conflicts).
__global__ void __launch_bounds__(128, 1)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int L, int H, int D,
                          float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int ds = D + 4;
  float* qs = smem_f;
  float* ks = qs + kTfQ * ds;
  float* vs = ks + 2 * kTfK * ds;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ND = D / 8;
  const float sl2 = scale * kLog2e;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const int i0 = blockIdx.x * kTfQ;
  const int n_tiles = L / kTfK;

  load_rows_async(qs, ds, q, base, row_stride, i0, kTfQ, D);
  load_rows_async(ks, ds, k, base, row_stride, 0, kTfK, D);
  load_rows_async(vs, ds, v, base, row_stride, 0, kTfK, D);
  cp_async_commit();

  const float* qw = qs + warp * 32 * ds;
  float acc[2][kTfNd][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nd = 0; nd < kTfNd; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.0f;
    }
  }
  // running max (log2 units) and sum of rows g, g + 8 of each m16 tile
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  float l[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nb = (buf ^ 1) * kTfK * ds;
      load_rows_async(ks + nb, ds, k, base, row_stride, (it + 1) * kTfK, kTfK,
                      D);
      load_rows_async(vs + nb, ds, v, base, row_stride, (it + 1) * kTfK, kTfK,
                      D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * kTfK * ds;
    const float* vt = vs + buf * kTfK * ds;

    // S = Q K^T: the warp's 32 queries x 32 keys (2 x 4 tiles of 16 x 8)
    float s[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTfNd; ++kk) {
      if (kk < ND) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* kp = kt + (8 * nt + g) * ds + 8 * kk + t;
          split_tf32(kp[0], bh[nt][0], bl[nt][0]);
          split_tf32(kp[4], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* qp = qw + (16 * mt + g) * ds + 8 * kk + t;
          const float a[4] = {qp[0], qp[8 * ds], qp[4], qp[8 * ds + 4]};
          uint32_t ah[4], al[4];
          split_frag(a, ah, al);
          mma_3xtf32(s[mt], 0, ah, al, bh, bl);
        }
      }
    }

    // online softmax per m16 tile: rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float alpha[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][nt][e] * sl2);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[mt][r] = exp2f(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
        l[mt][r] *= alpha[mt][r];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = exp2f(fmaf(s[mt][nt][e], sl2, -m[mt][e >> 1]));
          l[mt][e >> 1] += s[mt][nt][e];
        }
      }
#pragma unroll
      for (int nd = 0; nd < kTfNd; ++nd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nd][e] *= alpha[mt][e >> 1];
      }
    }

    // O += P V (the registers hold no second set of sums to fold): key
    // step kk covers keys 8kk..8kk+7; this lane's keys 8kk + 2t, + 1 stand
    // at k = t, t + 4
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float a[4] = {s[mt][kk][0], s[mt][kk][2], s[mt][kk][1],
                            s[mt][kk][3]};
        split_frag(a, ah[mt], al[mt]);
      }
      const float* vp = vt + (8 * kk + 2 * t) * ds + g;
#pragma unroll
      for (int n0 = 0; n0 < kTfNd; n0 += 4) {
        if (n0 < ND) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nd = n0 + i < ND ? n0 + i : n0;
            split_tf32(vp[8 * nd], bh[i][0], bl[i][0]);
            split_tf32(vp[ds + 8 * nd], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_3xtf32(acc[mt], n0, ah[mt], al[mt], bh, bl);
          }
        }
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
    const int row = i0 + warp * 32 + mt * 16 + g;
    if (lse != nullptr && t == 0) {
      const long lrow =
          (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L + row;
      lse[lrow] = (m[mt][0] + log2f(l[mt][0])) * kLn2;
      lse[lrow + 8] = (m[mt][1] + log2f(l[mt][1])) * kLn2;
    }
    const float inv0 = 1.0f / l[mt][0];
    const float inv1 = 1.0f / l[mt][1];
    float* o0 = o + base + row * row_stride + 2 * t;
    float* o1 = o0 + 8 * row_stride;
#pragma unroll
    for (int nd = 0; nd < kTfNd; ++nd) {
      if (nd < ND) {
        *reinterpret_cast<float2*>(o0 + 8 * nd) =
            make_float2(acc[mt][nd][0] * inv0, acc[mt][nd][1] * inv0);
        *reinterpret_cast<float2*>(o1 + 8 * nd) =
            make_float2(acc[mt][nd][2] * inv1, acc[mt][nd][3] * inv1);
      }
    }
  }
}

// The bf16 instance of width DN: its tensor maps (boxes of 128 query rows
// and BK key rows), then the launch.  key_tile must be the instance's BK.
template <int DN>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int L, int H, int D, float scale,
                int key_tile, cudaStream_t s) {
  constexpr int BK = DN <= 80 ? 128 : 64;
  if (key_tile != BK || D > DN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!bf16_rows_map(&tq, q, B, L, H, D, kWgRows) ||
      !bf16_rows_map(&tk, k, B, L, H, D, BK) ||
      !bf16_rows_map(&tv, v, B, L, H, D, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(flash_fwd_wgmma_kernel<DN, BK>, dim3(L / kWgRows, H, B),
                kWgThreads, WgTile<DN, BK>::kSmem, s, tq, tk, tv,
                static_cast<__nv_bfloat16*>(o), lse, L, H, D, scale);
}

// The map of a [B, H, D, L] fp32 V^T plane with box {32, rows, 1, 1}: 32
// keys (one 128-byte swizzled row) of `rows` head dims, zero-filled past D.
bool vt_map(CUtensorMap* map, const void* base, int B, int L, int H, int D,
            int rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 4ull * L;
  const cuuint64_t strides[3] = {row, row * D, row * D * H};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The fp32 wgmma instance of width DN: the split pass into the four planes
// of `scratch` (K hi, K lo, V^T hi, V^T lo: B L H D floats each), then the
// tensor maps (boxes of 32 head dims and 128 query rows or 64 key rows;
// of 32 keys and DN head dims) and the attention kernel.
template <int DN>
int launch_tf32(const void* q, const void* k, const void* v, void* o,
                float* lse, float* scratch, int B, int L, int H, int D,
                float scale, cudaStream_t s) {
  const long n = static_cast<long>(B) * L * H * D;
  float* kh = scratch;
  float* kl = kh + n;
  float* vh = kl + n;
  float* vl = vh + n;
  const int err = launch(flash_fwd_split_kernel, dim3(L / kTfKeys, H, B), 256,
                         0, s, static_cast<const float*>(k),
                         static_cast<const float*>(v), kh, kl, vh, vl, L, H,
                         D);
  if (err != 0) return err;
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  if (!f32_rows_map(&tq, q, B, L, H, D, kWgRows) ||
      !f32_rows_map(&tkh, kh, B, L, H, D, kTfKeys) ||
      !f32_rows_map(&tkl, kl, B, L, H, D, kTfKeys) ||
      !vt_map(&tvh, vh, B, L, H, D, DN) || !vt_map(&tvl, vl, B, L, H, D, DN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(flash_fwd_tf32_wgmma_kernel<DN>, dim3(L / kWgRows, H, B),
                kWgThreads, TfTile<DN>::kSmem, s, tq, tkh, tkl, tvh, tvl,
                static_cast<float*>(o), lse, L, H, D, scale);
}

}  // namespace

// q, k, v, o: [B, L, H, D] contiguous, 16-byte aligned; D % 8 == 0,
// D <= 160; L % 128 == 0.  is_bf16: 1 for bfloat16, 0 for float32.  lse:
// null, or [B, H, L] fp32 for the log-sum-exp of each query's scaled
// scores (what the backward K6/K7 recomputes P from).  key_tile, width:
// the instance (flash_attention.py::fwd_tiles): keys a tile and the P V
// width it is built for (bf16: 128 and 40, 64 or 80, or 64 and 160; fp32:
// 64 and 16, 32 or 64, or 32 and 160); any other pair is refused.
// scratch: 4 B L H D fp32 for the fp32 wgmma instance's K and V^T planes
// (16-byte aligned), else unused.
extern "C" int gsgen_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int L, int H, int D, float scale,
                                    int is_bf16, int key_tile, int width,
                                    void* scratch, void* stream) {
  if (L % kWgRows != 0 || D % 8 != 0 || D <= 0 || D > kMaxD || D > width ||
      B <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* lf = static_cast<float*>(lse);
  if (is_bf16) {
    switch (width) {
      case 40:
        return launch_bf16<40>(q, k, v, o, lf, B, L, H, D, scale, key_tile, s);
      case 64:
        return launch_bf16<64>(q, k, v, o, lf, B, L, H, D, scale, key_tile, s);
      case 80:
        return launch_bf16<80>(q, k, v, o, lf, B, L, H, D, scale, key_tile, s);
      case 160:
        return launch_bf16<160>(q, k, v, o, lf, B, L, H, D, scale, key_tile,
                                s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (key_tile == kTfKeys) {
    auto* sf = static_cast<float*>(scratch);
    if (sf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (width) {
      case 16:
        return launch_tf32<16>(q, k, v, o, lf, sf, B, L, H, D, scale, s);
      case 32:
        return launch_tf32<32>(q, k, v, o, lf, sf, B, L, H, D, scale, s);
      case 64:
        return launch_tf32<64>(q, k, v, o, lf, sf, B, L, H, D, scale, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (key_tile != kTfK || width != kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(flash_fwd_tf32_kernel, dim3(L / kTfQ, H, B), 128,
                sizeof(float) * (kTfQ + 4 * kTfK) * (D + 4), s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), lf, L,
                H, D, scale);
}
