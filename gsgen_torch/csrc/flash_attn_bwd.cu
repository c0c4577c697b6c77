// K6 and K7: flash self-attention backward, the gradients of
// out = softmax(q k^T * scale) v with respect to q, k and v.
//
// Replace the two Pallas kernels of the library flash attention's VJP
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_bwd
// runs _flash_attention_dkv_kernel, then _flash_attention_dq_kernel), which
// the JAX package reaches through guidance/unet2d.py::_flash_self_attention
// when VSD differentiates the UNet.  Layout as K5: q, k, v, dout and the
// gradients are [B, L, H, D], indexed directly (row stride H * D).
//
// Both kernels recompute P = exp(q k^T * scale - lse) from the lse K5 saved
// (exact in fp32, nothing of size L x L in device memory) and take
// Di = sum_d(out * dout) [B, H, L] from the caller (a torch reduction, as
// the library computes it outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Di),
//   dK = dS^T Q * scale (K6),  dQ = dS K * scale (K7).
// K6 takes one block per key tile and walks every query tile; K7 one block
// per query tile and walks every key tile.  Each block owns its output
// rows, so there are no atomics and the sums run in a fixed order: the
// results are deterministic, as the library's are.
//
// Bound on this card: operations.  At the VSD path's [4, 4096, 5, 64] the
// backward needs 10 B H L^2 D = 215 GFLOP (the library's count: S, dP, dV,
// dK, dQ; the kernels do 14 B H L^2 D, recomputing S and dP in both) against
// 42 MB of inputs and outputs.  K6 alone does 8 B H L^2 D = 172 GFLOP.
//
//  * K6 bf16, D <= 64: wgmma fed by TMA.  One CTA per (128-key tile, head,
//    batch): two consumer warpgroups of 64 keys and a producer warpgroup
//    (one thread issues the copies).  The
//    CTA's K and V tiles stay resident in shared memory; Q and dO tiles of
//    64 queries, with their lse and Di rows, stream through a 3-stage TMA
//    ring (mbarrier full/empty pairs, 128-byte swizzle, zero fill past D).
//    Per query tile: S^T = K Q^T and dP^T = V dO^T as SS wgmma (K-major);
//    P^T = exp2(S^T scale log2e - lse log2e) and dS^T = P^T (dP^T - Di),
//    rounded to bf16 in registers as the A operands of dV += P^T dO and
//    dK += dS^T Q, RS wgmma with dO and Q as MN-major B (tnspB).  dK * scale
//    and dV go to bf16 at the end.  setmaxnreg moves registers inside the
//    CTA's allocation (168 a thread): producer 40, consumers 232.
//  * K6 fp32, D <= 64 (the VSD path: the JAX VSD UNet runs in fp32): 3xTF32 on
//    wgmma fed by TMA, about 2^-21 relative per product: each operand x splits
//    into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest, and each
//    product is lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32 accumulation.
//    Bound at the rate this design can reach: 3 x 8 B H L^2 D / 495 TFLOP/s
//    (1.04 ms at [4, 4096, 5, 64]).  For 32-bit types wgmma reads
//    shared-memory operands K-major only (no transpose bit), and dV = P^T dO
//    and dK = dS^T Q contract over queries, which are not contiguous in the
//    [B, L, H, D] tiles.  So the gradient products are taken transposed, dV^T
//    = dO^T P and dK^T = Q^T dS: the row-major dO / Q tile is the register A
//    operand (registers have no majorness), loaded transposed and split in
//    registers, and P and dS go to shared memory as [key][query] hi and lo
//    planes, K-major B operands.  One CTA per (64-key tile, head, batch):
//    warpgroup 0 runs S = Q K^T, P and dV^T, warpgroup 1 dP = dO V^T, dS and
//    dK^T (4 products of 64 x 64 a tile, 2 each), one thread of a producer
//    warpgroup the TMA ring of Q / dO tiles of 64 queries with their lse and
//    Di rows (3 stages, mbarrier full/empty pairs, 128-byte swizzle, two boxes
//    of 32 fp32 side by side).  The score products take the Q / dO tile as A
//    against K and V split once into resident hi / lo planes.  Warpgroup 1
//    reads P back as hi + lo (named barriers between the two).  Shared memory:
//    8 planes of 16 KB and 3 stages of 32.5 KB, 226.5 KB of 227.  TF32
//    rounding takes two integer instructions (cvt.rna.tf32 ran at a fraction
//    of their rate), the next k-step's A values load before this one's
//    products issue, two k-steps are in flight, and every product takes 8
//    k-steps known at compile time (TMA zero-fills the head dims past D): a
//    run-time count serialised every wgmma.  Each tile's products go to
//    partial sums folded in by rounded fp32 adds.  D = 72-160 (only SD 1.5
//    under `fused_attention: on` would reach it; no shipped config runs VSD
//    so) stays on PR 5's mma.sync m16n8k8 instance: 4 warps of 16 keys, Q, dO,
//    lse and Di tiles of 32 queries double-buffered by cp.async.
//  * K7 bf16, D <= 64: K6's design with the roles swapped.  One CTA per
//    (128-query tile, head, batch): two consumer warpgroups of 64 queries
//    and a producer warpgroup.  Q and dO stay resident (lse and Di rows in
//    registers); K and V tiles of 64 keys stream through a 3-stage TMA
//    ring.  Per key tile: S = Q K^T and dP = dO V^T as SS wgmma; dS =
//    exp2(S scale log2e - lse log2e) (dP - Di) rounded to bf16 in registers
//    as the A operand of dQ += dS K, an RS wgmma reading K's tile MN-major
//    (tnspB) from the same swizzled bytes the score product read K-major.
//  * K7 fp32, D <= 64: 3xTF32 on wgmma + TMA, K6's design with the roles
//    swapped. dQ = dS K contracts over keys, so it is taken as dQ^T = K^T
//    dS^T: the K tile transposed is the register A operand, dS^T goes to
//    shared memory as [query][key] hi and lo planes.  One CTA per (64-query
//    tile, head, batch): Q and dO split once into resident hi / lo planes; K
//    and V tiles of 64 keys stream through the 3-stage ring.  Warpgroup 0 runs
//    S^T = K Q^T and P^T and hands P^T over in fp32; warpgroup 1 runs dP^T = V
//    dO^T, dS^T and dQ^T.  Giving warpgroup 0 half of dQ^T (a second pair of
//    named barriers) was 6.5% slower.  Bound at the rate this design can
//    reach: 3 x 6 B H L^2 D / 495 TFLOP/s (0.78 ms at [4, 4096, 5, 64]).  D =
//    72-160 stays on PR 6's mma.sync instance: 4 warps of 16 queries, K and V
//    tiles of 32 keys double-buffered by cp.async, dS in registers as the A
//    operand of dQ += dS K (keys (2t, 2t + 1) at k = (t, t + 4), K's rows
//    permuted the same way).
//  * K6 and K7 bf16, D = 72-160 (SD 1.5's levels under `fused_attention:
//    on`, D = 80 and 160): wgmma fed by TMA, one instance a width, DN = 80
//    (D = 72, 80) or 160 (D = 88-160), every product's k-steps known at
//    compile time and TMA zero-filling the head dims past D; a tile wider
//    than 64 head dims is ceil(DN / 64) 128-byte-swizzle boxes side by
//    side, as in K5.  Registers set the design: ptxas gives a 384-thread CTA
//    168 a thread, and one warpgroup holding dK and dV for its 64 keys
//    beside S^T and dP^T (the D <= 64 layout) would need 176 values at DN =
//    80 and 256 at 160.  So the roles split as in K6 fp32: one CTA per
//    (64-key tile, head, batch), warpgroup 0 runs S^T = K Q^T, P^T and dV
//    += P^T dO, warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - Di) and dK +=
//    dS^T Q, each holding one accumulator (DN / 2 values), one score tile
//    (32) and its bf16 fragments (16): 128 at DN = 160.  P^T passes to
//    warpgroup 1 in fp32 through 16 KB of shared memory in register order
//    (named barriers), so dS takes the exact P as before.  K and V stay
//    resident; Q and dO tiles of 64 queries with their lse and Di rows
//    stream through a ring of 4 stages at DN = 80 and 3 at 160 (216 KB of
//    shared memory at DN = 160).
//    K7 swaps the roles: one CTA per (64-query tile, head, batch), Q and dO
//    resident, K and V streamed; warpgroup 0 runs S = Q K^T and P,
//    warpgroup 1 dP = dO V^T, dS and dQ += dS K.  A warpgroup issues the
//    next tile's score product with this tile's gradient product; in K6 it
//    waits for the score product alone and runs its elementwise step (P^T
//    or dS^T) beside the gradient product, in K7 it waits for both (there
//    the overlap was slower).  P and dS are rounded to bf16 only as the A
//    operands of the gradient products (RS wgmma, the streamed tile as an
//    MN-major B).  Bound at SD 1.5's levels: operations at [4, 1024,
//    8, 80] (K6 0.0217 ms, K7 0.0163 ms at 989 TFLOP/s), bytes at [4, 256,
//    8, 160] (gsgen_torch/tools/k5_bench.py::bwd_bound_ms).
#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

#include <math.h>

namespace {

constexpr int kDkvKeys = 128;      // keys per CTA (K6 wgmma)
constexpr int kDkvQ = 64;          // queries per ring stage (K6 wgmma)
constexpr int kDkvStages = 3;
constexpr int kDkvTile = 64 * 128;  // bytes of a 64-row bf16 TMA tile
constexpr int kWgThreads = 384;     // two consumer warpgroups + producer
// dynamic shared memory: K and V, the Q / dO / lse / Di ring, the barriers,
// and the slack that aligns the base to 1024 bytes
constexpr int kDkvSmem = 4 * kDkvTile + kDkvStages * (2 * kDkvTile + 512) +
                         8 * (1 + 2 * kDkvStages) + 1024;
constexpr int kTfQ = 32;  // queries per streamed tile (K6 fp32)
constexpr int kDqQ = 128;          // queries per CTA (K7 wgmma)
constexpr int kDqKeys = 64;        // keys per ring stage (K7 wgmma)
constexpr int kDqStages = 3;
// dynamic shared memory (K7 wgmma): Q and dO, the K / V ring, the barriers,
// the alignment slack
constexpr int kDqSmem = 4 * kDkvTile + kDqStages * 2 * kDkvTile +
                        8 * (1 + 2 * kDqStages) + 1024;
constexpr int kDqTfKeys = 32;  // keys per streamed tile (K7 fp32)

// One warpgroup's DN / 2 accumulators of a 64-row output tile to bf16
// (the bf16 kernels' epilogue): rows row0 + 16 warp + g (+ 8) of [B, L, H,
// D] (b, h), times `mul`.
template <int DN>
__device__ __forceinline__ void store_rows_bf16(
    __nv_bfloat16* __restrict__ out, const float (&acc)[DN / 2], int b,
    int h, int row0, int L, int H, int D, float mul) {
  const int lane = threadIdx.x & 31;
  const long row_stride = static_cast<long>(H) * D;
  const int row = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const long off0 = (static_cast<long>(b) * L + row) * row_stride + h * D +
                    2 * (lane & 3);
  const long off1 = off0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < DN / 8; ++j) {
    if (j * 8 < D) {
      *reinterpret_cast<uint32_t*>(out + off0 + 8 * j) =
          pack_f32_bf16(acc[4 * j + 0] * mul, acc[4 * j + 1] * mul);
      *reinterpret_cast<uint32_t*>(out + off1 + 8 * j) =
          pack_f32_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

// ---- K6, bf16, D <= 64: wgmma + TMA ----------------------------------------
// Threads 0-255: two consumer warpgroups, each owning 64 of the CTA's 128
// keys; threads 256-383: the producer warpgroup (thread 256 issues the
// copies).  Shared memory (1024-aligned): K, V [128 rows]
// (resident), the ring of Q and dO tiles [kDkvStages][64 rows] and of
// their lse / Di rows [kDkvStages][64 + 64 floats], then the barriers
// kv_full, full[s], empty[s].
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int L, int H,
                               int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ks = (raw + 1023u) & ~1023u;
  const uint32_t vs = ks + 2 * kDkvTile;
  const uint32_t qs0 = vs + 2 * kDkvTile;
  const uint32_t dos0 = qs0 + kDkvStages * kDkvTile;
  const uint32_t rows0 = dos0 + kDkvStages * kDkvTile;  // lse, Di per stage
  const uint32_t kv_full = rows0 + kDkvStages * 512;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * kDkvStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kDkvKeys;
  const int n_tiles = L / kDkvQ;
  const long lbase = (static_cast<long>(b) * H + h) * L;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
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
      mbar_expect_tx(kv_full, 4 * kDkvTile);
      tma_load_4d(ks, &tk, kv_full, 0, h, j0, b);
      tma_load_4d(vs, &tv, kv_full, 0, h, j0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDkvStages;
        const uint32_t bar = full0 + 8 * s;
        if (it >= kDkvStages) {
          mbar_wait(empty0 + 8 * s, ((it / kDkvStages) - 1) & 1);
        }
        mbar_expect_tx(bar, 2 * kDkvTile + 512);
        tma_load_4d(qs0 + s * kDkvTile, &tq, bar, 0, h, it * kDkvQ, b);
        tma_load_4d(dos0 + s * kDkvTile, &tdo, bar, 0, h, it * kDkvQ, b);
        bulk_load(rows0 + s * 512, lse + lbase + it * kDkvQ, 256, bar);
        bulk_load(rows0 + s * 512 + 256, delta + lbase + it * kDkvQ, 256,
                  bar);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<232>();  // 256 x (232 - 168): what the producer gave
    const int wg = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int KT = (D + 15) / 16;
    const float sl2 = scale * kLog2e;
    const uint32_t ka = ks + wg * kDkvTile;  // this warpgroup's 64 keys
    const uint32_t va = vs + wg * kDkvTile;

    float acc_v[32], acc_k[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_v[i] = 0.0f;
      acc_k[i] = 0.0f;
    }

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDkvStages;
      mbar_wait(full0 + 8 * s, (it / kDkvStages) & 1);
      const uint32_t qb = qs0 + s * kDkvTile;
      const uint32_t db = dos0 + s * kDkvTile;
      const float* lse_s =
          reinterpret_cast<const float*>(smem_raw + (rows0 + s * 512 - raw));
      const float* di_s = lse_s + kDkvQ;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(st, desc_sw128(ka + 32 * kt), desc_sw128(qb + 32 * kt),
                   kt);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(dpt, desc_sw128(va + 32 * kt), desc_sw128(db + 32 * kt),
                   kt);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - Di), in
      // bf16 as the A operands (k = queries) of the two sums
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t;
        const float l0 = lse_s[qc] * kLog2e, l1 = lse_s[qc + 1] * kLog2e;
        const float d0 = di_s[qc], d1 = di_s[qc + 1];
        const float p0 = exp2f(fmaf(st[4 * j + 0], sl2, -l0));
        const float p1 = exp2f(fmaf(st[4 * j + 1], sl2, -l1));
        const float p2 = exp2f(fmaf(st[4 * j + 2], sl2, -l0));
        const float p3 = exp2f(fmaf(st[4 * j + 3], sl2, -l1));
        pa[j >> 1][(j & 1) * 2 + 0] = pack_f32_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_f32_bf16(p2, p3);
        da[j >> 1][(j & 1) * 2 + 0] = pack_f32_bf16(
            p0 * (dpt[4 * j + 0] - d0), p1 * (dpt[4 * j + 1] - d1));
        da[j >> 1][(j & 1) * 2 + 1] = pack_f32_bf16(
            p2 * (dpt[4 * j + 2] - d0), p3 * (dpt[4 * j + 3] - d1));
      }

      // dV += P^T dO, dK += dS^T Q: dO's and Q's rows (queries) are k,
      // their head dims N (MN-major)
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc_v, pa[kk], desc_sw128(db + 2048 * kk));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc_k, da[kk], desc_sw128(qb + 2048 * kk));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    store_rows_bf16<64>(dv, acc_v, b, h, j0 + wg * 64, L, H, D, 1.0f);
    store_rows_bf16<64>(dk, acc_k, b, h, j0 + wg * 64, L, H, D, scale);
  }
}

// ---- K7, bf16, D <= 64: wgmma + TMA ----------------------------------------
// K6's structure with the roles swapped.  Threads 0-255: two consumer
// warpgroups, each owning 64 of the CTA's 128 queries; threads 256-383: the
// producer warpgroup (thread 256 issues the copies).  Shared memory
// (1024-aligned): Q, dO [128 rows] (resident), the ring of K and V tiles
// [kDqStages][64 rows], then the barriers q_full, full[s], empty[s].
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int L, int H,
                              int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t dos = qs + 2 * kDkvTile;
  const uint32_t ks0 = dos + 2 * kDkvTile;
  const uint32_t vs0 = ks0 + kDqStages * kDkvTile;
  const uint32_t q_full = vs0 + kDqStages * kDkvTile;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kDqStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * kDqQ;
  const int n_tiles = L / kDqKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      mbar_expect_tx(q_full, 4 * kDkvTile);
      tma_load_4d(qs, &tq, q_full, 0, h, i0, b);
      tma_load_4d(dos, &tdo, q_full, 0, h, i0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDqStages;
        const uint32_t bar = full0 + 8 * s;
        if (it >= kDqStages) {
          mbar_wait(empty0 + 8 * s, ((it / kDqStages) - 1) & 1);
        }
        mbar_expect_tx(bar, 2 * kDkvTile);
        tma_load_4d(ks0 + s * kDkvTile, &tk, bar, 0, h, it * kDqKeys, b);
        tma_load_4d(vs0 + s * kDkvTile, &tv, bar, 0, h, it * kDqKeys, b);
      }
    }
  } else {
    // ---- consumers ----
    setmaxnreg_inc<232>();  // 256 x (232 - 168): what the producer gave
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int KT = (D + 15) / 16;
    const float sl2 = scale * kLog2e;
    const uint32_t qa = qs + wg * kDkvTile;  // this warpgroup's 64 queries
    const uint32_t da = dos + wg * kDkvTile;
    // this lane's two query rows: g and g + 8 of its warp's 16
    const int row = i0 + wg * 64 + warp * 16 + g;
    const long lrow = (static_cast<long>(b) * H + h) * L + row;
    const float l0 = lse[lrow] * kLog2e, l1 = lse[lrow + 8] * kLog2e;
    const float d0 = delta[lrow], d1 = delta[lrow + 8];

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kDqStages;
      mbar_wait(full0 + 8 * s, (it / kDqStages) & 1);
      const uint32_t kb = ks0 + s * kDkvTile;
      const uint32_t vb = vs0 + s * kDkvTile;

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(sc, desc_sw128(qa + 32 * kt), desc_sw128(kb + 32 * kt),
                   kt);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        if (kt < KT) {
          wgmma_ss(dp, desc_sw128(da + 32 * kt), desc_sw128(vb + 32 * kt),
                   kt);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp2(S scale log2e - lse log2e), dS = P (dP - Di), in bf16 as
      // the A operand (k = keys) of dQ += dS K
      uint32_t dsa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(fmaf(sc[4 * j + 0], sl2, -l0));
        const float p1 = exp2f(fmaf(sc[4 * j + 1], sl2, -l0));
        const float p2 = exp2f(fmaf(sc[4 * j + 2], sl2, -l1));
        const float p3 = exp2f(fmaf(sc[4 * j + 3], sl2, -l1));
        dsa[j >> 1][(j & 1) * 2 + 0] =
            pack_f32_bf16(p0 * (dp[4 * j + 0] - d0), p1 * (dp[4 * j + 1] - d0));
        dsa[j >> 1][(j & 1) * 2 + 1] =
            pack_f32_bf16(p2 * (dp[4 * j + 2] - d1), p3 * (dp[4 * j + 3] - d1));
      }

      // dQ += dS K: K's rows (keys) are k, its head dims N (MN-major)
      fence_regs(acc);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc, dsa[kk], desc_sw128(kb + 2048 * kk));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    store_rows_bf16<64>(dq, acc, b, h, i0 + wg * 64, L, H, D, scale);
  }
}

// ---- K6 and K7, fp32, D <= 64: 3xTF32 on wgmma + TMA ----------------------
// Every tile is 64 rows of 64 fp32 in the 128-byte swizzle: two atom
// columns of 64 rows x 128 bytes (32 floats), each the box of one TMA copy.
constexpr int kTfCol = 64 * 128;
constexpr int kTfTile = 2 * kTfCol;
constexpr int kTfStages = 3;
// K6: K, V (hi in place) and their lo planes, P and dS hi / lo, the ring of
// Q and dO tiles and of their lse / Di rows, the barriers, the slack that
// aligns the base to 1024 bytes (231,992 of the 232,448 bytes a block may
// have)
constexpr int kDkvTfSmem = 8 * kTfTile + kTfStages * (2 * kTfTile + 512) +
                           8 * (1 + 2 * kTfStages) + 1024;
// K7: Q, dO (hi in place) and their lo planes, P, dS hi / lo, the ring of K
// and V tiles, the barriers, the slack
constexpr int kDqTfSmem = 7 * kTfTile + kTfStages * 2 * kTfTile +
                          8 * (1 + 2 * kTfStages) + 1024;
// named barriers (0 is __syncthreads): P written / read between the two
// consumer warpgroups, then one for each warpgroup's own 128 threads
constexpr int kBarPFull = 1;
constexpr int kBarPFree = 2;
constexpr int kBarWg = 3;

__device__ __forceinline__ void bar_sync_n(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive_n(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Byte offset of element (row, col) of a swizzled fp32 tile.
__device__ __forceinline__ uint32_t tf_off(int row, int col) {
  return (col >> 5) * kTfCol + row * 128 +
         ((((col >> 2) & 7) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

__device__ __forceinline__ float& tf_at(unsigned char* tile, int row,
                                        int col) {
  return *reinterpret_cast<float*>(tile + tf_off(row, col));
}

// One 64-row fp32 tile (rows row0.. of head h, batch b) by two TMA boxes.
__device__ __forceinline__ void tma_tile_f32(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int h, int row0,
                                             int b) {
  tma_load_4d(dst, map, bar, 0, h, row0, b);
  tma_load_4d(dst + kTfCol, map, bar, 32, h, row0, b);
}

// A resident tile split into TF32 hi (rounded, in place) and lo planes by
// the warpgroup's 128 threads: elementwise, so the swizzle does not matter.
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo, int tid) {
  auto* h4 = reinterpret_cast<uint4*>(hi);
  auto* l4 = reinterpret_cast<uint4*>(lo);
  for (int i = tid; i < kTfTile / 16; i += 128) {
    uint4 x = h4[i], y;
    split_tf32(__uint_as_float(x.x), x.x, y.x);
    split_tf32(__uint_as_float(x.y), x.y, y.y);
    split_tf32(__uint_as_float(x.z), x.z, y.z);
    split_tf32(__uint_as_float(x.w), x.w, y.w);
    h4[i] = x;
    l4[i] = y;
  }
}

// acc = A B, 64 x 64, over 8 k-steps of 8: one warpgroup, A from the
// tile `a` in registers, split into TF32 hi and lo there; B the hi / lo
// planes at shared addresses bh / bl, K-major (their rows are N).  kCols:
// A's rows are the tile's columns and k its rows (A = tile^T); else A's rows
// are the tile's rows and k its columns.  Each k-step issues lo_a hi_b,
// hi_a lo_b, hi_a hi_b as one commit group; kInFlight groups are in flight,
// their A registers in turn, and the next k-step's A values are loaded
// before this one's products are issued.  m0 = 16 warp + g.
template <bool kCols>
__device__ __forceinline__ void mma_3xtf32_wg(float (&acc)[32],
                                              const unsigned char* a,
                                              uint32_t bh, uint32_t bl,
                                              int m0, int t) {
  constexpr int kSteps = 8;
  constexpr int kInFlight = 2;
  auto load = [&](int kk, float (&x)[4]) {
    const int k0 = 8 * kk + t;
    const int r[4] = {kCols ? k0 : m0, kCols ? k0 : m0 + 8,
                      kCols ? k0 + 4 : m0, kCols ? k0 + 4 : m0 + 8};
    const int c[4] = {kCols ? m0 : k0, kCols ? m0 + 8 : k0,
                      kCols ? m0 : k0 + 4, kCols ? m0 + 8 : k0 + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = *reinterpret_cast<const float*>(a + tf_off(r[e], c[e]));
    }
  };
  uint32_t ah[kInFlight][4], al[kInFlight][4];
  float x[4];
  load(0, x);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int u = kk % kInFlight;
    if (kk >= kInFlight) {
      wgmma_wait<kInFlight - 1>();  // group kk - kInFlight is done
      fence_regs(ah[u]);
      fence_regs(al[u]);
    }
    split_frag(x, ah[u], al[u]);
    if (kk + 1 < kSteps) load(kk + 1, x);
    const uint32_t off = (kk >> 2) * kTfCol + 32 * (kk & 3);
    wgmma_fence();
    wgmma_tf32(acc, al[u], desc_sw128(bh + off), kk);
    wgmma_tf32(acc, ah[u], desc_sw128(bl + off), 1);
    wgmma_tf32(acc, ah[u], desc_sw128(bh + off), 1);
    wgmma_commit();
  }
  wgmma_wait0();
  fence_regs(acc);
}

// K6 fp32: every D <= 64, the score products over 8 k-steps of head dims
// (TMA zero-fills the head dims past D).  A k-step count known to ptxas
// keeps the products' commit groups in flight: read at run time it
// serialised every wgmma (C7515) and took 25% longer.  One CTA per (64-key
// tile, head, batch).  Threads 0-127: consumer
// warpgroup 0, S = Q K^T, P, dV^T += dO^T P; threads 128-255: warpgroup 1,
// dP = dO V^T, dS = P (dP - Di), dK^T += Q^T dS; threads 256-383: the
// producer (thread 256 issues the copies).  The score products take the
// streamed Q / dO tile as the register A operand (64 queries, k = head
// dims) against the resident K / V hi and lo planes; the gradient products
// take the same tile transposed as A (64 head dims, k = queries) against P
// and dS written to shared memory as [key][query] hi and lo planes.
// Warpgroup 1 reads P back as hi + lo.  Each tile's product goes to a
// partial sum folded into the total by rounded fp32 adds.
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int L, int H,
                                    int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  constexpr int kKh = 0, kKl = kTfTile, kVh = 2 * kTfTile, kVl = 3 * kTfTile;
  constexpr int kPh = 4 * kTfTile, kPl = 5 * kTfTile;
  constexpr int kSh = 6 * kTfTile, kSl = 7 * kTfTile;
  constexpr int kQ0 = 8 * kTfTile, kO0 = kQ0 + kTfStages * kTfTile;
  constexpr int kRows0 = kO0 + kTfStages * kTfTile;  // lse, Di per stage
  const uint32_t kv_full = base + kRows0 + kTfStages * 512;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * kTfStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * 64;
  const int n_tiles = L / 64;
  const long lbase = (static_cast<long>(b) * H + h) * L;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * kTfTile);
      tma_tile_f32(base + kKh, &tk, kv_full, h, j0, b);
      tma_tile_f32(base + kVh, &tv, kv_full, h, j0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kTfStages;
        const uint32_t bar = full0 + 8 * s;
        if (it >= kTfStages) {
          mbar_wait(empty0 + 8 * s, ((it / kTfStages) - 1) & 1);
        }
        mbar_expect_tx(bar, 2 * kTfTile + 512);
        tma_tile_f32(base + kQ0 + s * kTfTile, &tq, bar, h, it * 64, b);
        tma_tile_f32(base + kO0 + s * kTfTile, &tdo, bar, h, it * 64, b);
        bulk_load(base + kRows0 + s * 512, lse + lbase + it * 64, 256, bar);
        bulk_load(base + kRows0 + s * 512 + 256, delta + lbase + it * 64,
                  256, bar);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * (tid >> 5) + g;  // rows m0, m0 + 8 of every product
  const float sl2 = scale * kLog2e;
  // this warpgroup's resident operand: K (wg 0) or V (wg 1)
  const int rh = wg ? kVh : kKh, rl = wg ? kVl : kKl;
  mbar_wait(kv_full, 0);
  split_tile(sm + rh, sm + rl, tid);
  fence_proxy_async();
  bar_sync_n(kBarWg + wg, 128);
  if (wg == 1) bar_arrive_n(kBarPFree, 256);  // no P to read yet

  float acc[32], part[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTfStages;
    mbar_wait(full0 + 8 * s, (it / kTfStages) & 1);
    const unsigned char* qt = sm + kQ0 + s * kTfTile;
    const unsigned char* ot = sm + kO0 + s * kTfTile;
    const float* rows =
        reinterpret_cast<const float*>(sm + kRows0 + s * 512);

    // S = Q K^T (wg 0) or dP = dO V^T (wg 1): 64 queries x 64 keys
    mma_3xtf32_wg<false>(sc, wg ? ot : qt, base + rh, base + rl, m0, t);

    // accumulator i: query m0 + 8 (i & 2 ? 1 : 0), key 8 (i / 4) + 2t +
    // (i & 1)
    if (wg == 0) {
      const float l0 = rows[m0] * kLog2e, l1 = rows[m0 + 8] * kLog2e;
      bar_sync_n(kBarPFree, 256);  // warpgroup 1 has read the last P
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = m0 + ((i & 2) << 2);
        const int key = 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = exp2f(fmaf(sc[i], sl2, (i & 2) ? -l1 : -l0));
        uint32_t hi, lo;
        split_tf32(p, hi, lo);
        tf_at(sm + kPh, key, q) = __uint_as_float(hi);
        tf_at(sm + kPl, key, q) = __uint_as_float(lo);
      }
      fence_proxy_async();
      bar_arrive_n(kBarPFull, 256);
      bar_sync_n(kBarWg, 128);
      // dV^T = dO^T P: 64 head dims x 64 keys, k = queries
      mma_3xtf32_wg<true>(part, ot, base + kPh, base + kPl, m0, t);
    } else {
      const float d0 = rows[64 + m0], d1 = rows[64 + m0 + 8];
      bar_sync_n(kBarPFull, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = m0 + ((i & 2) << 2);
        const int key = 8 * (i >> 2) + 2 * t + (i & 1);
        const float p = tf_at(sm + kPh, key, q) + tf_at(sm + kPl, key, q);
        sc[i] = p * (sc[i] - ((i & 2) ? d1 : d0));
      }
      if (it + 1 < n_tiles) bar_arrive_n(kBarPFree, 256);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = m0 + ((i & 2) << 2);
        const int key = 8 * (i >> 2) + 2 * t + (i & 1);
        uint32_t hi, lo;
        split_tf32(sc[i], hi, lo);
        tf_at(sm + kSh, key, q) = __uint_as_float(hi);
        tf_at(sm + kSl, key, q) = __uint_as_float(lo);
      }
      fence_proxy_async();
      bar_sync_n(kBarWg + 1, 128);
      // dK^T = Q^T dS: 64 head dims x 64 keys, k = queries
      mma_3xtf32_wg<true>(part, qt, base + kSh, base + kSl, m0, t);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }

  // acc i: head dim m0 + 8 (i & 2 ? 1 : 0), key 8 (i / 4) + 2t + (i & 1)
  float* out = wg ? dk : dv;
  const float mul = wg ? scale : 1.0f;
  const long row_stride = static_cast<long>(H) * D;
  const long o0 = (static_cast<long>(b) * L + j0) * row_stride + h * D;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = m0 + ((i & 2) << 2);
    const int key = 8 * (i >> 2) + 2 * t + (i & 1);
    if (d < D) out[o0 + key * row_stride + d] = acc[i] * mul;
  }
}

// K7 fp32: every D <= 64, as K6's.  One CTA per (64-query tile, head, batch).  Threads
// 0-127: consumer warpgroup 0, S^T = K Q^T and P^T; threads 128-255: warpgroup
// 1, dP^T = V dO^T, dS^T = P^T (dP^T - Di), dQ^T += K^T dS^T; threads 256-383:
// the producer.  The score products take the streamed K / V tile as the
// register A operand (64 keys, k = head dims) against the resident Q / dO hi
// and lo planes; P^T passes to warpgroup 1 in fp32 through shared memory in
// register order; dQ^T takes the K tile transposed as A (64 head dims, k =
// keys) against dS written as [query][key] hi and lo planes.  Each tile's dQ^T
// goes to a partial sum folded in by rounded fp32 adds.
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dq, int L, int H,
                                   int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  constexpr int kQh = 0, kQl = kTfTile, kOh = 2 * kTfTile, kOl = 3 * kTfTile;
  constexpr int kP = 4 * kTfTile, kSh = 5 * kTfTile, kSl = 6 * kTfTile;
  constexpr int kK0 = 7 * kTfTile, kV0 = kK0 + kTfStages * kTfTile;
  const uint32_t q_full = base + kV0 + kTfStages * kTfTile;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kTfStages;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * 64;
  const int n_tiles = L / 64;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * kTfTile);
      tma_tile_f32(base + kQh, &tq, q_full, h, i0, b);
      tma_tile_f32(base + kOh, &tdo, q_full, h, i0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kTfStages;
        const uint32_t bar = full0 + 8 * s;
        if (it >= kTfStages) {
          mbar_wait(empty0 + 8 * s, ((it / kTfStages) - 1) & 1);
        }
        mbar_expect_tx(bar, 2 * kTfTile);
        tma_tile_f32(base + kK0 + s * kTfTile, &tk, bar, h, it * 64, b);
        tma_tile_f32(base + kV0 + s * kTfTile, &tv, bar, h, it * 64, b);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * (tid >> 5) + g;
  const float sl2 = scale * kLog2e;
  // this warpgroup's resident operand: Q (wg 0) or dO (wg 1), and the
  // lse (log2 units) or Di of this lane's 16 query columns 8j + 2t + e
  const int rh = wg ? kOh : kQh, rl = wg ? kOl : kQl;
  const long lrow = (static_cast<long>(b) * H + h) * L + i0;
  float cst[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int q = 8 * (c >> 1) + 2 * t + (c & 1);
    cst[c] = wg ? delta[lrow + q] : lse[lrow + q] * kLog2e;
  }
  mbar_wait(q_full, 0);
  split_tile(sm + rh, sm + rl, tid);
  fence_proxy_async();
  bar_sync_n(kBarWg + wg, 128);
  if (wg == 1) bar_arrive_n(kBarPFree, 256);  // no P to read yet

  float acc[32], part[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float* pp = reinterpret_cast<float*>(sm + kP);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kTfStages;
    mbar_wait(full0 + 8 * s, (it / kTfStages) & 1);
    const unsigned char* kt = sm + kK0 + s * kTfTile;
    const unsigned char* vt = sm + kV0 + s * kTfTile;

    // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1): 64 keys x 64 queries;
    // accumulator i: key m0 + 8 (i & 2 ? 1 : 0), query column i / 2 of cst
    mma_3xtf32_wg<false>(sc, wg ? vt : kt, base + rh, base + rl, m0, t);
    if (wg == 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2, -cst[((i >> 2) << 1) | (i & 1)]));
      }
      bar_sync_n(kBarPFree, 256);  // warpgroup 1 has read the last P
#pragma unroll
      for (int i = 0; i < 32; ++i) pp[i * 128 + tid] = sc[i];
      bar_arrive_n(kBarPFull, 256);
      continue;
    }
    bar_sync_n(kBarPFull, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = pp[i * 128 + tid] * (sc[i] - cst[((i >> 2) << 1) | (i & 1)]);
    }
    if (it + 1 < n_tiles) bar_arrive_n(kBarPFree, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = m0 + ((i & 2) << 2);
      const int q = 8 * (i >> 2) + 2 * t + (i & 1);
      uint32_t hi, lo;
      split_tf32(sc[i], hi, lo);
      tf_at(sm + kSh, q, key) = __uint_as_float(hi);
      tf_at(sm + kSl, q, key) = __uint_as_float(lo);
    }
    fence_proxy_async();
    bar_sync_n(kBarWg + 1, 128);
    // dQ^T = K^T dS^T: 64 head dims x 64 queries, k = keys
    mma_3xtf32_wg<true>(part, kt, base + kSh, base + kSl, m0, t);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }
  if (wg == 0) return;

  // acc i: head dim m0 + 8 (i & 2 ? 1 : 0), query 8 (i / 4) + 2t + (i & 1)
  const long row_stride = static_cast<long>(H) * D;
  const long o0 = (static_cast<long>(b) * L + i0) * row_stride + h * D;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int d = m0 + ((i & 2) << 2);
    const int q = 8 * (i >> 2) + 2 * t + (i & 1);
    if (d < D) dq[o0 + q * row_stride + d] = acc[i] * scale;
  }
}

// ---- K6 and K7, bf16, D = 72-160: wgmma + TMA ----------------------------
// The instance of width DN (80 or 160; D rounds up to it, TMA zero-filling
// the head dims past D): sizes in bytes.  A tile is 64 rows in kAtoms atom
// columns of 64 rows x 128 bytes (64 head dims, one TMA box each).
template <int DN>
struct WideTile {
  static constexpr int kAtoms = (DN + 63) / 64;
  static constexpr int kCol = 64 * 128;
  static constexpr int kTile = kAtoms * kCol;
  // 4 stages where they fit (3% faster than 3 at [4, 1024, 8, 80])
  static constexpr int kStages = DN <= 80 ? 4 : 3;
  static constexpr int kPBuf = 64 * 64 * 4;  // P handed over in fp32
  // K6: K, V (resident), the ring of Q and dO tiles and of their lse / Di
  // rows, P, the barriers, the slack that aligns the base to 1024 bytes
  // (183,368 bytes at DN = 80, 215,608 at 160)
  static constexpr int kDkvSmem = 2 * kTile + kStages * (2 * kTile + 512) +
                                  kPBuf + 8 * (1 + 2 * kStages) + 1024;
  // K7: Q, dO (resident), the ring of K and V tiles, P, the barriers, the
  // slack (181,320 bytes at DN = 80, 214,072 at 160)
  static constexpr int kDqSmem = 2 * kTile + kStages * 2 * kTile + kPBuf +
                                 8 * (1 + 2 * kStages) + 1024;
};

// d = A B^T, 64 x 64, for one warpgroup: A's and B's 64 rows K-major, k the
// DN head dims (k-step kt reads 16 of atom column kt / 4).  Issued and
// committed, not waited for.
template <int DN>
__device__ __forceinline__ void issue_scores_wide(float (&d)[32], uint32_t a,
                                                  uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < DN / 16; ++kt) {
    const uint32_t off = (kt >> 2) * WideTile<DN>::kCol + 32 * (kt & 3);
    wgmma_ss(d, desc_sw128(a + off), desc_sw128(b + off), kt);
  }
  wgmma_commit();
}

// acc += A B, 64 x DN: A the bf16 fragments of a 64 x 64 score tile (k its
// 64 columns), B a streamed tile read MN-major (its rows are k, its head
// dims N; N past 64 runs on in the next atom column, kCol bytes on).
// Issued and committed, not waited for.
template <int DN>
__device__ __forceinline__ void issue_grad_wide(float (&acc)[DN / 2],
                                                uint32_t (&a)[4][4],
                                                uint32_t b) {
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(acc, a[kk], desc_sw128(b + 2048 * kk, WideTile<DN>::kCol));
  }
  wgmma_commit();
}

// A 64 x 64 score-shaped tile in fp32 registers (accumulator 4j + e: row
// 16 warp + g, + 8 if e >= 2; column 8j + 2t + (e & 1)) rounded to bf16 as
// the A fragments of a gradient product, k its 64 columns.
__device__ __forceinline__ void pack_frags(const float (&x)[32],
                                           uint32_t (&fa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    fa[j >> 1][(j & 1) * 2 + 0] = pack_f32_bf16(x[4 * j + 0], x[4 * j + 1]);
    fa[j >> 1][(j & 1) * 2 + 1] = pack_f32_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// K6, warpgroup 0: S^T into P^T = exp2(S^T sl2 - lse log2(e)) in place, lse
// the tile's 64 query rows (the columns), written to pp in register order
// for warpgroup 1.
__device__ __forceinline__ void dkv_probs(float (&sc)[32], const float* lse,
                                          float* pp, float sl2) {
  const int tid = threadIdx.x & 127;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float l0 = lse[qc] * kLog2e, l1 = lse[qc + 1] * kLog2e;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      sc[i] = exp2f(fmaf(sc[i], sl2, (e & 1) ? -l1 : -l0));
      pp[i * 128 + tid] = sc[i];
    }
  }
}

// K6, warpgroup 1: dP^T into dS^T = P^T (dP^T - Di) in place, P^T read back
// from pp at this thread's own places, Di the tile's 64 query rows.
__device__ __forceinline__ void dkv_dscores(float (&sc)[32], const float* di,
                                            const float* pp) {
  const int tid = threadIdx.x & 127;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qc = 8 * j + 2 * t;
    const float d0 = di[qc], d1 = di[qc + 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      sc[i] = pp[i * 128 + tid] * (sc[i] - ((e & 1) ? d1 : d0));
    }
  }
}

// K6 bf16, D = 72-160.  One CTA per (64-key tile, head, batch); K and V stay
// resident, Q and dO tiles of 64 queries with their lse and Di rows stream
// through the ring.  Threads 0-127: warpgroup 0, S^T = K Q^T, P^T, dV += P^T
// dO; threads 128-255: warpgroup 1, dP^T = V dO^T, dS^T = P^T (dP^T - Di),
// dK += dS^T Q; threads 256-383: the producer (thread 256 issues the
// copies).  Both score products are 64 keys x 64 queries in the same
// accumulator layout, so warpgroup 0 hands P^T over in fp32 in register
// order (conflict-free) and warpgroup 1 reads back the values it needs at
// its own registers' places (named barriers PFull / PFree).  Each
// warpgroup issues the next tile's score product together with this
// tile's gradient product, waits for the score product alone and runs its
// elementwise step (P^T or dS^T, in place) beside the gradient product
// (4.5% faster than waiting for both at [4, 1024, 8, 80]).
template <int DN>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int L, int H,
                              int D, float scale) {
  using T = WideTile<DN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  constexpr int kK = 0, kV = T::kTile;
  constexpr int kQ0 = 2 * T::kTile, kO0 = kQ0 + S * T::kTile;
  constexpr int kRows0 = kO0 + S * T::kTile;  // lse, Di per stage
  constexpr int kP = kRows0 + S * 512;
  const uint32_t kv_full = base + kP + T::kPBuf;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * 64;
  const int n_tiles = L / 64;
  const long lbase = (static_cast<long>(b) * H + h) * L;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * T::kTile);
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        tma_load_4d(base + kK + a * T::kCol, &tk, kv_full, 64 * a, h, j0, b);
        tma_load_4d(base + kV + a * T::kCol, &tv, kv_full, 64 * a, h, j0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        const uint32_t bar = full0 + 8 * s;
        if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) - 1) & 1);
        mbar_expect_tx(bar, 2 * T::kTile + 512);
#pragma unroll
        for (int a = 0; a < T::kAtoms; ++a) {
          const uint32_t off = s * T::kTile + a * T::kCol;
          tma_load_4d(base + kQ0 + off, &tq, bar, 64 * a, h, it * 64, b);
          tma_load_4d(base + kO0 + off, &tdo, bar, 64 * a, h, it * 64, b);
        }
        bulk_load(base + kRows0 + s * 512, lse + lbase + it * 64, 256, bar);
        bulk_load(base + kRows0 + s * 512 + 256, delta + lbase + it * 64,
                  256, bar);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const float sl2 = scale * kLog2e;
  float* pp = reinterpret_cast<float*>(sm + kP);
  // the resident operand of this warpgroup's score product (K or V), the
  // streamed one (Q or dO), and the B of its gradient product (dO or Q)
  const uint32_t res = base + (wg ? kV : kK);
  const uint32_t str0 = base + (wg ? kO0 : kQ0);
  const uint32_t grad0 = base + (wg ? kQ0 : kO0);

  float acc[DN / 2], sc[32];
  uint32_t fa[4][4];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.0f;
  if (wg == 1) bar_arrive_n(kBarPFree, 256);  // no P to read yet
  mbar_wait(kv_full, 0);
  mbar_wait(full0, 0);
  issue_scores_wide<DN>(sc, res, str0);
  wgmma_wait0();
  fence_regs(sc);

  // warpgroup 0 turns the scores into P^T and hands it over, warpgroup 1
  // turns them into dS^T with it; both in place, then to bf16 fragments
  auto scores_to_a = [&](int it) {
    const float* rows =
        reinterpret_cast<const float*>(sm + kRows0 + (it % S) * 512);
    if (wg == 0) {
      bar_sync_n(kBarPFree, 256);  // warpgroup 1 has read the last P
      dkv_probs(sc, rows, pp, sl2);
      bar_arrive_n(kBarPFull, 256);
    } else {
      bar_sync_n(kBarPFull, 256);
      dkv_dscores(sc, rows + 64, pp);
      if (it + 1 < n_tiles) bar_arrive_n(kBarPFree, 256);
    }
  };
  scores_to_a(0);
  pack_frags(sc, fa);
  // per tile: the next score product and this tile's gradient product in
  // flight, the next scores' elementwise step beside the gradient product
  for (int it = 0; it + 1 < n_tiles; ++it) {
    const int s = it % S;
    const int s1 = (it + 1) % S;
    mbar_wait(full0 + 8 * s1, ((it + 1) / S) & 1);
    issue_scores_wide<DN>(sc, res, str0 + s1 * T::kTile);
    issue_grad_wide<DN>(acc, fa, grad0 + s * T::kTile);
    wgmma_wait<1>();  // the scores of tile it + 1
    fence_regs(sc);
    scores_to_a(it + 1);
    wgmma_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    pack_frags(sc, fa);
  }
  issue_grad_wide<DN>(acc, fa, grad0 + ((n_tiles - 1) % S) * T::kTile);
  wgmma_wait0();
  fence_regs(acc);

  store_rows_bf16<DN>(wg ? dk : dv, acc, b, h, j0, L, H, D,
                      wg ? scale : 1.0f);
}

// K7 bf16, D = 72-160: K6's design with the roles swapped.  One CTA per
// (64-query tile, head, batch); Q and dO stay resident, K and V tiles of
// 64 keys stream through the ring.  Warpgroup 0: S = Q K^T and P, handed
// over in fp32; warpgroup 1: dP = dO V^T, dS = P (dP - Di), dQ += dS K
// (K's tile read MN-major from the bytes the score product read K-major),
// issuing the next tile's dP with this tile's dQ and waiting for both (K6's
// overlap of the elementwise step was 6% slower here at [4, 1024, 8, 80]).
template <int DN>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int L, int H,
                             int D, float scale) {
  using T = WideTile<DN>;
  constexpr int S = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  constexpr int kQ = 0, kO = T::kTile;
  constexpr int kK0 = 2 * T::kTile, kV0 = kK0 + S * T::kTile;
  constexpr int kP = kV0 + S * T::kTile;
  const uint32_t q_full = base + kP + T::kPBuf;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * 64;
  const int n_tiles = L / 64;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * T::kTile);
#pragma unroll
      for (int a = 0; a < T::kAtoms; ++a) {
        tma_load_4d(base + kQ + a * T::kCol, &tq, q_full, 64 * a, h, i0, b);
        tma_load_4d(base + kO + a * T::kCol, &tdo, q_full, 64 * a, h, i0,
                    b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        const uint32_t bar = full0 + 8 * s;
        if (it >= S) mbar_wait(empty0 + 8 * s, ((it / S) - 1) & 1);
        mbar_expect_tx(bar, 2 * T::kTile);
#pragma unroll
        for (int a = 0; a < T::kAtoms; ++a) {
          const uint32_t off = s * T::kTile + a * T::kCol;
          tma_load_4d(base + kK0 + off, &tk, bar, 64 * a, h, it * 64, b);
          tma_load_4d(base + kV0 + off, &tv, bar, 64 * a, h, it * 64, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const float sl2 = scale * kLog2e;
  float* pp = reinterpret_cast<float*>(sm + kP);
  // this lane's query rows 16 warp + g and + 8: their lse (log2 units,
  // warpgroup 0) or Di (warpgroup 1)
  const long lrow = (static_cast<long>(b) * H + h) * L + i0 +
                    ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const float c0 = wg ? delta[lrow] : lse[lrow] * kLog2e;
  const float c1 = wg ? delta[lrow + 8] : lse[lrow + 8] * kLog2e;
  float sc[32];
  mbar_wait(q_full, 0);

  // accumulator 4j + e: query 16 warp + g (+ 8 if e >= 2), key 8j + 2t +
  // (e & 1)
  if (wg == 0) {
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      issue_scores_wide<DN>(sc, base + kQ, base + kK0 + s * T::kTile);
      wgmma_wait0();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2, (i & 2) ? -c1 : -c0));
      }
      bar_sync_n(kBarPFree, 256);  // warpgroup 1 has read the last P
#pragma unroll
      for (int i = 0; i < 32; ++i) pp[i * 128 + tid] = sc[i];
      bar_arrive_n(kBarPFull, 256);
    }
    return;
  }

  float acc[DN / 2];
  uint32_t fa[4][4];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.0f;
  bar_arrive_n(kBarPFree, 256);  // no P to read yet
  mbar_wait(full0, 0);
  issue_scores_wide<DN>(sc, base + kO, base + kV0);
  wgmma_wait0();
  fence_regs(sc);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % S;
    // dP into dS = P (dP - Di) in place, P read back from pp
    bar_sync_n(kBarPFull, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = pp[i * 128 + tid] * (sc[i] - ((i & 2) ? c1 : c0));
    }
    pack_frags(sc, fa);
    if (it + 1 < n_tiles) {
      bar_arrive_n(kBarPFree, 256);
      const int s1 = (it + 1) % S;
      mbar_wait(full0 + 8 * s1, ((it + 1) / S) & 1);
      issue_scores_wide<DN>(sc, base + kO, base + kV0 + s1 * T::kTile);
    }
    issue_grad_wide<DN>(acc, fa, base + kK0 + s * T::kTile);
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }
  store_rows_bf16<DN>(dq, acc, b, h, i0, L, H, D, scale);
}

// ---- K6, fp32, D = 72-160: 3xTF32 on mma.sync ----------------------------
// 4 warps of 16 keys (64 keys a block); Q, dO, lse and Di stream in tiles of
// 32 queries, double-buffered by cp.async.  NTD: D/8 that the registers are
// sized for (kMaxD / 8).  Each tile's dV and dK add into the totals (the
// registers would not hold partial sums beside them).  Shared memory: K, V
// [64][D + 4], Q, dO [2][32][D + 4], lse, Di [2][32].
__global__ void __launch_bounds__(128, 1)
    flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int L, int H, int D, float scale) {
  constexpr int NTD = kMaxD / 8;
  extern __shared__ __align__(16) float smem[];
  const int ds = D + 4;
  float* ks = smem;
  float* vs = ks + kBlockK * ds;
  float* qs = vs + kBlockK * ds;
  float* dos = qs + 2 * kTfQ * ds;
  float* ls = dos + 2 * kTfQ * ds;
  float* dis = ls + 2 * kTfQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ND = D / 8;
  const float sl2 = scale * kLog2e;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int j0 = blockIdx.x * kBlockK;
  const int n_tiles = L / kTfQ;

  // tile `it` of Q, dO, lse and Di into buffer `buf` (not committed)
  auto load_tile = [&](int it, int buf) {
    load_rows_async(qs + buf * kTfQ * ds, ds, q, base, row_stride,
                    it * kTfQ, kTfQ, D);
    load_rows_async(dos + buf * kTfQ * ds, ds, dout, base, row_stride,
                    it * kTfQ, kTfQ, D);
    if (tid < kTfQ / 4) {
      cp_async16(ls + buf * kTfQ + 4 * tid, lse + lbase + it * kTfQ + 4 * tid);
    } else if (tid < kTfQ / 2) {
      const int c = 4 * (tid - kTfQ / 4);
      cp_async16(dis + buf * kTfQ + c, delta + lbase + it * kTfQ + c);
    }
  };
  load_rows_async(ks, ds, k, base, row_stride, j0, kBlockK, D);
  load_rows_async(vs, ds, v, base, row_stride, j0, kBlockK, D);
  load_tile(0, 0);
  cp_async_commit();

  const float* kw = ks + warp * 16 * ds;
  const float* vw = vs + warp * 16 * ds;
  float acc_v[NTD][4], acc_k[NTD][4];
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_v[nd][e] = 0.0f;
      acc_k[nd][e] = 0.0f;
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + buf * kTfQ * ds;
    const float* dot = dos + buf * kTfQ * ds;
    const float* lt = ls + buf * kTfQ;
    const float* dit = dis + buf * kTfQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nt][e] = 0.0f;
        dpt[nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NTD; ++kk) {
      if (kk < ND) {
        const int c = g * ds + 8 * kk + t;
        const float ak[4] = {kw[c], kw[c + 8 * ds], kw[c + 4],
                             kw[c + 8 * ds + 4]};
        const float av[4] = {vw[c], vw[c + 8 * ds], vw[c + 4],
                             vw[c + 8 * ds + 4]};
        uint32_t kh[4], kl[4], vh[4], vl[4];
        split_frag(ak, kh, kl);
        split_frag(av, vh, vl);
        uint32_t qh[4][2], ql[4][2], oh[4][2], ol[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = (8 * nt + g) * ds + 8 * kk + t;
          split_tf32(qt[r], qh[nt][0], ql[nt][0]);
          split_tf32(qt[r + 4], qh[nt][1], ql[nt][1]);
          split_tf32(dot[r], oh[nt][0], ol[nt][0]);
          split_tf32(dot[r + 4], oh[nt][1], ol[nt][1]);
        }
        mma_3xtf32(st, 0, kh, kl, qh, ql);
        mma_3xtf32(dpt, 0, vh, vl, oh, ol);
      }
    }

    // P^T and dS^T: rows = keys g, g + 8; columns = queries 8nt + 2t, + 1
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * t + (e & 1);
        const float p = exp2f(fmaf(st[nt][e], sl2, -lt[qc] * kLog2e));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dit[qc]);
      }
    }

    // dV += P^T dO, dK += dS^T Q: query step kk covers queries
    // 8kk..8kk+7; this lane's queries 8kk + 2t, + 1 stand at k = t, t + 4
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float ap[4] = {st[kk][0], st[kk][2], st[kk][1], st[kk][3]};
      const float ad[4] = {dpt[kk][0], dpt[kk][2], dpt[kk][1], dpt[kk][3]};
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_frag(ap, ph, pl);
      split_frag(ad, dh, dl);
      const int r = (8 * kk + 2 * t) * ds + g;
#pragma unroll
      for (int n0 = 0; n0 < NTD; n0 += 4) {
        if (n0 < ND) {
          uint32_t oh[4][2], ol[4][2], qh[4][2], ql[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = r + 8 * (n0 + i < ND ? n0 + i : n0);
            split_tf32(dot[c], oh[i][0], ol[i][0]);
            split_tf32(dot[c + ds], oh[i][1], ol[i][1]);
            split_tf32(qt[c], qh[i][0], ql[i][0]);
            split_tf32(qt[c + ds], qh[i][1], ql[i][1]);
          }
          mma_3xtf32(acc_v, n0, ph, pl, oh, ol);
          mma_3xtf32(acc_k, n0, dh, dl, qh, ql);
        }
      }
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

  const long row0 = base + (j0 + warp * 16 + g) * row_stride + 2 * t;
  const long row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd) {
    if (nd < ND) {
      *reinterpret_cast<float2*>(dv + row0 + 8 * nd) =
          make_float2(acc_v[nd][0], acc_v[nd][1]);
      *reinterpret_cast<float2*>(dv + row1 + 8 * nd) =
          make_float2(acc_v[nd][2], acc_v[nd][3]);
      *reinterpret_cast<float2*>(dk + row0 + 8 * nd) =
          make_float2(acc_k[nd][0] * scale, acc_k[nd][1] * scale);
      *reinterpret_cast<float2*>(dk + row1 + 8 * nd) =
          make_float2(acc_k[nd][2] * scale, acc_k[nd][3] * scale);
    }
  }
}

// ---- K7, fp32, D = 72-160: 3xTF32 on mma.sync ----------------------------
// 4 warps of 16 queries; the CTA's Q and dO rows stay resident, their lse
// and Di in registers; K and V stream in tiles of KEYS keys,
// double-buffered by cp.async.  NTD: D/8 that the registers are sized for
// (kMaxD / 8).  Each warp splits the K / V fragments it loads into TF32 hi
// and lo.  Shared memory (rows padded to D + 4 floats: conflict-free
// fragment loads): Q, dO [64], K, V [2][KEYS].
__global__ void __launch_bounds__(128, 1)
    flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int L, int H, int D,
                             float scale) {
  constexpr int NTD = kMaxD / 8;
  constexpr int KEYS = kDqTfKeys;
  constexpr int NT = KEYS / 8;  // key n-tiles of the score products
  extern __shared__ __align__(16) float smem[];
  const int ds = D + 4;
  float* qs = smem;
  float* dos = qs + 64 * ds;
  float* ks = dos + 64 * ds;
  float* vs = ks + 2 * KEYS * ds;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ND = D / 8;
  const float sl2 = scale * kLog2e;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(blockIdx.z) * L * row_stride +
                    static_cast<long>(blockIdx.y) * D;
  const long lbase = (static_cast<long>(blockIdx.z) * H + blockIdx.y) * L;
  const int i0 = blockIdx.x * 64;
  const int n_tiles = L / KEYS;

  load_rows_async(qs, ds, q, base, row_stride, i0, 64, D);
  load_rows_async(dos, ds, dout, base, row_stride, i0, 64, D);
  load_rows_async(ks, ds, k, base, row_stride, 0, KEYS, D);
  load_rows_async(vs, ds, v, base, row_stride, 0, KEYS, D);
  cp_async_commit();

  // this lane's query rows: g and g + 8 of the warp's 16
  const int r0 = warp * 16;
  float l2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long row = lbase + i0 + r0 + 8 * r + g;
    l2[r] = lse[row] * kLog2e;
    di[r] = delta[row];
  }
  // dQ, and this key tile's part of it (folded in by a rounded fp32 add)
  float acc[NTD][4], part[NTD][4];
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      const int nb = (buf ^ 1) * KEYS * ds;
      load_rows_async(ks + nb, ds, k, base, row_stride, (it + 1) * KEYS,
                      KEYS, D);
      load_rows_async(vs + nb, ds, v, base, row_stride, (it + 1) * KEYS,
                      KEYS, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * KEYS * ds;
    const float* vt = vs + buf * KEYS * ds;

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x the tile's KEYS
    // keys (NT n-tiles of 8)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.0f;
        dp[nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NTD; ++kk) {
      if (kk < ND) {
        uint32_t kh[NT][2], kl[NT][2], vh[NT][2], vl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int off = (8 * nt + g) * ds + 8 * kk + t;
          split_tf32(kt[off], kh[nt][0], kl[nt][0]);
          split_tf32(kt[off + 4], kh[nt][1], kl[nt][1]);
          split_tf32(vt[off], vh[nt][0], vl[nt][0]);
          split_tf32(vt[off + 4], vh[nt][1], vl[nt][1]);
        }
        const int c = (r0 + g) * ds + 8 * kk + t;
        const float aq[4] = {qs[c], qs[c + 8 * ds], qs[c + 4],
                             qs[c + 8 * ds + 4]};
        const float ao[4] = {dos[c], dos[c + 8 * ds], dos[c + 4],
                             dos[c + 8 * ds + 4]};
        uint32_t qh[4], ql[4], oh[4], ol[4];
        split_frag(aq, qh, ql);
        split_frag(ao, oh, ol);
        mma_3xtf32(s, 0, qh, ql, kh, kl);
        mma_3xtf32(dp, 0, oh, ol, vh, vl);
      }
    }

    // dS = P (dP - Di), P = exp2(S scale log2e - lse log2e): rows g (e = 0,
    // 1) and g + 8 (e = 2, 3), keys 8nt + 2t, + 1; into s
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], sl2, -l2[e >> 1]));
        s[nt][e] = p * (dp[nt][e] - di[e >> 1]);
      }
    }

    // this tile's dS K into the partial sums: key step kk covers keys
    // 8kk..8kk+7; this lane's keys 8kk + 2t, + 1 stand at k = t, t + 4, the
    // same permutation applied to K's rows
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nd][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      uint32_t ah[4], al[4];
      split_frag(a, ah, al);
      const int r = (8 * kk + 2 * t) * ds + g;
#pragma unroll
      for (int n0 = 0; n0 < NTD; n0 += 4) {
        if (n0 < ND) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = r + 8 * (n0 + i < ND ? n0 + i : n0);
            split_tf32(kt[c], bh[i][0], bl[i][0]);
            split_tf32(kt[c + ds], bh[i][1], bl[i][1]);
          }
          mma_3xtf32(part, n0, ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < NTD; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
    }
    __syncthreads();  // the tile's readers are done before it is refilled
  }

  const long row0 = base + (i0 + r0 + g) * row_stride + 2 * t;
  const long row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int nd = 0; nd < NTD; ++nd) {
    if (nd < ND) {
      *reinterpret_cast<float2*>(dq + row0 + 8 * nd) =
          make_float2(acc[nd][0] * scale, acc[nd][1] * scale);
      *reinterpret_cast<float2*>(dq + row1 + 8 * nd) =
          make_float2(acc[nd][2] * scale, acc[nd][3] * scale);
    }
  }
}

// The instance of K6 and K7 for this type and D (flash_attention.py::
// bwd_tiles): the rows a CTA owns (keys in K6, queries in K7) and the width
// it is built for.  bf16: the wgmma kernels of 128 rows up to D = 64 (the
// k-steps read at run time), the wide ones of 64 rows at widths 80 and 160
// above; fp32: the 3xTF32 wgmma kernels (64 rows, width 64) up to D = 64,
// the mma.sync ones (64 rows, registers sized for 160) above.
void bwd_instance(int is_bf16, int D, int& rows, int& width) {
  if (is_bf16) {
    rows = D <= 64 ? 128 : 64;
    width = D <= 64 ? 64 : (D <= 80 ? 80 : kMaxD);
  } else {
    rows = 64;
    width = D <= 64 ? 64 : kMaxD;
  }
}

// Whether the kernels refuse this shape or this instance.
bool bad_call(int B, int L, int H, int D, int is_bf16, int rows,
              int width) {
  if (L <= 0 || D % 8 != 0 || D <= 0 || D > kMaxD || B <= 0 || H <= 0 ||
      B > 65535 || H > 65535) {
    return true;
  }
  int want_rows, want_width;
  bwd_instance(is_bf16, D, want_rows, want_width);
  return rows != want_rows || width != want_width || L % rows != 0;
}

// The four bf16 tensor maps: Q and dO with boxes of q_rows rows, K and V
// of kv_rows.
bool bf16_maps(CUtensorMap& tq, CUtensorMap& tdo, CUtensorMap& tk,
               CUtensorMap& tv, const void* q, const void* dout,
               const void* k, const void* v, int B, int L, int H, int D,
               int q_rows, int kv_rows) {
  return bf16_rows_map(&tq, q, B, L, H, D, q_rows) &&
         bf16_rows_map(&tdo, dout, B, L, H, D, q_rows) &&
         bf16_rows_map(&tk, k, B, L, H, D, kv_rows) &&
         bf16_rows_map(&tv, v, B, L, H, D, kv_rows);
}

}  // namespace

// q, k, v, dout, dk, dv: [B, L, H, D] contiguous, 16-byte aligned, all
// bf16 (is_bf16 = 1) or fp32 (0); lse, delta: [B, H, L] fp32, 16-byte
// aligned.  D % 8 == 0, D <= 160.  rows, width: the instance
// (flash_attention.py::bwd_tiles; rows a CTA and the width it is built
// for); any other pair is refused, and L must be a multiple of rows.
extern "C" int gsgen_flash_attn_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int L,
                                        int H, int D, float scale,
                                        int is_bf16, int rows, int width,
                                        void* stream) {
  if (bad_call(B, L, H, D, is_bf16, rows, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / rows, H, B);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  if (is_bf16) {
    auto* dkb = static_cast<__nv_bfloat16*>(dk);
    auto* dvb = static_cast<__nv_bfloat16*>(dv);
    CUtensorMap tq, tdo, tk, tv;
    if (!bf16_maps(tq, tdo, tk, tv, q, dout, k, v, B, L, H, D, kDkvQ,
                   rows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (width == 64) {
      return launch(flash_bwd_dkv_wgmma_kernel, grid, kWgThreads, kDkvSmem,
                    s, tq, tdo, tk, tv, lf, df, dkb, dvb, L, H, D, scale);
    }
    if (width == 80) {
      return launch(flash_bwd_dkv_wide_kernel<80>, grid, kWgThreads,
                    WideTile<80>::kDkvSmem, s, tq, tdo, tk, tv, lf, df, dkb,
                    dvb, L, H, D, scale);
    }
    return launch(flash_bwd_dkv_wide_kernel<kMaxD>, grid, kWgThreads,
                  WideTile<kMaxD>::kDkvSmem, s, tq, tdo, tk, tv, lf, df, dkb,
                  dvb, L, H, D, scale);
  }
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  if (width == 64) {
    CUtensorMap tq, tdo, tk, tv;
    if (!f32_rows_map(&tq, q, B, L, H, D, 64) ||
        !f32_rows_map(&tdo, dout, B, L, H, D, 64) ||
        !f32_rows_map(&tk, k, B, L, H, D, 64) ||
        !f32_rows_map(&tv, v, B, L, H, D, 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch(flash_bwd_dkv_tf32_wgmma_kernel, grid, kWgThreads,
                  kDkvTfSmem, s, tq, tdo, tk, tv, lf, df, dkf, dvf, L, H, D,
                  scale);
  }
  const size_t smem =
      sizeof(float) * ((2 * kBlockK + 4 * kTfQ) * (D + 4) + 4 * kTfQ);
  return launch(flash_bwd_dkv_tf32_kernel, grid, 128, smem, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                lf, df, dkf, dvf, L, H, D, scale);
}

// As above, for dq.
extern "C" int gsgen_flash_attn_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int B, int L, int H, int D,
                                       float scale, int is_bf16, int rows,
                                       int width, void* stream) {
  if (bad_call(B, L, H, D, is_bf16, rows, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(L / rows, H, B);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  if (is_bf16) {
    auto* dqb = static_cast<__nv_bfloat16*>(dq);
    CUtensorMap tq, tdo, tk, tv;
    if (!bf16_maps(tq, tdo, tk, tv, q, dout, k, v, B, L, H, D, rows,
                   kDqKeys)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (width == 64) {
      return launch(flash_bwd_dq_wgmma_kernel, grid, kWgThreads, kDqSmem, s,
                    tq, tdo, tk, tv, lf, df, dqb, L, H, D, scale);
    }
    if (width == 80) {
      return launch(flash_bwd_dq_wide_kernel<80>, grid, kWgThreads,
                    WideTile<80>::kDqSmem, s, tq, tdo, tk, tv, lf, df, dqb, L,
                    H, D, scale);
    }
    return launch(flash_bwd_dq_wide_kernel<kMaxD>, grid, kWgThreads,
                  WideTile<kMaxD>::kDqSmem, s, tq, tdo, tk, tv, lf, df, dqb,
                  L, H, D, scale);
  }
  auto* dqf = static_cast<float*>(dq);
  if (width == 64) {
    CUtensorMap tq, tdo, tk, tv;
    if (!f32_rows_map(&tq, q, B, L, H, D, 64) ||
        !f32_rows_map(&tdo, dout, B, L, H, D, 64) ||
        !f32_rows_map(&tk, k, B, L, H, D, 64) ||
        !f32_rows_map(&tv, v, B, L, H, D, 64)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch(flash_bwd_dq_tf32_wgmma_kernel, grid, kWgThreads,
                  kDqTfSmem, s, tq, tdo, tk, tv, lf, df, dqf, L, H, D,
                  scale);
  }
  return launch(flash_bwd_dq_tf32_kernel, grid, 128,
                sizeof(float) * (D + 4) * (2 * 64 + 4 * kDqTfKeys), s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout),
                lf, df, dqf, L, H, D, scale);
}
