// Hopper building blocks of the flash-attention kernels K5, K6 and K7:
// TMA tensor maps and loads (mbarriers and bulk copies: sm90_async.cuh),
// warpgroup matrix multiply (wgmma) with shared-memory descriptors,
// setmaxnreg, and the 3xTF32 split with its mma.sync and wgmma products
// for the fp32 instances.
//
// Layout conventions (shared by every user):
//  * A [B, L, H, D] bf16 tensor is a 4-D TMA map with dims (D, H, L, B) and
//    byte strides (2D, 2HD, 2LHD); a box {64, 1, rows, 1} lands as `rows`
//    rows of 128 bytes (64 head dims, zero-filled past D) in the 128-byte
//    swizzle, in 1024-byte atoms of 8 rows.  Tile bases are 1024-aligned.
//    An fp32 tensor's map is the same with 4-byte elements and boxes {32,
//    1, rows, 1}: 32 head dims a 128-byte row, so a tile of 64 head dims is
//    two boxes side by side (atom columns of rows x 128 bytes).
//  * Such a tile is read by wgmma either K-major (the head dim is the
//    product's k: rows are M or N) or MN-major (the rows are the product's
//    k, the head dims its N: a B operand with tnspB = 1).
//  * wgmma m64nNk16 fp32 accumulators: warp w of the warpgroup holds rows
//    16w + g and 16w + g + 8 (lane = 4g + t); register 4j + e is column
//    8j + 2t + (e & 1), row + 8 when e >= 2 -- the mma.sync C layout
//    repeated per 8 columns.  The register A operand of the RS form has the
//    mma.sync m16n8k16 A layout, so a score accumulator converts in-thread
//    into the A fragments of the next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90_async.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- host: TMA tensor maps -------------------------------------------------
// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The map of a [B, L, H, D] tensor of `bytes`-byte elements with box
// {128 / bytes, 1, rows, 1}: one 128-byte swizzled row a box row.
bool rows_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
              const void* base, int B, int L, int H, int D, int rows) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t e = static_cast<cuuint64_t>(bytes);
  const cuuint64_t strides[3] = {e * D, e * H * D, e * L * H * D};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / bytes), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a [B, L, H, D] bf16 tensor with box {64, 1, rows, 1}.
bool bf16_rows_map(CUtensorMap* map, const void* base, int B, int L, int H,
                   int D, int rows) {
  return rows_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, L, H, D,
                  rows);
}

// The map of a [B, L, H, D] fp32 tensor with box {32, 1, rows, 1}.
bool f32_rows_map(CUtensorMap* map, const void* base, int B, int L, int H,
                  int D, int rows) {
  return rows_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, B, L, H, D,
                  rows);
}

// ---- device: TMA (mbarriers and bulk copies: sm90_async.cuh) ---------------
// One box of a 4-D map at coordinates (c0, c1, c2, c3) into shared memory;
// completion (the box's bytes) is reported to `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- device: wgmma ---------------------------------------------------------
// Descriptor of a 128-byte-swizzled tile at shared address `addr`: SBO 1024
// bytes (8 rows of 128 B) between 8-row groups along the rows.  K-major
// operands (k = 16 fits in a row) step k by 32 bytes within the row and
// take the next atom column (64 head dims further) at every fourth step;
// LBO is unused.  MN-major ones (the rows are k, N runs along the row) step
// k by 16 rows (2048 bytes); an N past 64 continues in the next atom
// column, `lbo` bytes on (the rows of the tile x 128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

#define GS_ACC4(d, o) \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
#define GS_ACC8(d, o) GS_ACC4(d, o), GS_ACC4(d, o + 4)

// wgmma_ss: d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared
// memory, N = 2 x the size of d (64, 128); scale_d 0 overwrites d.
// wgmma_rs: d[64 x N] += A[64 x 16] B[16 x N], A from registers (bf16
// pairs, the mma.sync A layout per warp), B MN-major in shared memory
// (tnspB = 1); N = 2 x the size of d (40, 64, 80, 160).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24),
        GS_ACC8(d, 32), GS_ACC8(d, 40),
        GS_ACC8(d, 48), GS_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[20],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC4(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24),
        GS_ACC8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[80],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24),
        GS_ACC8(d, 32), GS_ACC8(d, 40),
        GS_ACC8(d, 48), GS_ACC8(d, 56),
        GS_ACC8(d, 64), GS_ACC8(d, 72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma_tf32: d[64 x N] (+)= A[64 x 8] B[8 x N] in TF32 with fp32
// accumulate, A from registers (four .b32 a thread, the mma.sync m16n8k8
// tf32 A layout per warp: a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
// a3 = A[g + 8][t + 4] of the warp's 16 rows), B K-major in shared memory
// (32-bit types have no transposed form); N = 2 x the size of d (16, 32,
// 64); scale_d 0 overwrites d.  wgmma_tf32_ss: the same at N = 64 with A
// K-major in shared memory too.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;"
      "\n}\n"
      : GS_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : GS_ACC8(d, 0), GS_ACC8(d, 8),
        GS_ACC8(d, 16), GS_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef GS_ACC8
#undef GS_ACC4

// ---- device: 3xTF32 --------------------------------------------------------
// x rounded to the nearest TF32 value, ties away from zero: the bits of
// cvt.rna.tf32.f32 in two integer instructions (the conversion runs at a
// fraction of their rate: with it the splits held K5-K7 fp32 back by
// 12-20%, PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi), both rounded
// to nearest; a product a b is hi_a hi_b + hi_a lo_b + lo_a hi_b.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D(16x8) += A(16x8, row) B(8x8, col) in tf32, fp32 accumulate.  Fragments
// (lane = 4g + t): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0, c1 = C[g][2t..2t+1],
// c2, c3 = C[g+8][2t..2t+1].
// Not volatile: independent products may be scheduled across each other.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four A values (a0..a3 order) split into hi and lo fragments.
__device__ __forceinline__ void split_frag(const float (&x)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// c[off + i] += a b_i (i < N) to about fp32 accuracy, b_i given split
// (bh[i], bl[i]: the b0, b1 pair of each): the two small terms first, each
// term issued for all N before the next so the N chains interleave.
template <int N, int M>
__device__ __forceinline__ void mma_3xtf32(float (&c)[M][4], int off,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[off + i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[off + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[off + i], ah, bh[i][0], bh[i][1]);
}

// ---- device: cp.async ------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows x D floats of a [B, L, H, D] fp32 tensor (row `row0` on,
// `base` the offset of (b, 0, h, 0), `row_stride` = H * D) into shared rows
// of `stride` floats, 16 bytes a copy, asynchronously (not committed).
__device__ __forceinline__ void load_rows_async(float* dst, int stride,
                                                const float* src, long base,
                                                long row_stride, int row0,
                                                int rows, int D) {
  const int vec = D / 4;
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec;
    const int c = (i - r * vec) * 4;
    cp_async16(dst + r * stride + c,
               src + base + (row0 + r) * row_stride + c);
  }
}

}  // namespace
