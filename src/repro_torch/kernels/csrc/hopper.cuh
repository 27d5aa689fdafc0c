// Device helpers shared by the port's kernels for Hopper (sm_90a): the
// flash-attention kernels (flash_attention/csrc/flash_attention.cu, the
// forward, and flash_attention_bwd.cu, the backward) and the wkv kernels
// (ssm_scan/csrc/wkv.cu and wkv_bwd.cu, through wkv_chunk.cuh: their
// chunk states on split-TF32 wgmma) include this file. kernels/_nvcc.py
// hashes every header a source includes into the library's name, so an
// edit here rebuilds all four.
//
//   * mbarrier, TMA boxes (up to 256 rows x 128 bytes: 64 bf16 or 32 f32
//     columns, 128-byte swizzle) and the tensor maps they read
//     (cuTensorMapEncodeTiled through the runtime's driver entry point: the
//     libraries link no libcuda);
//   * wgmma descriptors of 128-byte-swizzled tiles, K-major and MN-major,
//     and the warpgroup products the bf16 kernels run (m64n64k16 and
//     m64n128k16 with both operands in shared memory; m64n64k16 and
//     m64n128k16 with A from registers and B read transposed), and the
//     tf32 ones of the f32 kernels (m64n32k8, m64n64k8 and m64n128k8, A
//     from registers, B K-major in shared memory: wgmma reads tf32 B only
//     K-major; each also as the first product of a fresh chain, whose
//     accumulators are outputs only);
//   * split TF32 (x = hi + lo, both rounded to TF32) and the A fragments of
//     raw f32 tiles, split as they are loaded;
//   * named barriers and the proxy fence that makes threads' shared-memory
//     writes visible to wgmma;
//   * cp.async of 16 bytes (zero-filled past `src_bytes`) and its groups:
//     the wkv kernels stage their strided rows with it.
//
// A tile of R rows x DHP columns lies in shared memory as DHP * elem / 128
// column blocks (64 bf16 or 32 f32 columns each), each R rows of 128
// bytes, as TMA writes it with the 128-byte swizzle (the 16-byte chunks of
// row r XORed with r % 8); a block is R / BR boxes of BR rows.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;
};

constexpr int BOX = 64;              // TMA box rows: 64 (bf16 maps, f32 q/do)
// setmaxnreg: a producer warpgroup's registers and each consumer thread's
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
// One arrival that also expects `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Returns once the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box (the map's box: BR rows x 128 bytes) of a 4-d map (dh, rows, head,
// batch) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, int h, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(h),
      "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A tile of R rows x DHP columns of `ELEM`-byte elements, rows r0 .. of
// head h of batch item b: DHP ELEM / 128 column blocks of 128 / ELEM
// columns, each R rows of 128 bytes swizzled by TMA (SWIZZLE_128B), loaded
// as R / BR boxes of BR rows per block (the map's box, BR a multiple of 8
// dividing R).
template <int DHP, int R, int ELEM = 2, int BR = BOX>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int r0,
                                         int h, int b, uint64_t* bar) {
  constexpr int COLS = 128 / ELEM;
#pragma unroll
  for (int blk = 0; blk < DHP / COLS; ++blk)
#pragma unroll
    for (int r = 0; r < R / BR; ++r)
      tma_box(dst + blk * R * 128 + r * BR * 128, map, COLS * blk,
              r0 + BR * r, h, b, bar);
}

// Byte offset of f32 element (r, c) of such a tile (R rows, 1024-byte
// aligned): column block c / 32, 16-byte chunk (c / 4) % 8 XORed with r % 8.
template <int R>
__device__ __forceinline__ int sw_f32(int r, int c) {
  return (c >> 5) * R * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
         ((c & 3) << 2);
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address a
// (leading and stride byte offsets in bytes; layout type B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t a, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (dh is the product's k): rows row0 .. of a tile of R
// rows, k-step kk (16 bf16 or 8 tf32 columns: 32 bytes into a 128-byte
// row, the column block kk / 4); groups of 8 rows 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32,
                    16, 1024);
}
// MN-major B operand (the tile's rows are the product's k, dh its n):
// k-step kk (rows 16 kk .. 16 kk + 15); the two column halves R * 128
// bytes apart, groups of 8 rows 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, R * 128, 1024);
}

// d (64 x N, f32) = a b (scale_d = 0) or d + a b (scale_d = 1) for the
// warpgroup, one k-step of 16: a (64 x 16) and b (N x 16) bf16, both
// K-major in shared memory, by descriptor. d[nt] is the warp's 16 x 8
// accumulator tile nt: rows 16 (warp % 4) + {g, g + 8}, columns 8 nt +
// {2t, 2t + 1}.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (*d)[4], uint64_t da,
                                         uint64_t db, int scale_d);
// d (64 x N, f32) = d + a b (scale_d = 1): a (64 x 16, bf16) from
// registers (each warp its 16 rows, the m16n8k16 A fragment), b (16 x N)
// MN-major in shared memory (the instruction reads it transposed).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (*d)[4], const uint32_t* a,
                                            uint64_t db, int scale_d);

#define HOPPER_ACC32(d)                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define HOPPER_ACC64(d)                                                     \
  HOPPER_ACC32(d), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),             \
      "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]),           \
      "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]),        \
      "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]),       \
      "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),       \
      "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),       \
      "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]),       \
      "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]),       \
      "+f"(d[15][3])
#define HOPPER_REGS32                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define HOPPER_REGS64                                                       \
  HOPPER_REGS32                                                             \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "     \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "  \
  "%59, %60, %61, %62, %63"

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (*d)[4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOPPER_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (*d)[4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" HOPPER_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (*d)[4],
                                                const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" HOPPER_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (*d)[4],
                                                const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" HOPPER_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) = a b (scale_d = 0) or d + a b (scale_d = 1), one
// k-step of 8 in tf32: a (64 x 8) from registers (each warp its 16 rows,
// the m16n8k8 tf32 A fragment: rows g, g + 8, columns t, t + 4), b (N x 8)
// K-major in shared memory by descriptor. The tensor cores read the top 19
// bits of each operand: callers pass values already rounded to tf32.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (*d)[4], const uint32_t* a,
                                           uint64_t db, int scale_d);
// d = a b, the first product of a fresh chain: d is written only, so its
// registers hold nothing live before the product is issued.
template <int N>
__device__ __forceinline__ void wgmma_tf32_first(float (*d)[4],
                                                 const uint32_t* a,
                                                 uint64_t db);

#define HOPPER_ACC16(d)                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
// The same accumulators as outputs only (a fresh chain's first product).
#define HOPPER_OUT16(d)                                                     \
  "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),               \
      "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),           \
      "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),           \
      "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3])
#define HOPPER_OUT32(d)                                                     \
  HOPPER_OUT16(d), "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]),             \
      "=f"(d[4][3]), "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]),           \
      "=f"(d[5][3]), "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]),           \
      "=f"(d[6][3]), "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]),           \
      "=f"(d[7][3])
#define HOPPER_OUT64(d)                                                     \
  HOPPER_OUT32(d), "=f"(d[8][0]), "=f"(d[8][1]), "=f"(d[8][2]),             \
      "=f"(d[8][3]), "=f"(d[9][0]), "=f"(d[9][1]), "=f"(d[9][2]),           \
      "=f"(d[9][3]), "=f"(d[10][0]), "=f"(d[10][1]), "=f"(d[10][2]),        \
      "=f"(d[10][3]), "=f"(d[11][0]), "=f"(d[11][1]), "=f"(d[11][2]),       \
      "=f"(d[11][3]), "=f"(d[12][0]), "=f"(d[12][1]), "=f"(d[12][2]),       \
      "=f"(d[12][3]), "=f"(d[13][0]), "=f"(d[13][1]), "=f"(d[13][2]),       \
      "=f"(d[13][3]), "=f"(d[14][0]), "=f"(d[14][1]), "=f"(d[14][2]),       \
      "=f"(d[14][3]), "=f"(d[15][0]), "=f"(d[15][1]), "=f"(d[15][2]),       \
      "=f"(d[15][3])
#define HOPPER_REGS16                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (*d)[4],
                                               const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HOPPER_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (*d)[4],
                                               const uint32_t* a,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" HOPPER_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (*d)[4],
                                                const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" HOPPER_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<32>(float (*d)[4],
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{" HOPPER_REGS16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : HOPPER_OUT16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<64>(float (*d)[4],
                                                     const uint32_t* a,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{" HOPPER_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32_first<128>(float (*d)[4],
                                                      const uint32_t* a,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{" HOPPER_REGS64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : HOPPER_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef HOPPER_ACC16
#undef HOPPER_OUT16
#undef HOPPER_OUT32
#undef HOPPER_OUT64
#undef HOPPER_REGS16
#undef HOPPER_ACC32
#undef HOPPER_ACC64
#undef HOPPER_REGS32
#undef HOPPER_REGS64

// Named barrier `id` (1..15) over `n` threads (a multiple of 32): sync
// waits for all n, arrive counts this warp's threads and goes on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Threads' (generic-proxy) shared-memory writes made visible to the async
// proxy (wgmma's operand reads); each writing thread runs it before the
// barrier that orders its writes before the products.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across wgmma's wait.
template <int NT>
__device__ __forceinline__ void pin(float (*x)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[nt][e])::"memory");
}
template <int NT>
__device__ __forceinline__ void zero(float (*x)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.f;
}

// The A fragments (bf16) of KS k-steps of 16 taken from an accumulator of
// 2 KS n8 tiles: step kk is tiles 2 kk and 2 kk + 1.
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// x to TF32, rounded to nearest (ties away from zero: cvt.rna.tf32.f32 for
// finite x), as bits with the low 13 zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, each rounded to TF32; x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ float lds(const unsigned char* tile, int off) {
  return *reinterpret_cast<const float*>(tile + off);
}
__device__ __forceinline__ uint32_t ldu(const unsigned char* tile, int off) {
  return *reinterpret_cast<const uint32_t*>(tile + off);
}

// The tf32 A fragment (rows g, g + 8; columns t, t + 4) of rows r0 .. and
// columns c0 .. of a raw f32 tile of R rows (TMA's layout), split.
template <int R>
__device__ __forceinline__ void frag_rows(uint32_t* ah, uint32_t* al,
                                          const unsigned char* tile, int r0,
                                          int c0, int g, int t) {
  split(lds(tile, sw_f32<R>(r0 + g, c0 + t)), ah[0], al[0]);
  split(lds(tile, sw_f32<R>(r0 + g + 8, c0 + t)), ah[1], al[1]);
  split(lds(tile, sw_f32<R>(r0 + g, c0 + t + 4)), ah[2], al[2]);
  split(lds(tile, sw_f32<R>(r0 + g + 8, c0 + t + 4)), ah[3], al[3]);
}

// Where index x of a contraction lies in a K-major B operand that A
// fragments taken from an accumulator (or read transposed) meet: within
// its k-step of 8, 2t -> t and 2t + 1 -> t + 4.
__device__ __host__ __forceinline__ int kperm(int x) {
  return (x & ~7) | ((x & 7) >> 1) | ((x & 1) << 2);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-d map (dh, rows, head, batch) of a bf16 (elem = 2) or f32 (elem =
// 4) tensor with element strides st over (batch, head, row), boxes of
// box_rows rows x 128 bytes, 128-byte swizzle, rows and columns past the
// tensor read as zeros. A stride over an axis of one entry is never used;
// it is given as 16 bytes.
bool encode_rows(CUtensorMap* map, const void* base, int B, int N, int S,
                 int dh, const Strides& st, int elem = 2,
                 int box_rows = BOX) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t e = (cuuint64_t)elem;
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st.s * e : 16,
                                 N > 1 ? (cuuint64_t)st.h * e : 16,
                                 B > 1 ? (cuuint64_t)st.b * e : 16};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows,
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether TMA takes rows of a tensor of `elem`-byte elements with these
// element strides: each row starts on 16 bytes (axes of one entry aside).
bool tma_rows(const void* p, int B, int N, int S, const Strides& st,
              int elem = 2) {
  const long long per = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (S == 1 || (st.s > 0 && st.s % per == 0)) &&
         (N == 1 || (st.h > 0 && st.h % per == 0)) &&
         (B == 1 || (st.b > 0 && st.b % per == 0));
}

}  // namespace
