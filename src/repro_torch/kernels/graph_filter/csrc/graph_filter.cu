// Fused K-hop graph filter  Y = sum_{k<=K} h_k S^k W  for Hopper (sm_90a),
// with every S.Y product on the tensor cores in split TF32 (wgmma).
//
// Replaces the Pallas TPU kernel of the reference package:
// src/repro/kernels/graph_filter/kernel.py (_kernel, graph_filter_pallas),
// reached through ops.py::graph_filter and make_pallas_mix. It runs in
// every unrolled U-DGD layer of a serve tick, of a single-cohort solve and
// of a meta-step's forward. Its transposed-S entry is the meta-step's
// backward: dW = sum_k h_k (S^T)^k G, the same filter on S^T applied to
// the cotangent G (the Pallas call inside ops.py::_bwd of the reference).
//
// Contract (batched natively, one launch per call):
//   S (B, n, n) f32, W (B, n, d) f32 or bf16, h (K+1,) f32 shared by the
//   batch; Y (B, n, d) in W's dtype. Any n >= 1, any d >= 1. Horner's
//   rule with f32 accumulation: Y = h_K W;  Y = S Y + h_k W  for
//   k = K-1 .. 0. bf16 W is widened to f32 and Y rounded to bf16 once.
//   For n > RESIDENT_N and K >= 2 the caller passes `work`, an f32
//   scratch of min(K-1, 2) B n d elements (the iterate between hops);
//   otherwise `work` may be null.
//
// Arithmetic: split TF32 ("3xTF32"). Each f32 operand x is x_hi + x_lo
// with x_hi = tf32(x) and x_lo = tf32(x - x_hi), both rounded to nearest
// (ties away) by an integer add and mask: x_lo is within 2^-22 of x's
// remainder. Each product is s_lo y_hi + s_hi y_lo + s_hi y_hi with f32
// accumulation; the dropped s_lo y_lo is about 2^-22 of the product.
// One-pass TF32 (about 2^-11) would not hold the reference's 5e-5; this
// does. A truncated x_lo (the flash-attention kernel's, within 2^-21)
// also holds 5e-5, but on mixing matrices whose entries TF32 does not
// hold exactly (1/3, 2/3: a graph with failed links) it doubled the
// meta-gradient entries at the f32 noise floor that chip_smoke.py's
// parity gate counts, past its cap; rounding x_lo brought them back.
//
// What bounds it: at the serve shape (B=8, n=128, d=5130, K=2) one launch
// does 2 K n^2 d B = 2.69 GFLOP on 42.5 MB (S, W read once, Y written
// once). As three TF32 products each on the tensor cores (495 TFLOP/s
// dense) that is 16.3 us, against 12.7 us of memory traffic at 3.35 TB/s
// and 40.5 us of f32 FFMA (67 TFLOP/s), the previous design's bound. At
// the single-cohort shape (B=1, n=100, d=5130, K=2) it is 0.21 GFLOP on
// 4.1 MB: 1.24 us on the tensor cores, 1.22 us of memory.
//
// Design, n <= RESIDENT_N = 128 (every PAPER path):
//   * the products are wgmma m64nNk8 tf32 (N = 32 or 64 columns), A from
//     registers, B from shared memory: mma.sync's TF32 rate on this card
//     is about a quarter of wgmma's, and with both operands in shared
//     memory the reads of A, not the tensor cores, set the pace. A
//     warpgroup owns 64 rows (ceil(n / 64) warpgroups), a warp 16.
//   * S is the A operand of every hop and every column tile: each thread
//     loads its A fragments once per batch item straight from global
//     memory (L2) into registers, split (8 registers per k-step of 8; k
//     padded to an even number of steps, the kernel instanced for each).
//   * the iterate Y is the B operand: after each hop it leaves the
//     accumulators through shared memory, split into hi and lo, in the
//     K-major no-swizzle layout of wgmma's descriptors (8 x 16-byte core
//     matrices); the C and B layouts differ, and every warpgroup needs
//     all rows. W's tile stays in registers for the h_k W terms.
//   * persistent blocks, one per SM: a block walks a contiguous range of
//     (batch item, column tile) items, reloading S only when the batch
//     item changes and loading the next tile's W during the current
//     tile's first hop. 32-column tiles; 64-column ones when those fill
//     the card in one wave and 32-column ones would not (B=1, d=5130: 81
//     tiles of 64 instead of 161 of 32 on 132 SMs).
//   * ragged n and d: A fragments and rows past n are zero, stores are
//     masked; no padded copy exists in device memory.
//   * the backward entry differs only in how A is loaded (S[k][i]); no
//     transposed copy of S exists anywhere.
//
// Design, n > RESIDENT_N (no PAPER path; kept simple): grid (ceil(d/32),
// B), 4 warps per block, each 32 rows x 32 columns of a 128-row chunk,
// mma.sync m16n8k8 in split TF32; S's (128 x 32) panels and the
// iterate's (32 x 32) panels come through shared memory by cp.async, and
// a hop's result goes to `work` (f32, block-private, L2-resident), which
// the next hop reads back after a barrier. No limit on n.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int RESIDENT_N = 128;         // largest n with S in registers
// The streamed path (n > RESIDENT_N): 4 warps, each 32 rows (two m16
// strips) x 32 columns (four n8 tiles) of the block's 128-row chunk.
constexpr int MS = 2;                   // 16-row strips per warp
constexpr int NT = 4;                   // n8 tiles per warp
constexpr int WR = 16 * MS;             // rows per warp
constexpr int BN = 8 * NT;              // columns per block
constexpr int NTH = 128;                // threads per block
constexpr int MC = WR * NTH / 32;       // rows per chunk
constexpr int LDY = BN + 8;             // iterate row stride (floats)
constexpr int KP = 32;                  // k-panel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes global -> shared; src_bytes = 0 writes zeros, reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// c += a b, one m16n8k8 tf32 product with f32 accumulators.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x ~ hi + lo: hi = x rounded to TF32 (to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x); x - hi is exact in f32, and lo is it
// rounded to TF32 the same way (within 2^-22 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// rows x cols of the n x n matrix G from (r0, c0) on into dst (row stride
// ld floats); entries outside [0, n)^2 are zero. 16-byte copies when
// `vec` (n % 4 == 0, G 16-byte aligned; c0, cols and ld are multiples
// of 4), else 4-byte ones. The caller waits and synchronises.
__device__ __forceinline__ void stage(float* dst, int ld, const float* G,
                                      int n, int r0, int c0, int rows,
                                      int cols, bool vec, int tid,
                                      int nth) {
  if (vec) {
    const int cpr = cols >> 2;
    for (int c = tid; c < rows * cpr; c += nth) {
      const int r = c / cpr;
      const int k = (c - r * cpr) << 2;
      const int gr = r0 + r, gc = c0 + k;
      const bool ok = gr < n && gc < n;
      cp_async16(dst + r * ld + k, ok ? G + (size_t)gr * n + gc : G,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nth) {
      const int r = e / cols;
      const int k = e - r * cols;
      const int gr = r0 + r, gc = c0 + k;
      const bool ok = gr < n && gc < n;
      cp_async4(dst + r * ld + k, ok ? G + (size_t)gr * n + gc : G,
                ok ? 4 : 0);
    }
  }
}

// acc/sml[MS][NT][4] += A B over nk (a multiple of 8) values of k with
// mma.sync m16n8k8 in split TF32: A rows row0 .. row0 + WR-1 of S (TRANS:
// of S^T) from sS, B the iterate's split rows 0 .. nk-1 from sYh/sYl.
// Only the first `live` strips compute.
template <bool TRANS>
__device__ __forceinline__ void hop_mma(float (*acc)[NT][4],
                                        float (*sml)[NT][4],
                                        const float* sS, int ld,
                                        const float* sYh, const float* sYl,
                                        int row0, int nk, int live, int g,
                                        int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < nk; k0 += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = (k0 + t) * LDY + nt * 8 + g;
      bh[nt][0] = __float_as_uint(sYh[o]);
      bh[nt][1] = __float_as_uint(sYh[o + 4 * LDY]);
      bl[nt][0] = __float_as_uint(sYl[o]);
      bl[nt][1] = __float_as_uint(sYl[o + 4 * LDY]);
    }
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      if (ms >= live) break;                 // warp-uniform
      const int r = row0 + ms * 16;
      float a[4];
      if constexpr (TRANS) {                 // A(i, k) = S[k][i]
        const float* p = sS + (k0 + t) * ld + r + g;
        a[0] = p[0]; a[1] = p[8]; a[2] = p[4 * ld]; a[3] = p[4 * ld + 8];
      } else {                               // A(i, k) = S[i][k]
        const float* p = sS + (r + g) * ld + k0 + t;
        a[0] = p[0]; a[1] = p[8 * ld]; a[2] = p[4]; a[3] = p[8 * ld + 4];
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(sml[ms][nt], al, bh[nt][0], bh[nt][1]);
        mma_tf32(sml[ms][nt], ah, bl[nt][0], bl[nt][1]);
        mma_tf32(acc[ms][nt], ah, bh[nt][0], bh[nt][1]);
      }
    }
  }
}

// The warp's (32 x 32) tile of a row-major (n x d) matrix M in the
// accumulator layout: x[ms][nt] = rows row0 + 16 ms + {g, g + 8}, columns
// c0 + 8 nt + {2t, 2t + 1}; zero outside. `pair`: d is even and M's rows
// are aligned for two-element accesses.
template <int STRIPS, int TILES, typename T>
__device__ __forceinline__ void load_tile(float (*x)[TILES][4], const T* M,
                                          int n, int d, int row0, int c0,
                                          bool pair, int g, int t) {
#pragma unroll
  for (int ms = 0; ms < STRIPS; ++ms) {
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt) {
      const int c = c0 + nt * 8 + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row0 + ms * 16 + g + 8 * hf;
        float v0 = 0.f, v1 = 0.f;
        if (r < n) {
          const T* p = M + (size_t)r * d + c;
          if (pair && c < d) {
            const float2 v = load2(p);
            v0 = v.x; v1 = v.y;
          } else {
            if (c < d) v0 = to_f32(p[0]);
            if (c + 1 < d) v1 = to_f32(p[1]);
          }
        }
        x[ms][nt][2 * hf] = v0;
        x[ms][nt][2 * hf + 1] = v1;
      }
    }
  }
}

template <int STRIPS, int TILES, typename T>
__device__ __forceinline__ void store_tile(T* M, const float (*x)[TILES][4],
                                           int n, int d, int row0, int c0,
                                           bool pair, int g, int t) {
#pragma unroll
  for (int ms = 0; ms < STRIPS; ++ms) {
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt) {
      const int c = c0 + nt * 8 + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row0 + ms * 16 + g + 8 * hf;
        if (r >= n || c >= d) continue;
        T* p = M + (size_t)r * d + c;
        const float v0 = x[ms][nt][2 * hf], v1 = x[ms][nt][2 * hf + 1];
        if (pair) {
          store2(p, v0, v1);
        } else {
          store1(p, v0);
          if (c + 1 < d) store1(p + 1, v1);
        }
      }
    }
  }
}

template <int STRIPS, int TILES>
__device__ __forceinline__ void zero(float (*x)[TILES][4]) {
#pragma unroll
  for (int ms = 0; ms < STRIPS; ++ms)
#pragma unroll
    for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[ms][nt][e] = 0.f;
}

__device__ __forceinline__ int live_strips(int n, int row0) {
  const int s = (n - row0 + 15) >> 4;
  return s < 0 ? 0 : (s > MS ? MS : s);
}

// Offset (floats) of element (r, k) of a K-major tile with nk columns of
// k in wgmma's no-swizzle layout: 8 x 4 core matrices of 128 contiguous
// bytes, 128 bytes apart along k (LBO) and 32 nk bytes apart along r
// (SBO).
__device__ __forceinline__ int kmaj(int r, int k, int nk) {
  return (r & 7) * 4 + (r >> 3) * 8 * nk + (k & 3) + (k >> 2) * 32;
}

// wgmma operand descriptor of such a tile from p (its element (0, 0)).
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int nk) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) |
         ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(((32 * nk) >> 4) & 0x3FFF) << 32);
}

// d += a b for the warpgroup, in tf32 with f32 accumulators: a (64 x 8)
// in registers (each warp 16 rows, in the m16n8k8 A layout), b (8 x N)
// from shared memory by descriptor; d[nt] is the warp's (16 x 8)
// accumulator of n8 tile nt (rows 16 (warp % 4) + {g, g + 8}).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (*d)[4], const uint32_t* a,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (*d)[4],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (*d)[4],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulators across wgmma issue/wait.
template <int TILES>
__device__ __forceinline__ void pin(float (*x)[4]) {
#pragma unroll
  for (int nt = 0; nt < TILES; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[nt][e])::"memory");
}

// The warp's A fragments of S (TRANS: S^T) for all NKS k-steps, split:
// rows r0 + {g, g + 8}, columns 8 kk + {t, t + 4}, zero outside
// [0, n)^2; straight from global memory (L2) into registers, where they
// stay for every hop and tile of this batch item.
template <bool TRANS, int NKS>
__device__ __forceinline__ void load_a(uint32_t (*ah)[4], uint32_t (*al)[4],
                                       const float* Sb, int n, int r0, int g,
                                       int t) {
  float v[NKS][4];
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e & 1);
      const int k = 8 * kk + t + 4 * (e >> 1);
      v[kk][e] = (i < n && k < n)
                     ? (TRANS ? Sb[(size_t)k * n + i] : Sb[(size_t)i * n + k])
                     : 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[kk][e], ah[kk][e], al[kk][e]);
}

// n <= RESIDENT_N: a persistent block walks the items [item0, item1) of
// (batch item, column tile of BNT columns), item = b tiles + c. S of the
// current batch item stays in registers, split, as the A fragments of
// all its tiles and hops (NKS k-steps of 8: k padded to 8 NKS); the
// iterate stays in registers between hops and, split, in shared memory
// as the next hop's B operand. blockDim.x = 128 ceil(n / 64): warpgroup q
// computes rows 64 q .. 64 q + 63 (warp w: rows 16 w ..) with three
// wgmma m64nBNTk8 per k-step into one accumulator.
template <typename T, bool TRANS, int BNT, int NKS>
__global__ void __launch_bounds__(256, 1)
graph_filter_kernel_resident(const float* __restrict__ S,
                             const T* __restrict__ W,
                             const float* __restrict__ h, T* __restrict__ Y,
                             int n, int d, int K, int tiles, int items,
                             bool pair) {
  constexpr int TL = BNT / 8;                // n8 tiles per warp
  constexpr int NK = 8 * NKS;                // k, padded
  extern __shared__ __align__(128) float smem[];
  float* sYh = smem;
  float* sYl = smem + BNT * NK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int item0 = (int)((long long)items * blockIdx.x / gridDim.x);
  const int item1 = (int)((long long)items * (blockIdx.x + 1) / gridDim.x);
  const float hK = h[K];
  int staged = -1;                           // batch item whose S is held
  uint32_t ah[NKS][4], al[NKS][4];
  // w: this tile's W; wn: the next tile's, loaded during this one's hops.
  float w[TL][4], wn[TL][4], acc[TL][4];
  if (item0 < item1) {
    const int b = item0 / tiles;
    load_tile<1, TL>(reinterpret_cast<float(*)[TL][4]>(wn),
                     W + (size_t)b * n * d, n, d, r0,
                     (item0 - b * tiles) * BNT, pair, g, t);
  }

  for (int item = item0; item < item1; ++item) {
    const int b = item / tiles;
    const int c0 = (item - b * tiles) * BNT;
    const bool next = item + 1 < item1;
    const int bn = (item + 1) / tiles;
    const int cn = (item + 1 - bn * tiles) * BNT;
#pragma unroll
    for (int nt = 0; nt < TL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[nt][e] = wn[nt][e];
    if (K == 0 && next) {
      load_tile<1, TL>(reinterpret_cast<float(*)[TL][4]>(wn),
                       W + (size_t)bn * n * d, n, d, r0, cn, pair, g, t);
    }
    if (b != staged && K > 0) {
      load_a<TRANS, NKS>(ah, al, S + (size_t)b * n * n, n, r0, g, t);
      staged = b;
    }
#pragma unroll
    for (int nt = 0; nt < TL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = hK * w[nt][e];

    for (int k = K - 1; k >= 0; --k) {
      __syncthreads();               // the last hop's reads of sY are done
#pragma unroll
      for (int nt = 0; nt < TL; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = r0 + g + 8 * (e >> 1);    // the iterate's row
          if (kr < NK) {
            const int o = kmaj(nt * 8 + 2 * t + (e & 1), kr, NK);
            uint32_t hi, lo;
            split(acc[nt][e], hi, lo);
            sYh[o] = __uint_as_float(hi);
            sYl[o] = __uint_as_float(lo);
          }
        }
      }
      fence_async_smem();
      __syncthreads();               // the iterate is complete
#pragma unroll
      for (int nt = 0; nt < TL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      pin<TL>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        const uint64_t yh = wgmma_desc(sYh + 64 * kk, NK);
        const uint64_t yl = wgmma_desc(sYl + 64 * kk, NK);
        wgmma_tf32<BNT>(acc, al[kk], yh);
        wgmma_tf32<BNT>(acc, ah[kk], yl);
        wgmma_tf32<BNT>(acc, ah[kk], yh);
      }
      if (k == K - 1 && next) {      // the next tile's W, under the hop
        load_tile<1, TL>(reinterpret_cast<float(*)[TL][4]>(wn),
                         W + (size_t)bn * n * d, n, d, r0, cn, pair, g, t);
      }
      wgmma_commit_wait();
      pin<TL>(acc);
      const float hk = h[k];
#pragma unroll
      for (int nt = 0; nt < TL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += hk * w[nt][e];
    }
    store_tile<1, TL>(Y + (size_t)b * n * d,
                      reinterpret_cast<const float(*)[TL][4]>(acc), n, d, r0,
                      c0, pair, g, t);
  }
}

// KP rows (k0 ..) x BN columns (c0 ..) of the iterate, scale * M, split
// into sYh/sYl; zero past n and d. M is the input W (hop 0) or `work`.
template <typename T>
__device__ __forceinline__ void stage_iterate(float* sYh, float* sYl,
                                              const T* M, float scale, int n,
                                              int d, int k0, int c0,
                                              int tid) {
  for (int e = tid; e < KP * BN; e += NTH) {
    const int r = e / BN;
    const int c = e - r * BN;
    const int gr = k0 + r, gc = c0 + c;
    const float v =
        (gr < n && gc < d) ? scale * to_f32(M[(size_t)gr * d + gc]) : 0.f;
    uint32_t hi, lo;
    split(v, hi, lo);
    sYh[r * LDY + c] = __uint_as_float(hi);
    sYl[r * LDY + c] = __uint_as_float(lo);
  }
}

// n > RESIDENT_N: grid (ceil(d / BN), B); S and the iterate streamed
// through shared memory in panels, the iterate between hops in `work`
// (min(K-1, 2) planes of B n d f32, block-private, read back after a
// barrier). blockDim.x = NTH.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(NTH)
graph_filter_kernel_streamed(const float* __restrict__ S,
                             const T* __restrict__ W,
                             const float* __restrict__ h, T* __restrict__ Y,
                             float* work, int n, int d, int K, bool vec,
                             bool pair) {
  constexpr int ld = TRANS ? MC + 8 : KP + 4;
  __shared__ __align__(16) float sS[TRANS ? KP * ld : MC * ld];
  __shared__ __align__(16) float sYh[KP * LDY];
  __shared__ __align__(16) float sYl[KP * LDY];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, c0 = blockIdx.x * BN;
  const size_t nd = (size_t)n * d;
  const size_t plane = (size_t)gridDim.y * nd;
  const float* Sb = S + (size_t)b * n * n;
  const T* Wb = W + b * nd;
  T* Yb = Y + b * nd;
  float acc[MS][NT][4], sml[MS][NT][4], w[MS][NT][4];

  if (K == 0) {
    const float h0 = h[0];
    for (int m0 = 0; m0 < n; m0 += MC) {
      const int row0 = m0 + warp * WR;
      load_tile<MS, NT>(w, Wb, n, d, row0, c0, pair, g, t);
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[ms][nt][e] *= h0;
      store_tile<MS, NT>(Yb, w, n, d, row0, c0, pair, g, t);
    }
    return;
  }

  for (int j = 0; j < K; ++j) {
    const int k = K - 1 - j;
    const float* src = j ? work + ((j - 1) & 1) * plane + b * nd : nullptr;
    float* dst = k ? work + (j & 1) * plane + b * nd : nullptr;
    const float hk = h[k];
    for (int m0 = 0; m0 < n; m0 += MC) {
      const int row0 = warp * WR;           // within the chunk
      const int live = live_strips(n, m0 + row0);
      zero<MS, NT>(acc);
      zero<MS, NT>(sml);
      for (int k0 = 0; k0 < n; k0 += KP) {
        __syncthreads();             // the last panel's reads are done
        if constexpr (TRANS) {
          stage(sS, ld, Sb, n, k0, m0, KP, MC, vec, tid, NTH);
        } else {
          stage(sS, ld, Sb, n, m0, k0, MC, KP, vec, tid, NTH);
        }
        if (j == 0) {
          stage_iterate(sYh, sYl, Wb, h[K], n, d, k0, c0, tid);
        } else {
          stage_iterate(sYh, sYl, src, 1.f, n, d, k0, c0, tid);
        }
        cp_async_wait_all();
        __syncthreads();
        hop_mma<TRANS>(acc, sml, sS, ld, sYh, sYl, row0, KP, live, g, t);
      }
      load_tile<MS, NT>(w, Wb, n, d, m0 + row0, c0, pair, g, t);
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[ms][nt][e] = (acc[ms][nt][e] + sml[ms][nt][e]) +
                             hk * w[ms][nt][e];
      if (k == 0) {
        store_tile<MS, NT>(Yb, acc, n, d, m0 + row0, c0, pair, g, t);
      } else {
        store_tile<MS, NT>(dst, acc, n, d, m0 + row0, c0, (d & 1) == 0, g,
                           t);
      }
    }
    __syncthreads();                 // this hop's iterate is in `work`
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The resident kernel's threads (a warpgroup per 64 rows), k-steps (an
// even count of 8-wide steps) and dynamic shared memory in bytes.
int resident_threads(int n) { return 128 * ((n + 63) / 64); }
int resident_ksteps(int n) { return (((n + 7) / 8) + 1) & ~1; }
size_t resident_smem(int nks, int bnt) {
  return sizeof(float) * 2 * (size_t)bnt * 8 * nks;
}

int sm_count() {
  static std::atomic<int> cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  int v = cache[dev & 63].load();
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || v < 1) {
      return 1;
    }
    cache[dev & 63].store(v);
  }
  return v;
}

// Blocks of one resident instance an SM holds at `threads`; per device.
template <typename T, bool TRANS, int BNT, int NKS>
cudaError_t resident_blocks_per_sm(int threads, int* out) {
  static std::atomic<int> cache[64][3];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& c = cache[dev & 63][threads / 128];
  int v = c.load();
  if (v == 0) {
    auto kernel = graph_filter_kernel_resident<T, TRANS, BNT, NKS>;
    const size_t smem = resident_smem(NKS, BNT);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, kernel, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (v < 1) return cudaErrorInvalidConfiguration;
    c.store(v);
  }
  *out = v;
  return cudaSuccess;
}

// 32-column tiles on persistent blocks; 64-column ones where those fit
// the card in one wave and 32-column ones would not.
template <typename T, bool TRANS, int NKS>
cudaError_t launch_resident(const float* S, const T* W, const float* h, T* Y,
                            int B, int n, int d, int K, bool pair,
                            cudaStream_t st) {
  const int sms = sm_count(), threads = resident_threads(n);
  int occ32 = 0, occ64 = 0;
  cudaError_t err =
      resident_blocks_per_sm<T, TRANS, 32, NKS>(threads, &occ32);
  if (err != cudaSuccess) return err;
  err = resident_blocks_per_sm<T, TRANS, 64, NKS>(threads, &occ64);
  if (err != cudaSuccess) return err;
  const int tiles32 = (d + 31) / 32, tiles64 = (d + 63) / 64;
  const long long items32 = (long long)B * tiles32;
  const long long items64 = (long long)B * tiles64;
  if (items32 > (long long)sms * occ32 && items64 <= (long long)sms * occ64) {
    graph_filter_kernel_resident<T, TRANS, 64, NKS>
        <<<(int)items64, threads, resident_smem(NKS, 64), st>>>(
            S, W, h, Y, n, d, K, tiles64, (int)items64, pair);
  } else {
    const long long slots = (long long)sms * occ32;
    graph_filter_kernel_resident<T, TRANS, 32, NKS>
        <<<(int)(items32 < slots ? items32 : slots), threads,
           resident_smem(NKS, 32), st>>>(S, W, h, Y, n, d, K, tiles32,
                                         (int)items32, pair);
  }
  return cudaGetLastError();
}

template <typename T, bool TRANS>
cudaError_t launch(const void* S_, const void* W_, const void* h_, void* Y_,
                   void* work, int B, int n, int d, int K, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || d < 1 || K < 0) {
    return cudaErrorInvalidValue;
  }
  const float* S = static_cast<const float*>(S_);
  const T* W = static_cast<const T*>(W_);
  const float* h = static_cast<const float*>(h_);
  T* Y = static_cast<T*>(Y_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned(S, 16);
  const bool pair =
      d % 2 == 0 && aligned(W, 2 * sizeof(T)) && aligned(Y, 2 * sizeof(T));
  if (n <= RESIDENT_N) {
    const int nks = resident_ksteps(n);
#define GF_CASE(N) \
  case N:          \
    return launch_resident<T, TRANS, N>(S, W, h, Y, B, n, d, K, pair, st);
    switch (nks) {
      GF_CASE(2) GF_CASE(4) GF_CASE(6) GF_CASE(8)
      GF_CASE(10) GF_CASE(12) GF_CASE(14) GF_CASE(16)
    }
#undef GF_CASE
    return cudaErrorInvalidValue;
  } else {
    const dim3 grid((d + BN - 1) / BN, B);
    if (K >= 2 && (work == nullptr || !aligned(work, 8))) {
      return cudaErrorInvalidValue;
    }
    graph_filter_kernel_streamed<T, TRANS><<<grid, NTH, 0, st>>>(
        S, W, h, Y, static_cast<float*>(work), n, d, K, vec, pair);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `work`: see
// the contract above (null unless n > graph_filter_resident_n() and
// K >= 2).
int graph_filter_f32(const void* S, const void* W, const void* h, void* Y,
                     void* work, int B, int n, int d, int K, void* stream) {
  return (int)launch<float, false>(S, W, h, Y, work, B, n, d, K, stream);
}

int graph_filter_bf16(const void* S, const void* W, const void* h, void* Y,
                      void* work, int B, int n, int d, int K, void* stream) {
  return (int)launch<__nv_bfloat16, false>(S, W, h, Y, work, B, n, d, K,
                                           stream);
}

// The backward's dW: Y = sum_k h_k (S^T)^k W with S given untransposed
// (f32 only: the reference casts the cotangent to f32 before its call).
int graph_filter_t_f32(const void* S, const void* W, const void* h, void* Y,
                       void* work, int B, int n, int d, int K, void* stream) {
  return (int)launch<float, true>(S, W, h, Y, work, B, n, d, K, stream);
}

// The largest n whose S stays resident in shared memory (no `work`).
int graph_filter_resident_n() { return RESIDENT_N; }

const char* graph_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
