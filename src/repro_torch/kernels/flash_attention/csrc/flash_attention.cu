// Blocked online-softmax attention (FlashAttention, forward) for Hopper
// (sm_90a), with both products on the tensor cores (mma.sync).
//
// Replaces the Pallas TPU kernel of the reference package:
// src/repro/kernels/flash_attention/kernel.py:26 (_kernel) and :81
// (flash_attention_pallas), reached through ops.py::flash_attention. In
// the port it runs every causal self-attention of an LLM prefill
// (models/attention.py::full_attention): 36 launches per qwen3-4b prefill.
//
// Contract: q (B, H, Sq, dh), k/v (B, KV, Skv, dh), f32 or bf16, any
// strides over (B, heads, sequence) and unit stride over dh, so the
// model's (B, S, H, dh) projections are read through a transposed view.
// Head h reads kv head h / (H / KV) (GQA). Causal (key j <= query i) and
// sliding-window (j > i - window) masks, no query offset. Scores are
// scaled by the true dh^-0.5; masked scores are -1e30 and get p = 0, the
// softmax denominator is max(l, 1e-30), as in the reference. Output o in
// q's dtype, through the strides it is given (the wrapper's torch.empty_like:
// q's strides when q is dense, contiguous otherwise); the softmax state
// (m, l) and O accumulate in f32. For training, the launch also writes each
// row's m + log2(l) to `lse` (one store per row after the loop), which the
// backward kernel (flash_attention_bwd.cu) reads; serving passes null.
//
// Departures from the reference's arithmetic:
//   * bf16 inputs: P is rounded to bf16 before P.V (the reference keeps P
//     in f32), as every bf16 flash kernel does; l sums the f32 P.
//   * f32 inputs: split TF32 ("3xTF32"). Each f32 operand x is
//     x_hi + x_lo with x_hi = tf32(x) (round to nearest, ties away, as
//     cvt.rna, by an integer add and mask, which issues faster than the
//     conversion) and x_lo = x - x_hi, and each product is a_lo b_hi +
//     a_hi b_lo + a_hi b_hi in f32 accumulators, for Q.K^T and P.V. x_lo
//     goes to the tensor core as f32 bits, which it reads as TF32 by
//     dropping the low 13 bits (truncation, as CUTLASS's 3xTF32 does for
//     its small part): that saves a rounding per element and costs at most
//     2^-21 of x. The dropped a_lo b_lo is about 2^-22 of the product:
//     f32 accuracy. No one-pass TF32 anywhere.
//   * exp is exp2 with scale * log2(e) folded into the score scale.
//
// What bounds it: at the qwen3-4b prefill shape (B=4, H=32, KV=8,
// S=2048, dh=128, causal) the live (i, j) pairs are S(S+1)/2 per head:
// 4 B H dh S(S+1)/2 = 137.6 GFLOP. On the tensor cores that is 0.139 ms
// in bf16 (989 TFLOP/s dense) and, at three TF32 products each, 0.834 ms
// in f32 (495 TFLOP/s), against 335 MB of q, k, v, o in f32 (0.10 ms at
// 3.35 TB/s): bound by operations. mma.sync reaches only part of the
// tensor-core peak (wgmma is the full rate); the split also costs CUDA-
// core instructions (3 per operand element per use).
//
// Design (wgmma + TMA + a producer warp is the later step for bf16):
//   * one block of 4 warps per (batch item x head, query tile of 64 rows);
//     each warp owns 16 query rows, and keeps the score tile, m, l and the
//     O accumulator (16 x dh f32) in registers. Q stays in shared memory
//     and its fragments are read again for every kv tile: registers, not
//     shared memory, limit the blocks per SM (3 in f32, 4 in bf16), and
//     Q's fragments at dh = 128 would take 64 more registers a thread.
//     Nothing is carried between blocks: the TPU kernel's sequential kv
//     grid axis is a loop inside the block.
//   * grid (B H, query tiles), the query tile reversed (the last, heaviest
//     causal tile of every head is dispatched first), so the light tiles
//     fill in at the end.
//   * K/V tiles (64 keys in bf16, 32 in f32) come through shared memory
//     with 16-byte cp.async, one buffer each, staggered: K(j+1) loads
//     while the softmax and P.V(j) run, V(j+1) while Q.K^T(j+1) runs (a
//     tile pair in flight at half the shared memory of double buffering).
//     Rows are padded (+8 bf16, +4 f32 elements), which makes ldmatrix
//     (bf16) and the f32 fragment reads free of bank conflicts. f32
//     operands are split on the fly; in Q.K^T the small products go to
//     their own accumulators, doubling the independent mma chains.
//   * bf16: mma.m16n8k16; K fragments by ldmatrix, V by ldmatrix.trans.
//     The accumulator layout of two n8 score tiles is the A-fragment
//     layout of one k16 step, so P stays in registers.
//   * f32: mma.m16n8k8 tf32. The C layout (thread t holds keys 2t, 2t+1
//     of an n8 tile) and the A layout (keys t, t+4) differ, so P stays in
//     registers and V's rows are permuted within each k-step instead:
//     A's logical key t is physical key 2t, logical t+4 is 2t+1, and the
//     B fragment reads V rows 2t and 2t+1.
//   * masks are applied per element only on tiles where they can bite
//     (the causal diagonal, the window's edge, the ragged end of Skv);
//     wholly masked tiles are skipped, so a windowed layer does O(S W)
//     work.
//   * ragged Sq, Skv and dh are zero-filled in shared memory (cp.async's
//     src-size 0); dh <= 64 runs the 64-wide instance, 64 < dh <= 128 the
//     128-wide one. The reference's padding of dh to 128 lanes and of S
//     to block multiples is a TPU tiling rule with no counterpart here.
//   * tensors whose rows are not 16-byte aligned (odd strides, dh not a
//     multiple of 16 bytes) take the same kernel with per-element loads
//     and stores (the `vec` flag, chosen by the wrapper), never a copy.
//   * shared memory: (64 query + 2 x kv-tile rows) x (dh + pad): 67,584 B
//     (f32) and 52,224 B (bf16) at dh = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;     // threads per block
constexpr int BQ = 16 * WARPS;     // query rows per block
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;
};

// Keys per kv tile, row padding (elements) and blocks per SM to aim for.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BKV = 32, PAD = 4, MIN_BLOCKS = 3;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BKV = 64, PAD = 8, MIN_BLOCKS = 4;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
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

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, one m16n8k16 bf16 product with f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, one m16n8k8 tf32 product with f32 accumulators.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: what cvt.rna.tf32.f32 gives, for finite x); lo = x - hi
// is exact in f32 and goes to the tensor core as it is, which reads its
// TF32 part (the top 19 bits: lo truncated, at most 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS rows of DHP elements from global row r0 on (rows >= n_rows and
// columns >= dh zero-filled) into shared rows of LD elements.
template <typename T, int DHP, int ROWS, bool VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int r0,
                                          int n_rows, int dh, int tid) {
  constexpr int LD = DHP + Tile<T>::PAD;
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
    constexpr int CPR = DHP / EPC;        // chunks per row
    for (int c = tid; c < ROWS * CPR; c += NT) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * EPC;
      const int gr = r0 + r;
      const bool ok = gr < n_rows && d < dh;
      cp_async16(dst + r * LD + d, ok ? src + gr * stride + d : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * DHP; e += NT) {
      const int r = e / DHP;
      const int d = e - r * DHP;
      const int gr = r0 + r;
      dst[r * LD + d] =
          (gr < n_rows && d < dh) ? src[gr * stride + d] : zero<T>();
    }
  }
}

// s[NS][4] = Q K^T for this warp's 16 rows (sQ) and the tile's BKV keys.
template <int DHP, int NS, int LD>
__device__ __forceinline__ void scores(float (*s)[4],
                                       const __nv_bfloat16* sQ,
                                       const __nv_bfloat16* sK, int lane) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sQ + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

template <int DHP, int NS, int LD>
__device__ __forceinline__ void scores(float (*s)[4], const float* sQ,
                                       const float* sK, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float small[NS][4];                  // the two small products apart:
#pragma unroll                         // twice the independent chains
  for (int n = 0; n < NS; ++n)
    small[n][0] = small[n][1] = small[n][2] = small[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DHP / 8; ++kk) {
    const float* qr = sQ + g * LD + kk * 8 + t;
    uint32_t ah[4], al[4];
    split(qr[0], ah[0], al[0]);
    split(qr[8 * LD], ah[1], al[1]);
    split(qr[4], ah[2], al[2]);
    split(qr[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const float* kr = sK + (nt * 8 + g) * LD + kk * 8 + t;
      uint32_t bh0, bl0, bh1, bl1;
      split(kr[0], bh0, bl0);
      split(kr[4], bh1, bl1);
      mma_tf32(small[nt], al, bh0, bh1);
      mma_tf32(small[nt], ah, bl0, bl1);
      mma_tf32(s[nt], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];
  }
}

// o[NO][4] += P V, P (this warp's 16 rows x BKV keys) in score layout.
template <int DHP, int NS, int LD>
__device__ __forceinline__ void accumulate(float (*o)[4],
                                           const float (*p)[4],
                                           const __nv_bfloat16* sV,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < DHP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sV + (kk * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                               np * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

template <int DHP, int NS, int LD>
__device__ __forceinline__ void accumulate(float (*o)[4],
                                           const float (*p)[4],
                                           const float* sV, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < NS; ++kt) {
    // A's logical key t is the score tile's key 2t, logical t+4 is 2t+1.
    uint32_t ah[4], al[4];
    split(p[kt][0], ah[0], al[0]);
    split(p[kt][2], ah[1], al[1]);
    split(p[kt][1], ah[2], al[2]);
    split(p[kt][3], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < DHP / 8; ++nt) {
      const float* vr = sV + (kt * 8 + 2 * t) * LD + nt * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split(vr[0], bh0, bl0);
      split(vr[LD], bh1, bl1);
      mma_tf32(o[nt], al, bh0, bh1);
      mma_tf32(o[nt], ah, bl0, bl1);
      mma_tf32(o[nt], ah, bh0, bh1);
    }
  }
}

template <typename T, int DHP, bool VEC>
__global__ void __launch_bounds__(NT, Tile<T>::MIN_BLOCKS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int G, int Sq, int Skv, int dh, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       float scale_log2, float* __restrict__ lse) {
  constexpr int BKV = Tile<T>::BKV;
  constexpr int LD = DHP + Tile<T>::PAD;
  constexpr int NS = BKV / 8;          // n8 score tiles per warp
  constexpr int NO = DHP / 8;          // n8 output tiles per warp
  static_assert(NS * 4 <= 32, "one mask bit per score register");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);    // BQ rows
  T* sK = sQ + BQ * LD;                      // BKV rows
  T* sV = sK + BKV * LD;                     // BKV rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + (h / G) * ks.h;
  const T* vp = v + b * vs.b + (h / G) * vs.h;
  T* op = o + b * os.b + h * os.h;

  const int n_kv = (Skv + BKV - 1) / BKV;
  const int j_end = causal ? min(n_kv, q_hi / BKV + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) / BKV : 0;

  // Copy groups, in order: {Q, K(j_begin)}, {V(j_begin)}, then per tile
  // {K(j+1)} after Q K(j)^T is read and {V(j+1)} after P V(j): each load
  // runs under the other half of the tile's work. A group may be empty.
  load_rows<T, DHP, BQ, VEC>(sQ, qp, qs.s, q_lo, Sq, dh, tid);
  if (j_begin < j_end)
    load_rows<T, DHP, BKV, VEC>(sK, kp, ks.s, j_begin * BKV, Skv, dh, tid);
  cp_async_commit();
  if (j_begin < j_end)
    load_rows<T, DHP, BKV, VEC>(sV, vp, vs.s, j_begin * BKV, Skv, dh, tid);
  cp_async_commit();

  // Rows g and g + 8 of this warp's 16: m, l (this thread's columns; the
  // quad's sum is taken at the end) and O.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int qi0 = q_lo + warp * 16 + g;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const bool more = jt + 1 < j_end;
    cp_async_wait<1>();                // K(jt) (and Q) have landed
    __syncthreads();
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    scores<DHP, NS, LD>(s, sQ + warp * 16 * LD, sK, lane);
    __syncthreads();                   // every warp has read K(jt)
    if (more)
      load_rows<T, DHP, BKV, VEC>(sK, kp, ks.s, (jt + 1) * BKV, Skv, dh, tid);
    cp_async_commit();

    const int k_lo = jt * BKV;
    const bool edge = (causal && k_lo + BKV - 1 > q_lo) ||
                      (window > 0 && k_lo <= q_lo + BQ - 1 - window) ||
                      k_lo + BKV > Skv;
    uint32_t dead = 0;                 // bit 4n + e: s[n][e] is masked
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (edge) {
          const int qi = qi0 + (e >> 1) * 8;
          const int kj = k_lo + n * 8 + 2 * t + (e & 1);
          const bool live = kj < Skv && (!causal || kj <= qi) &&
                            (window <= 0 || kj > qi - window);
          if (!live) {
            s[n][e] = NEG_INF;
            dead |= 1u << (4 * n + e);
          }
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (dead >> (4 * n + e)) & 1u
                            ? 0.f
                            : exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    cp_async_wait<1>();                // V(jt) has landed
    __syncthreads();
    accumulate<DHP, NS, LD>(acc, s, sV, lane);
    __syncthreads();                   // every warp has read V(jt)
    if (more)
      load_rows<T, DHP, BKV, VEC>(sV, vp, vs.s, (jt + 1) * BKV, Skv, dh, tid);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && t == 0) {       // the backward's row statistics
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qi0 + r * 8;
      if (qi < Sq) lse[(long long)blockIdx.x * Sq + qi] = m[r] + log2f(l[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + r * 8;
    if (qi >= Sq) continue;
    T* row = op + qi * os.s;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t;
      const float x = acc[n][2 * r] / l[r];
      const float y = acc[n][2 * r + 1] / l[r];
      if (VEC) {                       // dh is even: d < dh => d + 1 < dh
        if (d < dh) store2(row + d, x, y);
      } else {
        if (d < dh) store1(row + d, x);
        if (d + 1 < dh) store1(row + d + 1, y);
      }
    }
  }
}

template <typename T, int DHP, bool VEC>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int B, int H,
                   int KV, int Sq, int Skv, int dh, const Strides* st,
                   int causal, int window, float scale_log2, float* lse,
                   cudaStream_t stream) {
  const size_t smem = sizeof(T) * (BQ + 2 * Tile<T>::BKV) *
                      (size_t)(DHP + Tile<T>::PAD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DHP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, DHP, VEC><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, H / KV, Sq, Skv, dh, st[0], st[1], st[2], st[3], causal,
      window, scale_log2, lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Sq, int Skv, int dh,
                     const long long* strides, int causal, int window,
                     float scale_log2, int vec, float* lse, void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 2147483647LL || KV < 1 ||
      H % KV != 0 || Sq < 1 || (Sq + BQ - 1) / BQ > 65535 || Skv < 1 ||
      dh < 1 || dh > 128 || window < 0) {
    return cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int t = 0; t < 4; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  if (vec) {                           // the wrapper's claim, checked
    constexpr long long EPC = 16 / sizeof(T);
    bool ok = dh % EPC == 0;
    for (int t = 0; t < 12; ++t) ok = ok && strides[t] % EPC == 0;
    const void* ptrs[4] = {q, k, v, o};
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorMisalignedAddress;
  }
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(DHP, VEC)                                                \
  launch<T, DHP, VEC>(qq, kk, vv, oo, B, H, KV, Sq, Skv, dh, st, causal,      \
                      window, scale_log2, lse, s)
  if (dh <= 64) return vec ? FLASH_LAUNCH(64, true) : FLASH_LAUNCH(64, false);
  return vec ? FLASH_LAUNCH(128, true) : FLASH_LAUNCH(128, false);
#undef FLASH_LAUNCH
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides`
// holds 12 element strides: (batch, head, sequence) of q, k, v and o.
// `scale_log2` is dh^-0.5 log2(e); `vec` (0/1) says that every row of
// q, k, v and o starts 16-byte aligned and dh fills whole 16-byte chunks,
// so tiles load with cp.async (checked: cudaErrorMisalignedAddress).
// `lse`, when not null, receives each row's m + log2(l) as (B, H, Sq)
// f32 (in log2 units of the scaled scores): the backward kernel's
// (flash_attention_bwd.cu) softmax statistics. Serving passes null.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int dh,
                        const long long* strides, int causal, int window,
                        float scale_log2, int vec, void* lse, void* stream) {
  return (int)dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, dh, strides,
                              causal, window, scale_log2, vec,
                              static_cast<float*>(lse), stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int Sq, int Skv, int dh,
                         const long long* strides, int causal, int window,
                         float scale_log2, int vec, void* lse, void* stream) {
  return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, dh,
                                      strides, causal, window, scale_log2,
                                      vec, static_cast<float*>(lse), stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
