// Backward pass of blocked online-softmax attention (FlashAttention) for
// Hopper (sm_90a), f32, with every product on the tensor cores
// (mma.sync m16n8k8 in split TF32).
//
// Computes dq, dk and dv of  o = softmax(q k^T / sqrt(dh) + mask) v  for
// q (B, H, Sq, dh), k/v (B, KV, Skv, dh), with the forward kernel's masks
// (causal: key j <= query i; sliding window: j > i - window) and GQA
// (head h reads kv head h / G, G = H / KV, so dk and dv sum over the G
// query heads of a kv head).
//
// Replaces: the gradient of the reference's plain attention, which XLA
// differentiates (src/repro/models/attention.py:56, sdpa; the reference's
// Pallas kernel, src/repro/kernels/flash_attention/kernel.py:26, has no
// backward, and its LM trains through sdpa). In the port every causal
// self-attention of a training step runs through the forward kernel, so its
// gradient comes from here: one launch per attention layer per step.
//
// Inputs: q, k, v, the forward's output o and its row log-sum-exp `lse`
// (B, H, Sq) in the forward's log2 units: lse = m + log2(l), m the row max
// of s * scale * log2(e), l the sum of exp2(s * scale * log2(e) - m); so
// p = exp2(s * scale * log2(e) - lse). do (B, H, Sq, dh). Any strides over
// (batch, head, sequence), unit stride over dh. Outputs dq (B, H, Sq, dh),
// dk and dv (B, KV, Skv, dh), contiguous; `delta` (B, H, Sq) f32 scratch.
//
// Arithmetic: split TF32 ("3xTF32"), as the graph filter's: each f32
// operand x is x_hi + x_lo with x_hi = tf32(x) and x_lo = tf32(x - x_hi),
// both rounded to nearest (ties away) by an integer add and mask; each
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 accumulators (the
// dropped a_lo b_lo is about 2^-22 of the product). No one-pass TF32
// anywhere: it would miss chip_smoke.py's 1e-4 gate (its control shows it).
//
// What bounds it: at the qwen3-4b training shape (B=4, H=32, KV=8,
// S=2048, dh=128, causal) the gradient needs five S x S x dh products per
// head over the live (i, j) pairs (S(S+1)/2 per head): q k^T and do v^T
// (to rebuild P and dP), P^T do (dv), dS^T q (dk) and dS k (dq),
// 10 B H dh S(S+1)/2 = 344 GFLOP: 2.08 ms as split TF32 on the tensor
// cores (three products each, 495 TFLOP/s), against about 0.6 GB of inputs
// and outputs (0.18 ms at 3.35 TB/s): bound by operations. This design
// rebuilds P and dP a second time for dq (seven products per live pair),
// so its own bound is 7/5 of that, 2.92 ms.
//
// Design:
//   * no float atomics, so a rerun is bit-equal. dk and dv are summed by
//     the block that owns a kv tile; dq, a sum over kv tiles, by a second
//     kernel that owns a query tile. A per-kv-tile dq partial would take
//     S / 128 times dq's size (about 1 GB at the qwen3-4b shape).
//   * `dkdv`: one block of 8 warps per (batch item x kv head, tile of 128
//     keys), each warp owning 16 keys as the M rows of its products. It
//     loops over the G query heads of the kv head and, per head, over the
//     query tiles of 32 rows that can see the kv tile (causal: from the
//     tile's first key on; window: up to its last key + window - 1), and
//     computes the transposed scores directly: S^T = K Q^T and
//     dP^T = V dO^T (16 keys x 32 queries per warp). P^T and dS^T are then
//     in the accumulator layout of the rows that own dk and dv, and feed
//     dv += P^T dO and dk += dS^T Q through the C-to-A reshuffle the
//     forward uses for P.V (A's logical column t is the accumulator's 2t,
//     t + 4 is 2t + 1; B reads rows 2t and 2t + 1): no round trip through
//     shared memory. dk and dv (16 x dh each per warp) stay in registers
//     for the whole loop and are summed in a fixed order: each query
//     tile's contribution in fresh accumulators, then added in f32 (the
//     tensor cores' accumulation truncates, so a sum chained through every
//     tile drifts toward the 1e-4 gate at the qwen3-4b shape). The K and V
//     tiles are loaded once; the query tiles (Q, dO, lse, delta) come by
//     cp.async into two stages, tile n + 1 loading while tile n computes
//     (one barrier per tile). The kv tiles are taken first to last, so the
//     heaviest causal tiles start first. A warp whose 16 keys the query
//     tile cannot see skips its products; masks are applied per element
//     only on tiles where they can bite.
//   * `dq`: the forward's layout plus dS K: one block of 4 warps per
//     (batch item x head, query tile of 64 rows), each warp owning 16
//     rows; per kv tile of 32 keys, dP = dO V^T, S = Q K^T, P, dS in
//     registers, then dq += dS K through the same reshuffle (each kv
//     tile's part added in f32, as for dk and dv). K and V come
//     by cp.async into one buffer each, staggered: V(j+1) loads while
//     S, dS and dS K(j) run, K(j+1) while dO V(j+1)^T runs. The query
//     tiles are taken last to first (the heaviest causal tiles first).
//   * delta_i = sum_d do_i o_i (the row term of dS = P (dP - delta)) is
//     computed once per row by a first small kernel into `delta`.
//   * rows are padded by 4 floats, so every fragment read (rows g, columns
//     t; or rows 2t, columns g) is free of bank conflicts. Ragged Sq, Skv
//     and dh are zero-filled in shared memory (cp.async's src-size 0) and
//     masked; dh <= 64 runs the 64-wide instance, 64 < dh <= 128 the
//     128-wide one. Rows not 16-byte aligned (dh or a stride not a
//     multiple of 4, a base pointer off 16 bytes) take per-element loads.
//   * shared memory at dh = 128: dkdv (2 x 128 key rows + 2 stages x 2 x
//     32 query rows) x 132 floats + 2 x 2 x 32 row scalars = 203,264 B
//     (one block of 8 warps per SM); dq (2 x 64 + 2 x 32 rows) x 132
//     floats = 101,376 B (two blocks of 4 warps per SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 4;             // floats of padding per shared row
constexpr int KV_WARPS = 8;
constexpr int KV_NT = 32 * KV_WARPS;
constexpr int KV_BKV = 16 * KV_WARPS;   // keys per dkdv block
constexpr int KV_BQ = 32;               // query rows per staged tile
constexpr int Q_WARPS = 4;
constexpr int Q_NT = 32 * Q_WARPS;
constexpr int Q_BQ = 16 * Q_WARPS;      // query rows per dq block
constexpr int Q_BKV = 32;               // keys per staged kv tile
constexpr int DELTA_NT = 256;

struct Strides {
  long long b, h, s;
};

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// c += a b, one m16n8k8 tf32 product with f32 accumulators.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, each rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: cvt.rna.tf32.f32 for finite x); x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c += a b in split TF32: the two small products, then the large one.
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// The A fragment of rows r0 + g, r0 + g + 8 and columns c0 + t, c0 + t + 4
// of a row-major shared tile, split.
template <int LD>
__device__ __forceinline__ void a_rows(uint32_t* ah, uint32_t* al,
                                       const float* tile, int g, int t) {
  const float* p = tile + g * LD + t;
  split(p[0], ah[0], al[0]);
  split(p[8 * LD], ah[1], al[1]);
  split(p[4], ah[2], al[2]);
  split(p[8 * LD + 4], ah[3], al[3]);
}

// The A fragment of a k-step of 8 taken from an n8 accumulator tile c
// (rows g, g + 8; columns 2t, 2t + 1), split: A's logical column t is the
// accumulator's column 2t, logical t + 4 is 2t + 1. The B operand of the
// same k-step reads rows 2t and 2t + 1.
__device__ __forceinline__ void a_from_c(uint32_t* ah, uint32_t* al,
                                         const float* c) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// acc (16 x 8 NO) += C (16 x 8 NS, accumulator layout) B, B's rows read
// from `b` = tile + 2t rows + g columns (rows 2t and 2t + 1 of each
// k-step). Each output column tile's 3 NS mma run in fresh accumulators
// that are then added to acc in f32 (round to nearest): the tensor cores
// add into an accumulator with truncation, so a sum chained through every
// tile of a long loop (4 heads x 2048 queries for dk at the qwen3-4b
// shape: 3,072 mma) drifts; this keeps f32 rounding.
template <int NS, int NO, int LD>
__device__ __forceinline__ void tile_product(float (*acc)[4],
                                             const float (*c)[4],
                                             const float* b) {
  uint32_t ah[NS][4], al[NS][4];
#pragma unroll
  for (int kt = 0; kt < NS; ++kt) a_from_c(ah[kt], al[kt], c[kt]);
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < NS; ++kt) {
      const int o = kt * 8 * LD + nt * 8;
      mma3(part, ah[kt], al[kt], b[o], b[o + LD]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
  }
}

// ROWS rows of DHP floats from global row r0 on (rows >= n_rows and
// columns >= dh zero-filled) into shared rows of DHP + PAD floats.
template <int DHP, int ROWS, int NT, bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0,
                                          int n_rows, int dh, int tid) {
  constexpr int LD = DHP + PAD;
  if constexpr (VEC) {
    constexpr int CPR = DHP / 4;          // 16-byte chunks per row
    for (int c = tid; c < ROWS * CPR; c += NT) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * 4;
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
      dst[r * LD + d] = (gr < n_rows && d < dh) ? src[gr * stride + d] : 0.f;
    }
  }
}

// Two floats of an output row (contiguous, dh columns) from column d on.
__device__ __forceinline__ void store_pair(float* row, int d, int dh,
                                           float x, float y) {
  if ((dh & 1) == 0) {                  // d even, so d < dh => d + 1 < dh
    if (d < dh) *reinterpret_cast<float2*>(row + d) = make_float2(x, y);
  } else {
    if (d < dh) row[d] = x;
    if (d + 1 < dh) row[d + 1] = y;
  }
}

// delta[b, h, i] = sum_d do[b, h, i, d] o[b, h, i, d]: one warp per row.
__global__ void __launch_bounds__(DELTA_NT)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
             float* __restrict__ delta, int H, int Sq, int dh, Strides os,
             Strides gs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.y * (DELTA_NT / 32) + warp;
  if (i >= Sq) return;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const float* orow = o + b * os.b + h * os.h + i * os.s;
  const float* grow = dO + b * gs.b + h * gs.h + i * gs.s;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc = fmaf(orow[d], grow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(long long)blockIdx.x * Sq + i] = acc;
}

// dk and dv of one tile of KV_BKV keys of one (batch item, kv head).
template <int DHP, bool VEC>
__global__ void __launch_bounds__(KV_NT, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
            int Sq, int Skv, int dh, Strides qs, Strides ks, Strides vs,
            Strides gs, int causal, int window, float scale_log2,
            float scale) {
  constexpr int LD = DHP + PAD;
  constexpr int NS = KV_BQ / 8;         // n8 score tiles per warp
  constexpr int NO = DHP / 8;           // n8 output tiles per warp
  constexpr int TILE = KV_BQ * LD;      // one staged Q or dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sK = reinterpret_cast<float*>(smem_raw);   // KV_BKV rows
  float* const sV = sK + KV_BKV * LD;                     // KV_BKV rows
  float* const sQ = sV + KV_BKV * LD;                     // 2 stages
  float* const sdO = sQ + 2 * TILE;                       // 2 stages
  float* const sL = sdO + 2 * TILE;                       // 2 x KV_BQ
  float* const sD = sL + 2 * KV_BQ;                       // 2 x KV_BQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int k_lo = blockIdx.y * KV_BKV;   // first to last: heaviest first
  const int k_hi = min(k_lo + KV_BKV, Skv) - 1;
  const int kw_lo = k_lo + 16 * warp;     // this warp's 16 keys
  const int kw_hi = min(kw_lo + 15, Skv - 1);

  const int n_q = (Sq + KV_BQ - 1) / KV_BQ;
  const int i_begin = causal ? k_lo / KV_BQ : 0;
  const int i_end =
      window > 0 ? min(n_q, (k_hi + window - 1) / KV_BQ + 1) : n_q;
  const int per_head = max(i_end - i_begin, 0);
  const int n_tiles = G * per_head;

  // Query tile n: head kvh G + n / per_head, rows from q_lo on.
  auto load_tile = [&](int n) {
    const int st = n & 1;
    const int h = kvh * G + n / per_head;
    const int q_lo = (i_begin + n % per_head) * KV_BQ;
    load_rows<DHP, KV_BQ, KV_NT, VEC>(sQ + st * TILE, q + b * qs.b + h * qs.h,
                                      qs.s, q_lo, Sq, dh, tid);
    load_rows<DHP, KV_BQ, KV_NT, VEC>(sdO + st * TILE,
                                      dO + b * gs.b + h * gs.h, gs.s, q_lo,
                                      Sq, dh, tid);
    const long long row0 = ((long long)b * H + h) * Sq + q_lo;
    if (tid < 2 * KV_BQ) {
      const int r = tid & (KV_BQ - 1);
      const bool ok = q_lo + r < Sq;
      const float* src = (tid < KV_BQ ? lse : delta) + (ok ? row0 + r : 0);
      float* dst = (tid < KV_BQ ? sL : sD) + st * KV_BQ + r;
      if (VEC) {
        cp_async4(dst, src, ok ? 4 : 0);
      } else {
        *dst = ok ? *src : 0.f;
      }
    }
  };

  load_rows<DHP, KV_BKV, KV_NT, VEC>(sK, k + b * ks.b + kvh * ks.h, ks.s,
                                     k_lo, Skv, dh, tid);
  load_rows<DHP, KV_BKV, KV_NT, VEC>(sV, v + b * vs.b + kvh * vs.h, vs.s,
                                     k_lo, Skv, dh, tid);
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const float* wK = sK + 16 * warp * LD;
  const float* wV = sV + 16 * warp * LD;

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<0>();                  // tile n (and K, V) have landed,
    __syncthreads();                     // and every warp is done with n-1
    if (n + 1 < n_tiles) load_tile(n + 1);   // into the stage n-1 used
    cp_async_commit();

    const int st = n & 1;
    const int q_lo = (i_begin + n % per_head) * KV_BQ;
    const int q_hi = min(q_lo + KV_BQ, Sq) - 1;
    const bool dead = kw_lo >= Skv || (causal && kw_lo > q_hi) ||
                      (window > 0 && q_lo - kw_hi >= window);
    if (dead) continue;                  // warp-uniform
    const bool edge = (causal && kw_hi > q_lo) ||
                      (window > 0 && q_hi - kw_lo >= window) ||
                      kw_lo + 16 > Skv || q_lo + KV_BQ > Sq;
    const float* tQ = sQ + st * TILE;
    const float* tdO = sdO + st * TILE;
    const float* tL = sL + st * KV_BQ;
    const float* tD = sD + st * KV_BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int m = 0; m < NS; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][e] = dp[m][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DHP / 8; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      a_rows<LD>(kh, kl, wK + kk * 8, g, t);
      a_rows<LD>(vh, vl, wV + kk * 8, g, t);
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const float* qr = tQ + (m * 8 + g) * LD + kk * 8 + t;
        const float* gr = tdO + (m * 8 + g) * LD + kk * 8 + t;
        mma3(s[m], kh, kl, qr[0], qr[4]);
        mma3(dp[m], vh, vl, gr[0], gr[4]);
      }
    }

    // P^T and dS^T = P^T (dP^T - delta), in place; key g (+ 8), query
    // m 8 + 2t (+ 1).
#pragma unroll
    for (int m = 0; m < NS; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = m * 8 + 2 * t + (e & 1);
        bool live = true;
        if (edge) {
          const int qi = q_lo + col;
          const int kj = kw_lo + g + (e >> 1) * 8;
          live = qi < Sq && kj < Skv && (!causal || kj <= qi) &&
                 (window <= 0 || kj > qi - window);
        }
        const float p = live ? exp2f(s[m][e] * scale_log2 - tL[col]) : 0.f;
        s[m][e] = p;
        dp[m][e] = p * (dp[m][e] - tD[col]);
      }
    }

    // dv += P^T dO, dk += dS^T Q over this tile's 32 query rows
    tile_product<NS, NO, LD>(adv, s, tdO + 2 * t * LD + g);
    tile_product<NS, NO, LD>(adk, dp, tQ + 2 * t * LD + g);
  }

  float* dkp = dk + ((long long)b * KV + kvh) * Skv * dh;
  float* dvp = dv + ((long long)b * KV + kvh) * Skv * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw_lo + g + 8 * r;
    if (kj >= Skv) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int d = nt * 8 + 2 * t;
      store_pair(dkp + (long long)kj * dh, d, dh, adk[nt][2 * r] * scale,
                 adk[nt][2 * r + 1] * scale);
      store_pair(dvp + (long long)kj * dh, d, dh, adv[nt][2 * r],
                 adv[nt][2 * r + 1]);
    }
  }
}

// dq of one query tile of Q_BQ rows of one (batch item, head).
template <int DHP, bool VEC>
__global__ void __launch_bounds__(Q_NT, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int H, int KV, int Sq, int Skv, int dh,
          Strides qs, Strides ks, Strides vs, Strides gs, int causal,
          int window, float scale_log2, float scale) {
  constexpr int LD = DHP + PAD;
  constexpr int NS = Q_BKV / 8;          // n8 score tiles per warp
  constexpr int NO = DHP / 8;            // n8 output tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sQ = reinterpret_cast<float*>(smem_raw);   // Q_BQ rows
  float* const sdO = sQ + Q_BQ * LD;                      // Q_BQ rows
  float* const sK = sdO + Q_BQ * LD;                      // Q_BKV rows
  float* const sV = sK + Q_BKV * LD;                      // Q_BKV rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / KV;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * Q_BQ;   // heaviest first
  const int q_hi = min(q_lo + Q_BQ, Sq) - 1;
  const int qw_lo = q_lo + 16 * warp;    // this warp's 16 rows
  const int qw_hi = min(qw_lo + 15, Sq - 1);
  const long long row0 = ((long long)b * H + h) * Sq;
  const float* kp = k + b * ks.b + (h / G) * ks.h;
  const float* vp = v + b * vs.b + (h / G) * vs.h;

  const int n_kv = (Skv + Q_BKV - 1) / Q_BKV;
  const int j_end = causal ? min(n_kv, q_hi / Q_BKV + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) / Q_BKV : 0;

  // Copy groups, in order: {Q, dO, V(j_begin)}, {K(j_begin)}, then per
  // tile {V(j+1)} after dO V(j)^T is read and {K(j+1)} after dS K(j).
  load_rows<DHP, Q_BQ, Q_NT, VEC>(sQ, q + b * qs.b + h * qs.h, qs.s, q_lo,
                                  Sq, dh, tid);
  load_rows<DHP, Q_BQ, Q_NT, VEC>(sdO, dO + b * gs.b + h * gs.h, gs.s, q_lo,
                                  Sq, dh, tid);
  if (j_begin < j_end)
    load_rows<DHP, Q_BKV, Q_NT, VEC>(sV, vp, vs.s, j_begin * Q_BKV, Skv, dh,
                                     tid);
  cp_async_commit();
  if (j_begin < j_end)
    load_rows<DHP, Q_BKV, Q_NT, VEC>(sK, kp, ks.s, j_begin * Q_BKV, Skv, dh,
                                     tid);
  cp_async_commit();

  float lrow[2], drow[2];                // rows g and g + 8 of this warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw_lo + g + 8 * r;
    lrow[r] = qi < Sq ? lse[row0 + qi] : 0.f;
    drow[r] = qi < Sq ? delta[row0 + qi] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* wQ = sQ + 16 * warp * LD;
  const float* wdO = sdO + 16 * warp * LD;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const bool more = jt + 1 < j_end;
    const int k_lo = jt * Q_BKV;
    const int k_hi = min(k_lo + Q_BKV, Skv) - 1;
    const bool dead = qw_lo >= Sq || (causal && k_lo > qw_hi) ||
                      (window > 0 && qw_lo - k_hi >= window);
    const bool edge = (causal && k_hi > qw_lo) ||
                      (window > 0 && qw_hi - k_lo >= window) ||
                      k_lo + Q_BKV > Skv;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int m = 0; m < NS; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][e] = dp[m][e] = 0.f;

    cp_async_wait<1>();                  // V(jt) (and Q, dO) have landed
    __syncthreads();
    if (!dead) {                         // dP = dO V^T
#pragma unroll
      for (int kk = 0; kk < DHP / 8; ++kk) {
        uint32_t ah[4], al[4];
        a_rows<LD>(ah, al, wdO + kk * 8, g, t);
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const float* vr = sV + (m * 8 + g) * LD + kk * 8 + t;
          mma3(dp[m], ah, al, vr[0], vr[4]);
        }
      }
    }
    __syncthreads();                     // every warp has read V(jt)
    if (more)
      load_rows<DHP, Q_BKV, Q_NT, VEC>(sV, vp, vs.s, (jt + 1) * Q_BKV, Skv,
                                       dh, tid);
    cp_async_commit();

    cp_async_wait<1>();                  // K(jt) has landed
    __syncthreads();
    if (!dead) {
#pragma unroll
      for (int kk = 0; kk < DHP / 8; ++kk) {   // S = Q K^T
        uint32_t ah[4], al[4];
        a_rows<LD>(ah, al, wQ + kk * 8, g, t);
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const float* kr = sK + (m * 8 + g) * LD + kk * 8 + t;
          mma3(s[m], ah, al, kr[0], kr[4]);
        }
      }
      // dS = P (dP - delta) in place of dP; row g (+ 8), key m 8 + 2t (+ 1)
#pragma unroll
      for (int m = 0; m < NS; ++m) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool live = true;
          if (edge) {
            const int qi = qw_lo + g + (e >> 1) * 8;
            const int kj = k_lo + m * 8 + 2 * t + (e & 1);
            live = kj < Skv && (!causal || kj <= qi) &&
                   (window <= 0 || kj > qi - window);
          }
          const float p =
              live ? exp2f(s[m][e] * scale_log2 - lrow[e >> 1]) : 0.f;
          dp[m][e] = p * (dp[m][e] - drow[e >> 1]);
        }
      }
      // dq += dS K over this tile's keys
      tile_product<NS, NO, LD>(acc, dp, sK + 2 * t * LD + g);
    }
    __syncthreads();                     // every warp has read K(jt)
    if (more)
      load_rows<DHP, Q_BKV, Q_NT, VEC>(sK, kp, ks.s, (jt + 1) * Q_BKV, Skv,
                                       dh, tid);
    cp_async_commit();
  }

  float* dqp = dq + row0 * dh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw_lo + g + 8 * r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      store_pair(dqp + (long long)qi * dh, nt * 8 + 2 * t, dh,
                 acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
  }
}

template <int DHP>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((2 * KV_BKV + 4 * KV_BQ) * (size_t)(DHP + PAD) +
                          4 * KV_BQ);
}

template <int DHP>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * Q_BQ + 2 * Q_BKV) * (size_t)(DHP + PAD);
}

template <int DHP, bool VEC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dO, const float* lse,
                   float* dq, float* dk, float* dv, float* delta, int B,
                   int H, int KV, int Sq, int Skv, int dh, const Strides* st,
                   int causal, int window, float scale_log2, float scale,
                   cudaStream_t stream) {
  constexpr size_t kv_smem = dkdv_smem<DHP>();
  constexpr size_t q_smem = dq_smem<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DHP, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DHP, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return err;
  // st: q, k, v, o, do
  delta_kernel<<<dim3(B * H, (Sq + DELTA_NT / 32 - 1) / (DELTA_NT / 32)),
                 DELTA_NT, 0, stream>>>(o, dO, delta, H, Sq, dh, st[3],
                                        st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DHP, VEC><<<dim3(B * KV, (Skv + KV_BKV - 1) / KV_BKV), KV_NT,
                          kv_smem, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, H, KV, Sq, Skv, dh, st[0], st[1],
      st[2], st[4], causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DHP, VEC><<<dim3(B * H, (Sq + Q_BQ - 1) / Q_BQ), Q_NT, q_smem,
                        stream>>>(q, k, v, dO, lse, delta, dq, H, KV, Sq,
                                  Skv, dh, st[0], st[1], st[2], st[4],
                                  causal, window, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels (delta, dk/dv, dq) on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise and
// allocates nothing. `strides` holds 15 element strides: (batch, head,
// sequence) of q, k, v, o and do. dq, dk, dv are written contiguous;
// `delta` is (B, H, Sq) f32 scratch. `scale_log2` is dh^-0.5 log2(e) (the
// forward's), `scale` dh^-0.5. Tiles load with 16-byte cp.async when every
// row of q, k, v and do starts 16-byte aligned, else element by element.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, const void* lse,
                            void* dq, void* dk, void* dv, void* delta, int B,
                            int H, int KV, int Sq, int Skv, int dh,
                            const long long* strides, int causal, int window,
                            float scale_log2, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      dh < 1 || dh > 128 || window < 0 || (long long)B * H > 2147483647LL ||
      (Sq + Q_BQ - 1) / Q_BQ > 65535 || (Skv + KV_BKV - 1) / KV_BKV > 65535 ||
      (Sq + DELTA_NT / 32 - 1) / (DELTA_NT / 32) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  bool vec = dh % 4 == 0;
  for (int t = 0; t < 15; ++t) {
    if (t / 3 != 3) vec = vec && strides[t] % 4 == 0;   // o: delta only
  }
  const void* ptrs[4] = {q, k, v, dO};
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* oo = static_cast<const float*>(o);
  const float* gg = static_cast<const float*>(dO);
  const float* ll = static_cast<const float*>(lse);
  float* dqq = static_cast<float*>(dq);
  float* dkk = static_cast<float*>(dk);
  float* dvv = static_cast<float*>(dv);
  float* dd = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(DHP, VEC)                                            \
  launch<DHP, VEC>(qq, kk, vv, oo, gg, ll, dqq, dkk, dvv, dd, B, H, KV, Sq,   \
                   Skv, dh, st, causal, window, scale_log2, scale, s)
  if (dh <= 64)
    return (int)(vec ? FLASH_BWD_LAUNCH(64, true)
                     : FLASH_BWD_LAUNCH(64, false));
  return (int)(vec ? FLASH_BWD_LAUNCH(128, true)
                   : FLASH_BWD_LAUNCH(128, false));
#undef FLASH_BWD_LAUNCH
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
