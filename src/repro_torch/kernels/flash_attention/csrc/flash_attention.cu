// Blocked online-softmax attention (FlashAttention, forward) for Hopper
// (sm_90a), with both products on the tensor cores: f32 inputs in split
// TF32 (mma.sync), bf16 inputs in bf16 (wgmma on TMA tiles,
// `flash_attention_bf16`, in the second half of this header).
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
// scaled by the true dh^-0.5 (the wrapper passes it: a bf16 dh padded to a
// multiple of 8 keeps it); masked scores are -1e30 and get p = 0, the
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
// 3.35 TB/s; 0.05 ms in bf16): bound by operations in both. So the bf16
// products must run on wgmma, the only way to the tensor cores' full rate,
// fed by TMA without the compute threads' help; and the exp2 of every
// score (64 per thread per tile) must overlap the products rather than
// follow them. mma.sync (the f32 entry) reaches only part of the peak; the
// split also costs CUDA-core instructions (3 per operand element per use).
//
// f32 design (mma.sync):
//   * one block of 4 warps per (batch item x head, query tile of 64 rows);
//     each warp owns 16 query rows, and keeps the score tile, m, l and the
//     O accumulator (16 x dh f32) in registers. Q stays in shared memory
//     and its fragments are read again for every kv tile: registers, not
//     shared memory, limit the blocks per SM (3), and Q's fragments at
//     dh = 128 would take 64 more registers a thread. Nothing is carried
//     between blocks: the TPU kernel's sequential kv grid axis is a loop
//     inside the block.
//   * grid (B H, query tiles), the query tile reversed (the last, heaviest
//     causal tile of every head is dispatched first), so the light tiles
//     fill in at the end.
//   * K/V tiles of 32 keys come through shared memory with 16-byte
//     cp.async, one buffer each, staggered: K(j+1) loads while the softmax
//     and P.V(j) run, V(j+1) while Q.K^T(j+1) runs (a tile pair in flight
//     at half the shared memory of double buffering). Rows are padded by 4
//     floats, which makes the fragment reads free of bank conflicts.
//     Operands are split on the fly; in Q.K^T the small products go to
//     their own accumulators, doubling the independent mma chains.
//   * mma.m16n8k8 tf32. The C layout (thread t holds keys 2t, 2t+1 of an
//     n8 tile) and the A layout (keys t, t+4) differ, so P stays in
//     registers and V's rows are permuted within each k-step instead: A's
//     logical key t is physical key 2t, logical t+4 is 2t+1, and the B
//     fragment reads V rows 2t and 2t+1.
//   * ragged Sq, Skv and dh are zero-filled in shared memory (cp.async's
//     src-size 0); tensors whose rows are not 16-byte aligned take the same
//     kernel with per-element loads and stores (the `vec` flag, chosen by
//     the wrapper), never a copy. Shared memory (64 query + 2 x 32 kv rows)
//     x 132 floats: 67,584 B at dh = 128.
//
// bf16 design (`fwd_wgmma_kernel`: warpgroup products on TMA tiles):
//   * a block of three warpgroups per (batch item x head, query tile of 128
//     rows): two consumers, each owning 64 query rows, and a producer whose
//     first thread issues every copy: Q once, then the K and V tiles of
//     FW_KT keys into a ring of FW_STAGES stages (full[s] completes when a
//     stage's bytes land, empty[s] when the eight consumer warps are done
//     with it). TMA boxes of 64 rows x 64 columns with the 128-byte swizzle
//     that the wgmma descriptors name (dh = 128 is two column halves); rows
//     past Sq and Skv and columns past dh land as zeros (TMA's fill).
//     `setmaxnreg` gives the producer 24 registers, each consumer thread
//     240. The grid is one-dimensional: heads in groups of 16, all query
//     tiles of a group together, the heaviest causal tile first. The
//     running blocks then read the K/V of a few heads, which stay in L2
//     (MHA at S = 2048 holds 168 MB of K/V, more than L2), and the light
//     tiles of a group fill in behind the next group's heavy ones.
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory; P stays in registers as the A operand of O += P V (m64nDHPk16,
//     V read MN-major through the transposed swizzle). O, m and l stay in
//     f32 registers for the whole kv loop; O is rescaled there.
//   * each consumer overlaps its softmax with its own products: per tile
//     it issues S(j) = Q K(j)^T and O += P(j-1) V(j-1) together, waits for
//     S(j), computes m, P(j) and l while P V runs, then waits for it,
//     rescales O and frees the stage of j - 1. No product is left in flight
//     across the loop's back edge (ptxas would serialize the wgmma). The
//     softmax's results are pinned (an empty volatile asm) before the P V
//     wait: without that the compiler sinks this register-only work past
//     the wait, toward its uses, and no product runs under it.
//   * at dh = 128 the two consumers also take turns issuing their products
//     (named barriers 1 and 2), so one's softmax runs under the other's
//     products; every consumer takes the same number of turns (one per
//     tile of the block, one for its last P V). At dh <= 64 the turns cost
//     more than they hide (each turn's products are half as long), so that
//     instance runs without them.
//   * masks apply per element only on tiles where they can bite (the
//     causal diagonal, the window's edge, the ragged end of Skv); tiles
//     that no row of a warpgroup sees are skipped by that warpgroup (it
//     only frees their stage), so a windowed layer does O(S W) work.
//   * exp2 with the scale folded in: m is the scaled row max (the max of
//     the raw scores times scale_log2, exact since the scaling is
//     monotone) and p = exp2(fma(s, scale_log2, -m)); a masked score is
//     -inf for the max and p = 0.
//   * dh <= 64 runs the 64-wide instance, 64 < dh <= 128 the 128-wide one;
//     q, k and v must be legal for TMA (dh a multiple of 8, rows on 16
//     bytes): the wrapper pads or copies others, this entry refuses them.
//   * three stages: a consumer holds two (S of tile j, P V of tile j - 1)
//     while the producer fills the third. On an H100, two stages and key
//     tiles of 64 were each 22-28% slower at the qwen3-4b shape. Shared memory at dh = 128: Q 32
//     KB + 3 stages x (K, V) 64 KB = 224 KB (one block of 384 threads per
//     SM); at dh = 64, 112 KB.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---- f32: split TF32 on mma.sync ----

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;     // threads per block
constexpr int BQ = 16 * WARPS;     // query rows per block
constexpr int BKV = 32;            // keys per kv tile
constexpr int PAD = 4;             // floats of padding per shared row
constexpr int MIN_BLOCKS = 3;      // blocks per SM to aim for

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// x = hi + lo: hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: what cvt.rna.tf32.f32 gives, for finite x); lo = x - hi
// is exact in f32 and goes to the tensor core as it is, which reads its
// TF32 part (the top 19 bits: lo truncated, at most 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// ROWS rows of DHP floats from global row r0 on (rows >= n_rows and
// columns >= dh zero-filled) into shared rows of LD floats.
template <int DHP, int ROWS, bool VEC>
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

// s[NS][4] = Q K^T for this warp's 16 rows (sQ) and the tile's BKV keys.
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

template <int DHP, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int H, int G, int Sq, int Skv, int dh, Strides qs,
                       Strides ks, Strides vs, Strides os, int causal,
                       int window, float scale_log2,
                       float* __restrict__ lse) {
  constexpr int LD = DHP + PAD;
  constexpr int NS = BKV / 8;          // n8 score tiles per warp
  constexpr int NO = DHP / 8;          // n8 output tiles per warp
  static_assert(NS * 4 <= 32, "one mask bit per score register");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // BQ rows
  float* sK = sQ + BQ * LD;                         // BKV rows
  float* sV = sK + BKV * LD;                        // BKV rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + (h / G) * ks.h;
  const float* vp = v + b * vs.b + (h / G) * vs.h;
  float* op = o + b * os.b + h * os.h;

  const int n_kv = (Skv + BKV - 1) / BKV;
  const int j_end = causal ? min(n_kv, q_hi / BKV + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) / BKV : 0;

  // Copy groups, in order: {Q, K(j_begin)}, {V(j_begin)}, then per tile
  // {K(j+1)} after Q K(j)^T is read and {V(j+1)} after P V(j): each load
  // runs under the other half of the tile's work. A group may be empty.
  load_rows<DHP, BQ, VEC>(sQ, qp, qs.s, q_lo, Sq, dh, tid);
  if (j_begin < j_end)
    load_rows<DHP, BKV, VEC>(sK, kp, ks.s, j_begin * BKV, Skv, dh, tid);
  cp_async_commit();
  if (j_begin < j_end)
    load_rows<DHP, BKV, VEC>(sV, vp, vs.s, j_begin * BKV, Skv, dh, tid);
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
      load_rows<DHP, BKV, VEC>(sK, kp, ks.s, (jt + 1) * BKV, Skv, dh, tid);
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
      load_rows<DHP, BKV, VEC>(sV, vp, vs.s, (jt + 1) * BKV, Skv, dh, tid);
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
    float* row = op + qi * os.s;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * t;
      const float x = acc[n][2 * r] / l[r];
      const float y = acc[n][2 * r + 1] / l[r];
      if (VEC) {                       // dh is even: d < dh => d + 1 < dh
        if (d < dh) store2(row + d, x, y);
      } else {
        if (d < dh) row[d] = x;
        if (d + 1 < dh) row[d + 1] = y;
      }
    }
  }
}

template <int DHP, bool VEC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int KV, int Sq, int Skv, int dh,
                   const Strides* st, int causal, int window,
                   float scale_log2, float* lse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ + 2 * BKV) * (size_t)(DHP + PAD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DHP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<DHP, VEC><<<grid, NT, smem, stream>>>(
      q, k, v, o, H, H / KV, Sq, Skv, dh, st[0], st[1], st[2], st[3], causal,
      window, scale_log2, lse);
  return cudaGetLastError();
}

// ---- bf16: wgmma on tiles brought by TMA, a producer warp per block ----

constexpr int FW_NT = 384;           // consumer warpgroups 0, 1; producer 2
constexpr int FW_QROWS = 128;        // query rows per block (64 each)
constexpr int FW_KT = 128;           // keys per staged K/V tile
constexpr int FW_STAGES = 3;         // depth of the K/V ring
constexpr int FW_HEAD_GROUP = 16;    // heads whose query tiles run together
// Whether the consumers take turns issuing their products: at dh = 128
// (the wide instance); at dh <= 64 each turn's products are too short to
// hide the other warpgroup's softmax, and the waits cost more than the
// overlap gains.
template <int DHP>
constexpr bool PINGPONG = DHP == 128;

// Shared memory of the forward kernel (byte offsets from a 1024-byte
// aligned base): Q (128 rows), the ring of (K, V) tile pairs, the
// barriers.
template <int DHP>
struct FwdSmem {
  static constexpr int TQ = FW_QROWS * DHP * 2;
  static constexpr int TK = FW_KT * DHP * 2;
  static constexpr int Q = 0, KV = TQ;
  static constexpr int BAR = KV + FW_STAGES * 2 * TK;
  static constexpr int BYTES = BAR + 8 * (2 * FW_STAGES + 1) + 1024;
};

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp; results below 2^-126 flush
// to 0, which no sum of P can see next to the row's largest term, 1).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax for rows row0 and row0 + 8 of a consumer
// (the accumulator layout: sc[n][e] is row row0 + 8 (e >> 1), key k_lo +
// 8 n + 2t + (e & 1)). On return sc holds P (f32), m the scaled row max
// (this quad's, shared by its four threads), l this thread's part of the
// row sums rescaled to the new m, and alpha the factor O must take. EDGE:
// the tile is one where a mask can bite (per-element masks; an instance of
// its own, so the other tiles carry no mask arithmetic).
template <int NS, bool EDGE>
__device__ __forceinline__ void softmax_tile(float (*sc)[4], float* m,
                                             float* l, float* alpha,
                                             int row0, int k_lo, int t,
                                             int Skv, int causal, int window,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (EDGE) {
        const int qi = row0 + (e >> 1) * 8;
        const int kj = k_lo + n * 8 + 2 * t + (e & 1);
        const bool live = kj < Skv && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
        if (!live) sc[n][e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    }
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = fast_exp2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
    neg[r] = -mn;
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(sc[n][e], scale_log2, neg[e >> 1]));
      sc[n][e] = p;
      l[e >> 1] += p;
    }
  }
}

// softmax_tile on a tile that may be an edge one, its results then pinned
// (an empty volatile asm that reads and writes them): the compiler would
// otherwise sink this register-only work past the next wgmma wait, toward
// its uses, and no product would run under it.
template <int NS>
__device__ __forceinline__ void softmax_pinned(float (*sc)[4], float* m,
                                               float* l, float* alpha,
                                               bool edge, int row0, int k_lo,
                                               int t, int Skv, int causal,
                                               int window, float scale_log2) {
  if (edge)
    softmax_tile<NS, true>(sc, m, l, alpha, row0, k_lo, t, Skv, causal,
                           window, scale_log2);
  else
    softmax_tile<NS, false>(sc, m, l, alpha, row0, k_lo, t, Skv, causal,
                            window, scale_log2);
  pin<NS>(sc);
  asm volatile("" : "+f"(m[0]), "+f"(m[1]), "+f"(l[0]), "+f"(l[1]),
               "+f"(alpha[0]), "+f"(alpha[1])::"memory");
}

template <int NO>
__device__ __forceinline__ void rescale(float (*acc)[4], const float* alpha) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// The next stage of the K/V ring and its phase.
__device__ __forceinline__ void advance(int& s, uint32_t& ph) {
  if (++s == FW_STAGES) {
    s = 0;
    ph ^= 1;
  }
}

// The consumers' turns at issuing their products (when PINGPONG<DHP>):
// warpgroup wg waits on named barrier 1 + wg until the other one has
// issued its own (bar.arrive on it), so one's softmax runs under the
// other's products.
template <int DHP>
__device__ __forceinline__ void turn_begin(int wg) {
  if constexpr (PINGPONG<DHP>)
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
template <int DHP>
__device__ __forceinline__ void turn_end(int wg) {
  if constexpr (PINGPONG<DHP>)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// A consumer warp is done with a stage (8 arrivals free it).
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Issues S = Q K^T (the warpgroup's 64 rows x FW_KT keys of the K tile at
// sK) as one wgmma group.
template <int DHP>
__device__ __forceinline__ void issue_scores(float (*sc)[4], uint32_t sQ,
                                             int wg, uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk)
    wgmma_ss<FW_KT>(sc, kmajor<FW_QROWS>(sQ, 64 * wg, kk),
                    kmajor<FW_KT>(sK, 0, kk), kk > 0);
  wg_commit();
}

// Issues O += P V over the FW_KT keys of the V tile at sV (P in
// registers) as one wgmma group.
template <int DHP>
__device__ __forceinline__ void issue_pv(float (*acc)[4],
                                         const uint32_t (*pa)[4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < FW_KT / 16; ++kk)
    wgmma_rs_tb<DHP>(acc, pa[kk], mnmajor<FW_KT>(sV, kk), 1);
  wg_commit();
}

// Whether a mask can bite inside the tile of keys from k_lo for the rows
// qw_lo .. qw_hi.
__device__ __forceinline__ bool edge_tile(int k_lo, int qw_lo, int qw_hi,
                                          int Skv, int causal, int window) {
  return (causal && k_lo + FW_KT - 1 > qw_lo) ||
         (window > 0 && qw_hi - k_lo >= window) || k_lo + FW_KT > Skv;
}

// o (bf16, through its strides) and, when lse is not null, each row's
// m + log2(l), for one 128-row query tile of one (batch item, head).
template <int DHP>
__global__ void __launch_bounds__(FW_NT, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 __nv_bfloat16* __restrict__ o, Strides os, int H, int KV,
                 int Sq, int Skv, int dh, int causal, int window,
                 float scale_log2, float* __restrict__ lse) {
  using L = FwdSmem<DHP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* const empty = full + FW_STAGES;
  uint64_t* const q_full = empty + FW_STAGES;

  // Block order (a 1-d grid): heads in groups of FW_HEAD_GROUP, all
  // query tiles of a group's heads together, the heaviest first, so the
  // running blocks read the K/V of a few heads (which stay in L2) and the
  // light causal tiles fill in behind the next group's heavy ones.
  const int tid = threadIdx.x;
  const int nq = (Sq + FW_QROWS - 1) / FW_QROWS;
  const int group = blockIdx.x / (FW_HEAD_GROUP * nq);
  const int in_group = blockIdx.x - group * FW_HEAD_GROUP * nq;
  const int heads = min(FW_HEAD_GROUP, gridDim.x / nq - group * FW_HEAD_GROUP);
  const int bh = group * FW_HEAD_GROUP + in_group % heads;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q_lo = (nq - 1 - in_group / heads) * FW_QROWS;
  const int q_hi = min(q_lo + FW_QROWS, Sq) - 1;
  const int n_kv = (Skv + FW_KT - 1) / FW_KT;
  const int j_end = causal ? min(n_kv, q_hi / FW_KT + 1) : n_kv;
  const int j_begin =
      window > 0 ? min(max(0, q_lo - window + 1) / FW_KT, j_end) : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {                         // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == 256) {
      mbar_expect_tx(q_full, L::TQ);
      tma_tile<DHP, FW_QROWS>(sm + L::Q, &mq, q_lo, h, b, q_full);
      int s = 0;
      uint32_t ph = 0;
      for (int j = j_begin; j < j_end; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = sm + L::KV + s * 2 * L::TK;
        mbar_expect_tx(&full[s], 2 * L::TK);
        tma_tile<DHP, FW_KT>(st, &mk, j * FW_KT, kvh, b, &full[s]);
        tma_tile<DHP, FW_KT>(st + L::TK, &mv, j * FW_KT, kvh, b, &full[s]);
        if (++s == FW_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {                               // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    constexpr int NO = DHP / 8;          // n8 output tiles
    constexpr int NS = FW_KT / 8;        // n8 score tiles
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw_lo = q_lo + 64 * wg;    // this warpgroup's 64 rows
    const int qw_hi = min(qw_lo + 63, Sq - 1);
    const int row0 = qw_lo + 16 * warp + g;   // this thread's rows (+ 8)
    // the block's tiles [j_begin, j_end) that these rows see: [jw_begin,
    // jw_end); the others only have their stage freed
    const int jw_end =
        qw_lo >= Sq ? j_begin
                    : max(j_begin, causal ? min(j_end, qw_hi / FW_KT + 1)
                                          : j_end);
    const int jw_begin =
        window > 0 ? min(max(j_begin, max(0, qw_lo - window + 1) / FW_KT),
                         jw_end)
                   : j_begin;
    const uint32_t sQ = smem_addr(sm + L::Q);
    const uint32_t sKV = smem_addr(sm + L::KV);
    float acc[NO][4], sc[NS][4], alpha[2];
    uint32_t pa[NS / 2][4];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    zero<NO>(acc);
    int s = 0;
    uint32_t ph = 0;

    // Every warpgroup takes j_end - j_begin + 1 turns: one per tile of the
    // block (a tile it does not see only frees its stage) and one for its
    // last P V (or none), so the turns pair up.
    if (wg == 1) turn_end<DHP>(1);       // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    for (int j = j_begin; j < jw_begin; ++j) {
      mbar_wait(&full[s], ph);
      turn_begin<DHP>(wg);
      turn_end<DHP>(wg);
      release(&empty[s], lane);
      advance(s, ph);
    }
    if (jw_begin < jw_end) {
      mbar_wait(&full[s], ph);
      turn_begin<DHP>(wg);
      wg_fence();
      issue_scores<DHP>(sc, sQ, wg, sKV + s * 2 * L::TK);
      turn_end<DHP>(wg);
      wg_wait<0>();
      pin<NS>(sc);
      softmax_pinned<NS>(
          sc, m, l, alpha,
          edge_tile(jw_begin * FW_KT, qw_lo, qw_hi, Skv, causal, window),
          row0, jw_begin * FW_KT, t, Skv, causal, window, scale_log2);
      to_a<NS / 2>(pa, sc);
      int sp = s;                        // the stage P V still reads
      advance(s, ph);
      for (int j = jw_begin + 1; j < jw_end; ++j) {
        mbar_wait(&full[s], ph);
        turn_begin<DHP>(wg);
        wg_fence();
        issue_scores<DHP>(sc, sQ, wg, sKV + s * 2 * L::TK);
        issue_pv<DHP>(acc, pa, sKV + sp * 2 * L::TK + L::TK);
        turn_end<DHP>(wg);
        wg_wait<1>();                    // S(j) is in; P V(j - 1) runs on
        pin<NS>(sc);
        softmax_pinned<NS>(
            sc, m, l, alpha,
            edge_tile(j * FW_KT, qw_lo, qw_hi, Skv, causal, window), row0,
            j * FW_KT, t, Skv, causal, window, scale_log2);
        wg_wait<0>();
        pin<NO>(acc);
        rescale<NO>(acc, alpha);
        release(&empty[sp], lane);
        to_a<NS / 2>(pa, sc);
        sp = s;
        advance(s, ph);
      }
      turn_begin<DHP>(wg);
      wg_fence();
      issue_pv<DHP>(acc, pa, sKV + sp * 2 * L::TK + L::TK);
      turn_end<DHP>(wg);
      wg_wait<0>();
      pin<NO>(acc);
      release(&empty[sp], lane);
    } else {
      turn_begin<DHP>(wg);
      turn_end<DHP>(wg);
    }
    for (int j = jw_end; j < j_end; ++j) {
      mbar_wait(&full[s], ph);
      turn_begin<DHP>(wg);
      turn_end<DHP>(wg);
      release(&empty[s], lane);
      advance(s, ph);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    if (lse != nullptr && t == 0) {      // the backward's row statistics
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        if (qi < Sq) lse[(long long)bh * Sq + qi] = m[r] + log2f(l[r]);
      }
    }
    __nv_bfloat16* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= Sq) continue;
      __nv_bfloat16* row = op + qi * os.s;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = n * 8 + 2 * t;     // dh % 8 == 0: d < dh => d + 1 < dh
        if (d < dh)
          *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
              acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
  }
}

template <int DHP>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                        int H, int KV, int Sq, int Skv, int dh,
                        const Strides* st, int causal, int window,
                        float scale_log2, float* lse, cudaStream_t stream) {
  constexpr int smem = FwdSmem<DHP>::BYTES;
  // the shared-memory limit is set once per process and device
  static int attributes_set = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (attributes_set != device) {
    err = cudaFuncSetAttribute(fwd_wgmma_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    attributes_set = device;
  }
  CUtensorMap mq, mk, mv;
  if (!encode_rows(&mq, q, B, H, Sq, dh, st[0]) ||
      !encode_rows(&mk, k, B, KV, Skv, dh, st[1]) ||
      !encode_rows(&mv, v, B, KV, Skv, dh, st[2]))
    return cudaErrorInvalidValue;
  fwd_wgmma_kernel<DHP>
      <<<B * H * ((Sq + FW_QROWS - 1) / FW_QROWS), FW_NT, smem, stream>>>(
          mq, mk, mv, o, st[3], H, KV, Sq, Skv, dh, causal, window,
          scale_log2, lse);
  return cudaGetLastError();
}

bool valid(int B, int H, int KV, int Sq, int Skv, int dh, int window,
           int rows_per_block) {
  return B >= 1 && H >= 1 && (long long)B * H <= 2147483647LL && KV >= 1 &&
         H % KV == 0 && Sq >= 1 &&
         (Sq + rows_per_block - 1) / rows_per_block <= 65535 && Skv >= 1 &&
         dh >= 1 && dh <= 128 && window >= 0;
}

void read_strides(const long long* strides, Strides* st) {
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides`
// holds 12 element strides: (batch, head, sequence) of q, k, v and o.
// `scale_log2` is dh^-0.5 log2(e) of the true dh; `lse`, when not null,
// receives each row's m + log2(l) as (B, H, Sq) f32 (in log2 units of the
// scaled scores): the backward kernel's (flash_attention_bwd.cu) softmax
// statistics. Serving passes null.
//
// f32: `vec` (0/1) says that every row of q, k, v and o starts 16-byte
// aligned and dh fills whole 16-byte chunks, so tiles load with cp.async
// (checked: cudaErrorMisalignedAddress); otherwise per-element loads.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int dh,
                        const long long* strides, int causal, int window,
                        float scale_log2, int vec, void* lse, void* stream) {
  if (!valid(B, H, KV, Sq, Skv, dh, window, BQ))
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  read_strides(strides, st);
  if (vec) {                           // the wrapper's claim, checked
    bool ok = dh % 4 == 0;
    for (int t = 0; t < 12; ++t) ok = ok && strides[t] % 4 == 0;
    const void* ptrs[4] = {q, k, v, o};
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return (int)cudaErrorMisalignedAddress;
  }
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_LAUNCH(DHP, VEC)                                                \
  launch<DHP, VEC>(qq, kk, vv, oo, B, H, KV, Sq, Skv, dh, st, causal, window, \
                   scale_log2, ll, s)
  if (dh <= 64)
    return (int)(vec ? FLASH_LAUNCH(64, true) : FLASH_LAUNCH(64, false));
  return (int)(vec ? FLASH_LAUNCH(128, true) : FLASH_LAUNCH(128, false));
#undef FLASH_LAUNCH
}

// bf16: q, k and v are read by TMA and o is written in pairs, so dh must
// be a multiple of 8 and every row of q, k, v and o must start on 16
// bytes (each base pointer, and each stride over an axis of more than one
// entry a positive multiple of 8): cudaErrorInvalidValue and
// cudaErrorMisalignedAddress otherwise. The wrapper pads dh and copies
// other inputs first. `vec` is not read.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int Sq, int Skv, int dh,
                         const long long* strides, int causal, int window,
                         float scale_log2, int vec, void* lse, void* stream) {
  (void)vec;
  if (!valid(B, H, KV, Sq, Skv, dh, window, FW_QROWS) || dh % 8 != 0 ||
      (long long)B * H * ((Sq + FW_QROWS - 1) / FW_QROWS) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  read_strides(strides, st);
  if (!tma_rows(q, B, H, Sq, st[0]) || !tma_rows(k, B, KV, Skv, st[1]) ||
      !tma_rows(v, B, KV, Skv, st[2]) || !tma_rows(o, B, H, Sq, st[3]))
    return (int)cudaErrorMisalignedAddress;
  using bf = __nv_bfloat16;
  const bf* qq = static_cast<const bf*>(q);
  const bf* kk = static_cast<const bf*>(k);
  const bf* vv = static_cast<const bf*>(v);
  bf* oo = static_cast<bf*>(o);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dh <= 64 ? launch_bf16<64>(qq, kk, vv, oo, B, H, KV, Sq, Skv,
                                          dh, st, causal, window, scale_log2,
                                          ll, s)
                        : launch_bf16<128>(qq, kk, vv, oo, B, H, KV, Sq, Skv,
                                           dh, st, causal, window,
                                           scale_log2, ll, s));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
