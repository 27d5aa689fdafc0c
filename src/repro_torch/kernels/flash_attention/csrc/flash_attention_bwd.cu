// Backward pass of blocked online-softmax attention (FlashAttention) for
// Hopper (sm_90a), with every product on the tensor cores: f32 inputs in
// split TF32 (mma.sync m16n8k8), bf16 inputs in bf16 (wgmma on TMA tiles,
// `flash_attention_bwd_bf16`, at the end of this header).
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
// dk and dv (B, KV, Skv, dh), contiguous; f32 scratch for the centred keys,
// delta, the shifted lse and the key means.
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
//   * the dk/dv and dq kernels read the keys centred on their mean over the
//     kv head (`kmean`, then `centre` writes kc = k - kmean), and P is
//     rebuilt from the log-sum-exp shifted to match, lse - q_i . kmean
//     scale_log2 (the delta kernel computes it beside delta): softmax
//     ignores a shift of a score row, so dq, dk and dv are the same
//     analytically, and dq = sum_j dS_ij (k_j - kmean) because
//     sum_j dS_ij = 0. In f32 the row sum is not 0: delta comes from the
//     forward's o, P from this kernel's own scores, and their rounding
//     gap eps_i adds -eps_i sum_j P_ij k_j to dq, a multiple of whatever
//     component all keys share; the scores' rounding grows with it too.
//     Keys projected from one encoder output carry a large one (whisper's
//     cross-attention), and the centring removes it.
//   * the same gap reaches dk: sum_j dk_j = sum_i q_i sum_j dS_ij is 0
//     analytically for any mask (each row's dS sums to 0 over the keys it
//     sees), but sum_i q_i eps_i in f32, and a weight gradient
//     sum_j x_j dk_j^T carries the inputs' common component times it. So
//     dk is projected onto that identity last: `kmean` and `centre` again,
//     on dk in place (dk_j - mean_j dk_j).
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
//
// bf16 (`flash_attention_bwd_bf16`): q, k, v, o, do bf16, lse f32; dq, dk,
// dv bf16. Written for Hopper: every product is a warpgroup `wgmma` (bf16,
// f32 accumulators) on tiles that TMA brings into shared memory.
//   * what bounds it: at the qwen3-4b shape the same 344 GFLOP at 989
//     TFLOP/s, 0.348 ms, against 0.3 GB of bf16 inputs and outputs (0.09
//     ms): operations; the design's seven products per live pair, 0.487
//     ms. So the products must run on wgmma, the only way to the tensor
//     cores' full bf16 rate, fed without the compute threads' help.
//   * blocks of three warpgroups: two consumers and a producer, whose
//     first thread issues every copy (TMA boxes of 64 rows x 64 columns
//     with the 128-byte swizzle that the wgmma descriptors name; a row of
//     dh = 128 is two column halves) and waits on `mbarrier`s for a stage
//     to come free; `setmaxnreg` gives the producer 24 registers and each
//     consumer thread 240. Rows and columns past the tensors land as
//     zeros (TMA's fill); masks apply per element on edge tiles only.
//   * `dkdv_wgmma_kernel`: a block per (batch item x kv head, 128 keys),
//     K and V loaded once, the query tiles of 64 rows of the G heads in a
//     ring of BW_STAGES stages (Q, dO, and lse and delta by one bulk
//     copy). Consumer c owns 64 keys: S^T = K Q^T and dP^T = V dO^T
//     (m64n64k16, both operands in shared memory), P^T while dP^T runs,
//     then dv += P^T dO with A from registers (m64nDHPk16; dO read
//     transposed from its tile), dS^T = P^T (dP^T - delta) while that
//     runs, then dk += dS^T Q. dk and dv stay in f32 accumulators.
//   * `dq_wgmma_kernel`: a block per (batch item x head, 128 query rows),
//     Q and dO loaded once, key tiles of 64 (K, V and the centred keys
//     KC) in the ring. Consumer c owns 64 rows: S = Q K^T, dP = dO V^T,
//     P while dP runs, dS = P (dP - delta), dq += dS KC (A from
//     registers, KC read transposed), left running while the next tile's
//     S and dP are issued. It rebuilds S and dP (7 products per live pair
//     in all, not 5): a dq that reused the dk/dv kernel's dS would need
//     float atomics or a partial per key tile.
//   * S and dP come from the bf16 inputs as they are (exact products, f32
//     sums), P from the forward's lse unshifted: the forward computed that
//     lse from the same keys, so the keys are not centred for the scores
//     (a centred key rounded to bf16 would move every score by up to 2^-9
//     of |q| |k - kmean|).
//   * P and dS are rounded to bf16 only as the A operands of P^T do, dS^T q
//     and dS kc (each at most 2^-8 of its entry); dq, dk and dv sum in
//     wgmma's chained f32 accumulators (their truncation, about 2^-23 of
//     each add, is far below the bf16 roundings the bound allows) and are
//     rounded to bf16 once.
//   * dq = dS (k - kmean) scale: dS is rounded to bf16 here, so its rows no
//     longer sum to 0, and against the raw keys the gap would carry every
//     component that the keys share (2^-8 of |dS| times it; 30 times the
//     keys' own size at chip_smoke.py's key shift). So dq's product reads
//     the centred keys kc = bf16(k - kmean), a third tile beside K and V
//     (its rounding is at most 2^-8 of |k - kmean|).
//   * dk is summed in f32 into scratch, then its mean over the keys is
//     taken out (the same identity as the f32 entry's; the bf16 dS makes
//     sum_j dk_j nonzero by far more than f32 did) and it is rounded to
//     bf16 by the second centring pass. The key means are summed in two
//     deterministic passes over chunks of 64 keys (one block per (batch
//     item, kv head) would fill 32 of 132 SMs at the qwen3-4b shape).
//   * the wrapper makes q, k, v and do legal for TMA (rows on 16 bytes, dh
//     a multiple of 8) by padding or a copy; this entry refuses others.
//   * the TMA, mbarrier and wgmma helpers are hopper.cuh's, shared with
//     the forward's bf16 kernel (flash_attention.cu).
//   * shared memory at dh = 128: dkdv 2 x 32 KB (K, V) + 2 stages x 32 KB
//     (Q, dO) + 1 KB of lse/delta = 129 KB; dq 2 x 32 KB (Q, dO) + 2
//     stages x 48 KB (K, V, KC) = 160 KB (one block of 384 threads per SM).

#include "hopper.cuh"

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
constexpr int KMEAN_NT = 1024;
constexpr int CENTRE_NT = 256;
constexpr int CENTRE_ROWS = 16;          // key rows per centring block

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
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

// delta[b, h, i] = sum_d do[b, h, i, d] o[b, h, i, d], and (when `lsec`
// is not null: the f32 entry) the log-sum-exp shifted to the centred keys,
// lsec[b, h, i] = lse[b, h, i] - q[b, h, i] . kmean[b, h / G] scale_log2,
// which both the dq and the dk/dv kernel read: one warp per row.
template <typename T>
__global__ void __launch_bounds__(DELTA_NT)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
             const T* __restrict__ q, const float* __restrict__ lse,
             const float* __restrict__ kmean, float* __restrict__ delta,
             float* __restrict__ lsec, int H, int KV, int Sq, int dh,
             Strides os, Strides gs, Strides qs, float scale_log2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.y * (DELTA_NT / 32) + warp;
  if (i >= Sq) return;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* grow = dO + b * gs.b + h * gs.h + i * gs.s;
  const T* qrow = q + b * qs.b + h * qs.h + i * qs.s;
  const float* km = kmean + ((long long)b * KV + h / (H / KV)) * dh;
  float acc = 0.f, c = 0.f;
  for (int d = lane; d < dh; d += 32) {
    acc = fmaf(ldf(orow + d), ldf(grow + d), acc);
    if (lsec != nullptr) c = fmaf(ldf(qrow + d), km[d], c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    const long long r = (long long)blockIdx.x * Sq + i;
    delta[r] = acc;
    if (lsec != nullptr) lsec[r] = lse[r] - c * scale_log2;
  }
}

// kmean[b, kvh, d] = sum_j k[b, kvh, j, d] / Skv: one block per (batch
// item, kv head), 32 warps each summing a contiguous 32nd of the keys in
// order for 32 columns at a time, then the partials added in order (no
// atomics: a rerun is bit-equal).
template <typename T>
__global__ void __launch_bounds__(KMEAN_NT)
kmean_kernel(const T* __restrict__ k, float* __restrict__ kmean, int KV,
             int Skv, int dh, Strides ks) {
  __shared__ float part[KMEAN_NT / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const int per = (Skv + KMEAN_NT / 32 - 1) / (KMEAN_NT / 32);
  const int j0 = warp * per, j1 = min(j0 + per, Skv);
  for (int d0 = 0; d0 < dh; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    if (d < dh)
      for (int j = j0; j < j1; ++j) acc += ldf(kp + j * ks.s + d);
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && d < dh) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < KMEAN_NT / 32; ++w) sum += part[w][lane];
      kmean[(long long)blockIdx.x * dh + d] = sum / (float)Skv;
    }
    __syncthreads();
  }
}

// kc = k - kmean, contiguous (B, KV, Skv, dh): the keys the f32 entry's
// products kernels read, and dk projected (in place: kc == k, each thread
// reads the element it writes, so the pointers may alias; the bf16 entry
// has its own passes, `centre8_kernel`). One block per (batch item x kv
// head, CENTRE_ROWS keys).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(CENTRE_NT)
centre_kernel(const Tin* k, const float* __restrict__ kmean, Tout* kc,
              int KV, int Skv, int dh, Strides ks) {
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const Tin* kp = k + b * ks.b + kvh * ks.h;
  const float* km = kmean + (long long)blockIdx.x * dh;
  Tout* out = kc + (long long)blockIdx.x * Skv * dh;
  const int j0 = blockIdx.y * CENTRE_ROWS;
  for (int e = threadIdx.x; e < CENTRE_ROWS * dh; e += CENTRE_NT) {
    const int j = j0 + e / dh, d = e - (e / dh) * dh;
    if (j < Skv)
      stf(out + (long long)j * dh + d, ldf(kp + j * ks.s + d) - km[d]);
  }
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
                   float* dq, float* dk, float* dv, float* scratch, int B,
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
  // scratch: kc (B KV Skv dh), delta and lsec (B H Sq each), kmean
  float* kc = scratch;
  float* delta = kc + (long long)B * KV * Skv * dh;
  float* lsec = delta + (long long)B * H * Sq;
  float* kmean = lsec + (long long)B * H * Sq;
  const Strides cs{(long long)KV * Skv * dh, (long long)Skv * dh, dh};
  const dim3 centre_grid(B * KV, (Skv + CENTRE_ROWS - 1) / CENTRE_ROWS);
  kmean_kernel<float><<<B * KV, KMEAN_NT, 0, stream>>>(k, kmean, KV, Skv,
                                                        dh, st[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centre_kernel<float, float><<<centre_grid, CENTRE_NT, 0, stream>>>(
      k, kmean, kc, KV, Skv, dh, st[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  delta_kernel<float>
      <<<dim3(B * H, (Sq + DELTA_NT / 32 - 1) / (DELTA_NT / 32)), DELTA_NT, 0,
          stream>>>(o, dO, q, lse, kmean, delta, lsec, H, KV, Sq, dh, st[3],
                    st[4], st[0], scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DHP, VEC><<<dim3(B * KV, (Skv + KV_BKV - 1) / KV_BKV), KV_NT,
                          kv_smem, stream>>>(
      q, kc, v, dO, lsec, delta, dk, dv, H, KV, Sq, Skv, dh, st[0], cs,
      st[2], st[4], causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DHP, VEC><<<dim3(B * H, (Sq + Q_BQ - 1) / Q_BQ), Q_NT, q_smem,
                        stream>>>(q, kc, v, dO, lsec, delta, dq, H, KV, Sq,
                                  Skv, dh, st[0], cs, st[2], st[4],
                                  causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dk_j - mean_j dk_j, in place (kmean's buffer is free again)
  kmean_kernel<float><<<B * KV, KMEAN_NT, 0, stream>>>(dk, kmean, KV, Skv,
                                                        dh, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centre_kernel<float, float><<<centre_grid, CENTRE_NT, 0, stream>>>(
      dk, kmean, dk, KV, Skv, dh, cs);
  return cudaGetLastError();
}

// ---- bf16: wgmma on tiles brought by TMA, a producer warp per block ----

constexpr int BW_NT = 384;           // consumer warpgroups 0, 1; producer 2
constexpr int BW_KEYS = 128;         // keys per dk/dv block (64 per consumer)
constexpr int BW_QT = 64;            // query rows per staged tile (dk/dv)
constexpr int BW_QROWS = 128;        // query rows per dq block (64 each)
constexpr int BW_KT = 64;            // keys per staged tile (dq)
constexpr int BW_STAGES = 2;         // depth of the staged-tile rings
constexpr int LSED_TILE = 2 * BW_QT;     // floats: a tile's lse, then delta

// Two outputs of a contiguous bf16 row (dh columns) from column d on.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int d, int dh,
                                           float x, float y) {
  if ((dh & 1) == 0) {
    if (d < dh)
      *reinterpret_cast<__nv_bfloat162*>(row + d) =
          __floats2bfloat162_rn(x, y);
  } else {
    if (d < dh) row[d] = __float2bfloat16(x);
    if (d + 1 < dh) row[d + 1] = __float2bfloat16(y);
  }
}

// delta = rowsum(do o) and a copy of the forward's lse, laid out per query
// tile of 64 rows: lsed (B H, ceil(Sq / 64), {lse, delta}, 64) floats, rows
// from Sq on zero, so one 512-byte bulk copy brings a tile's pair. Each
// warp takes DELTA_ROWS rows, their loads issued together (VEC: 4 columns
// per lane by 8-byte loads, o's rows on 8 bytes; do's are on 16 for TMA);
// grid (B H, ceil(Sq / 64) 64 / (8 DELTA_ROWS)).
constexpr int DELTA_ROWS = 4;
template <bool VEC>
__global__ void __launch_bounds__(DELTA_NT)
delta_tiles_kernel(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dO,
                   const float* __restrict__ lse, float* __restrict__ lsed,
                   int H, int Sq, int dh, Strides os, Strides gs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = (blockIdx.y * (DELTA_NT / 32) + warp) * DELTA_ROWS;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  const __nv_bfloat16* obase = o + b * os.b + h * os.h;
  const __nv_bfloat16* gbase = dO + b * gs.b + h * gs.h;
  float acc[DELTA_ROWS];
#pragma unroll
  for (int r = 0; r < DELTA_ROWS; ++r) {
    acc[r] = 0.f;
    const int i = i0 + r;
    if (i >= Sq) continue;               // warp-uniform
    const __nv_bfloat16* orow = obase + (long long)i * os.s;
    const __nv_bfloat16* grow = gbase + (long long)i * gs.s;
    if constexpr (VEC) {
      const int d = 4 * lane;            // one pass: dh <= 128
      if (d < dh) {
        const uint2 a = *reinterpret_cast<const uint2*>(orow + d);
        const uint2 c = *reinterpret_cast<const uint2*>(grow + d);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 x = __bfloat1622float2(pa[u]);
          const float2 y = __bfloat1622float2(pc[u]);
          acc[r] = fmaf(x.y, y.y, fmaf(x.x, y.x, acc[r]));
        }
      }
    } else {
      for (int d = lane; d < dh; d += 32)
        acc[r] = fmaf(ldf(orow + d), ldf(grow + d), acc[r]);
    }
  }
  const int n_q = (Sq + BW_QT - 1) / BW_QT;
#pragma unroll
  for (int r = 0; r < DELTA_ROWS; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    const int i = i0 + r;
    if (lane == 0) {
      float* dst = lsed + ((long long)blockIdx.x * n_q + i / BW_QT) *
                              LSED_TILE + (i % BW_QT);
      dst[0] = i < Sq ? lse[(long long)blockIdx.x * Sq + i] : 0.f;
      dst[BW_QT] = acc[r];
    }
  }
}

// The bf16 entry's key means (of k, then of dk's f32 sums) in two
// deterministic passes that fill the card: partial column sums over chunks
// of KMEAN_ROWS keys, part (B KV, ceil(Skv / KMEAN_ROWS), dh), one thread
// per column summing its chunk's rows in order; then kmean_sum_kernel adds
// a (batch item, kv head)'s partials in order. Grid (B KV, chunks).
constexpr int KMEAN_ROWS = 64;
template <typename T>
__global__ void __launch_bounds__(128)
kmean_part_kernel(const T* __restrict__ x, float* __restrict__ part, int KV,
                  int Skv, int dh, Strides xs) {
  const int d = threadIdx.x;
  if (d >= dh) return;
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const int j0 = blockIdx.y * KMEAN_ROWS;
  const int j1 = min(j0 + KMEAN_ROWS, Skv);
  const T* xp = x + b * xs.b + kvh * xs.h + d;
  float acc = 0.f;
#pragma unroll 8
  for (int j = j0; j < j1; ++j) acc += ldf(xp + (long long)j * xs.s);
  part[((long long)blockIdx.x * gridDim.y + blockIdx.y) * dh + d] = acc;
}

__global__ void __launch_bounds__(128)
kmean_sum_kernel(const float* __restrict__ part, float* __restrict__ kmean,
                 int chunks, int Skv, int dh) {
  const int d = threadIdx.x;
  if (d >= dh) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c)
    acc += part[((long long)blockIdx.x * chunks + c) * dh + d];
  kmean[(long long)blockIdx.x * dh + d] = acc / (float)Skv;
}

// out = bf16(x - kmean), contiguous (B, KV, Skv, dh), 8 columns per thread
// by 16-byte stores: the centred keys from k (bf16), and dk from its f32
// sums. Rows of x on 16 bytes, dh a multiple of 8 (the bf16 entry's
// operands). One block per (batch item x kv head, CENTRE_ROWS keys).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    v[2 * u] = f.x;
    v[2 * u + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
}
template <typename T>
__global__ void __launch_bounds__(CENTRE_NT)
centre8_kernel(const T* __restrict__ x, const float* __restrict__ kmean,
               __nv_bfloat16* __restrict__ out, int KV, int Skv, int dh,
               Strides xs) {
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const T* xp = x + b * xs.b + kvh * xs.h;
  const float* km = kmean + (long long)blockIdx.x * dh;
  __nv_bfloat16* op = out + (long long)blockIdx.x * Skv * dh;
  const int per = dh / 8;
  const int j0 = blockIdx.y * CENTRE_ROWS;
  for (int e = threadIdx.x; e < CENTRE_ROWS * per; e += CENTRE_NT) {
    const int j = j0 + e / per, d = (e - (e / per) * per) * 8;
    if (j >= Skv) break;
    float v[8];
    load8(xp + (long long)j * xs.s + d, v);
    uint4 r;
    uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = pack_bf16(v[2 * u] - km[d + 2 * u], v[2 * u + 1] - km[d + 2 * u + 1]);
    *reinterpret_cast<uint4*>(op + (long long)j * dh + d) = r;
  }
}

// Shared memory of the dk/dv kernel (byte offsets from a 1024-byte
// aligned base): K and V (128 keys each), the rings of Q and dO tiles
// (64 rows each) and of lse/delta pairs, then the barriers.
template <int DHP>
struct DkdvSmem {
  static constexpr int TK = BW_KEYS * DHP * 2;
  static constexpr int TQ = BW_QT * DHP * 2;
  static constexpr int K = 0, V = TK, Q = 2 * TK;
  static constexpr int DO = Q + BW_STAGES * TQ;
  static constexpr int LD = DO + BW_STAGES * TQ;
  static constexpr int BAR = LD + BW_STAGES * LSED_TILE * 4;
  static constexpr int BYTES = BAR + 8 * (2 * BW_STAGES + 1) + 1024;
};

// dk (f32, into scratch, times scale) and dv (bf16) of one tile of 128
// keys of one (batch item, kv head). Warpgroup 2's first thread (the
// producer) loads K and V once, then keeps the query tiles of the G heads
// in flight (Q, dO, lse/delta into a ring of BW_STAGES stages: full[s]
// completes when a stage's bytes land, empty[s] when both consumers'
// eight warps are done with it). Consumer warpgroup c owns keys
// 64 c .. 64 c + 63 of the tile: per query tile S^T = K Q^T and
// dP^T = V dO^T (wgmma m64n64k16 from shared memory), then P^T and
// dS^T = P^T (dP^T - delta) in f32 registers, rounded to bf16 as the A
// operands (from registers) of dv += P^T dO and dk += dS^T Q (m64nDHPk16,
// dO and Q read transposed from the same tiles); dk and dv stay in f32
// accumulators for the whole loop.
template <int DHP>
__global__ void __launch_bounds__(BW_NT, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mdo,
                  const float* __restrict__ lsed, float* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int H, int KV, int Sq,
                  int Skv, int dh, int causal, int window, float scale_log2,
                  float scale) {
  using L = DkdvSmem<DHP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* const empty = full + BW_STAGES;
  uint64_t* const kv_full = empty + BW_STAGES;

  const int tid = threadIdx.x;
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int k_lo = blockIdx.y * BW_KEYS;   // first to last: heaviest first
  const int k_hi = min(k_lo + BW_KEYS, Skv) - 1;
  const int n_q = (Sq + BW_QT - 1) / BW_QT;
  const int i_begin = causal ? min(k_lo / BW_QT, n_q) : 0;
  const int i_end =
      window > 0 ? min(n_q, (k_hi + window - 1) / BW_QT + 1) : n_q;
  const int per_head = max(i_end - i_begin, 0);
  const int n_tiles = G * per_head;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid >> 7;
  if (wg == 2) {                         // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == 256) {
      mbar_expect_tx(kv_full, 2 * L::TK);
      tma_tile<DHP, BW_KEYS>(sm + L::K, &mk, k_lo, kvh, b, kv_full);
      tma_tile<DHP, BW_KEYS>(sm + L::V, &mv, k_lo, kvh, b, kv_full);
      int s = 0;
      uint32_t ph = 0;
      for (int n = 0; n < n_tiles; ++n) {
        mbar_wait(&empty[s], ph ^ 1);
        const int h = kvh * G + n / per_head;
        const int qt = i_begin + n % per_head;
        mbar_expect_tx(&full[s], 2 * L::TQ + LSED_TILE * 4);
        tma_tile<DHP, BW_QT>(sm + L::Q + s * L::TQ, &mq, qt * BW_QT, h, b,
                             &full[s]);
        tma_tile<DHP, BW_QT>(sm + L::DO + s * L::TQ, &mdo, qt * BW_QT, h, b,
                             &full[s]);
        bulk_copy(sm + L::LD + s * LSED_TILE * 4,
                  lsed + ((long long)(b * H + h) * n_q + qt) * LSED_TILE,
                  LSED_TILE * 4, &full[s]);
        if (++s == BW_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {                               // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    constexpr int NO = DHP / 8;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw_lo = k_lo + 64 * wg;    // this warpgroup's 64 keys
    const int kw_hi = min(kw_lo + 63, Skv - 1);
    const uint32_t sK = smem_addr(sm + L::K), sV = smem_addr(sm + L::V);
    float adk[NO][4], adv[NO][4];
    zero<NO>(adk);
    zero<NO>(adv);
    mbar_wait(kv_full, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int n = 0; n < n_tiles; ++n) {
      mbar_wait(&full[s], ph);
      const int q_lo = (i_begin + n % per_head) * BW_QT;
      const int q_hi = min(q_lo + BW_QT, Sq) - 1;
      const bool dead = kw_lo >= Skv || (causal && kw_lo > q_hi) ||
                        (window > 0 && q_lo - kw_hi >= window);
      if (!dead) {                       // warpgroup-uniform
        const bool edge = (causal && kw_hi > q_lo) ||
                          (window > 0 && q_hi - kw_lo >= window) ||
                          kw_lo + 64 > Skv || q_lo + BW_QT > Sq;
        const uint32_t sQ = smem_addr(sm + L::Q + s * L::TQ);
        const uint32_t sdO = smem_addr(sm + L::DO + s * L::TQ);
        const float* tL =
            reinterpret_cast<const float*>(sm + L::LD + s * LSED_TILE * 4);
        const float* tD = tL + BW_QT;

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, two groups
        float st[8][4], dp[8][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk)
          wgmma_ss<64>(st, kmajor<BW_KEYS>(sK, 64 * wg, kk),
                       kmajor<BW_QT>(sQ, 0, kk), kk > 0);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk)
          wgmma_ss<64>(dp, kmajor<BW_KEYS>(sV, 64 * wg, kk),
                       kmajor<BW_QT>(sdO, 0, kk), kk > 0);
        wg_commit();

        // P^T while dP^T runs; key 16 warp + g (+ 8), query 8 m + 2t (+ 1)
        wg_wait<1>();
        pin<8>(st);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = m * 8 + 2 * t + (e & 1);
            bool live = true;
            if (edge) {
              const int qi = q_lo + col;
              const int kj = kw_lo + 16 * warp + g + (e >> 1) * 8;
              live = qi < Sq && kj < Skv && (!causal || kj <= qi) &&
                     (window <= 0 || kj > qi - window);
            }
            st[m][e] = live ? exp2f(st[m][e] * scale_log2 - tL[col]) : 0.f;
          }
        }
        uint32_t pa[4][4], da[4][4];
        to_a<4>(pa, st);

        // dv += P^T dO over this tile's 64 query rows, then dS^T =
        // P^T (dP^T - delta) while it runs, then dk += dS^T Q
        wg_wait<0>();
        pin<8>(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<DHP>(adv, pa[kk], mnmajor<BW_QT>(sdO, kk), 1);
        wg_commit();
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[m][e] = st[m][e] * (dp[m][e] - tD[m * 8 + 2 * t + (e & 1)]);
        to_a<4>(da, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<DHP>(adk, da[kk], mnmajor<BW_QT>(sQ, kk), 1);
        wg_commit();
        wg_wait<0>();
        pin<NO>(adv);
        pin<NO>(adk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == BW_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }

    float* dkp = dk + ((long long)b * KV + kvh) * Skv * dh;
    __nv_bfloat16* dvp = dv + ((long long)b * KV + kvh) * Skv * dh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = kw_lo + 16 * warp + g + 8 * r;
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
}

// Shared memory of the dq kernel: Q and dO (128 rows each), then the ring
// of key tiles (K, V, KC: 64 keys each per stage), then the barriers.
template <int DHP>
struct DqSmem {
  static constexpr int TQ = BW_QROWS * DHP * 2;
  static constexpr int TK = BW_KT * DHP * 2;
  static constexpr int Q = 0, DO = TQ, KS = 2 * TQ;
  static constexpr int BAR = KS + BW_STAGES * 3 * TK;
  static constexpr int BYTES = BAR + 8 * (2 * BW_STAGES + 1) + 1024;
};

// dq (bf16) of one tile of 128 query rows of one (batch item, head). The
// producer loads Q and dO once, then keeps the key tiles (K, V and the
// centred keys KC, 64 keys each) in flight in a ring. Consumer warpgroup
// c owns rows 64 c .. 64 c + 63: per key tile S = Q K^T and dP = dO V^T
// (wgmma from shared memory, the scores from the raw keys), dS = P (dP -
// delta) in f32 registers, rounded to bf16 as the A operand of
// dq += dS KC (KC read transposed), in f32 accumulators for the loop.
template <int DHP>
__global__ void __launch_bounds__(BW_NT, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mkc,
                const float* __restrict__ lsed,
                __nv_bfloat16* __restrict__ dq, int H, int KV, int Sq,
                int Skv, int dh, int causal, int window, float scale_log2,
                float scale) {
  using L = DqSmem<DHP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* const empty = full + BW_STAGES;
  uint64_t* const q_full = empty + BW_STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BW_QROWS;  // heaviest 1st
  const int q_hi = min(q_lo + BW_QROWS, Sq) - 1;
  const int n_kv = (Skv + BW_KT - 1) / BW_KT;
  const int j_end = causal ? min(n_kv, q_hi / BW_KT + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) / BW_KT : 0;
  const int n_tiles = max(j_end - j_begin, 0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < BW_STAGES; ++s) {
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
      mbar_expect_tx(q_full, 2 * L::TQ);
      tma_tile<DHP, BW_QROWS>(sm + L::Q, &mq, q_lo, h, b, q_full);
      tma_tile<DHP, BW_QROWS>(sm + L::DO, &mdo, q_lo, h, b, q_full);
      int s = 0;
      uint32_t ph = 0;
      for (int n = 0; n < n_tiles; ++n) {
        mbar_wait(&empty[s], ph ^ 1);
        const int k0 = (j_begin + n) * BW_KT;
        unsigned char* st = sm + L::KS + s * 3 * L::TK;
        mbar_expect_tx(&full[s], 3 * L::TK);
        tma_tile<DHP, BW_KT>(st, &mk, k0, kvh, b, &full[s]);
        tma_tile<DHP, BW_KT>(st + L::TK, &mv, k0, kvh, b, &full[s]);
        tma_tile<DHP, BW_KT>(st + 2 * L::TK, &mkc, k0, kvh, b, &full[s]);
        if (++s == BW_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {                               // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    constexpr int NO = DHP / 8;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw_lo = q_lo + 64 * wg;    // this warpgroup's 64 rows
    const int qw_hi = min(qw_lo + 63, Sq - 1);
    const int n_q = (Sq + BW_QT - 1) / BW_QT;
    const long long bh = (long long)b * H + h;
    float lrow[2], drow[2];              // rows 16 warp + g (+ 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qw_lo + 16 * warp + g + 8 * r;
      const float* p =
          lsed + (bh * n_q + qi / BW_QT) * LSED_TILE + (qi % BW_QT);
      lrow[r] = qi < Sq ? p[0] : 0.f;
      drow[r] = qi < Sq ? p[BW_QT] : 0.f;
    }
    const uint32_t sQ = smem_addr(sm + L::Q), sdO = smem_addr(sm + L::DO);
    float acc[NO][4];
    zero<NO>(acc);
    mbar_wait(q_full, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int n = 0; n < n_tiles; ++n) {
      mbar_wait(&full[s], ph);
      const int k_lo = (j_begin + n) * BW_KT;
      const int k_hi = min(k_lo + BW_KT, Skv) - 1;
      const bool dead = qw_lo >= Sq || (causal && k_lo > qw_hi) ||
                        (window > 0 && qw_lo - k_hi >= window);
      if (!dead) {                       // warpgroup-uniform
        const bool edge = (causal && k_hi > qw_lo) ||
                          (window > 0 && qw_hi - k_lo >= window) ||
                          k_lo + BW_KT > Skv;
        const uint32_t sK = smem_addr(sm + L::KS + s * 3 * L::TK);
        const uint32_t sV = sK + L::TK, sC = sK + 2 * L::TK;

        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, two groups
        float sc[8][4], dp[8][4];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk)
          wgmma_ss<64>(sc, kmajor<BW_QROWS>(sQ, 64 * wg, kk),
                       kmajor<BW_KT>(sK, 0, kk), kk > 0);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk)
          wgmma_ss<64>(dp, kmajor<BW_QROWS>(sdO, 64 * wg, kk),
                       kmajor<BW_KT>(sV, 0, kk), kk > 0);
        wg_commit();

        // P while dP runs; row 16 warp + g (+ 8), key 8 m + 2t (+ 1)
        wg_wait<1>();
        pin<8>(sc);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool live = true;
            if (edge) {
              const int qi = qw_lo + 16 * warp + g + (e >> 1) * 8;
              const int kj = k_lo + m * 8 + 2 * t + (e & 1);
              live = kj < Skv && (!causal || kj <= qi) &&
                     (window <= 0 || kj > qi - window);
            }
            sc[m][e] =
                live ? exp2f(sc[m][e] * scale_log2 - lrow[e >> 1]) : 0.f;
          }
        }
        // dS = P (dP - delta), then dq += dS KC over this tile's 64 keys
        wg_wait<0>();
        pin<8>(dp);
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[m][e] = sc[m][e] * (dp[m][e] - drow[e >> 1]);
        uint32_t da[4][4];
        to_a<4>(da, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<DHP>(acc, da[kk], mnmajor<BW_KT>(sC, kk), 1);
        wg_commit();
        wg_wait<0>();
        pin<NO>(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == BW_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }

    __nv_bfloat16* dqp = dq + bh * Sq * dh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qw_lo + 16 * warp + g + 8 * r;
      if (qi >= Sq) continue;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        store_pair(dqp + (long long)qi * dh, nt * 8 + 2 * t, dh,
                   acc[nt][2 * r] * scale, acc[nt][2 * r + 1] * scale);
    }
  }
}

template <int DHP>
cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const __nv_bfloat16* o,
                        const __nv_bfloat16* dO, const float* lse,
                        __nv_bfloat16* dq, __nv_bfloat16* dk,
                        __nv_bfloat16* dv, float* scratch, int B, int H,
                        int KV, int Sq, int Skv, int dh, const Strides* st,
                        int causal, int window, float scale_log2,
                        float scale, cudaStream_t stream) {
  constexpr int kv_smem = DkdvSmem<DHP>::BYTES;
  constexpr int q_smem = DqSmem<DHP>::BYTES;
  // the shared-memory limit is set once per process and device
  static int attributes_set = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (attributes_set != device) {
    err = cudaFuncSetAttribute(dkdv_wgmma_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_wgmma_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_smem);
    if (err != cudaSuccess) return err;
    attributes_set = device;
  }
  // st: q, k, v, o, do
  // scratch: kc (B KV Skv dh bf16), dk's f32 sums (B KV Skv dh), lse and
  // delta per query tile (B H ceil(Sq / 64) 128), kmean (B KV dh), the key
  // means' partial sums (B KV ceil(Skv / KMEAN_ROWS) dh)
  const long long n = (long long)B * KV * Skv * dh;
  const int n_q = (Sq + BW_QT - 1) / BW_QT;
  const int chunks = (Skv + KMEAN_ROWS - 1) / KMEAN_ROWS;
  __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(scratch);
  float* dk32 = scratch + n / 2;
  float* lsed = dk32 + n;
  float* kmean = lsed + (long long)B * H * n_q * LSED_TILE;
  float* part = kmean + (long long)B * KV * dh;
  const Strides cs{(long long)KV * Skv * dh, (long long)Skv * dh, dh};
  CUtensorMap mq, mk, mv, mdo, mkc;
  if (!encode_rows(&mq, q, B, H, Sq, dh, st[0]) ||
      !encode_rows(&mk, k, B, KV, Skv, dh, st[1]) ||
      !encode_rows(&mv, v, B, KV, Skv, dh, st[2]) ||
      !encode_rows(&mdo, dO, B, H, Sq, dh, st[4]) ||
      !encode_rows(&mkc, kc, B, KV, Skv, dh, cs))
    return cudaErrorInvalidValue;
  const dim3 centre_grid(B * KV, (Skv + CENTRE_ROWS - 1) / CENTRE_ROWS);
  const dim3 part_grid(B * KV, chunks);
  kmean_part_kernel<__nv_bfloat16><<<part_grid, 128, 0, stream>>>(
      k, part, KV, Skv, dh, st[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kmean_sum_kernel<<<B * KV, 128, 0, stream>>>(part, kmean, chunks, Skv, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centre8_kernel<__nv_bfloat16><<<centre_grid, CENTRE_NT, 0, stream>>>(
      k, kmean, kc, KV, Skv, dh, st[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 delta_grid(B * H,
                        n_q * (BW_QT / (DELTA_NT / 32 * DELTA_ROWS)));
  if (reinterpret_cast<uintptr_t>(o) % 8 == 0 && st[3].b % 4 == 0 &&
      st[3].h % 4 == 0 && st[3].s % 4 == 0)
    delta_tiles_kernel<true><<<delta_grid, DELTA_NT, 0, stream>>>(
        o, dO, lse, lsed, H, Sq, dh, st[3], st[4]);
  else
    delta_tiles_kernel<false><<<delta_grid, DELTA_NT, 0, stream>>>(
        o, dO, lse, lsed, H, Sq, dh, st[3], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_wgmma_kernel<DHP>
      <<<dim3(B * KV, (Skv + BW_KEYS - 1) / BW_KEYS), BW_NT, kv_smem,
         stream>>>(mq, mk, mv, mdo, lsed, dk32, dv, H, KV, Sq, Skv, dh,
                   causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_wgmma_kernel<DHP>
      <<<dim3(B * H, (Sq + BW_QROWS - 1) / BW_QROWS), BW_NT, q_smem,
         stream>>>(mq, mk, mv, mdo, mkc, lsed, dq, H, KV, Sq, Skv, dh,
                   causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dk = bf16(dk32_j - mean_j dk32_j) (kmean's buffers are free again)
  kmean_part_kernel<float><<<part_grid, 128, 0, stream>>>(dk32, part, KV,
                                                           Skv, dh, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kmean_sum_kernel<<<B * KV, 128, 0, stream>>>(part, kmean, chunks, Skv, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centre8_kernel<float><<<centre_grid, CENTRE_NT, 0, stream>>>(
      dk32, kmean, dk, KV, Skv, dh, cs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the seven kernels (kmean and centre of k, delta, dk/dv, dq,
// kmean and centre of dk) on `stream` and returns cudaGetLastError() (0
// on success); it does not synchronise and allocates nothing. `strides` holds 15 element strides: (batch,
// head, sequence) of q, k, v, o and do. dq, dk, dv are written
// contiguous; `scratch` is f32 scratch of B KV Skv dh + 2 B H Sq + B KV dh
// floats, 16-byte aligned. `scale_log2` is dh^-0.5 log2(e) (the
// forward's), `scale` dh^-0.5. Tiles load with 16-byte cp.async when every
// row of q, v and do (and the centred keys) starts 16-byte aligned, else
// element by element.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, const void* lse,
                            void* dq, void* dk, void* dv, void* scratch, int B,
                            int H, int KV, int Sq, int Skv, int dh,
                            const long long* strides, int causal, int window,
                            float scale_log2, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      dh < 1 || dh > 128 || window < 0 || (long long)B * H > 2147483647LL ||
      (Sq + Q_BQ - 1) / Q_BQ > 65535 || (Skv + KV_BKV - 1) / KV_BKV > 65535 ||
      (Sq + DELTA_NT / 32 - 1) / (DELTA_NT / 32) > 65535 ||
      (Skv + CENTRE_ROWS - 1) / CENTRE_ROWS > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  bool vec = dh % 4 == 0;
  for (int t = 0; t < 15; ++t) {   // k: kmean and centre; o: delta only
    if (t / 3 != 1 && t / 3 != 3) vec = vec && strides[t] % 4 == 0;
  }
  const void* ptrs[4] = {q, v, dO, scratch};
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
  float* dd = static_cast<float*>(scratch);
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

// The same contract with bf16 q, k, v, o, do (lse f32) and bf16 dq, dk,
// dv: `scratch` is f32 scratch of B KV Skv dh / 2 + B KV Skv dh +
// 128 B H ceil(Sq / 64) + B KV dh (1 + ceil(Skv / 64)) floats, 16-byte
// aligned (the centred keys in bf16, dk's f32 sums, lse and delta per query
// tile, the key means and their partial sums).
// q, k, v and do are read by TMA, so dh must be a multiple of 8 and every
// row of q, k, v and do must start on 16 bytes (each base pointer, and
// each stride over an axis of more than one entry a positive multiple of
// 8): the wrapper makes other inputs legal by a copy. o is read by plain
// loads (any strides).
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dO, const void* lse,
                             void* dq, void* dk, void* dv, void* scratch,
                             int B, int H, int KV, int Sq, int Skv, int dh,
                             const long long* strides, int causal,
                             int window, float scale_log2, float scale,
                             void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      dh < 1 || dh > 128 || dh % 8 != 0 || window < 0 ||
      (long long)B * H > 2147483647LL ||
      (Sq + BW_QROWS - 1) / BW_QROWS > 65535 ||
      (Skv + KMEAN_ROWS - 1) / KMEAN_ROWS > 65535 ||
      (long long)(Sq + BW_QT - 1) / BW_QT *
              (BW_QT / (DELTA_NT / 32 * DELTA_ROWS)) > 65535 ||
      (Skv + CENTRE_ROWS - 1) / CENTRE_ROWS > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  if (!tma_rows(q, B, H, Sq, st[0]) || !tma_rows(k, B, KV, Skv, st[1]) ||
      !tma_rows(v, B, KV, Skv, st[2]) || !tma_rows(dO, B, H, Sq, st[4]) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  using bf = __nv_bfloat16;
  const bf* qq = static_cast<const bf*>(q);
  const bf* kk = static_cast<const bf*>(k);
  const bf* vv = static_cast<const bf*>(v);
  const bf* oo = static_cast<const bf*>(o);
  const bf* gg = static_cast<const bf*>(dO);
  const float* ll = static_cast<const float*>(lse);
  bf* dqq = static_cast<bf*>(dq);
  bf* dkk = static_cast<bf*>(dk);
  bf* dvv = static_cast<bf*>(dv);
  float* dd = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(DHP)                                                 \
  launch_bf16<DHP>(qq, kk, vv, oo, gg, ll, dqq, dkk, dvv, dd, B, H, KV, Sq,   \
                   Skv, dh, st, causal, window, scale_log2, scale, s)
  return (int)(dh <= 64 ? FLASH_BWD_LAUNCH(64) : FLASH_BWD_LAUNCH(128));
#undef FLASH_BWD_LAUNCH
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
