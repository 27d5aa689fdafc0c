// Blocked online-softmax attention (FlashAttention, forward) for Hopper
// (sm_90a), with both products as warpgroup `wgmma` on tiles that TMA
// brings into shared memory: f32 inputs in split TF32
// (`flash_attention_f32`, `fwd_tf32_kernel` after its split pass), bf16
// inputs in bf16 (`flash_attention_bf16`, `fwd_wgmma_kernel`).
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
// scaled by the true dh^-0.5 (the wrapper passes it: a dh padded to whole
// 16-byte rows keeps it); masked scores get p = 0, the softmax
// denominator is max(l, 1e-30), as in the reference, so a row that sees
// no key gets o = 0 (as from the reference's kernel). Output o in q's
// dtype, through the strides it is given (the wrapper's torch.empty_like:
// q's strides when q is dense, contiguous otherwise); the softmax state
// (m, l) and O accumulate in f32. For training, the launch also writes each
// row's m + log2(l) to `lse` (one store per row after the loop), which the
// backward kernel (flash_attention_bwd.cu) reads; serving passes null.
//
// Departures from the reference's arithmetic:
//   * bf16 inputs: P is rounded to bf16 before P.V (the reference keeps P
//     in f32), as every bf16 flash kernel does; l sums the f32 P.
//   * f32 inputs: split TF32 ("3xTF32"), as the backward's and the graph
//     filter's. Each f32 operand x is x_hi + x_lo with x_hi = tf32(x) and
//     x_lo = tf32(x - x_hi), both rounded to nearest (ties away, as
//     cvt.rna, by an integer add and mask), and each product is a_lo b_hi
//     + a_hi b_lo + a_hi b_hi in f32 accumulators, for Q.K^T and P.V. The
//     dropped a_lo b_lo is about 2^-22 of the product: f32 accuracy. No
//     one-pass TF32 anywhere (chip_smoke.py 5's control shows it would
//     miss the 1e-5 gate).
//   * exp is exp2 with scale * log2(e) folded into the score scale.
//
// What bounds it: at the qwen3-4b prefill shape (B=4, H=32, KV=8,
// S=2048, dh=128, causal) the live (i, j) pairs are S(S+1)/2 per head:
// 4 B H dh S(S+1)/2 = 137.6 GFLOP. On the tensor cores that is 0.139 ms
// in bf16 (989 TFLOP/s dense) and, at three TF32 products each, 0.834 ms
// in f32 (495 TFLOP/s), against 335 MB of q, k, v, o in f32 (0.10 ms at
// 3.35 TB/s; 0.05 ms in bf16): bound by operations in both. So the
// products must run on wgmma, the only way to the tensor cores' full rate
// (mma.sync reaches about a quarter of the TF32 one), fed by TMA without
// the compute threads' help; and the exp2 of every score must overlap the
// products rather than follow them.
//
// f32 design (`fwd_tf32_kernel`: split TF32 on warpgroup products):
//   * tf32 wgmma reads its B operand from shared memory only K-major, and
//     a split operand takes twice its f32 bytes. B is K (keys x dh) for
//     S = Q K^T and V^T (dh x keys) for O += P V, which TMA cannot read
//     transposed. So a pass before the kernel (`split_kv_kernel`) writes
//     k and v^T, each split into hi and lo planes, into f32 scratch the
//     wrapper allocates per call (4 B KV Skv dh floats: 134 MB at the
//     qwen3-4b shape), reading k and v through their strides; TMA then
//     brings the key tiles split and K-major, and no block splits one.
//     Within each k-step of 8 keys, V^T's column t holds key 2t and t + 4
//     key 2t + 1: P's accumulator registers (keys 2t, 2t + 1) are then the
//     A fragment of P V as they stand, with no shuffle.
//   * the bf16 kernel's block: three warpgroups per (batch item x head,
//     query tile of 128 rows), two consumers of 64 rows each and a
//     producer whose first thread issues every copy: Q once (raw f32,
//     boxes of 32 columns x 64 rows with the 128-byte swizzle), then the
//     split K tiles and V^T tiles into two `mbarrier` rings (K(j) is
//     freed when S(j) is in, V(j) when P V(j) is, so each load has a
//     whole tile's time).
//     `setmaxnreg` moves registers to the consumers. The grid is
//     one-dimensional: heads in groups of 8 (a split kv head takes 4 MB
//     at S = 2048, dh = 128), all query tiles of a group together, the
//     heaviest causal tile first.
//   * every A operand comes from registers: Q's fragments are split as
//     they are loaded from the raw tile (by rows, one k-step ahead of the
//     products), P's from the softmax's registers. S = Q K^T is two fresh
//     chains per tile, hi.hi in one and lo.hi, hi.lo in the other, added
//     in f32 (the tensor cores add into an accumulator by truncation; one
//     chain of all three carries three times the truncations at the
//     scores' size); P V is one fresh chain per tile, added to O in f32
//     registers: O chained through every tile drifts (the CPU emulation,
//     tests/test_torch_flash_fwd_f32.py, puts this design 1.2-3.7x closer
//     to f64 than the mma.sync kernel before it).
//   * per tile each consumer issues S(j) and P V(j - 1) together, waits
//     for S(j), runs its softmax (pinned, as the bf16 kernel's) while
//     P V(j - 1) runs, then waits for it, adds it and rescales O. Every
//     product sits in code both consumers run, and none is left in flight
//     across the loop's back edge (ptxas would serialize them).
//   * KEYS = 64 keys per tile at dh <= 64; 32 at dh = 128, where split
//     tiles of 64 keys (64 KB of K and 64 of V^T) leave no room beside Q
//     for a second stage. Shared memory at dh = 128: Q 64 KB + 2 stages x
//     (K, V^T) x (hi, lo) x 16 KB = 192 KB; at dh = 64, 160 KB (one block
//     of 384 threads per SM).
//   * masks apply per element only on edge tiles; tiles a warpgroup's
//     rows do not see are skipped (their stages freed), so a window costs
//     O(S W). q and o must be legal for TMA (dh a multiple of 4, rows on
//     16 bytes): the wrapper pads or copies others, this entry refuses
//     them.
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

#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

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

// x += y, elementwise over NT n8 accumulator tiles.
template <int NT>
__device__ __forceinline__ void add(float (*x)[4], const float (*y)[4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] += y[n][e];
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

// Whether a mask can bite inside the tile of KT keys from k_lo for the
// rows qw_lo .. qw_hi.
template <int KT = FW_KT>
__device__ __forceinline__ bool edge_tile(int k_lo, int qw_lo, int qw_hi,
                                          int Skv, int causal, int window) {
  return (causal && k_lo + KT - 1 > qw_lo) ||
         (window > 0 && qw_hi - k_lo >= window) || k_lo + KT > Skv;
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

// ---- f32: split TF32 on wgmma, TMA tiles, a producer warp per block ----

constexpr int FT_NT = 384;           // consumer warpgroups 0, 1; producer 2
constexpr int FT_QROWS = 128;        // query rows per block (64 each)
// Depth of the K ring and of the V ring: a third stage at dh = 64 (it
// fits) ran no faster on the H100.
constexpr int FT_STAGES = 2;
constexpr int FT_HEAD_GROUP = 8;     // heads whose query tiles run together
constexpr int SPLIT_NT = 256;        // threads of the split pass
constexpr int SPLIT_ROWS = 32;       // keys per split-pass block
// Keys per staged tile: 64 at dh <= 64; 32 at dh = 128, where split tiles
// of 64 keys (64 KB of K, 64 of V^T) would leave no room for a second
// stage beside Q (64 KB).
template <int DHP>
__host__ __device__ constexpr int ft_keys() {
  return DHP == 64 ? 64 : 32;
}
// Q's fragments come in batches of this many k-steps (two register
// buffers of them): with two, the consumers spilled (196 bytes at
// dh = 64, beside O, the P V part, the scores and P's split fragments);
// with one they spill nowhere and ran as fast.
constexpr int FT_QBATCH = 1;

// The split key and value tiles the forward reads as B operands, in f32
// scratch: k as hi and lo (contiguous (B, KV, Skv, dh) planes), v
// transposed as hi and lo ((B, KV, dh, skvp) planes, skvp = Skv rounded up
// to a multiple of 8, the columns past Skv zero), so TMA brings them split
// and K-major and no block splits a tile. Within each k-step of 8 keys,
// V^T's column t holds key 2t and column t + 4 key 2t + 1 (`kperm`): P's
// accumulator registers are then the A fragment of P V as they stand. One
// block per (batch item x kv head, SPLIT_ROWS keys); v goes through shared
// memory, so both the reads and the transposed writes are coalesced.
__global__ void __launch_bounds__(SPLIT_NT)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ kh, float* __restrict__ kl,
                float* __restrict__ vh, float* __restrict__ vl, int KV,
                int Skv, int skvp, int dh, Strides ks, Strides vs) {
  __shared__ float sv[SPLIT_ROWS][129];
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const float* kp = k + b * ks.b + kvh * ks.h;
  const float* vp = v + b * vs.b + kvh * vs.h;
  const int j0 = blockIdx.y * SPLIT_ROWS;
  const long long kbase = (long long)blockIdx.x * Skv * dh;
  for (int e = threadIdx.x; e < SPLIT_ROWS * dh; e += SPLIT_NT) {
    const int r = e / dh, d = e - r * dh, j = j0 + r;
    float x = 0.f;
    if (j < Skv) {
      uint32_t hi, lo;
      split(kp[j * ks.s + d], hi, lo);
      kh[kbase + (long long)j * dh + d] = __uint_as_float(hi);
      kl[kbase + (long long)j * dh + d] = __uint_as_float(lo);
      x = vp[j * vs.s + d];
    }
    sv[r][d] = x;
  }
  __syncthreads();
  const long long vbase = (long long)blockIdx.x * dh * skvp;
  for (int e = threadIdx.x; e < dh * SPLIT_ROWS; e += SPLIT_NT) {
    const int d = e / SPLIT_ROWS, c = e - d * SPLIT_ROWS;
    if (j0 + c >= skvp) continue;
    // column c holds key kperm^-1(c): t -> 2t, t + 4 -> 2t + 1
    const int key = (c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1);
    uint32_t hi, lo;
    split(sv[key][d], hi, lo);
    vh[vbase + (long long)d * skvp + j0 + c] = __uint_as_float(hi);
    vl[vbase + (long long)d * skvp + j0 + c] = __uint_as_float(lo);
  }
}

// Shared memory of the f32 forward kernel (byte offsets from a 1024-byte
// aligned base): raw Q (128 rows), the K ring (KEYS rows, hi and lo), the
// V^T ring (DHP rows x KEYS columns, hi and lo), the barriers.
template <int DHP>
struct FwdF32Smem {
  static constexpr int KEYS = ft_keys<DHP>();
  static constexpr int TQ = FT_QROWS * DHP * 4;
  static constexpr int TK = KEYS * DHP * 4;   // one plane of a K or V^T tile
  static constexpr int Q = 0, K = TQ, V = K + FT_STAGES * 2 * TK;
  static constexpr int BAR = V + FT_STAGES * 2 * TK;
  static constexpr int BYTES = BAR + 8 * (4 * FT_STAGES + 1) + 1024;
};

// One V^T tile (DHP rows x KEYS columns from key k0 on) of a transposed
// map (keys, dh rows, kv head, batch): KEYS / 32 column blocks, each one
// box of DHP rows.
template <int DHP, int KEYS>
__device__ __forceinline__ void tma_vt_tile(unsigned char* dst,
                                            const CUtensorMap* map, int k0,
                                            int kvh, int b, uint64_t* bar) {
#pragma unroll
  for (int blk = 0; blk < KEYS / 32; ++blk)
    tma_box(dst + blk * DHP * 128, map, k0 + 32 * blk, 0, kvh, b, bar);
}

// Issues S = Q K^T for the warpgroup's 64 rows (rows r0 .. of the raw Q
// tile) over the KEYS keys of the split K tile (hi at kh, lo at kl), in
// split TF32: per k-step lo.hi and hi.lo into `small`, hi.hi into `s`, each
// a fresh chain (two accumulators: the large one then takes a third of the
// tensor cores' truncating adds). Q's fragments are split as they are
// loaded, in batches of FT_QBATCH k-steps into two register buffers: batch
// b + 1 is loaded while batch b's products run. Leaves the last batch's
// group in flight: the caller waits.
template <int DHP, int KEYS>
__device__ __forceinline__ void issue_scores_f32(float (*s)[4],
                                                 float (*small)[4],
                                                 const unsigned char* tq,
                                                 int r0, uint32_t kh,
                                                 uint32_t kl, int g, int t) {
  constexpr int NK = DHP / 8, BK = FT_QBATCH, NB = NK / BK;
  uint32_t fh[2][BK][4], fl[2][BK][4];
#pragma unroll
  for (int j = 0; j < BK; ++j)
    frag_rows<FT_QROWS>(fh[0][j], fl[0][j], tq, r0, 8 * j, g, t);
#pragma unroll
  for (int bt = 0; bt < NB; ++bt) {
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kk = bt * BK + j;
      const uint32_t* ah = fh[bt & 1][j];
      const uint32_t* al = fl[bt & 1][j];
      if (kk == 0) {
        wgmma_tf32_first<KEYS>(small, al, kmajor<KEYS>(kh, 0, 0));
        wgmma_tf32<KEYS>(small, ah, kmajor<KEYS>(kl, 0, 0), 1);
        wgmma_tf32_first<KEYS>(s, ah, kmajor<KEYS>(kh, 0, 0));
      } else {
        wgmma_tf32<KEYS>(small, al, kmajor<KEYS>(kh, 0, kk), 1);
        wgmma_tf32<KEYS>(small, ah, kmajor<KEYS>(kl, 0, kk), 1);
        wgmma_tf32<KEYS>(s, ah, kmajor<KEYS>(kh, 0, kk), 1);
      }
    }
    wg_commit();
    if (bt + 1 < NB) {
      wg_wait<1>();                      // batch bt - 1 has read its buffer
#pragma unroll
      for (int j = 0; j < BK; ++j)
        frag_rows<FT_QROWS>(fh[(bt + 1) & 1][j], fl[(bt + 1) & 1][j], tq, r0,
                            8 * ((bt + 1) * BK + j), g, t);
    }
  }
}

// Issues part = P V for the warpgroup (P split in registers: ph, pl, one
// A fragment per k-step of 8 keys; V^T's split tile at vh, vl, K-major) as
// one fresh chain (lo.hi, hi.lo, hi.hi per k-step), one wgmma group.
template <int DHP, int NS>
__device__ __forceinline__ void issue_pv_f32(float (*part)[4],
                                             const uint32_t (*ph)[4],
                                             const uint32_t (*pl)[4],
                                             uint32_t vh, uint32_t vl) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    if (kk == 0)
      wgmma_tf32_first<DHP>(part, pl[0], kmajor<DHP>(vh, 0, 0));
    else
      wgmma_tf32<DHP>(part, pl[kk], kmajor<DHP>(vh, 0, kk), 1);
    wgmma_tf32<DHP>(part, ph[kk], kmajor<DHP>(vl, 0, kk), 1);
    wgmma_tf32<DHP>(part, ph[kk], kmajor<DHP>(vh, 0, kk), 1);
  }
  wg_commit();
}

// P's A fragments for P V, split: k-step n is the score tile n, whose
// registers (keys 2t, 2t + 1 of rows g, g + 8) are A's columns t, t + 4
// under V^T's key order.
template <int NS>
__device__ __forceinline__ void split_p(uint32_t (*ph)[4], uint32_t (*pl)[4],
                                        const float (*p)[4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    split(p[n][0], ph[n][0], pl[n][0]);
    split(p[n][2], ph[n][1], pl[n][1]);
    split(p[n][1], ph[n][2], pl[n][2]);
    split(p[n][3], ph[n][3], pl[n][3]);
  }
}

// o (f32, through its strides) and, when lse is not null, each row's
// m + log2(l), for one 128-row query tile of one (batch item, head).
template <int DHP>
__global__ void __launch_bounds__(FT_NT, 1)
fwd_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mkh,
                const __grid_constant__ CUtensorMap mkl,
                const __grid_constant__ CUtensorMap mvh,
                const __grid_constant__ CUtensorMap mvl,
                float* __restrict__ o, Strides os, int H, int KV, int Sq,
                int Skv, int dh, int causal, int window, float scale_log2,
                float* __restrict__ lse) {
  using L = FwdF32Smem<DHP>;
  constexpr int KEYS = L::KEYS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const kfull = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* const kempty = kfull + FT_STAGES;
  uint64_t* const vfull = kempty + FT_STAGES;
  uint64_t* const vempty = vfull + FT_STAGES;
  uint64_t* const q_full = vempty + FT_STAGES;

  // Block order (a 1-d grid): heads in groups of FT_HEAD_GROUP, all query
  // tiles of a group's heads together, the heaviest first (as the bf16
  // kernel's; a split kv head's K and V^T take 4 MB at S = 2048, dh = 128).
  const int tid = threadIdx.x;
  const int nq = (Sq + FT_QROWS - 1) / FT_QROWS;
  const int group = blockIdx.x / (FT_HEAD_GROUP * nq);
  const int in_group = blockIdx.x - group * FT_HEAD_GROUP * nq;
  const int heads =
      min(FT_HEAD_GROUP, gridDim.x / nq - group * FT_HEAD_GROUP);
  const int bh = group * FT_HEAD_GROUP + in_group % heads;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q_lo = (nq - 1 - in_group / heads) * FT_QROWS;
  const int q_hi = min(q_lo + FT_QROWS, Sq) - 1;
  const int n_kv = (Skv + KEYS - 1) / KEYS;
  const int j_end = causal ? min(n_kv, q_hi / KEYS + 1) : n_kv;
  const int j_begin =
      window > 0 ? min(max(0, q_lo - window + 1) / KEYS, j_end) : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < FT_STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 8);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 8);
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
      tma_tile<DHP, FT_QROWS, 4>(sm + L::Q, &mq, q_lo, h, b, q_full);
      for (int j = j_begin; j < j_end; ++j) {
        const int n = j - j_begin, s = n % FT_STAGES;
        const uint32_t ph = (n / FT_STAGES) & 1;
        unsigned char* kt = sm + L::K + s * 2 * L::TK;
        mbar_wait(&kempty[s], ph ^ 1);
        mbar_expect_tx(&kfull[s], 2 * L::TK);
        tma_tile<DHP, KEYS, 4, KEYS>(kt, &mkh, j * KEYS, kvh, b, &kfull[s]);
        tma_tile<DHP, KEYS, 4, KEYS>(kt + L::TK, &mkl, j * KEYS, kvh, b,
                                     &kfull[s]);
        unsigned char* vt = sm + L::V + s * 2 * L::TK;
        mbar_wait(&vempty[s], ph ^ 1);
        mbar_expect_tx(&vfull[s], 2 * L::TK);
        tma_vt_tile<DHP, KEYS>(vt, &mvh, j * KEYS, kvh, b, &vfull[s]);
        tma_vt_tile<DHP, KEYS>(vt + L::TK, &mvl, j * KEYS, kvh, b,
                               &vfull[s]);
      }
    }
  } else {                               // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    constexpr int NO = DHP / 8;          // n8 output tiles
    constexpr int NS = KEYS / 8;         // n8 score tiles, k-steps of P V
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw_lo = q_lo + 64 * wg;    // this warpgroup's 64 rows
    const int qw_hi = min(qw_lo + 63, Sq - 1);
    const int row0 = qw_lo + 16 * warp + g;   // this thread's rows (+ 8)
    // the block's tiles [j_begin, j_end) that these rows see: [jw_begin,
    // jw_end); the others only have their stages freed
    const int jw_end =
        qw_lo >= Sq ? j_begin
                    : max(j_begin, causal ? min(j_end, qw_hi / KEYS + 1)
                                          : j_end);
    const int jw_begin =
        window > 0 ? min(max(j_begin, max(0, qw_lo - window + 1) / KEYS),
                         jw_end)
                   : j_begin;
    const unsigned char* tq = sm + L::Q;
    const int r0 = 64 * wg + 16 * warp;  // this warp's rows of the Q tile
    // tile n (counted from j_begin): its K stage (hi; lo TK on) and V^T's
    auto k_at = [&](int n) {
      return smem_addr(sm + L::K + (n % FT_STAGES) * 2 * L::TK);
    };
    auto v_at = [&](int n) {
      return smem_addr(sm + L::V + (n % FT_STAGES) * 2 * L::TK);
    };
    auto wait_k = [&](int n) {
      mbar_wait(&kfull[n % FT_STAGES], (n / FT_STAGES) & 1);
    };
    auto wait_v = [&](int n) {
      mbar_wait(&vfull[n % FT_STAGES], (n / FT_STAGES) & 1);
    };
    auto skip = [&](int n) {             // a tile these rows do not see
      wait_k(n);
      wait_v(n);
      release(&kempty[n % FT_STAGES], lane);
      release(&vempty[n % FT_STAGES], lane);
    };
    float acc[NO][4], part[NO][4], sc[NS][4], small[NS][4], alpha[2];
    uint32_t ph[NS][4], pl[NS][4];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    zero<NO>(acc);

    // Per tile n: S(n) and P V(n - 1) issued together; S(n)'s wait, the
    // K stage freed, the softmax (pinned) while P V(n - 1) runs; then its
    // wait, the V stage freed, O = (O + part) alpha(n) in f32 (each tile's
    // P V in fresh accumulators: the tensor cores add into an accumulator
    // by truncation, and a chain through every tile drifts), P(n) split.
    // No product is left in flight across the loop's back edge.
    mbar_wait(q_full, 0);
    int n = 0;
    for (int j = j_begin; j < jw_begin; ++j, ++n) skip(n);
    if (jw_begin < jw_end) {
      wait_k(n);
      issue_scores_f32<DHP, KEYS>(sc, small, tq, r0, k_at(n),
                                  k_at(n) + L::TK, g, t);
      wg_wait<0>();
      pin<NS>(sc);
      pin<NS>(small);
      release(&kempty[n % FT_STAGES], lane);
      add<NS>(sc, small);
      softmax_pinned<NS>(
          sc, m, l, alpha,
          edge_tile<KEYS>(jw_begin * KEYS, qw_lo, qw_hi, Skv, causal,
                          window),
          row0, jw_begin * KEYS, t, Skv, causal, window, scale_log2);
      split_p<NS>(ph, pl, sc);
      int np = n++;                      // the tile P V still has to run
      for (int j = jw_begin + 1; j < jw_end; ++j, ++n) {
        wait_k(n);
        wait_v(np);
        issue_scores_f32<DHP, KEYS>(sc, small, tq, r0, k_at(n),
                                    k_at(n) + L::TK, g, t);
        issue_pv_f32<DHP, NS>(part, ph, pl, v_at(np), v_at(np) + L::TK);
        wg_wait<1>();                    // S(n) is in; P V(n - 1) runs on
        pin<NS>(sc);
        pin<NS>(small);
        release(&kempty[n % FT_STAGES], lane);
        add<NS>(sc, small);
        softmax_pinned<NS>(
            sc, m, l, alpha,
            edge_tile<KEYS>(j * KEYS, qw_lo, qw_hi, Skv, causal, window),
            row0, j * KEYS, t, Skv, causal, window, scale_log2);
        wg_wait<0>();
        pin<NO>(part);
        release(&vempty[np % FT_STAGES], lane);
        add<NO>(acc, part);
        rescale<NO>(acc, alpha);
        split_p<NS>(ph, pl, sc);
        np = n;
      }
      wait_v(np);
      issue_pv_f32<DHP, NS>(part, ph, pl, v_at(np), v_at(np) + L::TK);
      wg_wait<0>();
      pin<NO>(part);
      release(&vempty[np % FT_STAGES], lane);
      add<NO>(acc, part);
    }
    for (int j = jw_end; j < j_end; ++j, ++n) skip(n);

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
    float* op = o + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= Sq) continue;
      float* row = op + qi * os.s;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        const int d = nt * 8 + 2 * t;    // dh % 4 == 0: d < dh => d + 1 < dh
        if (d < dh)
          *reinterpret_cast<float2*>(row + d) = make_float2(
              acc[nt][2 * r] / l[r], acc[nt][2 * r + 1] / l[r]);
      }
    }
  }
}

template <int DHP>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, float* scratch, int B, int H, int KV,
                       int Sq, int Skv, int dh, const Strides* st, int causal,
                       int window, float scale_log2, float* lse,
                       cudaStream_t stream) {
  using L = FwdF32Smem<DHP>;
  constexpr int smem = L::BYTES;
  // the shared-memory limit is set once per process and device
  static int attributes_set = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (attributes_set != device) {
    err = cudaFuncSetAttribute(fwd_tf32_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    attributes_set = device;
  }
  // scratch: k hi, k lo ((B, KV, Skv, dh) each), then v^T hi, v^T lo
  // ((B, KV, dh, skvp) each)
  const int skvp = (Skv + 7) & ~7;
  const long long nk = (long long)B * KV * Skv * dh;
  const long long nv = (long long)B * KV * dh * skvp;
  float* kh = scratch;
  float* kl = kh + nk;
  float* vh = kl + nk;
  float* vl = vh + nv;
  const Strides ks{(long long)KV * Skv * dh, (long long)Skv * dh, dh};
  const Strides vs{(long long)KV * dh * skvp, (long long)dh * skvp, skvp};
  CUtensorMap mq, mkh, mkl, mvh, mvl;
  if (!encode_rows(&mq, q, B, H, Sq, dh, st[0], 4) ||
      !encode_rows(&mkh, kh, B, KV, Skv, dh, ks, 4, L::KEYS) ||
      !encode_rows(&mkl, kl, B, KV, Skv, dh, ks, 4, L::KEYS) ||
      !encode_rows(&mvh, vh, B, KV, dh, skvp, vs, 4, DHP) ||
      !encode_rows(&mvl, vl, B, KV, dh, skvp, vs, 4, DHP))
    return cudaErrorInvalidValue;
  split_kv_kernel<<<dim3(B * KV, (Skv + SPLIT_ROWS - 1) / SPLIT_ROWS),
                    SPLIT_NT, 0, stream>>>(k, v, kh, kl, vh, vl, KV, Skv,
                                           skvp, dh, st[1], st[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fwd_tf32_kernel<DHP>
      <<<B * H * ((Sq + FT_QROWS - 1) / FT_QROWS), FT_NT, smem, stream>>>(
          mq, mkh, mkl, mvh, mvl, o, st[3], H, KV, Sq, Skv, dh, causal,
          window, scale_log2, lse);
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
// f32: q is read by TMA and o written in pairs, so dh must be a multiple
// of 4 and every row of q and o must start on 16 bytes (each base
// pointer, and each stride over an axis of more than one entry a positive
// multiple of 4): cudaErrorInvalidValue and cudaErrorMisalignedAddress
// otherwise (the wrapper pads dh and copies other inputs first). k and v
// are read through their strides by the split pass into `scratch`: f32
// scratch of 2 B KV Skv dh + 2 B KV dh ceil(Skv / 8) 8 floats, 16-byte
// aligned (k as hi and lo, v transposed as hi and lo).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int dh,
                        const long long* strides, int causal, int window,
                        float scale_log2, void* scratch, void* lse,
                        void* stream) {
  if (!valid(B, H, KV, Sq, Skv, dh, window, FT_QROWS) || dh % 4 != 0 ||
      (long long)B * H * ((Sq + FT_QROWS - 1) / FT_QROWS) > 2147483647LL ||
      (Skv + SPLIT_ROWS - 1) / SPLIT_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  read_strides(strides, st);
  if (!tma_rows(q, B, H, Sq, st[0], 4) || !tma_rows(o, B, H, Sq, st[3], 4) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(o);
  float* sc = static_cast<float*>(scratch);
  float* ll = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dh <= 64 ? launch_f32<64>(qq, kk, vv, oo, sc, B, H, KV, Sq,
                                         Skv, dh, st, causal, window,
                                         scale_log2, ll, s)
                        : launch_f32<128>(qq, kk, vv, oo, sc, B, H, KV, Sq,
                                          Skv, dh, st, causal, window,
                                          scale_log2, ll, s));
}

// bf16: q, k and v are read by TMA and o is written in pairs, so dh must
// be a multiple of 8 and every row of q, k, v and o must start on 16
// bytes (each base pointer, and each stride over an axis of more than one
// entry a positive multiple of 8): cudaErrorInvalidValue and
// cudaErrorMisalignedAddress otherwise. The wrapper pads dh and copies
// other inputs first. `scratch` is not read (null).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int Sq, int Skv, int dh,
                         const long long* strides, int causal, int window,
                         float scale_log2, void* scratch, void* lse,
                         void* stream) {
  (void)scratch;
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
