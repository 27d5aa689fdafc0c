// Backward pass of blocked online-softmax attention (FlashAttention) for
// Hopper (sm_90a), with every product a warpgroup `wgmma` on tiles that
// TMA brings into shared memory: f32 inputs in split TF32
// (`flash_attention_bwd_f32`), bf16 inputs in bf16
// (`flash_attention_bwd_bf16`, at the end of this header).
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
// p = exp2(s * scale * log2(e) - lse). do (B, H, Sq, dh). Strides over
// (batch, head, sequence), unit stride over dh; q and do (bf16: and k, v)
// are read by TMA, so their rows start on 16 bytes. Outputs dq (B, H, Sq,
// dh), dk and dv (B, KV, Skv, dh), contiguous; f32 scratch for the centred
// keys, the row terms per query tile and the key means.
//
// f32 (`flash_attention_bwd_f32`). Arithmetic: split TF32 ("3xTF32"), as
// the graph filter's: each f32 operand x is x_hi + x_lo with x_hi =
// tf32(x) and x_lo = tf32(x - x_hi), both rounded to nearest (ties away) by
// an integer add and mask; each product is a_lo b_hi + a_hi b_lo + a_hi b_hi
// in f32 accumulators (the dropped a_lo b_lo is about 2^-22 of the
// product). No one-pass TF32 anywhere: it would miss chip_smoke.py's 1e-4
// gate (its control shows it).
//
// What bounds it: at the qwen3-4b training shape (B=4, H=32, KV=8,
// S=2048, dh=128, causal) the gradient needs five S x S x dh products per
// head over the live (i, j) pairs (S(S+1)/2 per head): q k^T and do v^T
// (to rebuild P and dP), P^T do (dv), dS^T q (dk) and dS k (dq),
// 10 B H dh S(S+1)/2 = 344 GFLOP: 2.08 ms as split TF32 on the tensor
// cores (three products each, 495 TFLOP/s), against about 0.6 GB of inputs
// and outputs (0.18 ms at 3.35 TB/s): bound by operations. The design
// rebuilds P and dP a second time for dq (seven products per live pair),
// so its own bound is 7/5 of that, 2.92 ms. So the products run on
// wgmma, the only way to the tensor cores' full TF32 rate (mma.sync's is
// about a quarter of it on this card).
//
// Design (f32):
//   * wgmma reads tf32 operands from shared memory K-major only (no
//     transposed read, which the bf16 design uses for P^T dO, dS^T q and
//     dS kc), and a split operand in shared memory takes twice its f32
//     bytes: 64 KB for a 64 x 128 tile, which a block of 227 KB cannot
//     hold many of. So every product takes its A operand from registers,
//     which any shared layout can feed: the streamed tiles (q and do, in
//     dq's kernel the resident ones) stay raw in shared memory, as TMA
//     writes them, and each thread splits its A fragments in registers
//     as it loads them, by rows (the scores) or by columns (the transposed
//     reads of the output products). Only B operands are split in shared
//     memory: the key tiles (kc, v), which a pass before the products
//     kernels writes split into scratch (hi and lo planes, so TMA brings
//     them split: splitting each tile in every block that loads it took
//     as much shared-memory traffic and issue as the products), and P and
//     dS, which the consumers write split in the K-major layout the output
//     products read. Within each k-step of 8 the A fragment's column t
//     reads row 2t of its tile and t + 4 row 2t + 1, and P and dS are
//     written in the same order: the fragment loads and the writes are then
//     free of bank conflicts under the 128-byte swizzle.
//   * the output products run with dh as M (dv^T = dO^T P, dk^T = Q^T dS,
//     dq^T = KC^T dS^T): their A operands are the transposed streamed
//     tiles, their B operands P and dS. The two consumer warpgroups share
//     each tile: consumer 0 computes the scores S = Q KC^T and P, consumer 1
//     dP = dO V^T and dS = P (dP - delta) (P handed over in shared memory),
//     each 64 query rows x KEYS keys. In dk/dv consumer 0 then runs dv's
//     product and consumer 1 dk's, whole, so neither waits on the other's
//     elementwise work but for P: one's runs under the other's products.
//     In dq each runs half of dq's product: dh rows 64 c .. at dh = 128;
//     at dh = 64 (one M tile) half its k-steps, the two partial sums added
//     once at the end. Named barriers order the hand-overs.
//   * KEYS = 64 at dh <= 64, so every product is a wgmma of N = 64: one of
//     N = 32 took about as long on the H100 (with 32 keys whisper's
//     shapes ran slower than the mma.sync kernel before this design). At
//     dh = 128 split tiles of 64 keys do not fit beside the rest, so
//     KEYS = 32 there.
//   * each tile's output part is summed in fresh accumulators (the first
//     wgmma of the tile with scale-d 0) and added to the running f32 sums
//     in registers: the tensor cores add into an accumulator with
//     truncation, so a sum chained through every tile of the loop drifts
//     toward the 1e-4 gate at the qwen3-4b shape, as the mma.sync design
//     before this one found); a tile's chain is 12 (dq) or 24 (dk, dv)
//     adds of 8 products.
//   * `dkdv_tf32_kernel`: a block per (batch item x kv head, KEYS keys), KC
//     and V (hi and lo) loaded once, the query tiles of 64 rows of the G
//     heads in a ring of TF_STAGES stages (Q, dO and the tile's shifted
//     lse and delta by one bulk copy), first to last key block so the
//     heaviest causal blocks start first.
//   * `dq_tf32_kernel`: a block per (batch item x head, 64 query rows), Q
//     and dO loaded once, key tiles of KEYS (KC and V, hi and lo) in the
//     ring, the heaviest query tiles first. It
//     rebuilds S and dP: a dq that reused the dk/dv kernel's dS would need
//     float atomics or a partial per key tile (S / KEYS times dq's size).
//   * blocks of three warpgroups: two consumers and a producer whose first
//     thread issues every copy (TMA boxes of 128 bytes x 64 or 32 rows,
//     the 128-byte swizzle that the wgmma descriptors name; a dh = 128
//     row is four column blocks) and waits on `mbarrier`s for a stage to
//     come free; `setmaxnreg` moves registers from the producer to the
//     consumers (24 and 240 at dh = 128, 40 and 232 at dh = 64: the split
//     that spills nowhere in each instance). Rows and columns past the
//     tensors land as zeros (TMA's fill); masks apply per element on edge
//     tiles only.
//   * no float atomics, so a rerun is bit-equal. dk and dv are summed by
//     the block that owns a key tile; dq by the block that owns a query
//     tile.
//   * the products read the keys centred on their mean over the kv head
//     (the key means in two passes over chunks of 64 keys, then
//     `split_keys` writes kc = k - kmean and v, split), and P is rebuilt
//     from the log-sum-exp
//     shifted to match, lse - q_i . kmean scale_log2 (the delta pass
//     computes it beside delta, per query tile of 64 rows for one bulk
//     copy): softmax ignores a shift of a score row, so dq, dk and dv are
//     the same analytically, and dq = sum_j dS_ij (k_j - kmean) because
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
//     dk is projected onto that identity last: the key means and `centre`
//     again, on dk in place (dk_j - mean_j dk_j).
//   * the wrapper makes q and do legal for TMA (rows on 16 bytes, dh a
//     multiple of 4) by padding or a copy; this entry refuses others.
//     dh <= 64 runs the 64-wide instance, 64 < dh <= 128 the 128-wide one.
//   * shared memory at dh = 128: dk/dv 4 x 16 KB (KC and V, hi and lo) + 2
//     stages x 64 KB (Q, dO) + 4 x 8 KB (P^T and dS^T, hi and lo) + 1 KB of
//     lse/delta = 225 KB; dq 2 x 32 KB (Q, dO) + 2 stages x 64 KB (KC and
//     V, hi and lo) + 2 x 8 KB (dS, hi and lo) = 208 KB; at dh = 64 (64
//     keys) 193 and 192 KB (one block of 384 threads per SM).
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
//   * the TMA, mbarrier and wgmma helpers are those of kernels/csrc/
//     hopper.cuh, shared with the forward (flash_attention.cu) and the wkv
//     kernels.
//   * shared memory at dh = 128: dkdv 2 x 32 KB (K, V) + 2 stages x 32 KB
//     (Q, dO) + 1 KB of lse/delta = 129 KB; dq 2 x 32 KB (Q, dO) + 2
//     stages x 48 KB (K, V, KC) = 160 KB (one block of 384 threads per SM).


#include "../../csrc/hopper.cuh"

namespace {

constexpr int DELTA_NT = 256;
constexpr int CENTRE_NT = 256;
constexpr int CENTRE_ROWS = 16;          // key rows per centring block
constexpr int BW_QT = 64;                // query rows per row-term tile
constexpr int LSED_TILE = 2 * BW_QT;     // floats: a tile's lse, then delta

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// dk less its mean over the keys, in place (contiguous (B, KV, Skv, dh);
// the f32 entry's last pass; the bf16 entry rounds in its own,
// `centre8_kernel`). One block per (batch item x kv head, CENTRE_ROWS
// keys).
__global__ void __launch_bounds__(CENTRE_NT)
centre_kernel(float* __restrict__ dk, const float* __restrict__ kmean,
              int Skv, int dh) {
  const float* km = kmean + (long long)blockIdx.x * dh;
  float* out = dk + (long long)blockIdx.x * Skv * dh;
  const int j0 = blockIdx.y * CENTRE_ROWS;
  for (int e = threadIdx.x; e < CENTRE_ROWS * dh; e += CENTRE_NT) {
    const int j = j0 + e / dh, d = e - (e / dh) * dh;
    if (j < Skv) out[(long long)j * dh + d] -= km[d];
  }
}

// The key means (of k, then of dk's f32 sums) in two deterministic passes
// that fill the card: partial column sums over chunks of KMEAN_ROWS keys,
// part (B KV, ceil(Skv / KMEAN_ROWS), dh), one thread per column summing
// its chunk's rows in order; then kmean_sum_kernel adds a (batch item, kv
// head)'s partials in order. Grid (B KV, chunks).
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

// ---- f32: split TF32 on wgmma, TMA tiles, a producer warpgroup ----

constexpr int TF_NT = 384;           // consumer warpgroups 0, 1; producer 2
// setmaxnreg: the producer warpgroup's registers and each consumer
// thread's, which must sum to the 3 x 168 the launch gives each thread
// (more makes the consumers' increase wait forever). dq's pipeline spills
// at dh = 128 with 232, and at dh = 64 the producer's loop with 24.
template <int DHP>
__host__ __device__ constexpr int tf_producer_regs() {
  return DHP == 64 ? 40 : 24;
}
template <int DHP>
__host__ __device__ constexpr int tf_consumer_regs() {
  return DHP == 64 ? 232 : 240;
}
constexpr int TF_QROWS = 64;         // query rows per dq block and per
                                     // staged dk/dv query tile
// Keys per dk/dv block and per dq key tile: 64 at dh <= 64, so every
// product has N = 64 (on the H100 a tf32 wgmma of N = 32 took about as
// long as one of 64); 32 at dh = 128, where split tiles of 64 keys would
// not fit.
template <int DHP>
__host__ __device__ constexpr int tf_keys() {
  return DHP == 64 ? 64 : 32;
}
// How the two consumers share an output product (dh rows as M): at dh =
// 128 consumer c takes dh rows 64 c .. 64 c + 63; at dh <= 64 (one M tile)
// it takes half the product's k-steps, and the two partial sums are added
// at the end (consumer 0's, then consumer 1's).
template <int DHP>
__host__ __device__ constexpr bool m_split() {
  return DHP == 128;
}
constexpr int TF_STAGES = 2;         // depth of the staged-tile rings

// The split key tiles both products kernels read as B operands:
// kc = k - kmean and v, each as hi and lo (contiguous (B, KV, Skv, dh)
// planes in scratch), so TMA brings them split and no block splits a tile.
// One block per (batch item x kv head, CENTRE_ROWS keys).
__global__ void __launch_bounds__(CENTRE_NT)
split_keys_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ kmean, float* __restrict__ kch,
                  float* __restrict__ kcl, float* __restrict__ vh,
                  float* __restrict__ vl, int KV, int Skv, int dh, Strides ks,
                  Strides vs) {
  const int b = blockIdx.x / KV, kvh = blockIdx.x - b * KV;
  const float* kp = k + b * ks.b + kvh * ks.h;
  const float* vp = v + b * vs.b + kvh * vs.h;
  const float* km = kmean + (long long)blockIdx.x * dh;
  const long long base = (long long)blockIdx.x * Skv * dh;
  const int j0 = blockIdx.y * CENTRE_ROWS;
  for (int e = threadIdx.x; e < CENTRE_ROWS * dh; e += CENTRE_NT) {
    const int j = j0 + e / dh, d = e - (e / dh) * dh;
    if (j >= Skv) break;
    const long long o = base + (long long)j * dh + d;
    uint32_t hi, lo;
    split(kp[j * ks.s + d] - km[d], hi, lo);
    kch[o] = __uint_as_float(hi);
    kcl[o] = __uint_as_float(lo);
    split(vp[j * vs.s + d], hi, lo);
    vh[o] = __uint_as_float(hi);
    vl[o] = __uint_as_float(lo);
  }
}

// The A fragment of the transposed tile: A row m is tile column c0 + m, A
// column t tile row r0 + 2t and column t + 4 row r0 + 2t + 1 (the k-step's
// rows interleaved, as P and dS are written: `kperm`). Raw, split here.
template <int R>
__device__ __forceinline__ void frag_cols(uint32_t* ah, uint32_t* al,
                                          const unsigned char* tile, int r0,
                                          int c0, int g, int t) {
  split(lds(tile, sw_f32<R>(r0 + 2 * t, c0 + g)), ah[0], al[0]);
  split(lds(tile, sw_f32<R>(r0 + 2 * t, c0 + g + 8)), ah[1], al[1]);
  split(lds(tile, sw_f32<R>(r0 + 2 * t + 1, c0 + g)), ah[2], al[2]);
  split(lds(tile, sw_f32<R>(r0 + 2 * t + 1, c0 + g + 8)), ah[3], al[3]);
}
// The same from a tile already split (hi and lo tiles).
template <int R>
__device__ __forceinline__ void frag_cols_split(uint32_t* ah, uint32_t* al,
                                                const unsigned char* hi,
                                                const unsigned char* lo,
                                                int r0, int c0, int g,
                                                int t) {
  const int o0 = sw_f32<R>(r0 + 2 * t, c0 + g);
  const int o1 = sw_f32<R>(r0 + 2 * t, c0 + g + 8);
  const int o2 = sw_f32<R>(r0 + 2 * t + 1, c0 + g);
  const int o3 = sw_f32<R>(r0 + 2 * t + 1, c0 + g + 8);
  ah[0] = ldu(hi, o0), al[0] = ldu(lo, o0);
  ah[1] = ldu(hi, o1), al[1] = ldu(lo, o1);
  ah[2] = ldu(hi, o2), al[2] = ldu(lo, o2);
  ah[3] = ldu(hi, o3), al[3] = ldu(lo, o3);
}
// c = A B for the warpgroup over NK k-steps of 8 in split TF32 (c is a
// fresh accumulator: the first wgmma has scale-d 0): per k-step lo.hi,
// hi.lo, hi.hi, A's fragments from `frag(kk, hi, lo)`, B's hi and lo by
// descriptor from `bh(kk)` and `bl(kk)`. The fragments come in batches of
// BK k-steps (four, or fewer where registers are short) into two register
// buffers: batch b + 1 is loaded (its shared-memory latency and its
// splits) while batch b's products run, and one fence covers a batch.
// Leaves the last batch's group in flight: the caller waits.
template <int N, int NK, int BK_MAX = 4, typename Frag, typename DescH,
          typename DescL>
__device__ __forceinline__ void rs_product(float (*c)[4], Frag frag,
                                           DescH bh, DescL bl) {
  constexpr int BK = NK < BK_MAX ? NK : BK_MAX;
  constexpr int NB = NK / BK;
  uint32_t fh[2][BK][4], fl[2][BK][4];
#pragma unroll
  for (int j = 0; j < BK; ++j) frag(j, fh[0][j], fl[0][j]);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kk = b * BK + j;
      wgmma_tf32<N>(c, fl[b & 1][j], bh(kk), kk > 0);
      wgmma_tf32<N>(c, fh[b & 1][j], bl(kk), 1);
      wgmma_tf32<N>(c, fh[b & 1][j], bh(kk), 1);
    }
    wg_commit();
    if (b + 1 < NB) {
      wg_wait<1>();                      // batch b - 1 has read its buffer
#pragma unroll
      for (int j = 0; j < BK; ++j)
        frag((b + 1) * BK + j, fh[(b + 1) & 1][j], fl[(b + 1) & 1][j]);
    }
  }
}

// The scores' product of one tile, 64 query rows x KEYS keys into s:
// A from the raw rows of `ta` (Q or dO, TF_QROWS rows: this warp's 16),
// B the split key tile (hi at bh, lo at bl: KC or V).
template <int DHP>
__device__ __forceinline__ void scores(float (*s)[4],
                                       const unsigned char* ta, uint32_t bh,
                                       uint32_t bl, int warp, int g, int t) {
  constexpr int KEYS = tf_keys<DHP>();
  rs_product<KEYS, DHP / 8>(
      s,
      [&](int kk, uint32_t* h, uint32_t* l) {
        frag_rows<TF_QROWS>(h, l, ta, 16 * warp, 8 * kk, g, t);
      },
      [&](int kk) { return kmajor<KEYS>(bh, 0, kk); },
      [&](int kk) { return kmajor<KEYS>(bl, 0, kk); });
  wg_wait<0>();
  pin<KEYS / 8>(s);
}

// Whether key kj is live for query qi under the masks.
__device__ __forceinline__ bool live_pair(int qi, int kj, int Sq, int Skv,
                                          int causal, int window) {
  return qi < Sq && kj < Skv && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

// The f32 entry's row terms in the bf16 entry's tile layout (lsed: (B H,
// ceil(Sq / 64), {lse, delta}, 64) floats, rows from Sq on zero): delta =
// rowsum(do o) and the log-sum-exp shifted to the centred keys,
// lse - q . kmean scale_log2. One warp per row; grid (B H, ceil(Sq / 64) 8).
__global__ void __launch_bounds__(DELTA_NT)
delta_f32_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                 const float* __restrict__ q, const float* __restrict__ lse,
                 const float* __restrict__ kmean, float* __restrict__ lsed,
                 int H, int KV, int Sq, int dh, Strides os, Strides gs,
                 Strides qs, float scale_log2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.y * (DELTA_NT / 32) + warp;
  const int b = blockIdx.x / H, h = blockIdx.x - (blockIdx.x / H) * H;
  float acc = 0.f, c = 0.f;
  if (i < Sq) {                          // warp-uniform
    const float* orow = o + b * os.b + h * os.h + i * os.s;
    const float* grow = dO + b * gs.b + h * gs.h + i * gs.s;
    const float* qrow = q + b * qs.b + h * qs.h + i * qs.s;
    const float* km = kmean + ((long long)b * KV + h / (H / KV)) * dh;
    for (int d = lane; d < dh; d += 32) {
      acc = fmaf(orow[d], grow[d], acc);
      c = fmaf(qrow[d], km[d], c);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    const int n_q = (Sq + BW_QT - 1) / BW_QT;
    float* dst = lsed + ((long long)blockIdx.x * n_q + i / BW_QT) *
                            LSED_TILE + (i % BW_QT);
    dst[0] = i < Sq ? lse[(long long)blockIdx.x * Sq + i] - c * scale_log2
                    : 0.f;
    dst[BW_QT] = acc;
  }
}

// Shared memory of the f32 dk/dv kernel (byte offsets from a 1024-byte
// aligned base): KC and V split (hi, lo: KEYS rows each), the rings of
// raw Q and dO tiles (TF_QROWS rows), P^T and dS^T split (KEYS rows x
// TF_QROWS columns, K-major), the ring of lse/delta pairs, the barriers.
template <int DHP>
struct DkdvF32Smem {
  static constexpr int KEYS = tf_keys<DHP>();
  static constexpr int TK = KEYS * DHP * 4;
  static constexpr int TQ = TF_QROWS * DHP * 4;
  static constexpr int TT = KEYS * TF_QROWS * 4;
  static constexpr int KH = 0, KL = TK, VH = 2 * TK, VL = 3 * TK;
  static constexpr int Q = 4 * TK, DO = Q + TF_STAGES * TQ;
  static constexpr int PH = DO + TF_STAGES * TQ, PL = PH + TT;
  static constexpr int DH = PL + TT, DL = DH + TT;
  static constexpr int LD = DL + TT;
  static constexpr int BAR = LD + TF_STAGES * LSED_TILE * 4;
  static constexpr int BYTES = BAR + 8 * (2 * TF_STAGES + 2) + 1024;
};

// dk (times scale) and dv of one tile of KEYS keys of one (batch item,
// kv head). The producer's first thread loads KC and V (hi and lo) once,
// then keeps the query tiles of the G heads in flight (Q, dO, lse/delta
// into a ring: full[s] completes when a stage's bytes land, empty[s] when
// the eight consumer warps are done with it). Per query tile, consumer 0:
// S = Q KC^T, P into P^T (split), then dv^T += dO^T P; consumer 1:
// dP = dO V^T, dS = P (dP - delta) from P^T's hi + lo into dS^T (split),
// then dk^T += Q^T dS. Named barrier 1 hands P over, 2 hands P^T back.
template <int DHP>
__global__ void __launch_bounds__(TF_NT, 1)
dkdv_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mkch,
                 const __grid_constant__ CUtensorMap mkcl,
                 const __grid_constant__ CUtensorMap mvh,
                 const __grid_constant__ CUtensorMap mvl,
                 const __grid_constant__ CUtensorMap mdo,
                 const float* __restrict__ lsed, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int KV, int Sq, int Skv,
                 int dh, int causal, int window, float scale_log2,
                 float scale) {
  using L = DkdvF32Smem<DHP>;
  constexpr int KEYS = L::KEYS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* const empty = full + TF_STAGES;
  uint64_t* const kv_full = empty + TF_STAGES;

  const int tid = threadIdx.x;
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int k_lo = blockIdx.y * KEYS;   // first to last: heaviest first
  const int k_hi = min(k_lo + KEYS, Skv) - 1;
  const int n_q = (Sq + TF_QROWS - 1) / TF_QROWS;
  const int i_begin = causal ? min(k_lo / TF_QROWS, n_q) : 0;
  const int i_end =
      window > 0 ? min(n_q, (k_hi + window - 1) / TF_QROWS + 1) : n_q;
  const int per_head = max(i_end - i_begin, 0);
  const int n_tiles = G * per_head;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
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
        tf_producer_regs<DHP>()));
    if (tid == 256) {
      mbar_expect_tx(kv_full, 4 * L::TK);
      tma_tile<DHP, KEYS, 4, KEYS>(sm + L::KH, &mkch, k_lo, kvh, b, kv_full);
      tma_tile<DHP, KEYS, 4, KEYS>(sm + L::KL, &mkcl, k_lo, kvh, b, kv_full);
      tma_tile<DHP, KEYS, 4, KEYS>(sm + L::VH, &mvh, k_lo, kvh, b, kv_full);
      tma_tile<DHP, KEYS, 4, KEYS>(sm + L::VL, &mvl, k_lo, kvh, b, kv_full);
      int s = 0;
      uint32_t ph = 0;
      for (int n = 0; n < n_tiles; ++n) {
        mbar_wait(&empty[s], ph ^ 1);
        const int h = kvh * G + n / per_head;
        const int qt = i_begin + n % per_head;
        mbar_expect_tx(&full[s], 2 * L::TQ + LSED_TILE * 4);
        tma_tile<DHP, TF_QROWS, 4>(sm + L::Q + s * L::TQ, &mq,
                                   qt * TF_QROWS, h, b, &full[s]);
        tma_tile<DHP, TF_QROWS, 4>(sm + L::DO + s * L::TQ, &mdo,
                                   qt * TF_QROWS, h, b, &full[s]);
        bulk_copy(sm + L::LD + s * LSED_TILE * 4,
                  lsed + ((long long)(b * H + h) * n_q + qt) * LSED_TILE,
                  LSED_TILE * 4, &full[s]);
        if (++s == TF_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {                               // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        tf_consumer_regs<DHP>()));
    // consumer 0: S, P and dv; consumer 1: dP, dS and dk. Each output
    // product covers every dh row (MT row blocks of 64) and the block's
    // KEYS keys, over the tile's 64 query rows.
    constexpr int MT = DHP / 64;
    constexpr int NO = KEYS / 8;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t sbh = smem_addr(sm + (wg == 0 ? L::KH : L::VH));
    const uint32_t sbl = sbh + L::TK;
    const uint32_t sth = smem_addr(sm + (wg == 0 ? L::PH : L::DH));
    const uint32_t stl = smem_addr(sm + (wg == 0 ? L::PL : L::DL));
    float acc[MT][NO][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) zero<NO>(acc[mt]);
    mbar_wait(kv_full, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int n = 0; n < n_tiles; ++n) {
      mbar_wait(&full[s], ph);
      const int q_lo = (i_begin + n % per_head) * TF_QROWS;
      const int q_hi = min(q_lo + TF_QROWS, Sq) - 1;
      const bool edge = (causal && k_hi > q_lo) ||
                        (window > 0 && q_hi - k_lo >= window) ||
                        k_lo + KEYS > Skv || q_lo + TF_QROWS > Sq;
      const unsigned char* tQ = sm + L::Q + s * L::TQ;
      const unsigned char* tdO = sm + L::DO + s * L::TQ;
      const float* tL =
          reinterpret_cast<const float*>(sm + L::LD + s * LSED_TILE * 4);
      const float* tD = tL + BW_QT;

      // consumer 0: S = Q KC^T; consumer 1: dP = dO V^T (64 rows x KEYS)
      float sc[KEYS / 8][4];
      scores<DHP>(sc, wg == 0 ? tQ : tdO, sbh, sbl, warp, g, t);

      // query row 16 warp + g (+ 8), key 8 m + 2t (+ 1); P^T and dS^T lie
      // K-major (a key's row, the queries in kperm order)
      if (wg == 0) {                     // P into P^T, split
        if (n > 0) named_sync(2, 256);   // consumer 1 has read the last P
#pragma unroll
        for (int m = 0; m < KEYS / 8; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e >> 1);
            const int key = 8 * m + 2 * t + (e & 1);
            const bool live = !edge || live_pair(q_lo + row, k_lo + key, Sq,
                                                 Skv, causal, window);
            const int off = sw_f32<KEYS>(key, kperm(row));
            uint32_t hi, lo;
            split(live ? exp2f(sc[m][e] * scale_log2 - tL[row]) : 0.f, hi,
                  lo);
            *reinterpret_cast<uint32_t*>(sm + L::PH + off) = hi;
            *reinterpret_cast<uint32_t*>(sm + L::PL + off) = lo;
          }
        }
        fence_async_smem();
        named_sync(3, 128);              // all of P^T, for dv's product
        named_arrive(1, 256);            // and for consumer 1
      } else {                           // dS = P (dP - delta), split
        named_sync(1, 256);
#pragma unroll
        for (int m = 0; m < KEYS / 8; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e >> 1);
            const int key = 8 * m + 2 * t + (e & 1);
            const int off = sw_f32<KEYS>(key, kperm(row));
            sc[m][e] = (lds(sm + L::PH, off) + lds(sm + L::PL, off)) *
                       (sc[m][e] - tD[row]);
          }
        }
        if (n + 1 < n_tiles) named_arrive(2, 256);   // P^T read
#pragma unroll
        for (int m = 0; m < KEYS / 8; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e >> 1);
            const int key = 8 * m + 2 * t + (e & 1);
            const int off = sw_f32<KEYS>(key, kperm(row));
            uint32_t hi, lo;
            split(sc[m][e], hi, lo);
            *reinterpret_cast<uint32_t*>(sm + L::DH + off) = hi;
            *reinterpret_cast<uint32_t*>(sm + L::DL + off) = lo;
          }
        }
        fence_async_smem();
        named_sync(4, 128);              // all of dS^T, for dk's product
      }

      // dv^T += dO^T P (consumer 0) or dk^T += Q^T dS (consumer 1) over
      // the tile's 64 rows, each dh row block in fresh accumulators
      const unsigned char* ta = wg == 0 ? tdO : tQ;
      float part[MT][NO][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        rs_product<KEYS, TF_QROWS / 8>(
            part[mt],
            [&](int kk, uint32_t* h, uint32_t* l) {
              frag_cols<TF_QROWS>(h, l, ta, 8 * kk, 64 * mt + 16 * warp, g,
                                  t);
            },
            [&](int kk) { return kmajor<KEYS>(sth, 0, kk); },
            [&](int kk) { return kmajor<KEYS>(stl, 0, kk); });
      wg_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pin<NO>(part[mt]);
#pragma unroll
        for (int nt = 0; nt < NO; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == TF_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }

    // dv (consumer 0) or dk (consumer 1): dh row 64 mt + 16 warp + g
    // (+ 8), key 8 nt + 2t (+ 1)
    float* out = (wg == 0 ? dv : dk) + ((long long)b * KV + kvh) * Skv * dh;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 64 * mt + 16 * warp + g + 8 * (e >> 1);
          const int kj = k_lo + 8 * nt + 2 * t + (e & 1);
          if (kj < Skv && d < dh) out[(long long)kj * dh + d] =
              acc[mt][nt][e] * mul;
        }
      }
    }
  }
}

// Shared memory of the f32 dq kernel: raw Q and dO (TF_QROWS rows each),
// the ring of key tiles (KC and V, each hi and lo, KEYS rows), two pairs
// by tile parity of X (P, then dS's hi) and Y (dS's lo), TF_QROWS rows x
// KEYS columns, K-major, the barriers.
template <int DHP>
struct DqF32Smem {
  static constexpr int KEYS = tf_keys<DHP>();
  static constexpr int TQ = TF_QROWS * DHP * 4;
  static constexpr int TK = KEYS * DHP * 4;
  static constexpr int TX = TF_QROWS * KEYS * 4;
  static constexpr int Q = 0, DO = TQ, KS = 2 * TQ;
  static constexpr int X = KS + TF_STAGES * 4 * TK;
  static constexpr int BAR = X + 4 * TX;
  static constexpr int BYTES = BAR + 8 * (2 * TF_STAGES + 1) + 1024;
};

// dq (times scale) of one tile of TF_QROWS query rows of one (batch item,
// head). The producer's first thread loads Q and dO once, then keeps the
// key tiles (KC and V, hi and lo) in flight in a ring. Per key tile,
// consumer 0: S = Q KC^T and P into X; consumer 1: dP = dO V^T,
// dS = P (dP - delta) into X (hi) and Y (lo); then both dq^T += KC^T
// dS^T, each its share (`m_split`). X and Y come in two pairs by the
// tile's parity, so each consumer issues its product of the next tile (S
// or dP) before it waits on the other for this one: consumer 0's S runs
// under consumer 1's dS. Named barrier 1 hands P over, 2 hands dS back
// (consumer 1 is done with the pair of two tiles back once it has handed
// back the last dS, so no third barrier guards the pair).
template <int DHP>
__global__ void __launch_bounds__(TF_NT, 1)
dq_tf32_kernel(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mkch,
               const __grid_constant__ CUtensorMap mkcl,
               const __grid_constant__ CUtensorMap mvh,
               const __grid_constant__ CUtensorMap mvl,
               const __grid_constant__ CUtensorMap mdo,
               const float* __restrict__ lsed, float* __restrict__ dq, int H,
               int KV, int Sq, int Skv, int dh, int causal, int window,
               float scale_log2, float scale) {
  using L = DqF32Smem<DHP>;
  constexpr int KEYS = L::KEYS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* const empty = full + TF_STAGES;
  uint64_t* const q_full = empty + TF_STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * TF_QROWS;  // heaviest 1st
  const int q_hi = min(q_lo + TF_QROWS, Sq) - 1;
  const int n_kv = (Skv + KEYS - 1) / KEYS;
  const int j_end = causal ? min(n_kv, q_hi / KEYS + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) / KEYS : 0;
  const int n_tiles = max(j_end - j_begin, 0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
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
        tf_producer_regs<DHP>()));
    if (tid == 256) {
      mbar_expect_tx(q_full, 2 * L::TQ);
      tma_tile<DHP, TF_QROWS, 4>(sm + L::Q, &mq, q_lo, h, b, q_full);
      tma_tile<DHP, TF_QROWS, 4>(sm + L::DO, &mdo, q_lo, h, b, q_full);
      int s = 0;
      uint32_t ph = 0;
      for (int n = 0; n < n_tiles; ++n) {
        mbar_wait(&empty[s], ph ^ 1);
        const int k0 = (j_begin + n) * KEYS;
        unsigned char* st = sm + L::KS + s * 4 * L::TK;
        mbar_expect_tx(&full[s], 4 * L::TK);
        tma_tile<DHP, KEYS, 4, KEYS>(st, &mkch, k0, kvh, b, &full[s]);
        tma_tile<DHP, KEYS, 4, KEYS>(st + L::TK, &mkcl, k0, kvh, b, &full[s]);
        tma_tile<DHP, KEYS, 4, KEYS>(st + 2 * L::TK, &mvh, k0, kvh, b,
                                     &full[s]);
        tma_tile<DHP, KEYS, 4, KEYS>(st + 3 * L::TK, &mvl, k0, kvh, b,
                                     &full[s]);
        if (++s == TF_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {                               // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        tf_consumer_regs<DHP>()));
    // the output product's share of this consumer (`m_split`): dh rows
    // m0 .., k-steps (keys / 8) kk0 .. kk0 + NKO - 1
    constexpr int NO = TF_QROWS / 8;
    constexpr int NKO = m_split<DHP>() ? KEYS / 8 : KEYS / 16;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = m_split<DHP>() ? 64 * wg : 0;
    const int kk0 = m_split<DHP>() ? 0 : NKO * wg;
    const int n_q = (Sq + BW_QT - 1) / BW_QT;
    const long long bh = (long long)b * H + h;
    // the row terms of this warp's rows 16 warp + g (+ 8): the shifted lse
    // (consumer 0, for P), delta (consumer 1, for dS)
    float rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      rs[r] = lsed[(bh * n_q + q_lo / BW_QT) * LSED_TILE + wg * BW_QT + row];
    }
    const unsigned char* ta = sm + (wg == 0 ? L::Q : L::DO);
    auto stage = [&](int n) { return sm + L::KS + (n % TF_STAGES) * 4 * L::TK; };
    auto wait_full = [&](int n) {
      mbar_wait(&full[n % TF_STAGES], (n / TF_STAGES) & 1);
    };
    // X (P, then dS's hi) and Y (dS's lo) of tile n: two of each, by parity
    auto xbuf = [&](int n) { return sm + L::X + (n & 1) * 2 * L::TX; };
    float acc[NO][4];
    zero<NO>(acc);

    // this consumer's share of dq^T += KC^T dS^T over tile n's keys: issue
    // into part, then (after wg_wait) finish: add it and free the stage
    float part[NO][4];
    auto dq_issue = [&](int n) {
      const unsigned char* st = stage(n);
      const uint32_t sX = smem_addr(xbuf(n)), sY = sX + L::TX;
      rs_product<TF_QROWS, NKO>(
          part,
          [&](int kk, uint32_t* hh, uint32_t* ll) {
            frag_cols_split<KEYS>(hh, ll, st, st + L::TK, 8 * (kk0 + kk),
                                  m0 + 16 * warp, g, t);
          },
          [&](int kk) { return kmajor<TF_QROWS>(sX, 0, kk0 + kk); },
          [&](int kk) { return kmajor<TF_QROWS>(sY, 0, kk0 + kk); });
    };
    auto dq_finish = [&](int n) {
      pin<NO>(part);
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[n % TF_STAGES]);
    };
    auto key0 = [&](int n) { return (j_begin + n) * KEYS; };
    auto is_edge = [&](int k_lo) {
      return (causal && min(k_lo + KEYS, Skv) - 1 > q_lo) ||
             (window > 0 && q_hi - k_lo >= window) || k_lo + KEYS > Skv;
    };
    mbar_wait(q_full, 0);
    // Both consumers run the same code (their wgmma issues in no branch of
    // their own: ptxas serializes a warpgroup's products in divergent
    // code), with role-dependent operands: consumer 0 the scores S = Q KC^T
    // and P, consumer 1 dP = dO V^T and dS. Each issues its product for
    // tile n + 1 before waiting on the other for tile n, so consumer 0's S
    // of the next tile runs under consumer 1's dS. Row 16 warp + g (+ 8),
    // key 8 m + 2t (+ 1).
    float sc[KEYS / 8][4], sn[KEYS / 8][4];   // tile n's, tile n + 1's
    auto scores_of = [&](int n) {        // this consumer's B tile (hi)
      return smem_addr(stage(n)) + (wg == 0 ? 0 : 2 * L::TK);
    };
    if (n_tiles > 0) {
      wait_full(0);
      scores<DHP>(sc, ta, scores_of(0), scores_of(0) + L::TK, warp, g, t);
    }
    for (int n = 0; n < n_tiles; ++n) {
      unsigned char* const X = xbuf(n);
      unsigned char* const Y = X + L::TX;
      if (wg == 0) {                     // P of tile n into X
        const int k_lo = key0(n);
        const bool edge = is_edge(k_lo);
#pragma unroll
        for (int m = 0; m < KEYS / 8; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e >> 1);
            const int key = 8 * m + 2 * t + (e & 1);
            const bool live = !edge || live_pair(q_lo + row, k_lo + key,
                                                 Sq, Skv, causal, window);
            *reinterpret_cast<float*>(X + sw_f32<TF_QROWS>(row, kperm(key))) =
                live ? exp2f(sc[m][e] * scale_log2 - rs[e >> 1]) : 0.f;
          }
        }
        named_arrive(1, 256);
      } else {                           // dS = P (dP - delta), split
        named_sync(1, 256);
#pragma unroll
        for (int m = 0; m < KEYS / 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e >> 1);
            const int key = 8 * m + 2 * t + (e & 1);
            sc[m][e] = lds(X, sw_f32<TF_QROWS>(row, kperm(key))) *
                       (sc[m][e] - rs[e >> 1]);
          }
#pragma unroll
        for (int m = 0; m < KEYS / 8; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e >> 1);
            const int key = 8 * m + 2 * t + (e & 1);
            const int off = sw_f32<TF_QROWS>(row, kperm(key));
            uint32_t hi, lo;
            split(sc[m][e], hi, lo);
            *reinterpret_cast<uint32_t*>(X + off) = hi;
            *reinterpret_cast<uint32_t*>(Y + off) = lo;
          }
        fence_async_smem();
        named_arrive(2, 256);
      }
      if (n + 1 < n_tiles) {             // S or dP of tile n + 1
        wait_full(n + 1);
        const uint32_t bh = scores_of(n + 1);
        // at KEYS = 64 two k-steps per batch, so the live registers fit
        rs_product<KEYS, DHP / 8, KEYS == 64 ? 2 : 4>(
            sn,
            [&](int kk, uint32_t* hh, uint32_t* ll) {
              frag_rows<TF_QROWS>(hh, ll, ta, 16 * warp, 8 * kk, g, t);
            },
            [&](int kk) { return kmajor<KEYS>(bh, 0, kk); },
            [&](int kk) { return kmajor<KEYS>(bh + L::TK, 0, kk); });
      }
      if (wg == 0)
        named_sync(2, 256);              // dS of tile n from consumer 1
      else
        named_sync(4, 128);              // all of consumer 1's dS
      dq_issue(n);
      wg_wait<0>();
      dq_finish(n);
      pin<KEYS / 8>(sn);
#pragma unroll
      for (int m = 0; m < KEYS / 8; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[m][e] = sn[m][e];
    }

    if (!m_split<DHP>()) {               // consumer 0 adds consumer 1's
      float* sum = reinterpret_cast<float*>(sm + L::KS) + (tid & 127);
      if (wg == 1) {
#pragma unroll
        for (int nt = 0; nt < NO; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[(4 * nt + e) * 128] = acc[nt][e];
      }
      named_sync(3, 256);
      if (wg == 1) return;
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += sum[(4 * nt + e) * 128];
    }
    // dh column m0 + 16 warp + g (+ 8), query row 8 nt + 2t (+ 1)
    float* dqp = dq + bh * Sq * dh;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = m0 + 16 * warp + g + 8 * (e >> 1);
        const int qi = q_lo + 8 * nt + 2 * t + (e & 1);
        if (qi < Sq && d < dh) dqp[(long long)qi * dh + d] = acc[nt][e] * scale;
      }
    }
  }
}

template <int DHP>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* o, const float* dO, const float* lse,
                       float* dq, float* dk, float* dv, float* scratch, int B,
                       int H, int KV, int Sq, int Skv, int dh,
                       const Strides* st, int causal, int window,
                       float scale_log2, float scale, cudaStream_t stream) {
  constexpr int kv_smem = DkdvF32Smem<DHP>::BYTES;
  constexpr int q_smem = DqF32Smem<DHP>::BYTES;
  constexpr int KEYS = tf_keys<DHP>();
  // the shared-memory limit is set once per process and device
  static int attributes_set = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (attributes_set != device) {
    err = cudaFuncSetAttribute(dkdv_tf32_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_tf32_kernel<DHP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_smem);
    if (err != cudaSuccess) return err;
    attributes_set = device;
  }
  // st: q, k, v, o, do
  // scratch: kc = k - kmean and v split (four B KV Skv dh planes: kc hi,
  // kc lo, v hi, v lo), the shifted lse and delta per query tile (B H
  // ceil(Sq / 64) 128), kmean (B KV dh), the key means' partial sums (B KV
  // ceil(Skv / KMEAN_ROWS) dh)
  const long long n = (long long)B * KV * Skv * dh;
  const int n_q = (Sq + BW_QT - 1) / BW_QT;
  const int chunks = (Skv + KMEAN_ROWS - 1) / KMEAN_ROWS;
  float* kch = scratch;
  float* kcl = kch + n;
  float* vh = kcl + n;
  float* vl = vh + n;
  float* lsed = vl + n;
  float* kmean = lsed + (long long)B * H * n_q * LSED_TILE;
  float* part = kmean + (long long)B * KV * dh;
  const Strides cs{(long long)KV * Skv * dh, (long long)Skv * dh, dh};
  CUtensorMap mq, mkch, mkcl, mvh, mvl, mdo;
  if (!encode_rows(&mq, q, B, H, Sq, dh, st[0], 4, TF_QROWS) ||
      !encode_rows(&mdo, dO, B, H, Sq, dh, st[4], 4, TF_QROWS) ||
      !encode_rows(&mkch, kch, B, KV, Skv, dh, cs, 4, KEYS) ||
      !encode_rows(&mkcl, kcl, B, KV, Skv, dh, cs, 4, KEYS) ||
      !encode_rows(&mvh, vh, B, KV, Skv, dh, cs, 4, KEYS) ||
      !encode_rows(&mvl, vl, B, KV, Skv, dh, cs, 4, KEYS))
    return cudaErrorInvalidValue;
  const dim3 centre_grid(B * KV, (Skv + CENTRE_ROWS - 1) / CENTRE_ROWS);
  const dim3 part_grid(B * KV, chunks);
  kmean_part_kernel<float><<<part_grid, 128, 0, stream>>>(k, part, KV, Skv,
                                                           dh, st[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kmean_sum_kernel<<<B * KV, 128, 0, stream>>>(part, kmean, chunks, Skv, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_keys_kernel<<<centre_grid, CENTRE_NT, 0, stream>>>(
      k, v, kmean, kch, kcl, vh, vl, KV, Skv, dh, st[1], st[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  delta_f32_kernel<<<dim3(B * H, n_q * (BW_QT / (DELTA_NT / 32))), DELTA_NT,
                     0, stream>>>(o, dO, q, lse, kmean, lsed, H, KV, Sq, dh,
                                  st[3], st[4], st[0], scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_tf32_kernel<DHP>
      <<<dim3(B * KV, (Skv + KEYS - 1) / KEYS), TF_NT, kv_smem,
         stream>>>(mq, mkch, mkcl, mvh, mvl, mdo, lsed, dk, dv, H, KV, Sq,
                   Skv, dh, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_tf32_kernel<DHP>
      <<<dim3(B * H, (Sq + TF_QROWS - 1) / TF_QROWS), TF_NT, q_smem,
         stream>>>(mq, mkch, mkcl, mvh, mvl, mdo, lsed, dq, H, KV, Sq, Skv,
                   dh, causal, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dk_j - mean_j dk_j, in place (the key means' buffers are free again)
  kmean_part_kernel<float><<<part_grid, 128, 0, stream>>>(dk, part, KV, Skv,
                                                           dh, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kmean_sum_kernel<<<B * KV, 128, 0, stream>>>(part, kmean, chunks, Skv, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  centre_kernel<<<centre_grid, CENTRE_NT, 0, stream>>>(dk, kmean, Skv, dh);
  return cudaGetLastError();
}

// ---- bf16: wgmma on tiles brought by TMA, a producer warp per block ----

constexpr int BW_NT = 384;           // consumer warpgroups 0, 1; producer 2
constexpr int BW_KEYS = 128;         // keys per dk/dv block (64 per consumer)
constexpr int BW_QROWS = 128;        // query rows per dq block (64 each)
constexpr int BW_KT = 64;            // keys per staged tile (dq)
constexpr int BW_STAGES = 2;         // depth of the staged-tile rings

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

// Launches the nine kernels (the key means in two passes, the split
// centred keys and values, the row terms, dk/dv, dq, then dk's key means
// and its centring) on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides` holds
// 15 element strides: (batch, head, sequence) of q, k, v, o and do. dq,
// dk, dv are written contiguous; `scratch` is f32 scratch of 4 B KV Skv dh
// + 128 B H ceil(Sq / 64) + B KV dh (1 + ceil(Skv / 64)) floats, 16-byte
// aligned (the centred keys and the values as hi and lo, the shifted lse
// and delta per query tile, the key means and their partial sums).
// `scale_log2` is dh^-0.5 log2(e) (the forward's), `scale` dh^-0.5. q and
// do are read by TMA, so dh must be a multiple of 4 and every row of q and
// do must start on 16 bytes (each base pointer, and each stride over an
// axis of more than one entry a positive multiple of 4): the wrapper makes
// other inputs legal by a copy. k, v and o are read by plain loads (any
// strides).
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, const void* lse,
                            void* dq, void* dk, void* dv, void* scratch, int B,
                            int H, int KV, int Sq, int Skv, int dh,
                            const long long* strides, int causal, int window,
                            float scale_log2, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      dh < 1 || dh > 128 || dh % 4 != 0 || window < 0 ||
      (long long)B * H > 2147483647LL ||
      (Sq + TF_QROWS - 1) / TF_QROWS > 65535 ||
      (Skv + tf_keys<128>() - 1) / tf_keys<128>() > 65535 ||
      (Skv + KMEAN_ROWS - 1) / KMEAN_ROWS > 65535 ||
      (long long)(Sq + BW_QT - 1) / BW_QT * (BW_QT / (DELTA_NT / 32)) >
          65535 ||
      (Skv + CENTRE_ROWS - 1) / CENTRE_ROWS > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  if (!tma_rows(q, B, H, Sq, st[0], 4) || !tma_rows(dO, B, H, Sq, st[4], 4) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
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
#define FLASH_BWD_LAUNCH(DHP)                                                 \
  launch_f32<DHP>(qq, kk, vv, oo, gg, ll, dqq, dkk, dvv, dd, B, H, KV, Sq,    \
                  Skv, dh, st, causal, window, scale_log2, scale, s)
  return (int)(dh <= 64 ? FLASH_BWD_LAUNCH(64) : FLASH_BWD_LAUNCH(128));
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
