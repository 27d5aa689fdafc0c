// Backward pass of blocked online-softmax attention (FlashAttention) for
// Hopper (sm_90a), f32, on the CUDA cores (FFMA).
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
// What bounds it: at the qwen3-4b training shape (B=4, H=32, KV=8,
// S=2048, dh=128, causal) the gradient needs five S x S x dh products per
// head over the live (i, j) pairs (S(S+1)/2 per head): q k^T and do v^T
// (to rebuild P and dP), P^T do (dv), dS^T q (dk) and dS k (dq),
// 10 B H dh S(S+1)/2 = 344 GFLOP: 5.13 ms in f32 FFMA (67 TFLOP/s), 2.08 ms
// as split TF32 on the tensor cores (three products each, 495 TFLOP/s),
// against about 0.6 GB of inputs and outputs (0.18 ms at 3.35 TB/s): bound
// by operations.
//
// Design (a first, simple kernel: FFMA from shared-memory tiles; the
// tensor cores are a later step):
//   * no float atomics, so a rerun is bit-equal. dk and dv are summed by
//     the block that owns a kv tile: kernel `dkdv` runs one block per
//     (batch item x kv head, tile of 64 keys) and loops over the G query
//     heads of that kv head and over the query tiles that can see the kv
//     tile (causal: from the tile's first key on; window: up to its last
//     key + window - 1), rebuilding P and dP per (query tile, kv tile).
//     dq is a sum over kv tiles, so it is the job of a second kernel, `dq`,
//     with one block per (batch item x head, query tile of 32 rows) that
//     loops over the kv tiles the query tile sees and rebuilds P and dP
//     again: 7 products per live pair instead of 5, for a deterministic
//     sum without a reduction buffer (a dq partial per kv tile would be
//     S / 64 times dq's size).
//   * delta_i = sum_d do_i o_i (the row term of dS = P (dP - delta)) is
//     computed once per row by a first small kernel into `delta`.
//   * per tile pair, 256 threads: the (32 x 64) S and dP tiles as 2 x 4
//     per thread (rows 2 ty, 2 ty + 1; keys tx + 16 c), then P and dS to
//     shared memory, then dv += P^T do and dk += dS^T q as 4 keys x dh/16
//     columns per thread (dq += dS k as 2 rows x dh/16 columns), summed in
//     the order of the query rows (dk, dv) or keys (dq), one f32 FMA at a
//     time. Rows are padded by one float, so the column-strided reads of
//     the S tiles are free of bank conflicts.
//   * masks as in the forward: p = 0 exactly where the mask drops (i, j),
//     and for rows past Sq and keys past Skv; ragged dh is zero-filled in
//     shared memory. dh <= 64 runs the 64-wide instance, 64 < dh <= 128
//     the 128-wide one.
//   * shared memory (both kernels): 64 + 64 + 32 + 32 rows of dh + 1
//     floats, two 32 x 65 tiles, 64 row scalars: 115,968 B at dh = 128,
//     66,816 B at dh = 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int BQ = 32;             // query rows per tile
constexpr int BKV = 64;            // keys per tile
constexpr int LDP = BKV + 1;       // padded row of a P / dS tile

struct Strides {
  long long b, h, s;
};

template <int DHP>
struct Dims {
  static constexpr int LD = DHP + 1;      // padded row of a q/k/v/do tile
  static constexpr int NC = DHP / 16;     // dh columns per thread
};

// ROWS rows of DHP floats from global row r0 on (rows >= n_rows and
// columns >= dh zero-filled) into shared rows of DHP + 1 floats.
template <int DHP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0,
                                          int n_rows, int dh, int tid) {
  for (int e = tid; e < ROWS * DHP; e += NT) {
    const int r = e / DHP;
    const int d = e - r * DHP;
    const int gr = r0 + r;
    dst[r * Dims<DHP>::LD + d] =
        (gr < n_rows && d < dh) ? src[gr * stride + d] : 0.f;
  }
}

// The S = q k^T and dP = do v^T tiles of this thread: rows 2 ty + a of the
// query tile, keys tx + 16 c of the kv tile, each a sum over d in order.
template <int DHP>
__device__ __forceinline__ void score_tiles(float (*s)[4], float (*dp)[4],
                                            const float* sQ,
                                            const float* sdO,
                                            const float* sK,
                                            const float* sV, int ty,
                                            int tx) {
  constexpr int LD = Dims<DHP>::LD;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
  const float* q0 = sQ + (2 * ty) * LD;
  const float* g0 = sdO + (2 * ty) * LD;
#pragma unroll 4
  for (int d = 0; d < DHP; ++d) {
    const float qa = q0[d], qb = q0[LD + d];
    const float ga = g0[d], gb = g0[LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float kk = sK[(tx + 16 * c) * LD + d];
      const float vv = sV[(tx + 16 * c) * LD + d];
      s[0][c] = fmaf(qa, kk, s[0][c]);
      s[1][c] = fmaf(qb, kk, s[1][c]);
      dp[0][c] = fmaf(ga, vv, dp[0][c]);
      dp[1][c] = fmaf(gb, vv, dp[1][c]);
    }
  }
}

// P and dS of this thread's 2 x 4 entries (p = 0 where the mask drops the
// pair, or past Sq / Skv), written to the shared P / dS tiles.
__device__ __forceinline__ void probs(const float (*s)[4],
                                      const float (*dp)[4], float* sP,
                                      float* sdS, const float* sL,
                                      const float* sD, int q_lo, int k_lo,
                                      int Sq, int Skv, int causal,
                                      int window, float scale_log2, int ty,
                                      int tx) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = 2 * ty + a;
    const int qi = q_lo + row;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      const int kj = k_lo + col;
      const bool live = qi < Sq && kj < Skv && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
      const float p = live ? exp2f(s[a][c] * scale_log2 - sL[row]) : 0.f;
      sP[row * LDP + col] = p;
      sdS[row * LDP + col] = p * (dp[a][c] - sD[row]);
    }
  }
}

// delta[b, h, i] = sum_d do[b, h, i, d] o[b, h, i, d]: one warp per row.
__global__ void __launch_bounds__(NT)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
             float* __restrict__ delta, int H, int Sq, int dh, Strides os,
             Strides gs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.y * (NT / 32) + warp;
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

// dk and dv of one kv tile of one (batch item, kv head).
template <int DHP>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
            int Sq, int Skv, int dh, Strides qs, Strides ks, Strides vs,
            Strides gs, int causal, int window, float scale_log2,
            float scale) {
  constexpr int LD = Dims<DHP>::LD, NC = Dims<DHP>::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // BKV rows
  float* sV = sK + BKV * LD;                        // BKV rows
  float* sQ = sV + BKV * LD;                        // BQ rows
  float* sdO = sQ + BQ * LD;                        // BQ rows
  float* sP = sdO + BQ * LD;                        // BQ x LDP
  float* sdS = sP + BQ * LDP;                       // BQ x LDP
  float* sL = sdS + BQ * LDP;                       // BQ
  float* sD = sL + BQ;                              // BQ

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;   // S tiles: rows, keys
  const int tk = tid >> 4, td = tid & 15;   // dk, dv: keys 4 tk.., cols td + 16 c
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int n_kv = (Skv + BKV - 1) / BKV;
  const int k_lo = (n_kv - 1 - blockIdx.y) * BKV;   // heaviest (causal) first
  const int k_hi = min(k_lo + BKV, Skv) - 1;
  load_rows<DHP, BKV>(sK, k + b * ks.b + kvh * ks.h, ks.s, k_lo, Skv, dh, tid);
  load_rows<DHP, BKV>(sV, v + b * vs.b + kvh * vs.h, vs.s, k_lo, Skv, dh, tid);

  const int n_q = (Sq + BQ - 1) / BQ;
  const int i_begin = causal ? k_lo / BQ : 0;
  const int i_end = window > 0 ? min(n_q, (k_hi + window - 1) / BQ + 1) : n_q;

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[e][c] = adv[e][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qp = q + b * qs.b + h * qs.h;
    const float* gp = dO + b * gs.b + h * gs.h;
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int it = i_begin; it < i_end; ++it) {
      const int q_lo = it * BQ;
      __syncthreads();                 // the previous tile is consumed
      load_rows<DHP, BQ>(sQ, qp, qs.s, q_lo, Sq, dh, tid);
      load_rows<DHP, BQ>(sdO, gp, gs.s, q_lo, Sq, dh, tid);
      if (tid < BQ) {
        const int qi = q_lo + tid;
        sL[tid] = qi < Sq ? lse[row0 + qi] : 0.f;
        sD[tid] = qi < Sq ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      float s[2][4], dp[2][4];
      score_tiles<DHP>(s, dp, sQ, sdO, sK, sV, ty, tx);
      probs(s, dp, sP, sdS, sL, sD, q_lo, k_lo, Sq, Skv, causal, window,
            scale_log2, ty, tx);
      __syncthreads();
      // dv += P^T do, dk += dS^T q, over this tile's query rows in order
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pe[4], se[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pe[e] = sP[i * LDP + 4 * tk + e];
          se[e] = sdS[i * LDP + 4 * tk + e];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float gv = sdO[i * LD + td + 16 * c];
          const float qv = sQ[i * LD + td + 16 * c];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            adv[e][c] = fmaf(pe[e], gv, adv[e][c]);
            adk[e][c] = fmaf(se[e], qv, adk[e][c]);
          }
        }
      }
    }
  }

  float* dkp = dk + ((long long)b * KV + kvh) * Skv * dh;
  float* dvp = dv + ((long long)b * KV + kvh) * Skv * dh;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int kj = k_lo + 4 * tk + e;
    if (kj >= Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = td + 16 * c;
      if (d < dh) {
        dkp[(long long)kj * dh + d] = adk[e][c] * scale;
        dvp[(long long)kj * dh + d] = adv[e][c];
      }
    }
  }
}

// dq of one query tile of one (batch item, head).
template <int DHP>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int H, int KV, int Sq, int Skv, int dh,
          Strides qs, Strides ks, Strides vs, Strides gs, int causal,
          int window, float scale_log2, float scale) {
  constexpr int LD = Dims<DHP>::LD, NC = Dims<DHP>::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);   // BKV rows
  float* sV = sK + BKV * LD;                        // BKV rows
  float* sQ = sV + BKV * LD;                        // BQ rows
  float* sdO = sQ + BQ * LD;                        // BQ rows
  float* sP = sdO + BQ * LD;                        // BQ x LDP (unused P)
  float* sdS = sP + BQ * LDP;                       // BQ x LDP
  float* sL = sdS + BQ * LDP;                       // BQ
  float* sD = sL + BQ;                              // BQ

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int G = H / KV;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int n_q = (Sq + BQ - 1) / BQ;
  const int q_lo = (n_q - 1 - blockIdx.y) * BQ;     // heaviest (causal) first
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const long long row0 = ((long long)b * H + h) * Sq;
  load_rows<DHP, BQ>(sQ, q + b * qs.b + h * qs.h, qs.s, q_lo, Sq, dh, tid);
  load_rows<DHP, BQ>(sdO, dO + b * gs.b + h * gs.h, gs.s, q_lo, Sq, dh, tid);
  if (tid < BQ) {
    const int qi = q_lo + tid;
    sL[tid] = qi < Sq ? lse[row0 + qi] : 0.f;
    sD[tid] = qi < Sq ? delta[row0 + qi] : 0.f;
  }
  const float* kp = k + b * ks.b + (h / G) * ks.h;
  const float* vp = v + b * vs.b + (h / G) * vs.h;

  const int n_kv = (Skv + BKV - 1) / BKV;
  const int j_end = causal ? min(n_kv, q_hi / BKV + 1) : n_kv;
  const int j_begin = window > 0 ? max(0, q_lo - window + 1) / BKV : 0;

  float acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k_lo = jt * BKV;
    __syncthreads();                   // the previous tile is consumed
    load_rows<DHP, BKV>(sK, kp, ks.s, k_lo, Skv, dh, tid);
    load_rows<DHP, BKV>(sV, vp, vs.s, k_lo, Skv, dh, tid);
    __syncthreads();
    float s[2][4], dp[2][4];
    score_tiles<DHP>(s, dp, sQ, sdO, sK, sV, ty, tx);
    probs(s, dp, sP, sdS, sL, sD, q_lo, k_lo, Sq, Skv, causal, window,
          scale_log2, ty, tx);
    __syncthreads();
    // dq += dS k, over this tile's keys in order
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float s0 = sdS[(2 * ty) * LDP + j];
      const float s1 = sdS[(2 * ty + 1) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[j * LD + tx + 16 * c];
        acc[0][c] = fmaf(s0, kv, acc[0][c]);
        acc[1][c] = fmaf(s1, kv, acc[1][c]);
      }
    }
  }

  float* dqp = dq + row0 * dh;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qi = q_lo + 2 * ty + a;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) dqp[(long long)qi * dh + d] = acc[a][c] * scale;
    }
  }
}

template <int DHP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((2 * BKV + 2 * BQ) * (size_t)Dims<DHP>::LD +
                          2 * BQ * LDP + 2 * BQ);
}

template <int DHP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* dO, const float* lse,
                   float* dq, float* dk, float* dv, float* delta, int B,
                   int H, int KV, int Sq, int Skv, int dh, const Strides* st,
                   int causal, int window, float scale_log2, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<DHP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  // st: q, k, v, o, do
  delta_kernel<<<dim3(B * H, (Sq + NT / 32 - 1) / (NT / 32)), NT, 0,
                 stream>>>(o, dO, delta, H, Sq, dh, st[3], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DHP><<<dim3(B * KV, (Skv + BKV - 1) / BKV), NT, smem,
                     stream>>>(q, k, v, dO, lse, delta, dk, dv, H, KV, Sq,
                               Skv, dh, st[0], st[1], st[2], st[4], causal,
                               window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DHP><<<dim3(B * H, (Sq + BQ - 1) / BQ), NT, smem, stream>>>(
      q, k, v, dO, lse, delta, dq, H, KV, Sq, Skv, dh, st[0], st[1], st[2],
      st[4], causal, window, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels (delta, dk/dv, dq) on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise and
// allocates nothing. `strides` holds 15 element strides: (batch, head,
// sequence) of q, k, v, o and do. dq, dk, dv are written contiguous;
// `delta` is (B, H, Sq) f32 scratch. `scale_log2` is dh^-0.5 log2(e) (the
// forward's), `scale` dh^-0.5.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, const void* lse,
                            void* dq, void* dk, void* dv, void* delta, int B,
                            int H, int KV, int Sq, int Skv, int dh,
                            const long long* strides, int causal, int window,
                            float scale_log2, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 ||
      dh < 1 || dh > 128 || window < 0 || (long long)B * H > 2147483647LL ||
      (Sq + BQ - 1) / BQ > 65535 || (Skv + BKV - 1) / BKV > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
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
  float* dd = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return (int)launch<64>(qq, kk, vv, oo, gg, ll, dqq, dkk, dvv, dd, B, H,
                           KV, Sq, Skv, dh, st, causal, window, scale_log2,
                           scale, s);
  return (int)launch<128>(qq, kk, vv, oo, gg, ll, dqq, dkk, dvv, dd, B, H,
                          KV, Sq, Skv, dh, st, causal, window, scale_log2,
                          scale, s);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
