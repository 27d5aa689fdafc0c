// Blocked online-softmax attention (FlashAttention, forward) for Hopper
// (sm_90a).
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
// scaled by the true dh^-0.5; masked scores are -1e30, the softmax
// denominator is max(l, 1e-30), as in the reference. Output o in q's
// dtype, with f32 accumulation (P stays f32 before P.V).
//
// What bounds it: at the qwen3-4b prefill shape (B=4, H=32, KV=8,
// S=2048, dh=128, causal) the live (i, j) pairs are S(S+1)/2 per head:
// 4 B H dh S(S+1)/2 = 137.6 GFLOP of f32 FMA, about 2.05 ms at 67 TFLOP/s
// (non-tensor f32), against 335 MB of q, k, v, o, about 0.10 ms at
// 3.35 TB/s. The kernel is bound by f32 operations. TF32 or bf16 tensor
// cores would be faster, but the reference's f32 tolerance (5e-4 here)
// rules TF32 out, so the products stay in FFMA with expf (no fast math).
//
// Design (simple and correct first; wgmma, TMA and a producer warp are
// later work):
//   * one block of 16 x 16 threads per (query tile of 64 rows, head,
//     batch item). Nothing is carried between blocks: the TPU kernel's
//     sequential kv grid axis becomes a loop inside the block, and the
//     running max m, sum l and accumulator (4 rows x dh/16 columns per
//     thread) live in registers.
//   * the query tile is staged once in shared memory, transposed
//     (sQ[d][row]); each kv tile of 64 rows is staged as K^T (sK[d][col])
//     and V (sV[col][d]). Scores: each thread owns 4 rows x 4 adjacent
//     columns and reads one float4 of Q^T and one of K^T per d (16 FMA
//     per two 16-byte loads). Row max and sum reduce over the 16 threads
//     of a row group with warp shuffles.
//   * P (f32) goes back through shared memory, transposed into the K^T
//     buffer (free once the scores are read), for P.V: each thread reads
//     one float4 of P and dh/64 float4s of V per key.
//   * kv tiles that are wholly masked are skipped: causal tiles past the
//     query tile's last row, and window tiles that end at or before
//     q_lo - window. So a windowed layer does O(S W) work.
//   * ragged Sq, Skv and dh are masked at the loads and stores; dh <= 64
//     runs the 64-wide instance, 64 < dh <= 128 the 128-wide one. The
//     reference's padding of dh to 128 lanes and of S to block multiples
//     is a TPU tiling rule with no counterpart here.
//   * shared memory: 2 x dh x 68 + 64 x dh floats, 102,400 bytes at
//     dh = 128 (two blocks per SM), above the 48 KB static limit, hence
//     the attribute below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 16;             // threads across score / output columns
constexpr int TY = 16;             // threads across query rows
constexpr int NT = TX * TY;
constexpr int RM = 4;              // query rows per thread
constexpr int CN = 4;              // score columns per thread
constexpr int BQ = TY * RM;        // query rows per block
constexpr int BKV = TX * CN;       // keys per kv tile
constexpr int LDT = BQ + 4;        // row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BKV, "sQ and sK share the transposed row stride");

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int G, int Sq, int Skv, int dh, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       float scale) {
  constexpr int ON = DHP / TX;     // output columns per thread
  constexpr int OG = ON / 4;       // float4 groups of them
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                // DHP x LDT: sQ[d * LDT + row]
  float* sK = sQ + DHP * LDT;      // DHP x LDT: sK[d * LDT + col]
  float* sP = sK;                  // BKV x LDT: sP[col * LDT + row]
  float* sV = sK + DHP * LDT;      // BKV x DHP: sV[col * DHP + d]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int q_lo = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + (h / G) * ks.h;
  const T* vp = v + b * vs.b + (h / G) * vs.h;
  T* op = o + b * os.b + h * os.h;

  // Q^T: neighbouring threads read neighbouring d of one row (coalesced).
  for (int e = tid; e < BQ * DHP; e += NT) {
    const int r = e / DHP;
    const int d = e - r * DHP;
    const int qi = q_lo + r;
    sQ[d * LDT + r] =
        (qi < Sq && d < dh) ? load_f32(qp + qi * qs.s + d) : 0.f;
  }

  float m[RM], l[RM], acc[RM][ON];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ON; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (Skv + BKV - 1) / BKV;
  const int j_end = causal ? min(n_kv, (q_lo + BQ - 1) / BKV + 1) : n_kv;
  for (int jt = 0; jt < j_end; ++jt) {
    const int k_lo = jt * BKV;
    if (window > 0 && k_lo + BKV - 1 <= q_lo - window) continue;  // uniform
    __syncthreads();               // the last tile's sP and sV are read
    for (int e = tid; e < BKV * DHP; e += NT) {
      const int c = e / DHP;
      const int d = e - c * DHP;
      const int kj = k_lo + c;
      const bool ok = kj < Skv && d < dh;
      sK[d * LDT + c] = ok ? load_f32(kp + kj * ks.s + d) : 0.f;
      sV[c * DHP + d] = ok ? load_f32(vp + kj * vs.s + d) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sQ + d * LDT + ty * RM);
      const float4 bk = *reinterpret_cast<const float4*>(sK + d * LDT + tx * CN);
      const float av[RM] = {a.x, a.y, a.z, a.w};
      const float bv[CN] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
      }
    }

    // Online softmax, row by row; a row's 64 scores sit in the 16
    // threads of one half-warp, 4 each.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q_lo + ty * RM + i;
      bool live[CN];
      float row_max = NEG_INF;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kj = k_lo + tx * CN + c;
        live[c] = kj < Skv && (!causal || kj <= qi) &&
                  (window <= 0 || kj > qi - window);
        s[i][c] = live[c] ? s[i][c] * scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        s[i][c] = live[c] ? expf(s[i][c] - m_new) : 0.f;
        row_sum += s[i][c];
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ON; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();               // every thread has read sK
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      *reinterpret_cast<float4*>(sP + (tx * CN + c) * LDT + ty * RM) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(sP + c * LDT + ty * RM);
      const float pv[RM] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(sV + c * DHP + g * 64 + tx * 4);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][g * 4 + jj] = fmaf(pv[i], vr[jj], acc[i][g * 4 + jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q_lo + ty * RM + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < OG; ++g) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < dh) store_f32(op + qi * os.s + d, acc[i][g * 4 + jj] / denom);
      }
    }
  }
}

template <typename T, int DHP>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int B, int H,
                   int KV, int Sq, int Skv, int dh, const Strides* st,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)DHP * LDT + (size_t)BKV * DHP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const dim3 block(TX, TY);
  flash_attention_kernel<T, DHP><<<grid, block, smem, stream>>>(
      q, k, v, o, H, H / KV, Sq, Skv, dh, st[0], st[1], st[2], st[3], causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int Sq, int Skv, int dh,
                     const long long* strides, int causal, int window,
                     float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0 ||
      Sq < 1 || Skv < 1 || dh < 1 || dh > 128 || window < 0) {
    return cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int t = 0; t < 4; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) {
    return launch<T, 64>(qq, kk, vv, oo, B, H, KV, Sq, Skv, dh, st, causal,
                         window, scale, s);
  }
  return launch<T, 128>(qq, kk, vv, oo, B, H, KV, Sq, Skv, dh, st, causal,
                        window, scale, s);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides`
// holds 12 element strides: (batch, head, sequence) of q, k, v and o.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Skv, int dh,
                        const long long* strides, int causal, int window,
                        float scale, void* stream) {
  return (int)dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, dh, strides,
                              causal, window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int Sq, int Skv, int dh,
                         const long long* strides, int causal, int window,
                         float scale, void* stream) {
  return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, dh,
                                      strides, causal, window, scale, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
