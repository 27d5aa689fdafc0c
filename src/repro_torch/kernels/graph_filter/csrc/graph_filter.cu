// Fused K-hop graph filter  Y = sum_{k<=K} h_k S^k W  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package:
// src/repro/kernels/graph_filter/kernel.py (_kernel, graph_filter_pallas),
// reached through ops.py::graph_filter and make_pallas_mix. It runs in
// every unrolled U-DGD layer of a serve tick, of a single-cohort solve and
// of a meta-step's forward. Its transposed-S entry is the meta-step's
// backward: dW = sum_k h_k (S^T)^k G, the same filter on S^T applied to
// the cotangent G (the Pallas call inside ops.py::_bwd of the reference).
//
// Contract (batched natively, one launch per layer of a serve tick):
//   S (B, n, n) f32, W (B, n, d) f32 or bf16, h (K+1,) f32 shared by the
//   batch; Y (B, n, d) in W's dtype. Horner's rule, f32 accumulation:
//   Y = h_K W;  Y = S Y + h_k W  for k = K-1 .. 0.
//
// What bounds it: at the serve shape (B=8, n=128, d=5130, K=2) one launch
// does 2 K n^2 d B = 2.69 GFLOP on 42.5 MB (S, W read once, Y written
// once). On an H100 SXM that is about 40 us of non-tensor f32 FMA
// (67 TFLOP/s) against about 13 us of memory traffic (3.35 TB/s): the
// kernel is bound by f32 operations. The backward's dW launch at the
// training shape (B=1, n=100, d=5130, K=2) is 0.21 GFLOP on 4.1 MB: about
// 3.1 us of f32 FMA against 1.2 us of memory, bound by operations too.
// TF32 tensor cores would be faster but keep about three decimal digits,
// and the f32 tolerance (5e-5) of the reference would not hold, so the
// product stays in FFMA.
//
// Design (simple and correct first; mma/wgmma and TMA are later work):
//   * grid (ceil(d / 64), B); a block of 16 x 16 threads owns one column
//     block of 64 columns of one batch item. Nothing is carried between
//     blocks, so the TPU's sequential grid has no counterpart here.
//   * the block stages S_b once in shared memory (rows padded by one
//     float so the two rows a warp reads sit on different banks) and
//     keeps it resident across all K hops, as the Pallas kernel keeps S
//     in VMEM. W's column block stays in registers; the current iterate
//     Y goes through one (n x 64) shared buffer per hop.
//   * each thread owns TM rows (ty + 16 r) x 4 adjacent columns: per
//     inner step it reads one float4 of Y and TM broadcast values of S
//     and runs 4 TM FFMAs.
//   * ragged n and d are masked at the global loads and stores; rows
//     past n are zero in shared memory, so no padded copies exist in
//     device memory (the reference's (8, 128) tile padding is a TPU rule).
//   * the backward entry stages S^T instead of S: the staging loop reads
//     S row by row (coalesced) and writes the transpose into shared
//     memory, so no transposed copy of S exists in device memory; the
//     hops are unchanged.
//   * S (n x n f32) must fit shared memory beside the Y buffer: TM <= 8
//     gives the largest n this kernel takes, MAX_N = 128 (the top of the
//     default serve bucket ladder), with 98,816 bytes of dynamic shared
//     memory, above the 48 KB static limit, hence the attribute below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TX = 16;               // threads across columns
constexpr int TY = 16;               // threads across rows
constexpr int TN = 4;                // columns per thread
constexpr int BD = TX * TN;          // columns per block
constexpr int MAX_TM = 8;            // rows per thread, at most
constexpr int MAX_N = TY * MAX_TM;   // largest n the kernel takes

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int TM, bool TRANS_S>
__global__ void __launch_bounds__(TX * TY, 2)
graph_filter_kernel(const float* __restrict__ S, const T* __restrict__ W,
                    const float* __restrict__ h, T* __restrict__ Y, int n,
                    int d, int K) {
  constexpr int NR = TY * TM;        // rows staged in shared memory
  constexpr int SS = NR + 1;         // row stride of S in shared memory
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                  // NR x SS
  float* sY = smem + NR * SS;        // NR x BD; NR * SS is a multiple of 16

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * BD + tx * TN;
  const float* Sb = S + (size_t)b * n * n;
  const T* Wb = W + (size_t)b * n * d;
  T* Yb = Y + (size_t)b * n * d;

  if constexpr (TRANS_S) {
    // sS[i][k] = S[k][i]; neighbouring threads read neighbouring i of one
    // row of S and write rows SS = NR + 1 (odd) floats apart: no bank
    // conflicts.
    for (int e = tid; e < NR * NR; e += TX * TY) {
      const int k = e / NR;
      const int i = e - k * NR;
      sS[i * SS + k] = (i < n && k < n) ? Sb[(size_t)k * n + i] : 0.f;
    }
  } else {
    for (int e = tid; e < NR * NR; e += TX * TY) {
      const int i = e / NR;
      const int k = e - i * NR;
      sS[i * SS + k] = (i < n && k < n) ? Sb[(size_t)i * n + k] : 0.f;
    }
  }

  float w[TM][TN];
  float y[TM][TN];
  const float hK = h[K];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = ty + TY * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = j0 + c;
      w[r][c] = (i < n && j < d) ? load_f32(Wb + (size_t)i * d + j) : 0.f;
      y[r][c] = hK * w[r][c];
    }
  }

  for (int k = K - 1; k >= 0; --k) {
    __syncthreads();                 // the previous hop's reads of sY are done
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      *reinterpret_cast<float4*>(sY + (ty + TY * r) * BD + tx * TN) =
          make_float4(y[r][0], y[r][1], y[r][2], y[r][3]);
    }
    __syncthreads();                 // sY, and sS on the first hop, complete
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) y[r][c] = 0.f;
    }
    for (int m = 0; m < n; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(sY + m * BD + tx * TN);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float s = sS[(ty + TY * r) * SS + m];
        y[r][0] = fmaf(s, v.x, y[r][0]);
        y[r][1] = fmaf(s, v.y, y[r][1]);
        y[r][2] = fmaf(s, v.z, y[r][2]);
        y[r][3] = fmaf(s, v.w, y[r][3]);
      }
    }
    const float hk = h[k];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) y[r][c] += hk * w[r][c];
    }
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = ty + TY * r;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = j0 + c;
      if (i < n && j < d) store_f32(Yb + (size_t)i * d + j, y[r][c]);
    }
  }
}

template <typename T, int TM, bool TRANS_S>
cudaError_t launch(const float* S, const T* W, const float* h, T* Y, int B,
                   int n, int d, int K, cudaStream_t stream) {
  constexpr int NR = TY * TM;
  const size_t smem = sizeof(float) * ((size_t)NR * (NR + 1) + (size_t)NR * BD);
  cudaError_t err = cudaFuncSetAttribute(
      graph_filter_kernel<T, TM, TRANS_S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d + BD - 1) / BD, B);
  const dim3 block(TX, TY);
  graph_filter_kernel<T, TM, TRANS_S><<<grid, block, smem, stream>>>(S, W, h, Y, n, d, K);
  return cudaGetLastError();
}

template <typename T, bool TRANS_S>
cudaError_t dispatch(const void* S, const void* W, const void* h, void* Y,
                     int B, int n, int d, int K, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || n > MAX_N || d < 1 || K < 0) {
    return cudaErrorInvalidValue;
  }
  const float* s = static_cast<const float*>(S);
  const T* w = static_cast<const T*>(W);
  const float* hh = static_cast<const float*>(h);
  T* y = static_cast<T*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((n + TY - 1) / TY) {
    case 1: return launch<T, 1, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    case 2: return launch<T, 2, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    case 3: return launch<T, 3, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    case 4: return launch<T, 4, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    case 5: return launch<T, 5, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    case 6: return launch<T, 6, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    case 7: return launch<T, 7, TRANS_S>(s, w, hh, y, B, n, d, K, st);
    default: return launch<T, 8, TRANS_S>(s, w, hh, y, B, n, d, K, st);
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing.
int graph_filter_f32(const void* S, const void* W, const void* h, void* Y,
                     int B, int n, int d, int K, void* stream) {
  return (int)dispatch<float, false>(S, W, h, Y, B, n, d, K, stream);
}

int graph_filter_bf16(const void* S, const void* W, const void* h, void* Y,
                      int B, int n, int d, int K, void* stream) {
  return (int)dispatch<__nv_bfloat16, false>(S, W, h, Y, B, n, d, K, stream);
}

// The backward's dW: Y = sum_k h_k (S^T)^k W with S given untransposed
// (f32 only: the reference casts the cotangent to f32 before its call).
int graph_filter_t_f32(const void* S, const void* W, const void* h, void* Y,
                       int B, int n, int d, int K, void* stream) {
  return (int)dispatch<float, true>(S, W, h, Y, B, n, d, K, stream);
}

const char* graph_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
