// RWKV6 wkv recurrence (data-dependent per-channel decay) for Hopper
// (sm_90a):
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// from S_0 = 0, per (batch item, head); returns y and the f32 S_T.
//
// Replaces the Pallas TPU kernel of the reference package:
// src/repro/kernels/ssm_scan/kernel.py:24 (_kernel) and :51 (wkv_pallas),
// reached through ops.py::wkv. In the port it runs every RWKV6 time-mix of
// an LLM prefill (models/ssm.py::rwkv6_full): 24 launches per rwkv6-1.6b
// prefill. Decode stays the plain one-step recurrence, as in the reference.
//
// Contract: r, k, v, w (B, H, T, dk), f32 or bf16, any strides over
// (B, H, T) and unit stride over dk; u (H, dk) f32. y (B, H, T, dk) in r's
// dtype (strides given), S (B, H, dk, dk) f32 contiguous, S[i][j] the
// entry of key channel i and value channel j.
//
// What bounds it: at the rwkv6-1.6b prefill shape (B=4, H=32, T=2048,
// dk=64, f32) each step does about 5 dk^2 flops per head: 5 B H T dk^2 =
// 5.4 GFLOP, 0.08 ms at 67 TFLOP/s, against 5 B H T dk x 4 bytes of r, k,
// v, w, y plus the f32 state, 338 MB, 0.10 ms at 3.35 TB/s. Both bounds
// are far below what a sequential recurrence over T = 2048 steps on
// B H = 128 independent heads can reach: the kernel is bound by the
// latency of its serial chain, one step after another.
//
// Design (simple and correct first; splitting the columns of S over more
// blocks, or a chunked parallel form, is later work):
//   * one block per (b, h), one thread per value column j: the thread
//     holds S[:, j] (dk <= 64 f32) in registers for the whole sequence,
//     so the state never leaves the SM. The grid is B H = 128 blocks at
//     full width, a little under the 132 SMs.
//   * the TPU kernel's sequential chunk grid becomes a loop inside the
//     block: chunks of 32 steps of r, k, v, w are staged in shared memory
//     with coalesced loads, then the 32 steps run from shared memory
//     (broadcast reads), so global-memory latency is paid once per chunk,
//     not once per step. u is staged once.
//   * the loop runs over the real T: the reference pads time with w=1,
//     k=0 no-op steps to a chunk multiple, a TPU tiling artifact. Ragged
//     dk is padded with zero channels in shared memory (k = 0 keeps the
//     padded rows of S at zero).
//   * y_t's dot product over i runs in four partial sums to shorten the
//     dependent chain; FFMA in full f32 (no fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CT = 32;             // time steps staged per chunk

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

template <typename T, int DK>
__global__ void __launch_bounds__(DK)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ y,
           float* __restrict__ s_out, int H, int T_len, int dk, Strides rs,
           Strides ks, Strides vs, Strides ws, Strides ys) {
  __shared__ float sr[CT][DK], sk[CT][DK], sv[CT][DK], sw[CT][DK];
  __shared__ float su[DK];
  const int j = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const T* wp = w + b * ws.b + h * ws.h;
  T* yp = y + b * ys.b + h * ys.h;
  su[j] = j < dk ? u[h * dk + j] : 0.f;

  float S[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += CT) {
    const int nt = min(CT, T_len - t0);
    __syncthreads();               // the last chunk is consumed
    for (int tt = 0; tt < CT; ++tt) {
      const bool ok = tt < nt && j < dk;
      const long long t = t0 + tt;
      sr[tt][j] = ok ? load_f32(rp + t * rs.s + j) : 0.f;
      sk[tt][j] = ok ? load_f32(kp + t * ks.s + j) : 0.f;
      sv[tt][j] = ok ? load_f32(vp + t * vs.s + j) : 0.f;
      sw[tt][j] = ok ? load_f32(wp + t * ws.s + j) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = sv[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const float kv = sk[tt][i] * vj;
        acc[i & 3] = fmaf(sr[tt][i], S[i] + su[i] * kv, acc[i & 3]);
        S[i] = fmaf(sw[tt][i], S[i], kv);
      }
      if (j < dk) {
        store_f32(yp + (long long)(t0 + tt) * ys.s + j,
                  (acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
    }
  }
  if (j < dk) {
    float* sp = s_out + ((long long)blockIdx.x * dk) * dk;
#pragma unroll
    for (int i = 0; i < DK; ++i) {
      if (i < dk) sp[(long long)i * dk + j] = S[i];
    }
  }
}

template <typename T, int DK>
cudaError_t launch(const T* r, const T* k, const T* v, const T* w,
                   const float* u, T* y, float* s, int B, int H, int T_len,
                   int dk, const Strides* st, cudaStream_t stream) {
  wkv_kernel<T, DK><<<B * H, DK, 0, stream>>>(r, k, v, w, u, y, s, H, T_len,
                                              dk, st[0], st[1], st[2], st[3],
                                              st[4]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, void* s, int B,
                     int H, int T_len, int dk, const long long* strides,
                     void* stream) {
  if (B < 1 || H < 1 || (long long)B * H > 2147483647LL || T_len < 1 ||
      dk < 1 || dk > 64) {
    return cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  const float* uu = static_cast<const float*>(u);
  T* yy = static_cast<T*>(y);
  float* ss = static_cast<float*>(s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dk <= 16) return launch<T, 16>(rr, kk, vv, ww, uu, yy, ss, B, H, T_len, dk, st, cs);
  if (dk <= 32) return launch<T, 32>(rr, kk, vv, ww, uu, yy, ss, B, H, T_len, dk, st, cs);
  return launch<T, 64>(rr, kk, vv, ww, uu, yy, ss, B, H, T_len, dk, st, cs);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides`
// holds 15 element strides: (batch, head, time) of r, k, v, w and y.
int wkv_f32(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* y, void* s, int B, int H, int T, int dk,
            const long long* strides, void* stream) {
  return (int)dispatch<float>(r, k, v, w, u, y, s, B, H, T, dk, strides,
                              stream);
}

int wkv_bf16(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* s, int B, int H, int T, int dk,
             const long long* strides, void* stream) {
  return (int)dispatch<__nv_bfloat16>(r, k, v, w, u, y, s, B, H, T, dk,
                                      strides, stream);
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
