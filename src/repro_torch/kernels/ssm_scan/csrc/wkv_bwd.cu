// Backward pass of the RWKV6 wkv recurrence for Hopper (sm_90a), f32:
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// from S_0 = 0 per (batch item, head). Given dy, it returns dr, dk, dv, dw
// (B, H, T, dk) and du (H, dk). The final state S_T is treated as having
// no gradient (it is unused in training; the wrapper raises on a nonzero
// one). It runs in reverse time carrying G_t = dL/dS_t:
//
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]     + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]     + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b, t} r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   G_T = 0.
//
// Replaces: the gradient of the reference's RWKV6 time scan, which XLA
// differentiates (src/repro/models/ssm.py:42, chunked_time_scan, through
// _rwkv_step; the reference's Pallas kernel, src/repro/kernels/ssm_scan/
// kernel.py:24, has no backward, and its LM trains through the scan). In
// the port every RWKV6 time-mix of a training step runs through the
// forward kernel (wkv.cu), so its gradient comes from here: one launch per
// RWKV layer per step.
//
// What bounds it: at the rwkv6-1.6b training shape (B=4, H=32, T=2048,
// dk=64) it reads r, k, v, w, dy and writes dr, dk, dv, dw: 9 tensors of
// 67 MB, 0.18 ms at 3.35 TB/s; the reverse step does about 14 dk^2 flops
// per head (the G update, dk, dv, dw and dr products and S_{t-1}),
// 15.0 GFLOP, 0.22 ms at 67 TFLOP/s (f32 FFMA): operations.
//
// Design (a first, simple kernel; speed is a later step):
//   * S_{t-1} is needed at every reverse step, and w may be near 0, so it
//     is never recovered by dividing by w. One block per (batch item,
//     head) first runs the recurrence forward and stores the state at the
//     start of every chunk of 16 steps (its own patch, to the wrapper's
//     scratch `ckpt`); the reverse sweep then takes the chunks last to
//     first and rebuilds S_{t-1} for each step of a chunk from the chunk's
//     stored state (at most 15 steps of the update per step, 7.5 on
//     average; the patch stays in registers).
//   * 256 threads hold the 64 x 64 state (and G) as 4 x 4 patches: rows
//     4 rg .. 4 rg + 3 and columns 4 cg .. 4 cg + 3, cg = tid % 16. A
//     row's 16 column groups are the 16 lanes of a half-warp, so the sums
//     over j (dr, dk, dw) are shuffles within it (xor 1, 2, 4, 8); the sum
//     over i (dv) crosses the block's 16 row groups and goes through
//     shared memory: each step's shares are kept for the chunk, then summed
//     in row-group order after one barrier.
//   * du sums over time in registers and over the batch in a second small
//     kernel (`du_kernel`): no float atomics, so a rerun is bit-equal.
//   * v . dy and r . (u * k) of each step are computed once per chunk (one
//     warp per step) into shared memory.
//   * r, k, v, w and dy are staged per chunk in shared memory; dk < 64 is
//     padded with zero channels (k = w = r = 0 keep padded rows of S and
//     G at zero, v = dy = 0 padded columns). dr, dk, dv, dw are written
//     contiguous.
//   * shared memory: 5 x 16 x 64 staged inputs, 16 x 16 x 64 dv shares and
//     32 scalars: 86,144 B. Scratch: ceil(T / 16) states of 64 x 64 f32 per
//     (batch item, head), 268 MB at the rwkv6-1.6b shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;           // threads per block
constexpr int CT = 16;             // steps per chunk
constexpr int DKP = 64;            // the state's padded width
constexpr int PATCH = 16;          // floats of the state per thread

struct Strides {
  long long b, h, s;
};

// CT steps from t0 on of dk channels (valid: t < T_len, channel < dk) into
// dst[CT][DKP]; the rest zero-filled.
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           long long stride, int t0,
                                           int T_len, int dk, int tid) {
  for (int e = tid; e < CT * DKP; e += NTH) {
    const int r = e / DKP;
    const int d = e - r * DKP;
    dst[e] = (t0 + r < T_len && d < dk) ? src[(t0 + r) * stride + d] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(const float4 x, float* a) {
  a[0] = x.x;
  a[1] = x.y;
  a[2] = x.z;
  a[3] = x.w;
}

__global__ void __launch_bounds__(NTH)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dy,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_part, float* __restrict__ ckpt, int H,
               int T_len, int dkn, int n_ch, Strides rs, Strides ks,
               Strides vs, Strides ws, Strides gs) {
  // Dynamic shared memory: r, k, v, w, dy of a chunk as [CT][DKP] each;
  // the dv shares as [CT][16 row groups][DKP]; v . dy and r . (u k).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sr = reinterpret_cast<float*>(smem_raw);
  float* const sk = sr + CT * DKP;
  float* const sv = sk + CT * DKP;
  float* const sw = sv + CT * DKP;
  float* const sg = sw + CT * DKP;
  float* const part = sg + CT * DKP;
  float* const svdy = part + CT * 16 * DKP;
  float* const sruk = svdy + CT;

  const int tid = threadIdx.x;
  const int cg = tid & 15;               // columns 4 cg .. 4 cg + 3
  const int rg = tid >> 4;               // rows 4 rg .. 4 rg + 3
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const float* rp = r + b * rs.b + h * rs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const float* wp = w + b * ws.b + h * ws.h;
  const float* gp = dy + b * gs.b + h * gs.h;
  const long long out0 = (long long)bh * T_len * dkn;
  float* const ck = ckpt + (long long)bh * n_ch * NTH * PATCH;

  float uu[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    uu[e] = 4 * rg + e < dkn ? u[h * dkn + 4 * rg + e] : 0.f;
  const float u_lo = lane < dkn ? u[h * dkn + lane] : 0.f;
  const float u_hi = lane + 32 < dkn ? u[h * dkn + lane + 32] : 0.f;

  // 1. forward: the state at the start of every chunk, to ckpt
  float S[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) S[e][c] = 0.f;
  for (int ch = 0; ch < n_ch; ++ch) {
    float4* dst = reinterpret_cast<float4*>(ck + (ch * NTH + tid) * PATCH);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[e] = make_float4(S[e][0], S[e][1], S[e][2], S[e][3]);
    if (ch == n_ch - 1) break;           // the last chunk's end is unused
    const int t0 = ch * CT;
    __syncthreads();
    load_chunk(sk, kp, ks.s, t0, T_len, dkn, tid);
    load_chunk(sv, vp, vs.s, t0, T_len, dkn, tid);
    load_chunk(sw, wp, ws.s, t0, T_len, dkn, tid);
    __syncthreads();
    for (int tt = 0; tt < CT; ++tt) {    // a full chunk: t0 + CT <= T
      float k4[4], w4[4], v4[4];
      unpack(ld4(sk + tt * DKP + 4 * rg), k4);
      unpack(ld4(sw + tt * DKP + 4 * rg), w4);
      unpack(ld4(sv + tt * DKP + 4 * cg), v4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) S[e][c] = fmaf(w4[e], S[e][c], k4[e] * v4[c]);
    }
  }

  // 2. reverse, chunk by chunk
  float G[4][4], du_acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) G[e][c] = 0.f;
  for (int ch = n_ch - 1; ch >= 0; --ch) {
    const int t0 = ch * CT;
    const int nt = min(CT, T_len - t0);
    __syncthreads();                     // the previous chunk is consumed
    load_chunk(sr, rp, rs.s, t0, T_len, dkn, tid);
    load_chunk(sk, kp, ks.s, t0, T_len, dkn, tid);
    load_chunk(sv, vp, vs.s, t0, T_len, dkn, tid);
    load_chunk(sw, wp, ws.s, t0, T_len, dkn, tid);
    load_chunk(sg, gp, gs.s, t0, T_len, dkn, tid);
    __syncthreads();
    for (int tt = warp; tt < CT; tt += NTH / 32) {
      const float* rr = sr + tt * DKP;
      const float* kk = sk + tt * DKP;
      float a = sv[tt * DKP + lane] * sg[tt * DKP + lane];
      a = fmaf(sv[tt * DKP + lane + 32], sg[tt * DKP + lane + 32], a);
      float c = rr[lane] * u_lo * kk[lane];
      c = fmaf(rr[lane + 32] * u_hi, kk[lane + 32], c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        c += __shfl_xor_sync(0xffffffffu, c, off);
      }
      if (lane == 0) {
        svdy[tt] = a;
        sruk[tt] = c;
      }
    }
    __syncthreads();
    float C0[4][4];
    {
      const float4* src =
          reinterpret_cast<const float4*>(ck + (ch * NTH + tid) * PATCH);
#pragma unroll
      for (int e = 0; e < 4; ++e) unpack(src[e], C0[e]);
    }
    for (int tt = nt - 1; tt >= 0; --tt) {
      // S_{t-1}: the chunk's first state, advanced tt steps
      float Sp[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) Sp[e][c] = C0[e][c];
      for (int s = 0; s < tt; ++s) {
        float k4[4], w4[4], v4[4];
        unpack(ld4(sk + s * DKP + 4 * rg), k4);
        unpack(ld4(sw + s * DKP + 4 * rg), w4);
        unpack(ld4(sv + s * DKP + 4 * cg), v4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            Sp[e][c] = fmaf(w4[e], Sp[e][c], k4[e] * v4[c]);
      }
      float r4[4], k4[4], w4[4], v4[4], g4[4];
      unpack(ld4(sr + tt * DKP + 4 * rg), r4);
      unpack(ld4(sk + tt * DKP + 4 * rg), k4);
      unpack(ld4(sw + tt * DKP + 4 * rg), w4);
      unpack(ld4(sv + tt * DKP + 4 * cg), v4);
      unpack(ld4(sg + tt * DKP + 4 * cg), g4);
      float pdk[4], pdw[4], pdr[4], pdv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pdk[e] = G[e][0] * v4[0];
        pdw[e] = G[e][0] * Sp[e][0];
        pdr[e] = Sp[e][0] * g4[0];
#pragma unroll
        for (int c = 1; c < 4; ++c) {
          pdk[e] = fmaf(G[e][c], v4[c], pdk[e]);
          pdw[e] = fmaf(G[e][c], Sp[e][c], pdw[e]);
          pdr[e] = fmaf(Sp[e][c], g4[c], pdr[e]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pdv[c] = G[0][c] * k4[0];
#pragma unroll
        for (int e = 1; e < 4; ++e) pdv[c] = fmaf(G[e][c], k4[e], pdv[c]);
      }
      *reinterpret_cast<float4*>(part + (tt * 16 + rg) * DKP + 4 * cg) =
          make_float4(pdv[0], pdv[1], pdv[2], pdv[3]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pdk[e] += __shfl_xor_sync(0xffffffffu, pdk[e], off);
          pdw[e] += __shfl_xor_sync(0xffffffffu, pdw[e], off);
          pdr[e] += __shfl_xor_sync(0xffffffffu, pdr[e], off);
        }
      }
      const float vdy = svdy[tt];
      const long long row = out0 + (long long)(t0 + tt) * dkn;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * rg + e;
        if (i < dkn) {
          if (cg == e) dk[row + i] = fmaf(uu[e] * r4[e], vdy, pdk[e]);
          if (cg == 4 + e) dw[row + i] = pdw[e];
          if (cg == 8 + e) dr[row + i] = fmaf(uu[e] * k4[e], vdy, pdr[e]);
        }
        du_acc[e] = fmaf(r4[e] * k4[e], vdy, du_acc[e]);
#pragma unroll
        for (int c = 0; c < 4; ++c) G[e][c] = fmaf(w4[e], G[e][c], r4[e] * g4[c]);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nt * DKP; idx += NTH) {
      const int tt = idx / DKP;
      const int j = idx - tt * DKP;
      if (j >= dkn) continue;
      float s = part[(tt * 16) * DKP + j];
#pragma unroll
      for (int g = 1; g < 16; ++g) s += part[(tt * 16 + g) * DKP + j];
      dv[out0 + (long long)(t0 + tt) * dkn + j] =
          fmaf(sruk[tt], sg[tt * DKP + j], s);
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * rg + e < dkn) du_part[(long long)bh * dkn + 4 * rg + e] = du_acc[e];
  }
}

// du[h][i] = sum_b du_part[b][h][i], in batch order.
__global__ void du_kernel(const float* __restrict__ du_part,
                          float* __restrict__ du, int B, int H, int dkn) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * dkn) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[(long long)b * H * dkn + idx];
  du[idx] = s;
}

constexpr size_t smem_bytes() {
  return sizeof(float) * (5 * CT * DKP + CT * 16 * DKP + 2 * CT);
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream` and returns cudaGetLastError() (0
// on success); it does not synchronise and allocates nothing. `strides`
// holds 15 element strides: (batch, head, time) of r, k, v, w and dy (unit
// stride over dk). u (H, dk) f32 contiguous; dr, dk, dv, dw (B, H, T, dk)
// and du (H, dk) are written contiguous. Scratch from the wrapper:
// `du_part` (B, H, dk) f32 and `ckpt`, B H ceil(T / 16) 4096 f32 (one
// 64 x 64 state per chunk of 16 steps per (batch item, head)).
int wkv_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* dy, void* dr, void* dk, void* dv,
                void* dw, void* du, void* du_part, void* ckpt, int B, int H,
                int T, int dkn, const long long* strides, void* stream) {
  if (B < 1 || H < 1 || T < 1 || dkn < 1 || dkn > DKP ||
      (long long)B * H > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  const int n_ch = (T + CT - 1) / CT;
  constexpr size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  wkv_bwd_kernel<<<B * H, NTH, smem, cs>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<float*>(dr), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dw),
      static_cast<float*>(du_part), static_cast<float*>(ckpt), H, T, dkn,
      n_ch, st[0], st[1], st[2], st[3], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  du_kernel<<<(H * dkn + 255) / 256, 256, 0, cs>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), B, H,
      dkn);
  return (int)cudaGetLastError();
}

const char* wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
