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
// prefill, 48 per train step (remat). Decode stays the plain one-step
// recurrence, as in the reference.
//
// Contract: r, k, v, w (B, H, T, dk), f32 or bf16, any strides over
// (B, H, T) and unit stride over dk; u (H, dk) f32. y (B, H, T, dk) in r's
// dtype (strides given), S (B, H, dk, dk) f32 contiguous, S[i][j] the
// entry of key channel i and value channel j. dk <= 64. Scratch from the
// wrapper: `states`, B H ceil(T / 64) 64 x 64 f32 (the state at every
// chunk start).
//
// What bounds it: at the rwkv6-1.6b prefill shape (B=4, H=32, T=2048,
// dk=64, f32) each step does about 5 dk^2 flops per head: 5 B H T dk^2 =
// 5.4 GFLOP, 0.08 ms at 67 TFLOP/s, against 5 B H T dk x 4 bytes of r, k,
// v, w, y plus the f32 state, 338 MB, 0.10 ms at 3.35 TB/s: bytes. The
// SIMT design held one serial chain of 2048 steps per head in 256 blocks
// of 4 warps; this one breaks the chain, at the price of a second pass:
// the state pass reads k, w, v once more and writes the chunk states
// (268 MB, 0.08 ms at 3.35 TB/s), the y pass reads them back.
//
// Design: two launches.
//   * the chunk-state pass (wkv_chunk.cuh, `wkv_state_kernel`): per
//     (batch item, head) the state at the start of each chunk of 64 steps,
//     one split-TF32 wgmma product per chunk (S_end = diag(prod w) S_start
//     + K~^T V, k~ = k times suffix products of w), and S_T from the last
//     chunk. 128 blocks at the rwkv6-1.6b shape, the chain 32 products
//     long, bound by its bytes. The states are returned to the caller (the
//     backward of the same inputs can take them).
//   * the chunks in parallel (`wkv_chunk_kernel`): one block of 128
//     threads per (batch item, head, chunk), 4096 blocks there, runs the
//     direct recurrence over its chunk from its chunk-start state: each
//     thread holds a 4 x 8 patch of S in registers (4 key rows, one float4
//     group; 8 value columns), R = 16 consecutive lanes span a column's 64
//     rows. y_t[j] = sum_i r_i S_{t-1}[i][j] + (sum_i r_i u_i k_i) v_j: each
//     lane takes both sums over its own 4 rows and keeps its shares of a
//     sub-chunk's 4 steps in registers; only the state update is a chain.
//     After the sub-chunk each lane writes its 32 shares to its own padded
//     row of shared memory and, after a __syncwarp, reads back 2 entries of
//     each of its group's 16 rows, sums them as a tree and stores 2 values
//     of y. Sub-chunks of 4 steps of r, k, w, v (all 64 channels) are
//     staged with 16-byte cp.async, 3 stages; bf16 inputs are staged as
//     they are and widened as they are read. 30 KB of shared memory and
//     96 registers a thread: five blocks (20 warps) per SM. On the H100
//     4 x 4 patches in 256 threads ran as fast; deeper staging (6 and 8
//     stages) and looser register caps (three and four blocks per SM) ran
//     slower: the pass is bound by latency, and warps per SM hide it.
//   * the loops run over the real T (the reference pads time with w=1,
//     k=0 no-op steps to a chunk multiple, a TPU tiling artifact; the state
//     pass treats steps past T as such no-ops). dk < 64 is padded with zero
//     channels (k = w = 0 keeps the padded rows of S at zero, v = 0 its
//     padded columns). Rows that are not 16-byte aligned (odd strides, dk
//     not a multiple of 16 bytes) take per-element loads (the `vec` flag,
//     chosen by the wrapper).
//
// Departure from the reference's arithmetic: the chunk-start states come
// from split-TF32 products (each operand x = hi + lo rounded to TF32; the
// lo.lo product dropped; the tensor cores' adds truncate), and y is summed
// in another order (per lane over its 4 rows, bonus term included, then a
// tree over the lanes: halves at distance R/2 first), so it agrees to f32
// rounding, not bit for bit.

#include "wkv_chunk.cuh"

namespace {

constexpr int NTH = 128;           // threads per block of the y kernel
constexpr int NSTAGE = 3;          // sub-chunks in flight + the one computing
constexpr int CT = 4;              // steps per sub-chunk
constexpr int R = DKP / 4;         // lanes per column group (4 rows each)
constexpr int C = 8;               // value columns per lane
constexpr int V = CT * C;          // shares of y per lane and sub-chunk
constexpr int LDV = V + 4;         // its padded row
static_assert((DKP / C) * R == NTH && V == 2 * R, "tiling");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// Sums N float2s pairwise as a tree: the halves at distance N/2 first,
// then N/4, ..; compile-time indices (no local memory).
template <int N>
__device__ __forceinline__ float2 tree_sum(float2* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      x[i].x += x[i + N / 2].x;
      x[i].y += x[i + N / 2].y;
    }
    return tree_sum<N / 2>(x);
  }
}

// The chunk-state pass of the forward: the state chain, S_T to s_out.
template <typename T, bool VEC>
__global__ void __launch_bounds__(ST_NT, 1)
wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ w,
                 const T* __restrict__ v, Strides ks, Strides ws, Strides vs,
                 float* __restrict__ states, float* __restrict__ s_out,
                 int H, int T_len, int dk, int n_ch) {
  state_chain<T, VEC>(k, w, v, ks, ws, vs, nullptr, states, s_out, H,
                         T_len, dk, n_ch, false, blockIdx.x);
}

// y over one chunk of one (batch item, head) from its chunk-start state.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NTH, 5)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u,
                 const float* __restrict__ states, T* __restrict__ y, int H,
                 int T_len, int dk, int n_ch, Strides rs, Strides ks,
                 Strides vs, Strides ws, Strides ys) {
  // Dynamic shared memory: r, k, w, v as [NSTAGE][CT][DKP] in the input
  // dtype; then each lane's shares of y as f32 [NTH][LDV] (read back only
  // by its own warp).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sr = reinterpret_cast<T*>(smem_raw);
  T* const sk = sr + NSTAGE * CT * DKP;
  T* const sw = sk + NSTAGE * CT * DKP;
  T* const sv = sw + NSTAGE * CT * DKP;
  float* const sy = reinterpret_cast<float*>(sv + NSTAGE * CT * DKP);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_ch;      // the chunks of a head are
  const int ch = blockIdx.x - bh * n_ch; // neighbours
  const int b = bh / H;
  const int h = bh - b * H;
  const int t_begin = ch * CH;
  const int t_end = min(T_len, t_begin + CH);
  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const T* wp = w + b * ws.b + h * ws.h;
  T* yp = y + b * ys.b + h * ys.h;

  const int cg = tid / R;                // this lane's column group: columns
  const int lr = tid - cg * R;           // C cg .., rows 4 lr .. 4 lr + 3
  float u4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    u4[e] = 4 * lr + e < dk ? u[h * dk + 4 * lr + e] : 0.f;
  float S[C][4];
  {
    const float* s0 = states + ((long long)bh * n_ch + ch) * DKP * DKP;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < C; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(
            s0 + (4 * lr + e) * DKP + C * cg + q);
        S[q][e] = x.x;
        S[q + 1][e] = x.y;
        S[q + 2][e] = x.z;
        S[q + 3][e] = x.w;
      }
  }

  auto load = [&](int stage, int t0) {
    stage_rows<CT, DKP, NTH, VEC>(sr + stage * CT * DKP, rp, rs.s, t0, t_end,
                                 dk, tid);
    stage_rows<CT, DKP, NTH, VEC>(sk + stage * CT * DKP, kp, ks.s, t0, t_end,
                                 dk, tid);
    stage_rows<CT, DKP, NTH, VEC>(sw + stage * CT * DKP, wp, ws.s, t0, t_end,
                                 dk, tid);
    stage_rows<CT, DKP, NTH, VEC>(sv + stage * CT * DKP, vp, vs.s, t0, t_end,
                                 dk, tid);
  };

  // Sub-chunk c computes from stage c % NSTAGE while sub-chunks c+1 ..
  // c+NSTAGE-1 load; one copy group per sub-chunk (empty past the end).
  const int n_sc = (t_end - t_begin + CT - 1) / CT;
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) {
    if (c < n_sc) load(c, t_begin + c * CT);
    cp_async_commit();
  }
  for (int c = 0; c < n_sc; ++c) {
    const int st = c % NSTAGE;
    const int t0 = t_begin + c * CT;
    const int nt = min(CT, t_end - t0);
    cp_async_wait<NSTAGE - 2>();         // sub-chunk c has landed, and
    __syncthreads();                     // every warp is done with c - 1,
    const int ahead = c + NSTAGE - 1;    // whose stage refills now
    if (ahead < n_sc) load(ahead % NSTAGE, t_begin + ahead * CT);
    cp_async_commit();

    // The serial steps: only the state update is a chain. A lane's share
    // of y_t[j] over its rows i is sum_i r_i S[i][j] + (sum_i r_i u_i k_i)
    // v_j, kept in registers.
    float part[V];
    auto step = [&](int tt) {
      const int row = (st * CT + tt) * DKP + 4 * lr;
      const float4 r4 = ld4(sr + row);
      const float4 k4 = ld4(sk + row);
      const float4 w4 = ld4(sw + row);
      float bonus = r4.x * u4[0] * k4.x;
      bonus = fmaf(r4.y * u4[1], k4.y, bonus);
      bonus = fmaf(r4.z * u4[2], k4.z, bonus);
      bonus = fmaf(r4.w * u4[3], k4.w, bonus);
      float vj[C];
#pragma unroll
      for (int q = 0; q < C; q += 4) {
        const float4 v4 = ld4(sv + (st * CT + tt) * DKP + C * cg + q);
        vj[q] = v4.x, vj[q + 1] = v4.y, vj[q + 2] = v4.z, vj[q + 3] = v4.w;
      }
#pragma unroll
      for (int c2 = 0; c2 < C; ++c2) {
        float d = r4.x * S[c2][0];
        d = fmaf(r4.y, S[c2][1], d);
        d = fmaf(r4.z, S[c2][2], d);
        d = fmaf(r4.w, S[c2][3], d);
        part[tt * C + c2] = fmaf(bonus, vj[c2], d);
        S[c2][0] = fmaf(w4.x, S[c2][0], k4.x * vj[c2]);
        S[c2][1] = fmaf(w4.y, S[c2][1], k4.y * vj[c2]);
        S[c2][2] = fmaf(w4.z, S[c2][2], k4.z * vj[c2]);
        S[c2][3] = fmaf(w4.w, S[c2][3], k4.w * vj[c2]);
      }
    };
    if (nt == CT) {
#pragma unroll
      for (int tt = 0; tt < CT; ++tt) step(tt);
    } else {                             // the last sub-chunk only
#pragma unroll
      for (int tt = 0; tt < CT; ++tt) {
        if (tt < nt) {
          step(tt);
        } else {
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2) part[tt * C + c2] = 0.f;
        }
      }
    }

    // Sum the shares over the R lanes of the column group, through this
    // warp's rows of sy: lane lr adds entries 2 lr, 2 lr + 1 of the R
    // lanes' shares (a tree), which are y at step lr / 4 and columns
    // 2 (lr % 4), 2 (lr % 4) + 1 of the group, and stores them.
    float* mine = sy + tid * LDV;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(mine + i) =
          make_float4(part[i], part[i + 1], part[i + 2], part[i + 3]);
    __syncwarp();
    float2 sh[R];
    const float* group = sy + (tid - lr) * LDV + 2 * lr;
#pragma unroll
    for (int l2 = 0; l2 < R; ++l2)
      sh[l2] = *reinterpret_cast<const float2*>(group + l2 * LDV);
    const float2 y2 = tree_sum<R>(sh);
    const int tt = lr >> 2;
    const int j = C * cg + 2 * (lr & 3);
    if (tt < nt) {
      T* yr = yp + (long long)(t0 + tt) * ys.s;
      if (j < dk) store1(yr + j, y2.x);
      if (j + 1 < dk) store1(yr + j + 1, y2.y);
    }
  }
}

template <typename T>
constexpr size_t chunk_smem_bytes() {
  return sizeof(T) * NSTAGE * CT * 4 * DKP + sizeof(float) * NTH * LDV;
}

template <typename T, bool VEC>
cudaError_t launch(const T* r, const T* k, const T* v, const T* w,
                   const float* u, T* y, float* s, float* states, int B,
                   int H, int T_len, int dk, const Strides* st,
                   cudaStream_t stream) {
  const int n_ch = (T_len + CH - 1) / CH;
  constexpr size_t smem_st = StateSmem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_state_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_st);
  if (err != cudaSuccess) return err;
  wkv_state_kernel<T, VEC><<<B * H, ST_NT, smem_st, stream>>>(
      k, w, v, st[1], st[3], st[2], states, s, H, T_len, dk, n_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = chunk_smem_bytes<T>();
  err = cudaFuncSetAttribute(wkv_chunk_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  wkv_chunk_kernel<T, VEC><<<B * H * n_ch, NTH, smem, stream>>>(
      r, k, v, w, u, states, y, H, T_len, dk, n_ch, st[0], st[1], st[2],
      st[3], st[4]);
  return cudaGetLastError();
}

bool valid(int B, int H, int T_len, int dk) {
  return B >= 1 && H >= 1 && T_len >= 1 && dk >= 1 && dk <= DKP &&
         (long long)B * H * ((T_len + CH - 1) / CH) <= 2147483647LL;
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, void* s,
                     void* states, int B, int H, int T_len, int dk,
                     const long long* strides, int vec, void* stream) {
  if (!valid(B, H, T_len, dk)) return cudaErrorInvalidValue;
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  if (vec) {                             // the wrapper's claim, checked
    constexpr long long EPC = 16 / sizeof(T);
    bool ok = dk % EPC == 0;
    for (int t = 0; t < 12; ++t) ok = ok && strides[t] % EPC == 0;
    const void* ptrs[4] = {r, k, v, w};
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorMisalignedAddress;
  }
#define WKV_LAUNCH(VEC)                                                       \
  launch<T, VEC>(static_cast<const T*>(r), static_cast<const T*>(k),          \
                 static_cast<const T*>(v), static_cast<const T*>(w),          \
                 static_cast<const float*>(u), static_cast<T*>(y),            \
                 static_cast<float*>(s), static_cast<float*>(states), B, H,   \
                 T_len, dk, st, static_cast<cudaStream_t>(stream))
  return vec ? WKV_LAUNCH(true) : WKV_LAUNCH(false);
#undef WKV_LAUNCH
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides`
// holds 15 element strides: (batch, head, time) of r, k, v, w and y.
// `states` is the wrapper's scratch: B H ceil(T / 64) x 64 x 64 f32.
// `vec` (0/1) says that every row of r, k, v and w starts 16-byte aligned
// and dk fills whole 16-byte chunks, so chunks load with cp.async
// (checked: cudaErrorMisalignedAddress).
int wkv_f32(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* y, void* s, void* states, int B, int H,
            int T, int dk, const long long* strides, int vec, void* stream) {
  return (int)dispatch<float>(r, k, v, w, u, y, s, states, B, H, T, dk,
                              strides, vec, stream);
}

int wkv_bf16(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* s, void* states, int B, int H,
             int T, int dk, const long long* strides, int vec,
             void* stream) {
  return (int)dispatch<__nv_bfloat16>(r, k, v, w, u, y, s, states, B, H, T,
                                      dk, strides, vec, stream);
}

// The launch geometry of the y kernel for (B, H, T, dk): grid[0] blocks of
// grid[1] threads (the state pass runs B H blocks of 128).
int wkv_launch_shape(int B, int H, int T, int dk, int* grid) {
  if (!valid(B, H, T, dk)) return (int)cudaErrorInvalidValue;
  grid[0] = B * H * ((T + CH - 1) / CH);
  grid[1] = NTH;
  return 0;
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
