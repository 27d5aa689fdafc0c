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
// entry of key channel i and value channel j. dk <= 64.
//
// What bounds it: at the rwkv6-1.6b prefill shape (B=4, H=32, T=2048,
// dk=64, f32) each step does about 5 dk^2 flops per head: 5 B H T dk^2 =
// 5.4 GFLOP, 0.08 ms at 67 TFLOP/s, against 5 B H T dk x 4 bytes of r, k,
// v, w, y plus the f32 state, 338 MB, 0.10 ms at 3.35 TB/s: bytes. The
// serial chain over T is one FMA per state entry per step,
// S[i][j] <- w_i S[i][j] + k_i v_j; everything else (y's dot product, the
// bonus term) hangs off it. So the kernel has to spread the state over
// enough threads to issue that work, and keep y off the chain.
//
// Design:
//   * value columns are independent (S[:, j] depends only on v_j). A block
//     takes 32 columns of one head in 128 threads: each thread holds a
//     4 x C patch of S in registers (4 key rows, one float4 group; C = 4
//     value columns at dk = 64, 2 at 32, 1 at 16), and R = dk / 4
//     consecutive lanes span a column's rows. A thread reads its rows of
//     r, k, w once per step as float4s and uses them for C columns. At the
//     full-width shape that is 2 blocks per head, 256 blocks of 4 warps,
//     against one block of 2 warps per head before. Every block stages
//     all of r, k and w, so fewer, wider blocks per head copy less from L2.
//   * y_t[j] = sum_i r_i S_{t-1}[i][j] + (sum_i r_i u_i k_i) v_j. Each lane
//     takes both sums over its own 4 rows (the bonus term needs no pass of
//     its own) and keeps its shares of the chunk's 16 steps in registers;
//     only the state update S[i][j] <- w_i S[i][j] + k_i v_j is a chain
//     from step to step. After the chunk each lane writes its 16 C shares
//     to its own padded row of shared memory and, after a __syncwarp,
//     reads back 4 entries of each of its group's R rows, sums them as a
//     tree and stores 4 finished values of y. No block barrier separates
//     these phases, so one warp's reduction overlaps another's steps (with
//     a barrier between phases each phase is bound by its own latency).
//     The transpose issues fewer instructions than a shuffle butterfly
//     would (at dk = 64, 16 + 16 vector accesses per lane and chunk against
//     60 shuffles and 120 selects).
//   * the TPU kernel's sequential chunk grid becomes a loop inside the
//     block over chunks of 16 steps of r, k, w (all dk channels) and v (the
//     block's columns), staged in shared memory with 16-byte cp.async, 4
//     stages deep (3 chunks load while one computes; one barrier per
//     chunk). bf16 inputs are staged as they are and widened to f32 as
//     they are read; the state and all arithmetic stay f32. Rows that are
//     not 16-byte aligned (odd strides, dk not a multiple of 16 bytes) take
//     per-element loads (the `vec` flag, chosen by the wrapper).
//   * the loop runs over the real T: the reference pads time with w=1,
//     k=0 no-op steps to a chunk multiple, a TPU tiling artifact. Ragged dk
//     is padded with zero channels in shared memory (k = w = 0 keeps the
//     padded rows of S at zero, v = 0 its padded columns).
//   * shared memory: 4 stages x 16 steps x (3 dk + 32) plus 128 x (16 C + 4)
//     f32 shares: 92,160 B in f32 at dk = 64 (2 blocks per SM).
//
// Departure from the reference's arithmetic: y is summed in another order
// (per lane over its 4 rows, bonus term included, then a tree over the
// lanes: halves at distance R/2 first), so it agrees to f32 rounding, not
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int JC = 32;             // value columns per block
constexpr int NTH = 128;           // threads per block
constexpr int NSTAGE = 4;          // chunks in flight + the one computing
constexpr int CT = 16;             // steps per chunk

// A block takes JC value columns of one head in 128 threads; each thread
// holds C of them for 4 key rows (one float4 group), and R = DK / 4
// consecutive lanes span the rows. CT = 4 R / C, so a lane's CT x C shares
// of y reduce over the R lanes to 4 values per lane.
template <int DK>
struct Split {
  static constexpr int R = DK / 4;                           // lanes per column group
  static constexpr int C = DK == 64 ? 4 : DK == 32 ? 2 : 1;  // columns per lane
  static constexpr int V = CT * C;                           // shares per lane
  static constexpr int LDV = V + 4;                          // padded row
  static_assert((JC / C) * R == NTH && V == 4 * R && R <= 32, "tiling");
};

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
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
// C floats to 16-, 8- or 4-byte-aligned shared memory in one store.
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
  if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// CT steps from t0 on of W channels (valid: t < T_len, channel < ncols)
// into dst[CT][W]; the rest zero-filled.
template <typename T, int W, bool VEC>
__device__ __forceinline__ void load_chunk(T* dst, const T* src,
                                           long long stride, int t0,
                                           int T_len, int ncols, int tid) {
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = W / EPC;
    for (int c = tid; c < CT * CPR; c += NTH) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * EPC;
      const bool ok = t0 + r < T_len && d < ncols;
      cp_async16(dst + r * W + d, ok ? src + (t0 + r) * stride + d : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < CT * W; e += NTH) {
      const int r = e / W;
      const int d = e - r * W;
      dst[e] = (t0 + r < T_len && d < ncols) ? src[(t0 + r) * stride + d]
                                             : zero<T>();
    }
  }
}

// Sums N float4s pairwise as a tree: the halves at distance N/2 first,
// then N/4, ..; compile-time indices (no local memory).
template <int N>
__device__ __forceinline__ float4 tree_sum(float4* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      x[i].x += x[i + N / 2].x;
      x[i].y += x[i + N / 2].y;
      x[i].z += x[i + N / 2].z;
      x[i].w += x[i + N / 2].w;
    }
    return tree_sum<N / 2>(x);
  }
}

template <typename T, int DK, bool VEC>
__global__ void __launch_bounds__(NTH)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ y,
           float* __restrict__ s_out, int H, int T_len, int dk, int n_cb,
           Strides rs, Strides ks, Strides vs, Strides ws, Strides ys) {
  constexpr int R = Split<DK>::R, C = Split<DK>::C;
  constexpr int V = Split<DK>::V, LDV = Split<DK>::LDV;
  // Dynamic shared memory (smem_bytes): r, k, w as [NSTAGE][CT][DK] and v
  // as [NSTAGE][CT][JC], in the input dtype; then each lane's shares of y
  // as f32 [NTH][LDV] (read back only by its own warp).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sr = reinterpret_cast<T*>(smem_raw);
  T* const sk = sr + NSTAGE * CT * DK;
  T* const sw = sk + NSTAGE * CT * DK;
  T* const sv = sw + NSTAGE * CT * DK;
  float* const sy = reinterpret_cast<float*>(sv + NSTAGE * CT * JC);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_cb;      // the column blocks of a head
  const int j0 = (blockIdx.x - bh * n_cb) * JC;   // are neighbours
  const int b = bh / H;
  const int h = bh - b * H;
  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h + j0;
  const T* wp = w + b * ws.b + h * ws.h;
  T* yp = y + b * ys.b + h * ys.h;

  const int cg = tid / R;                // this lane's column group
  const int lr = tid - cg * R;           // and its 4 rows: 4 lr .. 4 lr + 3
  float u4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) u4[e] = 4 * lr + e < dk ? u[h * dk + 4 * lr + e] : 0.f;
  float S[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) S[c][0] = S[c][1] = S[c][2] = S[c][3] = 0.f;

  auto load = [&](int stage, int t0) {
    load_chunk<T, DK, VEC>(sr + stage * CT * DK, rp, rs.s, t0, T_len, dk,
                           tid);
    load_chunk<T, DK, VEC>(sk + stage * CT * DK, kp, ks.s, t0, T_len, dk,
                           tid);
    load_chunk<T, DK, VEC>(sw + stage * CT * DK, wp, ws.s, t0, T_len, dk,
                           tid);
    load_chunk<T, JC, VEC>(sv + stage * CT * JC, vp, vs.s, t0, T_len,
                           dk - j0, tid);
  };

  // Chunk c computes from stage c % NSTAGE while chunks c+1 .. c+NSTAGE-1
  // load; one copy group per chunk (empty past the end).
  const int n_ch = (T_len + CT - 1) / CT;
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) {
    if (c < n_ch) load(c, c * CT);
    cp_async_commit();
  }
  for (int c = 0; c < n_ch; ++c) {
    const int st = c % NSTAGE;
    const int t0 = c * CT;
    const int nt = min(CT, T_len - t0);
    cp_async_wait<NSTAGE - 2>();         // chunk c has landed, and every
    __syncthreads();                     // warp is done with chunk c-1,
    const int ahead = c + NSTAGE - 1;    // whose stage refills now
    if (ahead < n_ch) load(ahead % NSTAGE, ahead * CT);
    cp_async_commit();

    // The serial steps: only the state update is a chain. A lane's share
    // of y_t[j] over its rows i is sum_i r_i S[i][j] + (sum_i r_i u_i k_i)
    // v_j, kept in registers.
    float part[V];
    auto step = [&](int tt) {
      const int row = (st * CT + tt) * DK + 4 * lr;
      const float4 r4 = ld4(sr + row);
      const float4 k4 = ld4(sk + row);
      const float4 w4 = ld4(sw + row);
      float bonus = r4.x * u4[0] * k4.x;
      bonus = fmaf(r4.y * u4[1], k4.y, bonus);
      bonus = fmaf(r4.z * u4[2], k4.z, bonus);
      bonus = fmaf(r4.w * u4[3], k4.w, bonus);
#pragma unroll
      for (int c2 = 0; c2 < C; ++c2) {
        const float vj = ld1(sv + (st * CT + tt) * JC + cg * C + c2);
        float d = r4.x * S[c2][0];
        d = fmaf(r4.y, S[c2][1], d);
        d = fmaf(r4.z, S[c2][2], d);
        d = fmaf(r4.w, S[c2][3], d);
        part[tt * C + c2] = fmaf(bonus, vj, d);
        S[c2][0] = fmaf(w4.x, S[c2][0], k4.x * vj);
        S[c2][1] = fmaf(w4.y, S[c2][1], k4.y * vj);
        S[c2][2] = fmaf(w4.z, S[c2][2], k4.z * vj);
        S[c2][3] = fmaf(w4.w, S[c2][3], k4.w * vj);
      }
    };
    if (nt == CT) {
#pragma unroll
      for (int tt = 0; tt < CT; ++tt) step(tt);
    } else {                             // the last chunk only
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
    // warp's rows of sy: lane lr adds entries 4 lr .. 4 lr + 3 of the R
    // lanes' shares (a tree), which are y at step (4 lr + m) / C and
    // column (4 lr + m) % C of the group, and stores them.
    float* mine = sy + tid * LDV;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(mine + i) =
          make_float4(part[i], part[i + 1], part[i + 2], part[i + 3]);
    __syncwarp();
    float4 sh[R];
    const float* group = sy + (tid - lr) * LDV + 4 * lr;
#pragma unroll
    for (int l2 = 0; l2 < R; ++l2)
      sh[l2] = *reinterpret_cast<const float4*>(group + l2 * LDV);
    const float4 y4 = tree_sum<R>(sh);
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int tt = (4 * lr + m) / C;
      const int j = j0 + cg * C + (4 * lr + m) % C;
      if (tt < nt && j < dk)
        store1(yp + (long long)(t0 + tt) * ys.s + j, yv[m]);
    }
  }

  float* sp = s_out + (long long)bh * dk * dk;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + cg * C + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * lr + e;
      if (i < dk && j < dk) sp[(long long)i * dk + j] = S[c][e];
    }
  }
}

// Blocks per head: JC value columns each.
int column_blocks(int dk) { return (dk + JC - 1) / JC; }

template <typename T, int DK>
constexpr size_t smem_bytes() {
  return sizeof(T) * NSTAGE * CT * (3 * DK + JC) +
         sizeof(float) * NTH * Split<DK>::LDV;
}

template <typename T, int DK, bool VEC>
cudaError_t launch(const T* r, const T* k, const T* v, const T* w,
                   const float* u, T* y, float* s, int B, int H, int T_len,
                   int dk, const Strides* st, cudaStream_t stream) {
  const int n_cb = column_blocks(dk);
  constexpr size_t smem = smem_bytes<T, DK>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, DK, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wkv_kernel<T, DK, VEC><<<B * H * n_cb, NTH, smem, stream>>>(
      r, k, v, w, u, y, s, H, T_len, dk, n_cb, st[0], st[1], st[2], st[3],
      st[4]);
  return cudaGetLastError();
}

bool valid(int B, int H, int T_len, int dk) {
  return B >= 1 && H >= 1 && T_len >= 1 && dk >= 1 && dk <= 64 &&
         (long long)B * H * column_blocks(dk) <= 2147483647LL;
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* y, void* s, int B,
                     int H, int T_len, int dk, const long long* strides,
                     int vec, void* stream) {
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
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  const float* uu = static_cast<const float*>(u);
  T* yy = static_cast<T*>(y);
  float* ss = static_cast<float*>(s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define WKV_LAUNCH(DK, VEC)                                                   \
  launch<T, DK, VEC>(rr, kk, vv, ww, uu, yy, ss, B, H, T_len, dk, st, cs)
  if (dk <= 16) return vec ? WKV_LAUNCH(16, true) : WKV_LAUNCH(16, false);
  if (dk <= 32) return vec ? WKV_LAUNCH(32, true) : WKV_LAUNCH(32, false);
  return vec ? WKV_LAUNCH(64, true) : WKV_LAUNCH(64, false);
#undef WKV_LAUNCH
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing. `strides`
// holds 15 element strides: (batch, head, time) of r, k, v, w and y.
// `vec` (0/1) says that every row of r, k, v and w starts 16-byte aligned
// and dk fills whole 16-byte chunks, so chunks load with cp.async
// (checked: cudaErrorMisalignedAddress).
int wkv_f32(const void* r, const void* k, const void* v, const void* w,
            const void* u, void* y, void* s, int B, int H, int T, int dk,
            const long long* strides, int vec, void* stream) {
  return (int)dispatch<float>(r, k, v, w, u, y, s, B, H, T, dk, strides,
                              vec, stream);
}

int wkv_bf16(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* s, int B, int H, int T, int dk,
             const long long* strides, int vec, void* stream) {
  return (int)dispatch<__nv_bfloat16>(r, k, v, w, u, y, s, B, H, T, dk,
                                      strides, vec, stream);
}

// The launch geometry for (B, H, dk): grid[0] blocks of grid[1] threads.
int wkv_launch_shape(int B, int H, int dk, int* grid) {
  if (!valid(B, H, 1, dk)) return (int)cudaErrorInvalidValue;
  grid[0] = B * H * column_blocks(dk);
  grid[1] = NTH;
  return 0;
}

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
