// Backward pass of the RWKV6 wkv recurrence for Hopper (sm_90a), f32 or
// bf16 inputs, f32 arithmetic:
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// from S_0 = 0 per (batch item, head). Given dy and the final state's
// gradient dS (B, H, dk, dk) f32, or none (zero), it returns dr, dk, dv,
// dw (B, H, T, dk, in the inputs' dtype) and du (H, dk, f32). It runs in
// reverse time carrying G_t = dL/dS_t:
//
//   dr_t[i] = sum_j S_{t-1}[i][j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j]     + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i]     + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]   = sum_{b, t} r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   G_T = dS (0 without one).
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
// 15.0 GFLOP, 0.22 ms at 67 TFLOP/s (f32 FFMA): operations. This design
// adds the column groups' partials of dr, dk and dw (written and read
// once by the `wkv_reduce` kernel: 0.40 GB at two groups), the
// chunk-start states (0.27 GB) and half a forward step more per step (the
// states rebuilt in two halves). What holds it back on the card is shared
// memory: every step writes and reads each state entry and each dv share
// once at distinct addresses (four wavefronts per 16-byte warp access);
// the broadcast reads of r, k, w, v and dy cost little.
//
// Design:
//   * column j of S_t depends only on v_t[j], and column j of G_t only on
//     dy_t[j], so the value columns are split over blocks: one block of
//     128 threads per (batch item, head, group of 32 columns), 256 blocks
//     at the rwkv6-1.6b shape (a block per head before). A block owns its
//     columns of S and G outright. dv_t[j] sums over the rows and stays in
//     the block; dr, dk and dw sum over the columns, so each block writes
//     its group's partial to scratch and a second kernel (`wkv_reduce`) adds
//     the groups in a fixed order and sums du over the batch: no float
//     atomics, so a rerun is bit-equal. The first group's partials carry
//     the bonus terms (u k (v . dy), u r (v . dy)) and du.
//   * thread (row i = tid / 2, half = tid % 2) holds 16 columns of row i
//     of G in registers, so dr, dk and dw of a step are sums within the
//     thread and one shuffle with its neighbour; only G's update
//     G <- w_i G + r_i dy is a chain from step to step. The partials go
//     straight to scratch, a row per step.
//   * S_{t-1} is needed at every reverse step and w may be near 0, so it
//     is never recovered by dividing by w. A first pass runs the
//     recurrence forward and stores the state at the start of every chunk
//     of 16 steps (its own columns, to the wrapper's scratch `ckpt`; the
//     chunks staged two ahead). The reverse pass takes the chunks last to
//     first, in two halves of 8 steps: it rebuilds the half's 8 states
//     forward once, from the chunk's stored state, into shared memory
//     (each thread its own row and columns, so no barrier), then runs the
//     half's steps in reverse reading them (before: up to 15 updates per
//     step to rebuild S_{t-1}, 7.5 on average). A step's dv shares
//     G_t[i][j] k_t[i] overwrite the state it has just read; after the
//     half, one barrier, and the block sums them over the rows (four
//     interleaved partial sums, added in a fixed order) and writes dv.
//   * each chunk's r, k, w, v and dy (all dk channels) are staged in
//     shared memory with 16-byte cp.async, two stages: the next chunk
//     loads while this one computes. v . dy and r . (u k) of each step are
//     computed once per chunk (4 threads per sum). Rows not 16-byte
//     aligned take per-element loads. dk < 64 is padded with zero channels
//     (k = w = r = 0 keep padded rows of S and G at zero, v = dy = 0
//     padded columns), and dk <= 32 runs one column group. The loops run
//     over the real T.
//   * the state buffer's 16-byte chunks are swizzled by the row (chunk q
//     of row i at q ^ (i % 4)), so a warp's row-wise and column-wise reads
//     are free of bank conflicts.
//   * G_T = dS: each thread starts its 16 entries of G from dS's row i and
//     its own columns (so the two column groups split dS as they split the
//     state); a null dS starts them at zero.
//   * bf16 (`wkv_bwd_bf16`): r, k, v, w and dy are widened to f32 as they
//     are staged (16-byte loads through registers: cp.async cannot
//     convert, and two bf16 staging buffers would not leave room for two
//     blocks per SM), so the recurrence and every sum are the f32 entry's;
//     dv, and dr, dk, dw in `wkv_reduce`, are rounded to bf16 once as they
//     are stored. The partials and du stay f32.
//   * shared memory: 2 stages x 5 x 16 x 64 staged inputs, 8 x 64 x 32
//     states and 32 scalars: 106,624 B (two blocks per SM). Scratch:
//     ckpt, ceil(T / 16) states of 64 x 64 f32 per (batch item, head),
//     268 MB at the rwkv6-1.6b shape; the partials, 3 x groups x B H T dk
//     f32, 403 MB there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 128;           // threads per block
constexpr int CT = 16;             // steps per chunk (between stored states)
constexpr int SC = CT / 2;         // states in shared memory at a time
constexpr int DKP = 64;            // the state's padded width
constexpr int JC = 32;             // value columns per block
constexpr int HC = 16;             // columns per thread
constexpr int STAGE = 5 * CT * DKP;     // r, k, w, v, dy of one chunk
constexpr int RED_NT = 256;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(x.x, x.y);
  q[1] = __floats2bfloat162_rn(x.z, x.w);
}

// CT steps from t0 on of dk channels (valid: t < T_len, channel < dk) into
// dst[CT][DKP] f32; the rest zero-filled. bf16 rows are widened through
// registers (8 values per 16-byte load).
template <bool VEC>
__device__ __forceinline__ void load_chunk(float* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int t0,
                                           int T_len, int dk, int tid) {
  if constexpr (VEC) {
    constexpr int CPR = DKP / 8;
    for (int c = tid; c < CT * CPR; c += NTH) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (t0 + r < T_len && d < dk) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + (t0 + r) * stride + d);
        const __nv_bfloat162* b =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a0 = __bfloat1622float2(b[0]);
        const float2 a1 = __bfloat1622float2(b[1]);
        const float2 a2 = __bfloat1622float2(b[2]);
        const float2 a3 = __bfloat1622float2(b[3]);
        lo = make_float4(a0.x, a0.y, a1.x, a1.y);
        hi = make_float4(a2.x, a2.y, a3.x, a3.y);
      }
      *reinterpret_cast<float4*>(dst + r * DKP + d) = lo;
      *reinterpret_cast<float4*>(dst + r * DKP + d + 4) = hi;
    }
  } else {
    for (int e = tid; e < CT * DKP; e += NTH) {
      const int r = e / DKP;
      const int d = e - r * DKP;
      dst[e] = (t0 + r < T_len && d < dk)
                   ? __bfloat162float(src[(t0 + r) * stride + d])
                   : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           long long stride, int t0,
                                           int T_len, int dk, int tid) {
  if constexpr (VEC) {
    constexpr int CPR = DKP / 4;
    for (int c = tid; c < CT * CPR; c += NTH) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * 4;
      const bool ok = t0 + r < T_len && d < dk;
      cp_async16(dst + r * DKP + d, ok ? src + (t0 + r) * stride + d : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < CT * DKP; e += NTH) {
      const int r = e / DKP;
      const int d = e - r * DKP;
      dst[e] = (t0 + r < T_len && d < dk) ? src[(t0 + r) * stride + d] : 0.f;
    }
  }
}

__device__ __forceinline__ void ld16(float* x, const float* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}

// The thread's 16 columns (half `hf` of the block's 32) of row i of a
// state slot, 16-byte chunk q at chunk (4 hf + q) ^ (i % 4) of the row.
__device__ __forceinline__ void ld_state(float* x, const float* slot, int i,
                                         int hf) {
  const float* row = slot + i * JC;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f =
        *reinterpret_cast<const float4*>(row + 4 * ((4 * hf + q) ^ (i & 3)));
    x[4 * q] = f.x;
    x[4 * q + 1] = f.y;
    x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}
__device__ __forceinline__ void st_state(float* slot, const float* x, int i,
                                         int hf) {
  float* row = slot + i * JC;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(row + 4 * ((4 * hf + q) ^ (i & 3))) =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// S <- diag(w) S + k v^T on the thread's 16 entries, step tt of a chunk
// staged as [CT][DKP] arrays sk, sw, sv.
__device__ __forceinline__ void advance(float* S, const float* sk,
                                       const float* sw, const float* sv,
                                       int tt, int i, int col0) {
  const float k_i = sk[tt * DKP + i], w_i = sw[tt * DKP + i];
  float v[HC];
  ld16(v, sv + tt * DKP + col0);
#pragma unroll
  for (int m = 0; m < HC; ++m) S[m] = fmaf(w_i, S[m], k_i * v[m]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NTH, 2)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const float* __restrict__ u, const T* __restrict__ dy,
               const float* __restrict__ dS, T* __restrict__ dv,
               float* __restrict__ part,
               float* __restrict__ du_part, float* __restrict__ ckpt, int H,
               int T_len, int dkn, int n_cb, int n_ch, Strides rs,
               Strides ks, Strides vs, Strides ws, Strides gs) {
  // Dynamic shared memory: two stages of r, k, w, v, dy as [CT][DKP]
  // each (the forward pass uses the same bytes as three stages of k, w,
  // v); SC states [DKP][JC] (swizzled); v . dy and r . (u k) of the
  // chunk's steps.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const stages = reinterpret_cast<float*>(smem_raw);
  float* const states = stages + 2 * STAGE;
  float* const svdy = states + SC * DKP * JC;
  float* const sruk = svdy + CT;

  const int tid = threadIdx.x;
  const int i = tid >> 1, hf = tid & 1;  // row i, columns 16 hf .. of the group
  const int bh = blockIdx.x / n_cb;
  const int cb = blockIdx.x - bh * n_cb;
  const int b = bh / H;
  const int h = bh - b * H;
  const int col0 = cb * JC + hf * HC;    // this thread's first value column
  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  const T* wp = w + b * ws.b + h * ws.h;
  const T* gp = dy + b * gs.b + h * gs.h;
  // this thread's 16 entries of the chunk-start states
  float* const ck = ckpt + (((long long)bh * n_ch) * n_cb + cb) * NTH * HC +
                    tid * HC;
  const long long ck_step = (long long)n_cb * NTH * HC;   // per chunk
  const long long N = (long long)gridDim.x / n_cb * T_len * dkn;   // B H T dk
  const long long out0 = (long long)bh * T_len * dkn;
  // this group's partials of dr, dk, dw for this head, row i
  float* const pdr = part + cb * 3 * N + out0 + i;

  // 1. forward: the state at the start of every chunk, to ckpt. Chunk c's
  //    k, w, v are staged in stage c % 3, two chunks ahead.
  constexpr int FW = 3 * CT * DKP;       // one forward stage
  auto load_fw = [&](int c) {
    float* st = stages + (c % 3) * FW;
    const int t0 = c * CT;
    load_chunk<VEC>(st, kp, ks.s, t0, T_len, dkn, tid);
    load_chunk<VEC>(st + CT * DKP, wp, ws.s, t0, T_len, dkn, tid);
    load_chunk<VEC>(st + 2 * CT * DKP, vp, vs.s, t0, T_len, dkn, tid);
  };
  float S[HC];
#pragma unroll
  for (int m = 0; m < HC; ++m) S[m] = 0.f;
  // chunk c is advanced through only if c < n_ch - 1 (the last chunk's
  // end is unused)
  if (0 < n_ch - 1) load_fw(0);
  cp_async_commit();
  if (1 < n_ch - 1) load_fw(1);
  cp_async_commit();
  for (int c = 0; c < n_ch; ++c) {
    float4* dst = reinterpret_cast<float4*>(ck + c * ck_step);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_float4(S[4 * q], S[4 * q + 1], S[4 * q + 2], S[4 * q + 3]);
    if (c == n_ch - 1) break;
    cp_async_wait<1>();                  // chunk c has landed, and every
    __syncthreads();                     // thread is done with chunk c-1
    if (c + 2 < n_ch - 1) load_fw(c + 2);
    cp_async_commit();
    const float* st = stages + (c % 3) * FW;
#pragma unroll
    for (int tt = 0; tt < CT; ++tt)      // a full chunk: c < n_ch - 1
      advance(S, st, st + CT * DKP, st + 2 * CT * DKP, tt, i, col0);
  }
  cp_async_wait<0>();
  __syncthreads();                       // the stages are free again

  // 2. reverse, chunk by chunk, each in two halves of SC steps
  const float u_i = i < dkn ? u[h * dkn + i] : 0.f;
  // v . dy and r . (u k) of a step: 4 threads per sum, 16 channels each
  const int dot = tid >> 2, quad = tid & 3;
  float u_seg[16];
#pragma unroll
  for (int m = 0; m < 16; ++m)
    u_seg[m] = 16 * quad + m < dkn ? u[h * dkn + 16 * quad + m] : 0.f;
  // the dv sums: columns cc of steps s and s + 4 of a half, the state
  // buffer's swizzled column of cc in rows with i % 4 = q
  const int dv_cc = tid & 31, dv_s = tid >> 5;
  int dv_off[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dv_off[q] = (((dv_cc >> 2) ^ q) << 2) | (dv_cc & 3);
  // G_T = dS: row i, this thread's columns (zero past dk, or without dS)
  float G[HC], du_acc = 0.f;
#pragma unroll
  for (int m = 0; m < HC; ++m) G[m] = 0.f;
  if (dS != nullptr && i < dkn) {
    const float* g0 = dS + ((long long)bh * dkn + i) * dkn;
#pragma unroll
    for (int m = 0; m < HC; ++m)
      if (col0 + m < dkn) G[m] = g0[col0 + m];
  }
  auto load_bw = [&](int c) {
    float* st = stages + (c & 1) * STAGE;
    const int t0 = c * CT;
    load_chunk<VEC>(st, rp, rs.s, t0, T_len, dkn, tid);
    load_chunk<VEC>(st + 1 * CT * DKP, kp, ks.s, t0, T_len, dkn, tid);
    load_chunk<VEC>(st + 2 * CT * DKP, wp, ws.s, t0, T_len, dkn, tid);
    load_chunk<VEC>(st + 3 * CT * DKP, vp, vs.s, t0, T_len, dkn, tid);
    load_chunk<VEC>(st + 4 * CT * DKP, gp, gs.s, t0, T_len, dkn, tid);
  };
  load_bw(n_ch - 1);
  cp_async_commit();
  for (int c = n_ch - 1; c >= 0; --c) {
    const int t0 = c * CT;
    const int nt = min(CT, T_len - t0);
    float C0[HC];
    {
      const float4* src = reinterpret_cast<const float4*>(ck + c * ck_step);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = src[q];
        C0[4 * q] = f.x;
        C0[4 * q + 1] = f.y;
        C0[4 * q + 2] = f.z;
        C0[4 * q + 3] = f.w;
      }
    }
    cp_async_wait<0>();                  // chunk c has landed, and every
    __syncthreads();                     // thread is done with chunk c+1
    if (c > 0) load_bw(c - 1);
    cp_async_commit();
    const float* st = stages + (c & 1) * STAGE;
    const float* sr = st;
    const float* sk = st + 1 * CT * DKP;
    const float* sw = st + 2 * CT * DKP;
    const float* sv = st + 3 * CT * DKP;
    const float* sg = st + 4 * CT * DKP;
    {
      const int tt = dot & (CT - 1);
      const float* a = (dot < CT ? sv : sr) + tt * DKP + 16 * quad;
      const float* bb = (dot < CT ? sg : sk) + tt * DKP + 16 * quad;
      float x[16], y[16];
      ld16(x, a);
      ld16(y, bb);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int m = 0; m < 16; m += 2) {
        const float x0 = dot < CT ? x[m] : x[m] * u_seg[m];
        const float x1 = dot < CT ? x[m + 1] : x[m + 1] * u_seg[m + 1];
        acc0 = fmaf(x0, y[m], acc0);
        acc1 = fmaf(x1, y[m + 1], acc1);
      }
      float e = acc0 + acc1;
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      if (quad == 0) (dot < CT ? svdy : sruk)[tt] = e;
    }
    __syncthreads();                     // svdy, sruk

    for (int half = 1; half >= 0; --half) {
      const int h0 = half * SC;
      const int hn = min(SC, nt - h0);
      if (hn <= 0) continue;
      // the half's states S_{t-1}, t = t0 + h0 .. t0 + h0 + hn - 1, into
      // slots 0 .. hn - 1 (this thread's entries only)
#pragma unroll
      for (int m = 0; m < HC; ++m) S[m] = C0[m];
      if (half) {                        // hn > 0: steps 0 .. SC-1 are real
#pragma unroll
        for (int tt = 0; tt < SC; ++tt) advance(S, sk, sw, sv, tt, i, col0);
      }
#pragma unroll
      for (int s = 0; s < SC; ++s) {
        if (s < hn) {
          st_state(states + s * DKP * JC, S, i, hf);
          if (s + 1 < hn) advance(S, sk, sw, sv, h0 + s, i, col0);
        }
      }
      // the half's steps in reverse
#pragma unroll
      for (int s = SC - 1; s >= 0; --s) {
        if (s >= hn) continue;
        const int tt = h0 + s;
        float* slot = states + s * DKP * JC;
        float Sp[HC], vv[HC], gg[HC];
        ld_state(Sp, slot, i, hf);
        ld16(vv, sv + tt * DKP + col0);
        ld16(gg, sg + tt * DKP + col0);
        const float r_i = sr[tt * DKP + i], k_i = sk[tt * DKP + i];
        const float w_i = sw[tt * DKP + i];
        float pr[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f}, pw[2] = {0.f, 0.f};
#pragma unroll
        for (int m = 0; m < HC; ++m) {
          pr[m & 1] = fmaf(Sp[m], gg[m], pr[m & 1]);
          pk[m & 1] = fmaf(G[m], vv[m], pk[m & 1]);
          pw[m & 1] = fmaf(G[m], Sp[m], pw[m & 1]);
        }
        float dr_p = pr[0] + pr[1], dk_p = pk[0] + pk[1];
        float dw_p = pw[0] + pw[1];
        dr_p += __shfl_xor_sync(0xffffffffu, dr_p, 1);
        dk_p += __shfl_xor_sync(0xffffffffu, dk_p, 1);
        dw_p += __shfl_xor_sync(0xffffffffu, dw_p, 1);
#pragma unroll
        for (int m = 0; m < HC; ++m) {
          Sp[m] = G[m] * k_i;            // the dv shares, over the state
          G[m] = fmaf(w_i, G[m], r_i * gg[m]);
        }
        st_state(slot, Sp, i, hf);
        if (hf == 0 && i < dkn) {
          if (cb == 0) {
            const float vdy = svdy[tt];
            dr_p = fmaf(u_i * k_i, vdy, dr_p);
            dk_p = fmaf(u_i * r_i, vdy, dk_p);
            du_acc = fmaf(r_i * k_i, vdy, du_acc);
          }
          const long long o = (long long)(t0 + tt) * dkn;
          pdr[o] = dr_p;
          pdr[N + o] = dk_p;
          pdr[2 * N + o] = dw_p;
        }
      }
      __syncthreads();                   // the dv shares
      // dv: the shares summed over the rows in order (four interleaved
      // partial sums, added in a fixed order), plus r.(u k) dy
#pragma unroll
      for (int s2 = 0; s2 < SC; s2 += NTH / JC) {
        const int s = s2 + dv_s;
        if (s < hn) {
          const float* slot = states + s * DKP * JC;
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ii = 0; ii < DKP; ii += 4) {
#pragma unroll
            for (int q = 0; q < 4; ++q) a[q] += slot[(ii + q) * JC + dv_off[q]];
          }
          const int tt = h0 + s;
          const int j = cb * JC + dv_cc;
          if (j < dkn)
            store1(dv + out0 + (long long)(t0 + tt) * dkn + j,
                   fmaf(sruk[tt], sg[tt * DKP + j],
                        (a[0] + a[1]) + (a[2] + a[3])));
        }
      }
      __syncthreads();                   // before the slots are rebuilt
    }
  }
  if (cb == 0 && hf == 0 && i < dkn) du_part[(long long)bh * dkn + i] = du_acc;
}

// dr, dk, dw (blockIdx.y = 0, 1, 2) = the column groups' partials summed
// in group order; du[h][i] = sum_b du_part[b][h][i] in batch order
// (blockIdx.y = 3).
template <typename T>
__global__ void __launch_bounds__(RED_NT)
wkv_reduce_kernel(const float* __restrict__ part, T* __restrict__ dr,
                  T* __restrict__ dk, T* __restrict__ dw,
                  const float* __restrict__ du_part, float* __restrict__ du,
                  long long N, int n_cb, int B, int Hdk) {
  const long long first = blockIdx.x * (long long)RED_NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * RED_NT;
  const int a = blockIdx.y;
  if (a == 3) {
    for (long long e = first; e < Hdk; e += stride) {
      float s = 0.f;
      for (int bb = 0; bb < B; ++bb) s += du_part[bb * (long long)Hdk + e];
      du[e] = s;
    }
    return;
  }
  T* const out = a == 0 ? dr : a == 1 ? dk : dw;
  const float* const p = part + a * N;
  const long long group = 3 * N;         // from one group's partial to the next
  if ((N & 3) == 0) {                    // float4s
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (long long x = first; x < N / 4; x += stride) {
      float4 s = p4[x];
      for (int c = 1; c < n_cb; ++c) {
        const float4 q = p4[x + c * group / 4];
        s.x += q.x;
        s.y += q.y;
        s.z += q.z;
        s.w += q.w;
      }
      store4(out + 4 * x, s);
    }
  } else {
    for (long long x = first; x < N; x += stride) {
      float s = p[x];
      for (int c = 1; c < n_cb; ++c) s += p[x + c * group];
      store1(out + x, s);
    }
  }
}

constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * STAGE + SC * DKP * JC + 2 * CT);
}

template <typename T, bool VEC>
cudaError_t launch(const T* r, const T* k, const T* v, const T* w,
                   const float* u, const T* dy, const float* dS, T* dr,
                   T* dk, T* dv, T* dw, float* du, float* du_part,
                   float* ckpt, float* part, int B, int H, int T_len,
                   int dkn, const Strides* st, cudaStream_t cs) {
  const int n_ch = (T_len + CT - 1) / CT;
  const int n_cb = (dkn + JC - 1) / JC;
  constexpr size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<T, VEC><<<B * H * n_cb, NTH, smem, cs>>>(
      r, k, v, w, u, dy, dS, dv, part, du_part, ckpt, H, T_len, dkn, n_cb,
      n_ch, st[0], st[1], st[2], st[3], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long N = (long long)B * H * T_len * dkn;
  const long long per = (N & 3) == 0 ? N / 4 : N;   // items per array
  const long long blocks = (per + RED_NT - 1) / RED_NT;
  wkv_reduce_kernel<T><<<dim3((unsigned)(blocks < 2048 ? blocks : 2048), 4),
                         RED_NT, 0, cs>>>(part, dr, dk, dw, du_part, du, N,
                                          n_cb, B, H * dkn);
  return cudaGetLastError();
}

// Each entry launches the two kernels on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise and allocates
// nothing. `strides` holds 15 element strides: (batch, head, time) of r,
// k, v, w and dy (unit stride over dk). u (H, dk) f32 contiguous; dS (B, H,
// dk, dk) f32 contiguous, the final state's gradient, or null for none;
// dr, dk, dv, dw (B, H, T, dk, the inputs' dtype) and du (H, dk, f32) are
// written contiguous. Scratch from the wrapper: `du_part` (B, H, dk) f32;
// `ckpt`, B H ceil(T / 16) 4096 f32 (one 64 x 64 state per chunk of 16
// steps per (batch item, head)); `part`, 3 ceil(dk / 32) B H T dk f32 (the
// column groups' partials of dr, dk, dw). Chunks load 16 bytes at a time
// when every row of r, k, v, w and dy starts 16-byte aligned, else element
// by element.
template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* dy, const void* dS, void* dr,
             void* dk, void* dv, void* dw, void* du, void* du_part,
             void* ckpt, void* part, int B, int H, int T_len, int dkn,
             const long long* strides, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || dkn < 1 || dkn > DKP ||
      (long long)B * H * ((dkn + JC - 1) / JC) > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[5];
  for (int t = 0; t < 5; ++t) {
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  }
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  bool vec = dkn % EPC == 0;
  for (int t = 0; t < 15; ++t) vec = vec && strides[t] % EPC == 0;
  const void* ptrs[5] = {r, k, v, w, dy};
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
#define WKV_BWD_LAUNCH(VEC)                                                   \
  launch<T, VEC>(static_cast<const T*>(r), static_cast<const T*>(k),          \
                 static_cast<const T*>(v), static_cast<const T*>(w),          \
                 static_cast<const float*>(u), static_cast<const T*>(dy),     \
                 static_cast<const float*>(dS), static_cast<T*>(dr),          \
                 static_cast<T*>(dk), static_cast<T*>(dv),                    \
                 static_cast<T*>(dw), static_cast<float*>(du),                \
                 static_cast<float*>(du_part), static_cast<float*>(ckpt),     \
                 static_cast<float*>(part), B, H, T_len, dkn, st,             \
                 static_cast<cudaStream_t>(stream))
  return (int)(vec ? WKV_BWD_LAUNCH(true) : WKV_BWD_LAUNCH(false));
#undef WKV_BWD_LAUNCH
}

}  // namespace

extern "C" {

int wkv_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* dy, const void* dS, void* dr,
                void* dk, void* dv, void* dw, void* du, void* du_part,
                void* ckpt, void* part, int B, int H, int T, int dkn,
                const long long* strides, void* stream) {
  return dispatch<float>(r, k, v, w, u, dy, dS, dr, dk, dv, dw, du, du_part,
                         ckpt, part, B, H, T, dkn, strides, stream);
}

int wkv_bwd_bf16(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* dy, const void* dS, void* dr,
                 void* dk, void* dv, void* dw, void* du, void* du_part,
                 void* ckpt, void* part, int B, int H, int T, int dkn,
                 const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, dy, dS, dr, dk, dv, dw, du,
                                 du_part, ckpt, part, B, H, T, dkn, strides,
                                 stream);
}

const char* wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
