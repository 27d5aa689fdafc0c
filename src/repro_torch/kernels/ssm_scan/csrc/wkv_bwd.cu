// Backward pass of the RWKV6 wkv recurrence for Hopper (sm_90a), f32 or
// bf16 inputs, f32 arithmetic:
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// from S_0 = 0 per (batch item, head). Given dy, the final state's
// gradient dS (B, H, dk, dk) f32, or none (zero), and the chunk-start
// states the forward (wkv.cu) wrote for the same inputs, it returns dr,
// dk, dv, dw (B, H, T, dk, in the inputs' dtype) and du (H, dk, f32). With
// G_t = dL/dS_t:
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
// adds the chunk-boundary gradients G (67 MB written, read once) and
// reads the forward's chunk-start states S (67 MB), the
// chunk's first 48 steps run forward once more (checkpoints), 7/8 of a
// step more per step (each 8-step sub-chunk's states rebuilt from a
// checkpoint), and shuffles: dr, dk, dw over a row's 8 lanes, dv over a
// warp's 4 rows. What holds it back on the card is the chunk kernel's
// shared-memory and shuffle traffic per step (every warp loads v and dy
// of all 64 columns; clock64() marks: 45% of a block in the reverse
// steps, 36% rebuilding states, 13% in the checkpoint pass).
//
// Design: three launches, no float atomics (a rerun is bit-equal), no
// partial sums of dr, dk or dw in device memory.
//   * the chunk-state pass (wkv_chunk.cuh, `wkv_bwd_state_kernel`): per
//     (batch item, head), last chunk first from dS, the gradient G after
//     each chunk's last step (R~^T dY products, r~ = r times prefix
//     products of w): split TF32 on wgmma, B H blocks of 128 threads (one
//     per SM, the next chunk staged while this one computes), one product
//     per chunk. The state S at the start of each chunk is the forward's:
//     its entry wrote them for the same r, k, v, w (K~^T V products, k~ =
//     k times suffix products of w), and the wrapper's autograd Function
//     keeps them for the backward.
//   * the chunks in parallel (`wkv_bwd_chunk_kernel`): one block of 512
//     threads per (batch item, head, chunk), 4096 blocks at the rwkv6-1.6b
//     shape, against 256 blocks of one serial chain over T before. Thread
//     (row i = 4 warp + lane / 8, columns 8 (lane % 8) ..) holds 8 entries
//     of G, so a row's 64 columns lie in 8 lanes of one warp and dr, dk
//     and dw are complete in the block: sums within the thread, then one
//     reduce-scatter of the three over the row's 8 lanes (4 shuffles).
//     4 x 4 patches per thread in 256 threads (less shared-memory traffic
//     per entry, but 8 warps per SM) ran 25% slower. The chunk's r, k, w,
//     v, dy (64 steps x 64 channels) are staged once in shared memory
//     (cp.async; bf16 widened through registers), v and dy swizzled (the
//     16-byte groups of channels 32..63 swapped in pairs: 8 lanes reading
//     a row's 8-column groups hit distinct banks; without it the backward
//     took 1900 us, with it 1459). A forward pass from the chunk-start
//     state stores checkpoints every 16 steps in shared memory (each
//     thread its own entries, so no barrier); the reverse pass takes each
//     16-step segment in two sub-chunks of 8 steps, rebuilds the
//     sub-chunk's 8 states S_{t-1} into registers from the checkpoint
//     (never by dividing by w), then runs its steps in reverse with the
//     direct formulas above, the states read from registers, not through
//     shared memory as before. dv's shares are summed over the warp's 4
//     rows by 2 shuffle rounds (reduce-scatter, 2 values a lane), written
//     to shared memory and, after each sub-chunk, summed over the 16 warps
//     in a fixed order (two buffers, one barrier a sub-chunk). dr, dk, dw
//     overwrite r, k, w of their steps in shared memory once the sub-chunk
//     is done and are stored coalesced at the end; du's partial over the
//     chunk goes to scratch.
//   * `wkv_du_kernel`: du summed from the per-chunk partials in a fixed
//     order (batch item, then chunk).
//   * the loops run over the real T; dk < 64 is padded with zero channels
//     (k = w = r = 0 keep padded rows of S and G at zero, v = dy = 0 padded
//     columns). bf16 (`wkv_bwd_bf16`): r, k, v, w and dy are widened to f32
//     as they are staged, so the recurrence and every sum are the f32
//     entry's; dr, dk, dv, dw are rounded to bf16 once as they are stored;
//     du stays f32.
//   * shared memory of the chunk kernel: 5 x 64 x 64 staged inputs (80
//     KB), 4 checkpoints (64 KB), dv's warp sums of two sub-chunks (64
//     KB): 208.5 KB, one block of 16 warps per SM. Scratch: the gradients
//     at the chunk boundaries, B H ceil(T / 64) 64 x 64 f32 (67 MB at the rwkv6-1.6b shape,
//     where the SIMT design held 671 MB of 16-step checkpoints and
//     column-group partials), du's partials B H ceil(T / 64) 64 f32.

#include "wkv_chunk.cuh"

namespace {

constexpr int BW_NT = 512;         // threads of the chunk kernel
constexpr int SEG = 16;            // steps between checkpoints
constexpr int SUB = 8;             // states rebuilt into registers at a time
constexpr int NCK = CH / SEG;      // checkpoints per chunk (the start first)
constexpr int NWARP = BW_NT / 32;
constexpr int DU_NT = 256;

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// 8 floats from row p (a step or state row), channels c0 .. c0 + 7 (c0 a
// multiple of 8), without (ld8) or with the swizzle (ld8s, st8s).
__device__ __forceinline__ void ld8(float* x, const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void ld8s(float* x, const float* row, int c0) {
  const float4 a = *reinterpret_cast<const float4*>(row + swz(c0));
  const float4 b = *reinterpret_cast<const float4*>(row + swz(c0 + 4));
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void st8s(float* row, int c0, const float* x) {
  *reinterpret_cast<float4*>(row + swz(c0)) =
      make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(row + swz(c0 + 4)) =
      make_float4(x[4], x[5], x[6], x[7]);
}

// The chunk-state pass of the backward: the gradient chain (the gradients
// at chunk ends, last chunk first from dS); the states at chunk starts are
// the forward's.
template <typename T, bool VEC>
__global__ void __launch_bounds__(ST_NT, 1)
wkv_bwd_state_kernel(const T* __restrict__ r, const T* __restrict__ w,
                     const T* __restrict__ dy, const float* __restrict__ dS,
                     Strides rs, Strides ws, Strides gs,
                     float* __restrict__ g_states, int H, int T_len, int dk,
                     int n_ch) {
  state_chain<T, VEC>(r, w, dy, rs, ws, gs, dS, g_states, nullptr, H,
                         T_len, dk, n_ch, true, blockIdx.x);
}

// Shared memory of the chunk kernel, in floats: r, k, w, v, dy as
// [CH][DKP]; NCK checkpoints [DKP][DKP]; dv's warp sums [2][NWARP][SUB][DKP]
// (two buffers: a sub-chunk's sums are added while the next one's are
// written); v . dy and r . (u k) per step.
constexpr int IN = CH * DKP;
constexpr int CK_OFF = 5 * IN;
constexpr int DVP = NWARP * SUB * DKP;
constexpr int DVP_OFF = CK_OFF + NCK * DKP * DKP;
constexpr int VDY_OFF = DVP_OFF + 2 * DVP;
constexpr int RUK_OFF = VDY_OFF + CH;
constexpr size_t CHUNK_SMEM = sizeof(float) * (RUK_OFF + CH);

// One (batch item, head, chunk): thread (row i = 4 warp + lane / 8,
// columns 8 (lane % 8) ..) holds 8 entries of G and of the states it
// rebuilds; a row's 64 columns lie in 8 lanes of one warp.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BW_NT, 1)
wkv_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u, const T* __restrict__ dy,
                    const float* __restrict__ s_states,
                    const float* __restrict__ g_states, T* __restrict__ dr,
                    T* __restrict__ dkk, T* __restrict__ dv,
                    T* __restrict__ dw, float* __restrict__ du_part, int H,
                    int T_len, int dkn, int n_ch, Strides rs, Strides ks,
                    Strides vs, Strides ws, Strides gs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float* const sr = sm;                  // dr once a sub-chunk is done
  float* const sk = sm + IN;             // dk
  float* const sw = sm + 2 * IN;         // dw
  float* const sv = sm + 3 * IN;         // swizzled
  float* const sg = sm + 4 * IN;         // swizzled
  float* const ck = sm + CK_OFF;
  float* const dvp = sm + DVP_OFF;
  float* const svdy = sm + VDY_OFF;
  float* const sruk = sm + RUK_OFF;
  const int tid = threadIdx.x, wp = tid >> 5, lane = tid & 31;
  const int i = 4 * wp + (lane >> 3);    // this thread's row
  const int cg = lane & 7;               // and columns c0 .. c0 + 7
  const int c0 = 8 * cg;
  const int bh = blockIdx.x / n_ch;
  const int ch = blockIdx.x - bh * n_ch;
  const int b = bh / H;
  const int h = bh - b * H;
  const int t0 = ch * CH;
  const int nt = min(CH, T_len - t0);
  stage_rows<CH, DKP, BW_NT, VEC>(sr, r + b * rs.b + h * rs.h, rs.s, t0,
                                  T_len, dkn, tid);
  stage_rows<CH, DKP, BW_NT, VEC>(sk, k + b * ks.b + h * ks.h, ks.s, t0,
                                  T_len, dkn, tid);
  stage_rows<CH, DKP, BW_NT, VEC>(sw, w + b * ws.b + h * ws.h, ws.s, t0,
                                  T_len, dkn, tid);
  stage_rows<CH, DKP, BW_NT, VEC, true>(sv, v + b * vs.b + h * vs.h, vs.s,
                                        t0, T_len, dkn, tid);
  stage_rows<CH, DKP, BW_NT, VEC, true>(sg, dy + b * gs.b + h * gs.h, gs.s,
                                        t0, T_len, dkn, tid);
  cp_async_commit();
  const long long st0 = ((long long)bh * n_ch + ch) * DKP * DKP;
  float S[8], G[8];
  ld8(S, s_states + st0 + i * DKP + c0);
  ld8(G, g_states + st0 + i * DKP + c0);
  const float u_i = i < dkn ? u[h * dkn + i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // v . dy (dot < 64; both swizzled alike, so the channels pair up) and
  // r . (u k) (dot >= 64) of each step: 4 threads per sum, 16 channels
  // each, added in a fixed order
  {
    const int dot = tid >> 2, quad = tid & 3;
    const int tt = dot & (CH - 1);
    const float* a = (dot < CH ? sv : sr) + tt * DKP + 16 * quad;
    const float* bb = (dot < CH ? sg : sk) + tt * DKP + 16 * quad;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int m = 0; m < 16; m += 2) {
      const int c = 16 * quad + m;
      const float x0 =
          dot < CH ? a[m] : a[m] * (c < dkn ? u[h * dkn + c] : 0.f);
      const float x1 =
          dot < CH ? a[m + 1]
                   : a[m + 1] * (c + 1 < dkn ? u[h * dkn + c + 1] : 0.f);
      acc0 = fmaf(x0, bb[m], acc0);
      acc1 = fmaf(x1, bb[m + 1], acc1);
    }
    float e = acc0 + acc1;
    e += __shfl_xor_sync(0xffffffffu, e, 1);
    e += __shfl_xor_sync(0xffffffffu, e, 2);
    if (quad == 0) (dot < CH ? svdy : sruk)[tt] = e;
  }
  // S_{t-1} <- S_t on the thread's 8 entries, step tt of the chunk
  auto advance = [&](float* x, int tt) {
    const float k_i = sk[tt * DKP + i], w_i = sw[tt * DKP + i];
    float vv[8];
    ld8s(vv, sv + tt * DKP, c0);
#pragma unroll
    for (int m = 0; m < 8; ++m) x[m] = fmaf(w_i, x[m], k_i * vv[m]);
  };
  // the checkpoints: the state before steps 0, 16, 32, 48 (own entries)
  const int nseg = (nt + SEG - 1) / SEG;
  st8s(ck + i * DKP, c0, S);
  for (int q = 1; q < nseg; ++q) {
#pragma unroll
    for (int j = 0; j < SEG; ++j) advance(S, (q - 1) * SEG + j);
    st8s(ck + (q * DKP + i) * DKP, c0, S);
  }
  __syncthreads();                       // svdy, sruk

  // the reverse pass: segments last to first, each in two sub-chunks of
  // SUB steps (the later first)
  float du_acc = 0.f;
  int buf = 0;
  const int hib = (lane >> 4) & 1, mid = (lane >> 3) & 1;
  const int hi4 = (lane >> 2) & 1, hi2 = (lane >> 1) & 1;
  const int sel = cg >> 1;               // the sum this lane keeps: dr, dk, dw
  for (int q = nseg - 1; q >= 0; --q) {
#pragma unroll
    for (int p = SEG / SUB - 1; p >= 0; --p) {
      const int h0 = q * SEG + p * SUB;
      if (h0 >= nt) continue;
      const int hn = min(SUB, nt - h0);
      float* const dvb = dvp + buf * DVP;
      float red[SUB];                    // this lane's dr, dk or dw per step
      // the sub-chunk's states S_{t-1}, t = h0 .. h0 + SUB - 1
      float st[SUB][8];
      ld8s(st[0], ck + (q * DKP + i) * DKP, c0);
#pragma unroll
      for (int j = 0; j < p * SUB; ++j) advance(st[0], q * SEG + j);
#pragma unroll
      for (int l = 1; l < SUB; ++l) {
#pragma unroll
        for (int m = 0; m < 8; ++m) st[l][m] = st[l - 1][m];
        advance(st[l], h0 + l - 1);
      }
#pragma unroll
      for (int l = SUB - 1; l >= 0; --l) {
        if (l >= hn) continue;
        const int tt = h0 + l;
        const float r_i = sr[tt * DKP + i], k_i = sk[tt * DKP + i];
        const float w_i = sw[tt * DKP + i];
        const float vdy = svdy[tt];
        float vv[8], gg[8];
        ld8s(vv, sv + tt * DKP, c0);
        ld8s(gg, sg + tt * DKP, c0);
        float pr[2] = {0.f, 0.f}, pk[2] = {0.f, 0.f}, pw[2] = {0.f, 0.f};
        float dvs[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          pr[m & 1] = fmaf(st[l][m], gg[m], pr[m & 1]);
          pk[m & 1] = fmaf(G[m], vv[m], pk[m & 1]);
          pw[m & 1] = fmaf(G[m], st[l][m], pw[m & 1]);
          dvs[m] = G[m] * k_i;
          G[m] = fmaf(w_i, G[m], r_i * gg[m]);
        }
        du_acc = fmaf(r_i * k_i, vdy, du_acc);
        // dr, dk, dw (and an empty fourth) over the row's 8 lanes,
        // reduce-scattered: lanes 2q, 2q + 1 of the row keep sum q
        float x4r[4] = {pr[0] + pr[1], pk[0] + pk[1], pw[0] + pw[1], 0.f};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float keep = hi4 ? x4r[m + 2] : x4r[m];
          const float send = hi4 ? x4r[m] : x4r[m + 2];
          x4r[m] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
        }
        {
          const float keep = hi2 ? x4r[1] : x4r[0];
          const float send = hi2 ? x4r[0] : x4r[1];
          x4r[0] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
        // plus the bonus terms: u k (v . dy) to dr, u r (v . dy) to dk
        const float bonus =
            sel == 0 ? u_i * k_i : sel == 1 ? u_i * r_i : 0.f;
        red[l] = fmaf(bonus, vdy,
                      x4r[0] + __shfl_xor_sync(0xffffffffu, x4r[0], 1));
        // dv's shares over the warp's 4 rows, reduce-scattered: the lane
        // keeps columns c0 + 4 hib + 2 mid + {0, 1}
        float x4[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float keep = hib ? dvs[m + 4] : dvs[m];
          const float send = hib ? dvs[m] : dvs[m + 4];
          x4[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
        float x2[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float keep = mid ? x4[m + 2] : x4[m];
          const float send = mid ? x4[m] : x4[m + 2];
          x2[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        *reinterpret_cast<float2*>(dvb + (wp * SUB + l) * DKP +
                                   swz(c0 + 4 * hib + 2 * mid)) =
            make_float2(x2[0], x2[1]);
      }
      // dr, dk, dw of the sub-chunk's steps over r, k, w of those steps,
      // once the warp's reads of them are done
      __syncwarp();
#pragma unroll
      for (int l = 0; l < SUB; ++l) {
        if (l >= hn) continue;
        const int o = (h0 + l) * DKP + i;
        if (cg == 0) sr[o] = red[l];
        if (cg == 2) sk[o] = red[l];
        if (cg == 4) sw[o] = red[l];
      }
      __syncthreads();                   // dv's warp sums
      // dv: the 16 warps' sums in a fixed order (four interleaved partial
      // sums), plus r . (u k) dy
      {
        const int l = tid >> 6, j = tid & (DKP - 1);
        if (l < hn) {
          const int tt = h0 + l;
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int x = 0; x < NWARP; x += 4)
#pragma unroll
            for (int y = 0; y < 4; ++y)
              a[y] += dvb[((x + y) * SUB + l) * DKP + swz(j)];
          if (j < dkn)
            store1(dv + ((long long)bh * T_len + t0 + tt) * dkn + j,
                   fmaf(sruk[tt], sg[tt * DKP + swz(j)],
                        (a[0] + a[1]) + (a[2] + a[3])));
        }
      }
      buf ^= 1;
    }
  }
  __syncthreads();                       // dr, dk, dw of every step
  if (cg == 0 && i < dkn)
    du_part[((long long)bh * n_ch + ch) * DKP + i] = du_acc;
  // dr, dk, dw of the chunk, coalesced
  for (int e = tid; e < nt * DKP; e += BW_NT) {
    const int tt = e / DKP, j = e - tt * DKP;
    if (j < dkn) {
      const long long o = ((long long)bh * T_len + t0 + tt) * dkn + j;
      store1(dr + o, sr[e]);
      store1(dkk + o, sk[e]);
      store1(dw + o, sw[e]);
    }
  }
}

// du[h][i] = sum over batch items b, then chunks c, of du_part[b][h][c][i].
__global__ void __launch_bounds__(DU_NT)
wkv_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
              int B, int H, int dkn, int n_ch) {
  const int e = blockIdx.x * DU_NT + threadIdx.x;
  if (e >= H * dkn) return;
  const int h = e / dkn, i = e - h * dkn;
  float s = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = du_part + ((long long)(b * H + h) * n_ch) * DKP + i;
    for (int c = 0; c < n_ch; ++c) s += p[(long long)c * DKP];
  }
  du[e] = s;
}

template <typename T, bool VEC>
cudaError_t launch(const T* r, const T* k, const T* v, const T* w,
                   const float* u, const T* dy, const float* dS, T* dr,
                   T* dk, T* dv, T* dw, float* du, const float* s_states,
                   float* g_states, float* du_part, int B, int H, int T_len,
                   int dkn, const Strides* st, cudaStream_t cs) {
  const int n_ch = (T_len + CH - 1) / CH;
  constexpr size_t smem_st = StateSmem<T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_state_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_st);
  if (err != cudaSuccess) return err;
  wkv_bwd_state_kernel<T, VEC><<<B * H, ST_NT, smem_st, cs>>>(
      r, w, dy, dS, st[0], st[3], st[4], g_states, H, T_len, dkn, n_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_bwd_chunk_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)CHUNK_SMEM);
  if (err != cudaSuccess) return err;
  wkv_bwd_chunk_kernel<T, VEC><<<B * H * n_ch, BW_NT, CHUNK_SMEM, cs>>>(
      r, k, v, w, u, dy, s_states, g_states, dr, dk, dv, dw, du_part, H,
      T_len, dkn, n_ch, st[0], st[1], st[2], st[3], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_du_kernel<<<(H * dkn + DU_NT - 1) / DU_NT, DU_NT, 0, cs>>>(
      du_part, du, B, H, dkn, n_ch);
  return cudaGetLastError();
}

// Each entry launches the three kernels on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise and allocates
// nothing. `strides` holds 15 element strides: (batch, head, time) of r,
// k, v, w and dy (unit stride over dk). u (H, dk) f32 contiguous; dS (B, H,
// dk, dk) f32 contiguous, the final state's gradient, or null for none;
// dr, dk, dv, dw (B, H, T, dk, the inputs' dtype) and du (H, dk, f32) are
// written contiguous. `s_states`: the states at chunk starts that the
// forward entry wrote for the same r, k, v, w (B H ceil(T / 64) 64 x 64
// f32; null is refused). Scratch from the wrapper: `g_states`, as large
// (the gradients at chunk ends), and `du_part`, B H ceil(T / 64) 64 f32.
// Inputs load 16 bytes at a time when every row of r, k, v, w and dy
// starts 16-byte aligned, else element by element.
template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* dy, const void* dS, void* dr,
             void* dk, void* dv, void* dw, void* du, const void* s_states,
             void* g_states, void* du_part, int B, int H, int T_len, int dkn,
             const long long* strides, void* stream) {
  if (s_states == nullptr || B < 1 || H < 1 || T_len < 1 || dkn < 1 ||
      dkn > DKP ||
      (long long)B * H * ((T_len + CH - 1) / CH) > 2147483647LL) {
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
                 static_cast<const float*>(s_states),                        \
                 static_cast<float*>(g_states), static_cast<float*>(du_part), \
                 B, H, T_len, dkn, st, static_cast<cudaStream_t>(stream))
  return (int)(vec ? WKV_BWD_LAUNCH(true) : WKV_BWD_LAUNCH(false));
#undef WKV_BWD_LAUNCH
}

}  // namespace

extern "C" {

int wkv_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* dy, const void* dS, void* dr,
                void* dk, void* dv, void* dw, void* du,
                const void* s_states, void* g_states, void* du_part, int B,
                int H, int T, int dkn, const long long* strides,
                void* stream) {
  return dispatch<float>(r, k, v, w, u, dy, dS, dr, dk, dv, dw, du,
                         s_states, g_states, du_part, B, H, T, dkn, strides,
                         stream);
}

int wkv_bwd_bf16(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* dy, const void* dS, void* dr,
                 void* dk, void* dv, void* dw, void* du,
                 const void* s_states, void* g_states, void* du_part, int B,
                 int H, int T, int dkn, const long long* strides,
                 void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, dy, dS, dr, dk, dv, dw, du,
                                 s_states, g_states, du_part, B, H, T, dkn,
                                 strides, stream);
}

const char* wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
