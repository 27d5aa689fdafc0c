// The chunk-state pass shared by the wkv forward (wkv.cu) and backward
// (wkv_bwd.cu) for Hopper (sm_90a), and the row loader all their kernels
// use.
//
// Time is split into chunks of CH = 64 steps. Per (batch item, head) one
// block walks the chunks in order and writes the state at every chunk
// boundary, one matrix product per chunk instead of 64 serial updates:
//
//   state chain (forward, and the backward's S):
//     S_end = diag(prod_{s in c} w_s) S_start + K~^T V,
//     k~_s  = k_s * prod_{s' > s, s' in c} w_s'        (suffix products)
//   gradient chain (backward, last chunk first, from dS or zero):
//     G_before = diag(prod_{s in c} w_s) G_end + R~^T dY,
//     r~_s  = r_s * prod_{s' < s, s' in c} w_s'        (prefix products)
//
// The decay factors are products of w inside the chunk, each <= 1, built
// one step at a time: never a ratio and never a log-space cumulative sum,
// so w = 1e-7, and w = 0, stay exact. Steps past T count as w = 1 with
// zero k (r), so the last chunk's product is the state after step T - 1.
//
// The product (64 key rows x 64 value columns over the chunk's 64 steps)
// runs on the tensor cores in split TF32: wgmma m64n64k8 .tf32, A (K~^T or
// R~^T, a key row per accumulator row) from registers, split hi and lo as
// its fragments are loaded; B (V or dY) K-major in shared memory, where
// tf32 wgmma reads B only K-major, so it is transposed and split into a hi
// and a lo plane (128-byte swizzle) as it is staged. Per k-step of 8 steps
// three products: hi.hi into one fresh accumulator, lo.hi and hi.lo into
// another, both added to the state in f32 registers (the state scaled by
// the chunk's decay product first, one f32 multiply per entry). Chained
// into the state, the tensor cores' truncating adds put the gradients
// 4-6x as far from f64 as the serial f32 recurrence; so, 1.5-2.4x. That
// is a deliberate departure from the serial order's precision, held by
// tests/test_torch_wkv.py's f64 oracle at 2.5x for S_T, dk, dv, dw and
// 1.75x for dr (y and du no farther), two decades inside the kernels'
// gates. A fresh accumulator per k-step (dk, dv, dw 1.0-1.1x, S_T still
// 1.7-1.9x) left ptxas short of registers: it spilled.
//
// One warpgroup per block. Per chunk: the chunk's w, A source and B source
// staged as they come with cp.async (rows off 16 bytes element by
// element), widened to f32 as they are read; channel threads 0..63 build
// the decay factors serially over the 64 steps and scale the A source
// into an f32 array, threads 64..127 split B into the planes; then the
// boundary state is written (64 x 64 f32 per chunk: 67 MB at the
// rwkv6-1.6b shape), scaled, and the 24 products run.
// The next chunk loads while this one computes (NST = 2 stages), one
// block (one chain) per SM in both kernels; a third stage made the
// forward's pass slower (117 us against 112 on the H100).

#pragma once

#include <type_traits>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int CH = 64;               // steps per chunk
constexpr int DKP = 64;              // the state's padded width
constexpr int ST_NT = 128;           // threads of the chunk-state pass
constexpr int NST = 2;               // chunks staged: the next one and this one
// Row stride (floats) of the staged arrays: 72 = 8 mod 32, so the A
// fragments' reads (rows g, columns t of a step-major array) are free of
// bank conflicts.
constexpr int LDS_ST = 72;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Where channel c of a staged f32 row lies with the swizzle (SWZ): the
// 16-byte groups of channels 32..63 swap in pairs, so 8 lanes reading 8
// channels each of one row (32 bytes apart) hit 32 distinct banks.
__device__ __forceinline__ int swz(int c) { return c ^ (((c >> 5) & 1) << 2); }

// ROWS steps from t0 on (valid: t < t_end) of DKP channels (valid: < dk)
// of one (batch item, head) slice (`stride` elements between steps) into
// dst[ROWS][LD], the rest zero, by NT threads. D is the input dtype T (the
// rows as they are) or f32 (bf16 widened as it is staged); with SWZ (f32
// rows only) channel c lies at swz(c). Rows on 16 bytes (VEC) go by
// cp.async when D is T (the caller commits and waits), bf16 into f32
// through registers, 8 values per load; others element by element.
template <int ROWS, int LD, int NT, bool VEC, bool SWZ = false, typename D,
          typename T>
__device__ __forceinline__ void stage_rows(D* dst, const T* src,
                                           long long stride, int t0,
                                           int t_end, int dk, int tid) {
  static_assert(!SWZ || sizeof(D) == 4, "the swizzle moves f32 groups");
  constexpr bool RAW = std::is_same<D, T>::value;
  static_assert(RAW || std::is_same<D, float>::value, "stage T or f32");
  if constexpr (VEC && RAW) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = DKP / EPC;
    for (int c = tid; c < ROWS * CPR; c += NT) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * EPC;
      const bool ok = t0 + r < t_end && d < dk;
      cp_async16(dst + r * LD + (SWZ ? swz(d) : d),
                 ok ? src + (t0 + r) * stride + d : src, ok ? 16 : 0);
    }
  } else if constexpr (VEC) {
    constexpr int CPR = DKP / 8;
#pragma unroll 4
    for (int c = tid; c < ROWS * CPR; c += NT) {
      const int r = c / CPR;
      const int d = (c - r * CPR) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (t0 + r < t_end && d < dk) {
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
      *reinterpret_cast<float4*>(dst + r * LD + (SWZ ? swz(d) : d)) = lo;
      *reinterpret_cast<float4*>(dst + r * LD + (SWZ ? swz(d + 4) : d + 4)) =
          hi;
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < ROWS * DKP; e += NT) {
      const int r = e / DKP;
      const int d = e - r * DKP;
      const bool ok = t0 + r < t_end && d < dk;
      D x = static_cast<D>(0.f);
      if constexpr (RAW) {
        if (ok) x = src[(t0 + r) * stride + d];
      } else {
        if (ok) x = widen(src[(t0 + r) * stride + d]);
      }
      dst[r * LD + (SWZ ? swz(d) : d)] = x;
    }
  }
}

// Shared memory of the chunk-state pass (byte offsets from a 1024-byte
// aligned base): B's hi and lo planes (DKP rows x CH steps f32, 128-byte
// swizzled: sw_f32<DKP>), A (the A source times the decay factors,
// [CH][LDS_ST] f32), NST stages of w, the A source and the B source as
// they come ([CH][LDS_ST] each in the input dtype), the chunk's decay
// product per channel.
template <typename T>
struct StateSmem {
  static constexpr int PLANE = DKP * CH * 4;
  static constexpr int STAGE = 3 * CH * LDS_ST * (int)sizeof(T);
  static constexpr int HI = 0, LO = PLANE, AT = 2 * PLANE;
  static constexpr int STG = AT + CH * LDS_ST * 4;
  static constexpr int PALL = STG + NST * STAGE;
  static constexpr int BYTES = PALL + DKP * 4 + 1024;
};

// One chain for (batch item, head) bh (128 threads, one warpgroup).
// rev = false, the state chain: a_src = k, b_src = v, chunks in order,
// the state at the start of chunk c to out[bh][c] (64 x 64 f32, [i][j]);
// with s_last the final state S_T to s_last (B, H, dk, dk), else the last
// chunk's product is skipped. rev = true, the gradient chain: a_src = r,
// b_src = dy, chunks last to first from `seed` (dS, (B, H, dk, dk) f32) or
// zero, G after the last step of chunk c to out[bh][c]; the first chunk's
// product is skipped. The accumulator d holds rows (key channels)
// 16 warp + {g, g + 8}, columns (value channels) 8 nt + {2t, 2t + 1}.
template <typename T, bool VEC>
__device__ __forceinline__ void state_chain(
    const T* __restrict__ a_src, const T* __restrict__ w,
    const T* __restrict__ b_src, Strides as, Strides ws, Strides bs,
    const float* __restrict__ seed, float* __restrict__ out,
    float* __restrict__ s_last, int H, int T_len, int dk, int n_ch,
    bool rev, int bh) {
  using L = StateSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  const uint32_t bhi = smem_addr(sm + L::HI), blo = smem_addr(sm + L::LO);
  float* const pall = reinterpret_cast<float*>(sm + L::PALL);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = bh / H, h = bh - b * H;
  const T* ap = a_src + b * as.b + h * as.h;
  const T* wp = w + b * ws.b + h * ws.h;
  const T* bp = b_src + b * bs.b + h * bs.h;

  float d[8][4];
  zero<8>(d);
  if (seed != nullptr) {
    const float* s0 = seed + (long long)bh * dk * dk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * warp + g + 8 * (e >> 1);
        const int j = 8 * nt + 2 * t + (e & 1);
        if (i < dk && j < dk) d[nt][e] = s0[i * dk + j];
      }
  }
  auto stage = [&](int c, int slot) {
    T* st = reinterpret_cast<T*>(sm + L::STG + slot * L::STAGE);
    const int t0 = c * CH;
    stage_rows<CH, LDS_ST, ST_NT, VEC>(st, wp, ws.s, t0, T_len, dk, tid);
    stage_rows<CH, LDS_ST, ST_NT, VEC>(st + CH * LDS_ST, ap, as.s, t0, T_len,
                                      dk, tid);
    stage_rows<CH, LDS_ST, ST_NT, VEC>(st + 2 * CH * LDS_ST, bp, bs.s, t0,
                                      T_len, dk, tid);
  };

  // chunk number it of the chain (its order: first to last, or last to
  // first) stages into slot it % NST, NST - 1 chunks ahead of the one
  // computing; one copy group per chunk (empty past the end)
  auto chunk_of = [&](int it) { return rev ? n_ch - 1 - it : it; };
#pragma unroll
  for (int it = 0; it < NST - 1; ++it) {
    if (it < n_ch) stage(chunk_of(it), it);
    cp_async_commit();
  }
  for (int it = 0; it < n_ch; ++it) {
    const int c = chunk_of(it);
    const int slot = it % NST;
    cp_async_wait<NST - 2>();            // chunk c has landed, and every
    __syncthreads();                     // warp is done with chunk it - 1,
    const int ahead = it + NST - 1;      // whose slot refills now
    if (ahead < n_ch) stage(chunk_of(ahead), ahead % NST);
    cp_async_commit();

    // the state at the chunk boundary
    float* o = out + ((long long)bh * n_ch + c) * DKP * DKP;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(o + (16 * warp + g + 8 * hf) * DKP +
                                   8 * nt + 2 * t) =
            make_float2(d[nt][2 * hf], d[nt][2 * hf + 1]);
    if (it + 1 == n_ch && s_last == nullptr) break;

    const T* const st =
        reinterpret_cast<const T*>(sm + L::STG + slot * L::STAGE);
    const T* const sw = st;
    const T* const sr = st + CH * LDS_ST;    // the A source as staged
    const T* const sb = st + 2 * CH * LDS_ST;
    float* const sa = reinterpret_cast<float*>(sm + L::AT);
    if (tid < DKP) {
      // channel tid's decay factors, one step at a time: suffix products
      // (the state chain, last step first) or prefix products (the
      // gradient chain, first step first), each excluding its own step;
      // steps past T decay by 1
      const int nt_c = min(CH, T_len - c * CH);
      const T* __restrict__ wr = sw + tid;
      const T* __restrict__ rr = sr + tid;
      float* __restrict__ ar = sa + tid;
      float acc = 1.f;
      // (8 steps' loads at a time ahead of the chain)
#pragma unroll 1
      for (int q0 = 0; q0 < CH; q0 += 8) {
        float wv[8], av[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int s = rev ? q0 + q : CH - 1 - q0 - q;
          wv[q] = s < nt_c ? widen(wr[s * LDS_ST]) : 1.f;
          av[q] = widen(rr[s * LDS_ST]);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int s = rev ? q0 + q : CH - 1 - q0 - q;
          ar[s * LDS_ST] = av[q] * acc;
          acc *= wv[q];
        }
      }
      pall[tid] = acc;
    } else {
      // B transposed and split: element (step s, channel j) to row j,
      // column s of both planes; lanes span 8 channels x 4 steps (reads
      // and swizzled writes free of bank conflicts), 8 reads ahead
      const int u = tid - DKP;
      const int jl = u & 7, sl = (u >> 3) & 3;
#pragma unroll 1
      for (int p0 = 0; p0 < (DKP / 8) * (CH / 4) / 2; p0 += 8) {
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int p = 2 * (p0 + q) + (u >> 5);
          x[q] = widen(sb[(4 * (p >> 3) + sl) * LDS_ST + 8 * (p & 7) + jl]);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int p = 2 * (p0 + q) + (u >> 5);
          uint32_t hi, lo;
          split(x[q], hi, lo);
          const int off = sw_f32<DKP>(8 * (p & 7) + jl, 4 * (p >> 3) + sl);
          *reinterpret_cast<uint32_t*>(sm + L::HI + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + L::LO + off) = lo;
        }
      }
      fence_async_smem();
    }
    __syncthreads();

    const float p0 = pall[16 * warp + g], p1 = pall[16 * warp + g + 8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      d[nt][0] *= p0;
      d[nt][1] *= p0;
      d[nt][2] *= p1;
      d[nt][3] *= p1;
    }
    // The chunk's product in split TF32 as two fresh chains in one group,
    // hi.hi in one accumulator and the small products lo.hi and hi.lo in
    // the other, both added to the state in f32: each chain's truncating
    // adds stay with its own magnitude. A's fragments (rows 16 warp +
    // {g, g + 8}, steps 8 kk + {t, t + 4}) are split as they are loaded.
    uint32_t ah[8][4], al[8][4];
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* a0 = sa + (8 * kk + t) * LDS_ST + r0;
      const float* a1 = a0 + 4 * LDS_ST;
      split(a0[0], ah[kk][0], al[kk][0]);
      split(a0[8], ah[kk][1], al[kk][1]);
      split(a1[0], ah[kk][2], al[kk][2]);
      split(a1[8], ah[kk][3], al[kk][3]);
    }
    float big[8][4], small[8][4];
    wg_fence();
    wgmma_tf32_first<DKP>(small, al[0], kmajor<DKP>(bhi, 0, 0));
    wgmma_tf32<DKP>(small, ah[0], kmajor<DKP>(blo, 0, 0), 1);
    wgmma_tf32_first<DKP>(big, ah[0], kmajor<DKP>(bhi, 0, 0));
#pragma unroll
    for (int kk = 1; kk < 8; ++kk) {
      wgmma_tf32<DKP>(small, al[kk], kmajor<DKP>(bhi, 0, kk), 1);
      wgmma_tf32<DKP>(small, ah[kk], kmajor<DKP>(blo, 0, kk), 1);
      wgmma_tf32<DKP>(big, ah[kk], kmajor<DKP>(bhi, 0, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    pin<8>(big);
    pin<8>(small);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] += big[nt][e] + small[nt][e];
  }
  if (s_last != nullptr) {
    float* o = s_last + (long long)bh * dk * dk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * warp + g + 8 * (e >> 1);
        const int j = 8 * nt + 2 * t + (e & 1);
        if (i < dk && j < dk) o[i * dk + j] = d[nt][e];
      }
  }
}

}  // namespace
