// FlashAttention-2 backward, float32, for sm_90a: two kernels on the
// tensor cores in 3xTF32. This header holds the kernels and their
// launches; the entries that instantiate them are four sources, so that
// each nvcc compiles a share of the instantiations (every instantiation
// of both dtypes took 107.6 s in one nvcc on an H100's host, the float32
// dK/dV's alone 87.5 s): flash_dq_f32.cu
// and flash_dkv_f32.cu (D 32, 64 and 128 exact, and the padded widths 8,
// 16, 32 and 64), flash_dq_f32_wide.cu and flash_dkv_f32_wide.cu (the
// padded widths 96, 128 and 256). The bf16 kernels are
// flash_bwd_bf16.cu's.
//
// Replaces paddle_tpu/ops/pallas_attention.py::_flash_dq_kernel and
// ::_flash_dkv_kernel (launched by _flash_backward). With S = Q K^T *
// sm_scale (causal-masked), the saved row logsumexp lse, delta =
// rowsum(dO * O) (computed beside the launch), and the dropout keep mask
// (flash_common.cuh) with drop_scale = 1 / (1 - rate):
//   W      = exp(S - lse)                  normalised, undropped weights
//   dW     = keep ? (dO V^T) * drop_scale : 0
//   dS     = W * (dW - delta) * sm_scale
//   dQ     = dS K                          (flash_dq_kernel)
//   dK     = dS^T Q,  dV = W_drop^T dO     (flash_dkv_kernel)
// where W_drop = keep ? W * drop_scale : 0. The [T, T] matrices never
// reach device memory: each kernel rebuilds its tiles of W, dW and dS
// from Q, K, V, dO, lse and delta, as the TPU kernels do (dQ 3 products
// of 2*T^2*D per (b, h), dK/dV 4).
//
// What bounds them on the H100: against 5 (dQ) or 6 (dK/dV) [T, D]
// tensors read or written, that is about T/2 operations per byte, so both
// are bound by arithmetic. Every product runs on the tensor cores as
// mma.sync m16n8k8 TF32 in the 3xTF32 split (mma_tf32.cuh): three TF32
// products per fp32 product, so the ceiling is 495 / 3 = 165 TFLOP/s, not
// the 67 TFLOP/s of the fp32 CUDA cores that the first version used.
// One TF32 product alone keeps 11 significant bits and misses the
// backward's 1e-4 tolerance (tests/test_torch_tf32_split.py); 3xTF32
// keeps fp32 accuracy.
//
// Design. mma.sync, not wgmma: wgmma reads tf32 operands K-major from
// shared memory only, and the transposed products (dS^T Q, W_drop^T dO)
// would need transposed copies of Q and dO. mma.sync fragments are read
// from shared memory by index in either orientation, and the hi/lo split
// stays in registers.
// - dQ: grid (ceil(T/64), B*H), 4 warps, one block per 64 query rows, 16
//   rows a warp. Q and dO stay in shared memory; K and V tiles of BS rows
//   stream through a two-stage cp.async ring (tile n+1 lands while tile n
//   computes). Per tile a warp takes S = Q K^T and dP = dO V^T into
//   accumulator fragments, turns them into dS in registers (exp, masks,
//   dropout hash), and feeds dS straight back as the A operand of
//   dQ += dS K: the accumulator holds columns 2t, 2t + 1 where the A
//   fragment wants t, t + 4, so the k index is permuted and K's rows are
//   read in the same order (acc_as_a / load_b_perm). dQ stays in
//   registers and is written once.
// - dK/dV: grid (ceil(T/64), B*H), one block per 64 key rows, K and V
//   resident; Q, dO, lse and delta tiles stream through the ring from the
//   first live query tile. A warp computes S^T = K Q^T and dP^T = V dO^T
//   for its 16 key rows, turns them into W_drop^T and dS^T in registers
//   and feeds them as A into dV += W_drop^T dO and dK += dS^T Q. Nothing
//   goes through shared memory but the input tiles.
// - Shared rows have stride D + 4 floats: rows g = 0..7 and columns
//   t = 0..3 of every fragment load (and rows 2t, 2t + 1) fall on 32
//   distinct banks.
// - Streamed tiles are BS = 32 rows: at D 64 a block then takes 69 KB of
//   shared memory and at most 168 registers a thread, and an SM holds 3
//   blocks (12 warps), where 64-row tiles allowed 2 and ran slower on the
//   H100. Rows >= T are zero-filled by the copy's src-size operand and
//   never read; rows and columns >= T are masked (W = 0) and never
//   written.
// - S's small terms go to an accumulator of their own (mma_3xtf32_sep):
//   W = exp(S - lse) turns an error of S into a relative error of W.
// - causal: tiles wholly above the diagonal are skipped, the diagonal tile
//   is masked.
// - No atomics and a fixed order of every sum: two launches on the same
//   inputs give bit-equal outputs.
// - dropout regenerates the forward's mask from (seed, bh, row, column),
//   independent of tiling; it is a template flag, and rate 0 (thresh == 0)
//   launches the instantiation without it.
//
// Head dims (the TPU kernels take any D <= 256): every multiple of 8 from
// 8 to 256. D 32, 64 and 128 run in their exact instantiations (PAD
// false), the design above instruction for instruction. Any other D runs
// in the padded instantiation of the smallest width DP in {8, 16, 32, 64,
// 96, 128, 256} that covers it, the float32 forward's widths (bwd_width;
// worst case D 136 in DP 256, 1.88x the products). The copy zero-fills
// columns D..DP of each Q, dO, K and V row (cp.async with src-size 0, as
// for rows past T), so they add exact zeros to S and dP, and dQ, dK and
// dV's columns past D, which are not stored; global rows keep their
// stride D and nothing is copied outside the kernel. What each end of the
// range needed:
// - DP 8: a 32-row streamed tile is 64 16-byte chunks for 128 threads,
//   so the copy loop guards its last round (a no-op test at the other
//   widths).
// - DP 96: 102,400 B a block (135,168 at DP 128), one block of 4 warps an
//   SM for the registers, as at D 128.
// - DP 256: 4 (2 BR + 4 BS) (DP + 4) bytes of shared memory were 266,240
//   at BS 32, over the 232,448 a block may take: streamed tiles are 16
//   rows (bs(); 199,680 B). dQ's accumulator is 128 floats a thread and
//   fits; dK and dV together would be 256, past the 255-register ceiling,
//   so dK/dV launches twice (dkv_split): a dV launch (S^T and W_drop^T
//   only, no dP^T) and a dK launch, each keeping one 16 x 256 accumulator
//   a warp; S^T is computed in both, 5 products of 2 B H T^2 D where one
//   launch would take 4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace ptt_flash;
using namespace ptt_mma;

constexpr int BWD_THREADS = 128;  // 4 warps
constexpr int BR = 64;            // resident rows a block: 16 a warp

// rows of a streamed tile: 32; 16 at DP 256 (shared memory, see above)
template <int D>
__host__ __device__ constexpr int bs() { return D > 128 ? 16 : 32; }

// blocks an SM must hold at once: 3 at D <= 64 caps registers at 168
// (no spills) and fits 3 blocks' shared memory; D = 128 needs its 255
template <int D>
constexpr int min_blocks() { return D <= 64 ? 3 : 1; }

// rows [r0, r0 + ROWS) of a [T, D] slice -> shared (row stride D + 4),
// asynchronously; rows >= T are zero-filled and not read. PAD: the slice
// is [T, d] (row stride d), and columns d..D are zero-filled and not read.
template <int D, int ROWS, bool PAD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int T, int tid, int d) {
  constexpr int SD = D + 4;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  constexpr int N = ROWS * CPR;
  const int ld = PAD ? d : D;
#pragma unroll
  for (int it = 0; it < (N + BWD_THREADS - 1) / BWD_THREADS; ++it) {
    const int i = tid + it * BWD_THREADS;
    if (N % BWD_THREADS != 0 && i >= N) break;  // DP 8's streamed tile
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r0 + r < T && (!PAD || c < d);
    cp_async16(dst + r * SD + c,
               src + (size_t)(ok ? r0 + r : 0) * ld + (PAD && !ok ? 0 : c),
               ok);
  }
}

// rows [r0, r0 + ROWS) of a [T] row vector -> shared, zeros past T
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int T, int tid) {
  if (tid < ROWS) {
    const bool ok = r0 + tid < T;
    cp_async4(dst + tid, src + (ok ? r0 + tid : 0), ok);
  }
}

// d: the head dim (D unless PAD); q, k, v, dout and dq are [B*H, T, d]
template <int D, bool DROP, bool PAD>
__global__ void __launch_bounds__(BWD_THREADS, min_blocks<D>())
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int T, float sm_scale, int causal,
                uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale,
                int d) {
  constexpr int BS = bs<D>();
  constexpr int SD = D + 4;
  constexpr int NS = BS / 8;         // 8-key n-tiles of S, k-tiles of dQ
  constexpr int ND = D / 8;          // 8-wide k-tiles of S, n-tiles of dQ
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BR][SD]
  float* dOs = Qs + BR * SD;         // [BR][SD]
  float* Ks = dOs + BR * SD;         // [2][BS][SD]
  float* Vs = Ks + 2 * BS * SD;      // [2][BS][SD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BR;
  const int ld = PAD ? d : D;        // global row stride
  const size_t base = (size_t)blockIdx.y * T * ld;
  const size_t rbase = (size_t)blockIdx.y * T;

  const int n_kv = (T + BS - 1) / BS;
  const int n_tiles = causal ? min(n_kv, (q0 + BR - 1) / BS + 1) : n_kv;

  load_tile<D, BR, PAD>(Qs, q + base, q0, T, tid, d);
  load_tile<D, BR, PAD>(dOs, dout + base, q0, T, tid, d);
  load_tile<D, BS, PAD>(Ks, k + base, 0, T, tid, d);
  load_tile<D, BS, PAD>(Vs, v + base, 0, T, tid, d);
  cp_async_commit();

  // this thread's query rows: wr and wr + 8 of the tile
  const int wr = 16 * warp + g;
  const int row[2] = {q0 + wr, q0 + wr + 8};
  float lse_r[2], delta_r[2];
  uint32_t rkey[2];
  const uint32_t bk = DROP ? bh_key(seed, bh0 + blockIdx.y) : 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = row[h] < T ? lse[rbase + row[h]] : 0.f;
    delta_r[h] = row[h] < T ? delta[rbase + row[h]] : 0.f;
    rkey[h] = DROP ? row_key(bk, row[h]) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const int st = (kt + 1) & 1;
      load_tile<D, BS, PAD>(Ks + st * BS * SD, k + base, (kt + 1) * BS, T,
                            tid, d);
      load_tile<D, BS, PAD>(Vs + st * BS * SD, v + base, (kt + 1) * BS, T,
                            tid, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (kt & 1) * BS * SD;
    const float* Vt = Vs + (kt & 1) * BS * SD;
    const int k0 = kt * BS;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BS keys
    float s[NS][4], s_small[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_small[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      load_a<SD>(Qs, wr, 8 * kk + t, qh, ql);
      load_a<SD>(dOs, wr, 8 * kk + t, oh, ol);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bh[2], bl[2];
        load_b_t<SD>(Kt, 8 * j + g, 8 * kk + t, bh, bl);
        mma_3xtf32_sep(s[j], s_small[j], qh, ql, bh, bl);
        load_b_t<SD>(Vt, 8 * j + g, 8 * kk + t, bh, bl);
        mma_3xtf32(dp[j], oh, ol, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_small[j][e];

    // dS in place of S: element e of n-tile j is row[e >> 1], key column
    // k0 + 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = row[h] < T && col < T && !(causal && col > row[h]);
        const float w = live ? expf(s[j][e] * sm_scale - lse_r[h]) : 0.f;
        float dw = dp[j][e];
        if (DROP) dw = keep(rkey[h], col, thresh) ? dw * drop_scale : 0.f;
        s[j][e] = w * (dw - delta_r[h]) * sm_scale;
      }

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t ah[4], al[4];
      acc_as_a(s[j], ah, al);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        load_b_perm<SD>(Kt, 8 * j + 2 * t, 8 * n + g, bh, bl);
        mma_3xtf32(acc[n], ah, al, bh, bl);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < T) {
      float* dst = dq + base + (size_t)row[h] * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        if (!PAD || 8 * n < d)   // a padded width's columns past d: not stored
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// What a dK/dV launch accumulates: both (every width but DP 256), or, at DP
// 256, where dK and dV together would be 256 floats a thread, dV in a first
// launch and dK in a second (the launch makes both, in that order).
constexpr int DKV_BOTH = 0, DKV_DV = 1, DKV_DK = 2;

template <int D>
__host__ __device__ constexpr bool dkv_split() { return D > 128; }

// d: the head dim (D unless PAD); q, k, v, dout, dk and dv are [B*H, T, d]
template <int D, bool DROP, bool PAD, int PART>
__global__ void __launch_bounds__(BWD_THREADS, min_blocks<D>())
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int T,
                 float sm_scale, int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                 float drop_scale, int d) {
  constexpr int BS = bs<D>();
  constexpr bool DO_DV = PART != DKV_DK, DO_DK = PART != DKV_DV;
  constexpr int SD = D + 4;
  constexpr int NS = BS / 8;         // 8-query n-tiles of S^T, k-tiles of dK/dV
  constexpr int ND = D / 8;          // 8-wide k-tiles of S^T, n-tiles of dK/dV
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BR][SD]
  float* Vs = Ks + BR * SD;          // [BR][SD]
  float* Qs = Vs + BR * SD;          // [2][BS][SD]
  float* dOs = Qs + 2 * BS * SD;     // [2][BS][SD]
  float* lse_s = dOs + 2 * BS * SD;  // [2][BS]
  float* delta_s = lse_s + 2 * BS;   // [2][BS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BR;
  const int ld = PAD ? d : D;        // global row stride
  const size_t base = (size_t)blockIdx.y * T * ld;
  const size_t rbase = (size_t)blockIdx.y * T;
  const uint32_t bk = DROP ? bh_key(seed, bh0 + blockIdx.y) : 0u;

  const int n_q = (T + BS - 1) / BS;
  // causal: query tiles ending before this key tile's first row see none
  // of it; k0 is a multiple of BS
  const int qt0 = causal ? k0 / BS : 0;

  load_tile<D, BR, PAD>(Ks, k + base, k0, T, tid, d);
  load_tile<D, BR, PAD>(Vs, v + base, k0, T, tid, d);
  load_tile<D, BS, PAD>(Qs, q + base, qt0 * BS, T, tid, d);
  load_tile<D, BS, PAD>(dOs, dout + base, qt0 * BS, T, tid, d);
  load_rows<BS>(lse_s, lse + rbase, qt0 * BS, T, tid);
  load_rows<BS>(delta_s, delta + rbase, qt0 * BS, T, tid);
  cp_async_commit();

  // this thread's key rows: wr and wr + 8 of the tile
  const int wr = 16 * warp + g;
  const int krow[2] = {k0 + wr, k0 + wr + 8};

  float dk_acc[DO_DK ? ND : 1][4], dv_acc[DO_DV ? ND : 1][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (DO_DK) dk_acc[n][e] = 0.f;
      if constexpr (DO_DV) dv_acc[n][e] = 0.f;
    }

  for (int qt = qt0; qt < n_q; ++qt) {
    const int i = qt - qt0;
    if (qt + 1 < n_q) {
      const int st = (i + 1) & 1;
      const int r0 = (qt + 1) * BS;
      load_tile<D, BS, PAD>(Qs + st * BS * SD, q + base, r0, T, tid, d);
      load_tile<D, BS, PAD>(dOs + st * BS * SD, dout + base, r0, T, tid, d);
      load_rows<BS>(lse_s + st * BS, lse + rbase, r0, T, tid);
      load_rows<BS>(delta_s + st * BS, delta + rbase, r0, T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (i & 1) * BS * SD;
    const float* dOt = dOs + (i & 1) * BS * SD;
    const float* lse_t = lse_s + (i & 1) * BS;
    const float* delta_t = delta_s + (i & 1) * BS;
    const int q0 = qt * BS;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows x BS
    // queries
    float s[NS][4], s_small[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_small[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      load_a<SD>(Ks, wr, 8 * kk + t, kh, kl);
      if constexpr (DO_DK) load_a<SD>(Vs, wr, 8 * kk + t, vh, vl);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bh[2], bl[2];
        load_b_t<SD>(Qt, 8 * j + g, 8 * kk + t, bh, bl);
        mma_3xtf32_sep(s[j], s_small[j], kh, kl, bh, bl);
        if constexpr (DO_DK) {   // dP^T feeds dS^T only
          load_b_t<SD>(dOt, 8 * j + g, 8 * kk + t, bh, bl);
          mma_3xtf32(dp[j], vh, vl, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s_small[j][e];

    // W_drop^T in place of S^T, dS^T in place of dP^T: element e of n-tile
    // j is key row krow[e >> 1], query column q0 + 8 j + 2 t + (e & 1)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int qc = 8 * j + 2 * t + p;
        const int qrow = q0 + qc;
        const uint32_t rk = DROP ? row_key(bk, qrow) : 0u;
        const float lse_q = lse_t[qc];
        const float delta_q = delta_t[qc];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + p;
          const bool live = qrow < T && krow[h] < T &&
                            !(causal && krow[h] > qrow);
          const float w = live ? expf(s[j][e] * sm_scale - lse_q) : 0.f;
          float wd = w, dw = DO_DK ? dp[j][e] : 0.f;
          if (DROP) {
            const bool kp = keep(rk, krow[h], thresh);
            wd = kp ? w * drop_scale : 0.f;
            dw = kp ? dw * drop_scale : 0.f;
          }
          s[j][e] = wd;
          if (DO_DK) dp[j][e] = w * (dw - delta_q) * sm_scale;
        }
      }

    // dV += W_drop^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t wh[4], wl[4], sh[4], sl[4];
      if constexpr (DO_DV) acc_as_a(s[j], wh, wl);
      if constexpr (DO_DK) acc_as_a(dp[j], sh, sl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        if constexpr (DO_DV) {
          load_b_perm<SD>(dOt, 8 * j + 2 * t, 8 * n + g, bh, bl);
          mma_3xtf32(dv_acc[n], wh, wl, bh, bl);
        }
        if constexpr (DO_DK) {
          load_b_perm<SD>(Qt, 8 * j + 2 * t, 8 * n + g, bh, bl);
          mma_3xtf32(dk_acc[n], sh, sl, bh, bl);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] < T) {
      float* dkr = dk + base + (size_t)krow[h] * ld + 2 * t;
      float* dvr = dv + base + (size_t)krow[h] * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        if (PAD && 8 * n >= d) continue;   // a padded width's columns past d
        if constexpr (DO_DK)
          *reinterpret_cast<float2*>(dkr + 8 * n) =
              make_float2(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
        if constexpr (DO_DV)
          *reinterpret_cast<float2*>(dvr + 8 * n) =
              make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BR + 4 * bs<D>()) * (D + 4);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return dq_smem_bytes<D>() + sizeof(float) * 4 * bs<D>();
}

// The instantiation width that serves head dim d: d itself at 32, 64 and
// 128 (exact), else the smallest of 8, 16, 32, 64, 96, 128, 256 that
// covers it (padded, the float32 forward's widths); 0 for a head dim no
// instantiation takes.
inline int bwd_width(int d) {
  if (d < 8 || d > 256 || d % 8 != 0) return 0;
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
       : d <= 96 ? 96 : d <= 128 ? 128 : 256;
}

template <int D, bool PAD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int bh, int T, int d, float sm_scale,
                      int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                      float drop_scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = thresh ? flash_dq_kernel<D, true, PAD>
                       : flash_dq_kernel<D, false, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, T, sm_scale, causal, seed, bh0, thresh,
      drop_scale, d);
  return cudaGetLastError();
}

template <int D, bool PAD, int PART>
cudaError_t launch_dkv_part(const float* q, const float* k, const float* v,
                            const float* dout, const float* lse,
                            const float* delta, float* dk, float* dv, int bh,
                            int T, int d, float sm_scale, int causal,
                            uint32_t seed, uint32_t bh0, uint32_t thresh,
                            float drop_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = thresh ? flash_dkv_kernel<D, true, PAD, PART>
                       : flash_dkv_kernel<D, false, PAD, PART>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, T, sm_scale, causal, seed, bh0, thresh,
      drop_scale, d);
  return cudaGetLastError();
}

// one launch of both, or at DP 256 dV's launch, then dK's
template <int D, bool PAD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int T, int d,
                       float sm_scale, int causal, uint32_t seed, uint32_t bh0,
                       uint32_t thresh, float drop_scale, cudaStream_t stream) {
  if constexpr (dkv_split<D>()) {
    cudaError_t err = launch_dkv_part<D, PAD, DKV_DV>(
        q, k, v, dout, lse, delta, dk, dv, bh, T, d, sm_scale, causal, seed,
        bh0, thresh, drop_scale, stream);
    if (err != cudaSuccess) return err;
    return launch_dkv_part<D, PAD, DKV_DK>(
        q, k, v, dout, lse, delta, dk, dv, bh, T, d, sm_scale, causal, seed,
        bh0, thresh, drop_scale, stream);
  } else {
    return launch_dkv_part<D, PAD, DKV_BOTH>(
        q, k, v, dout, lse, delta, dk, dv, bh, T, d, sm_scale, causal, seed,
        bh0, thresh, drop_scale, stream);
  }
}

// the padded widths that flash_dq_f32_wide.cu and flash_dkv_f32_wide.cu
// compile: 96, 128 and 256 (d 72 .. 256 but 128)
inline bool bwd_wide(int d) { return d != 128 && bwd_width(d) >= 96; }

}  // namespace

namespace ptt_flash_bwd {

// The float32 dQ and dK/dV at a head dim d with bwd_wide(d), each defined
// in its *_wide.cu source and called by the entry of the other: functions
// of the library, not entries of it. Arguments as launch_dq's and
// launch_dkv's; the caller has set the device.
__attribute__((visibility("hidden"))) cudaError_t dq_f32_wide(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dq, int bh, int T, int d,
    float sm_scale, int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
    float drop_scale, cudaStream_t stream);
__attribute__((visibility("hidden"))) cudaError_t dkv_f32_wide(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int bh,
    int T, int d, float sm_scale, int causal, uint32_t seed, uint32_t bh0,
    uint32_t thresh, float drop_scale, cudaStream_t stream);

}  // namespace ptt_flash_bwd
