// FlashAttention-2 backward, float32, for sm_90a: two kernels on the
// tensor cores in 3xTF32.
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
// bf16 (flash_dq_bf16_kernel, flash_dkv_bf16_kernel, for bf16 mixed
// precision): kernels of their own on Hopper's wgmma, TMA and mbarriers
// (wgmma_bf16.cuh), so the float32 kernels above stay as they were. They
// replace the same two TPU kernels in bf16 and round where those round:
// S, W, dP, delta and dS are float32; dQ rounds dS to bf16 for dS K;
// dK/dV rounds W_drop and dS for W_drop^T dO and dS^T Q; dQ, dK and dV
// are written as bf16. The keep hash is flash_common.cuh's.
//
// What bounds them at train-base-amp's shape (B 64, H 8, T 256, D 64):
// bytes, 85 MB (dQ: Q, K, V, dO in, dQ out, lse and delta) and 102 MB
// (dK/dV), 25 and 30 us at 3.35 TB/s, against 12.9 and 17.2 GFLOP of
// products, 13 and 17 us at 989 TFLOP/s. Beside them the CUDA-core pass
// over 33.5 M weights a kernel (exp, masks, dS; at rate 0.1 the fmix32
// keep hash, about 11 integer operations a weight): about 20 instructions
// a weight in dQ, some 22 us of issue on 132 SMs, which the tensor cores
// cannot take.
//
// Design:
// - Persistent blocks, one an SM, each walking work items: 128 rows
//   (query rows for dQ, key rows for dK/dV) of one head; the row blocks
//   of a head are neighbouring items, so blocks side by side read its
//   streamed tiles once from memory and then from L2. A block is two
//   consumer warpgroups, 64 resident rows each, and a producer warpgroup
//   of which one warp works (setmaxnreg hands the producer's registers
//   to the consumers at run time, 232 and 32 a thread; ptxas still
//   compiles every thread for at most 168, see flash_fwd.cu).
// - The producer TMA-loads each item's resident tiles (Q and dO, or K and
//   V) into one of two buffers, so the next item's land while this one
//   computes, then streams the other two tensors through a 4-stage ring
//   (2 for dQ's 32 KB tiles at D 128) with full and empty mbarriers;
//   both warpgroups read each streamed tile, so it is loaded once per 128
//   rows. For dK/dV it also stages each query tile's lse and delta (by
//   cp.async, which arrives on the stage's full barrier when they land,
//   so no load latency holds the next TMA back) and its dropout row keys.
//   3-D tensor maps [B*H, T, D] make TMA fill rows >= T of a head with
//   zeros.
// - Tiles sit in shared memory in TMA's 128-byte swizzle (64-column
//   panels; the 64-byte swizzle at D 32), which wgmma reads directly:
//   S = Q K^T and dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV)
//   are m64nNk16 products with A and B from shared memory, both K-major.
//   dS (and W_drop) come from the accumulators in registers: the m64nN
//   accumulator, packed in pairs with cvt.rn.bf16x2, is the register A
//   operand, and the streamed tile is read MN-major through wgmma's
//   transpose bit (bf16 allows either major order for B, which tf32 does
//   not; see above) for dQ += dS K, dV += W_drop^T dO and dK += dS^T Q.
// - The CUDA-core pass: exp is ex2.approx with log2 e folded into lse and
//   the scale; tiles wholly inside T and below the diagonal run without
//   the mask tests. The two warpgroups take turns issuing a tile's S and
//   dP (named barriers), so that one's pass runs while the other's
//   products use the tensor cores.
// - Each warpgroup writes its dQ (dK and dV) tile into its own resident
//   slot, free once its products are done, in TMA's layout, and one
//   bulk TMA store sends it out (rows past T clipped): scattered 4-byte
//   stores of the outputs held dK/dV's pipeline back more than anything
//   else.
// - Tried and not kept: a warpgroup issuing the next tile's S and dP
//   behind this tile's register-A products (ptxas gives their A operand
//   the registers of the dead dP accumulator and then serializes every
//   wgmma, C7515/C7518); one consumer warpgroup a block at two blocks an
//   SM (dK/dV's accumulators spilled); 128-key dQ tiles (no faster,
//   causal slower); dropping lse and delta loads' latency was not what
//   held dK/dV back (its epilogue was).
// - Known limit: at D 128 ptxas spills about 600 bytes in dK/dV and
//   serializes its wgmmas (C7512); D 128 is correct, and off the main
//   path (the repo's models run D 64).
// - causal: key (query) tiles past (before) the item's rows are not
//   loaded, a warpgroup skips the tiles it cannot see, and the diagonal
//   tile is masked. No atomics and a fixed order of every sum: two
//   launches give equal bits. Any T >= 1; D 32, 64 or 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace ptt_flash;
using namespace ptt_mma;

constexpr int BWD_THREADS = 128;  // 4 warps
constexpr int BR = 64;            // resident rows a block: 16 a warp
constexpr int BS = 32;            // rows of a streamed tile

// blocks an SM must hold at once: 3 at D <= 64 caps registers at 168
// (no spills) and fits 3 blocks' shared memory; D = 128 needs its 255
template <int D>
constexpr int min_blocks() { return D <= 64 ? 3 : 1; }

// rows [r0, r0 + ROWS) of a [T, D] slice -> shared (row stride D + 4),
// asynchronously; rows >= T are zero-filled and not read
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int T, int tid) {
  constexpr int SD = D + 4;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert((ROWS * CPR) % BWD_THREADS == 0, "tile / thread mismatch");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / BWD_THREADS; ++it) {
    const int i = tid + it * BWD_THREADS;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r0 + r < T;
    cp_async16(dst + r * SD + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
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

template <int D, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS, min_blocks<D>())
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int T, float sm_scale, int causal,
                uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale) {
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
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;

  const int n_kv = (T + BS - 1) / BS;
  const int n_tiles = causal ? min(n_kv, (q0 + BR - 1) / BS + 1) : n_kv;

  load_tile<D, BR>(Qs, q + base, q0, T, tid);
  load_tile<D, BR>(dOs, dout + base, q0, T, tid);
  load_tile<D, BS>(Ks, k + base, 0, T, tid);
  load_tile<D, BS>(Vs, v + base, 0, T, tid);
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
      load_tile<D, BS>(Ks + st * BS * SD, k + base, (kt + 1) * BS, T, tid);
      load_tile<D, BS>(Vs + st * BS * SD, v + base, (kt + 1) * BS, T, tid);
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
      float* dst = dq + base + (size_t)row[h] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS, min_blocks<D>())
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int T,
                 float sm_scale, int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                 float drop_scale) {
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
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;
  const uint32_t bk = DROP ? bh_key(seed, bh0 + blockIdx.y) : 0u;

  const int n_q = (T + BS - 1) / BS;
  // causal: query tiles ending before this key tile's first row see none
  // of it; k0 is a multiple of BS
  const int qt0 = causal ? k0 / BS : 0;

  load_tile<D, BR>(Ks, k + base, k0, T, tid);
  load_tile<D, BR>(Vs, v + base, k0, T, tid);
  load_tile<D, BS>(Qs, q + base, qt0 * BS, T, tid);
  load_tile<D, BS>(dOs, dout + base, qt0 * BS, T, tid);
  load_rows<BS>(lse_s, lse + rbase, qt0 * BS, T, tid);
  load_rows<BS>(delta_s, delta + rbase, qt0 * BS, T, tid);
  cp_async_commit();

  // this thread's key rows: wr and wr + 8 of the tile
  const int wr = 16 * warp + g;
  const int krow[2] = {k0 + wr, k0 + wr + 8};

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int i = qt - qt0;
    if (qt + 1 < n_q) {
      const int st = (i + 1) & 1;
      const int r0 = (qt + 1) * BS;
      load_tile<D, BS>(Qs + st * BS * SD, q + base, r0, T, tid);
      load_tile<D, BS>(dOs + st * BS * SD, dout + base, r0, T, tid);
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
      load_a<SD>(Vs, wr, 8 * kk + t, vh, vl);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bh[2], bl[2];
        load_b_t<SD>(Qt, 8 * j + g, 8 * kk + t, bh, bl);
        mma_3xtf32_sep(s[j], s_small[j], kh, kl, bh, bl);
        load_b_t<SD>(dOt, 8 * j + g, 8 * kk + t, bh, bl);
        mma_3xtf32(dp[j], vh, vl, bh, bl);
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
          float wd = w, dw = dp[j][e];
          if (DROP) {
            const bool kp = keep(rk, krow[h], thresh);
            wd = kp ? w * drop_scale : 0.f;
            dw = kp ? dw * drop_scale : 0.f;
          }
          s[j][e] = wd;
          dp[j][e] = w * (dw - delta_q) * sm_scale;
        }
      }

    // dV += W_drop^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t wh[4], wl[4], sh[4], sl[4];
      acc_as_a(s[j], wh, wl);
      acc_as_a(dp[j], sh, sl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        load_b_perm<SD>(dOt, 8 * j + 2 * t, 8 * n + g, bh, bl);
        mma_3xtf32(dv_acc[n], wh, wl, bh, bl);
        load_b_perm<SD>(Qt, 8 * j + 2 * t, 8 * n + g, bh, bl);
        mma_3xtf32(dk_acc[n], sh, sl, bh, bl);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] < T) {
      float* dkr = dk + base + (size_t)krow[h] * D + 2 * t;
      float* dvr = dv + base + (size_t)krow[h] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<float2*>(dkr + 8 * n) =
            make_float2(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
        *reinterpret_cast<float2*>(dvr + 8 * n) =
            make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BR + 4 * BS) * (D + 4);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return dq_smem_bytes<D>() + sizeof(float) * 4 * BS;
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int bh, int T, float sm_scale, int causal,
                      uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = thresh ? flash_dq_kernel<D, true> : flash_dq_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, T, sm_scale, causal, seed, bh0, thresh,
      drop_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int T, float sm_scale,
                       int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                       float drop_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = thresh ? flash_dkv_kernel<D, true> : flash_dkv_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, T, sm_scale, causal, seed, bh0, thresh,
      drop_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed shared memory (wgmma_bf16.cuh)
// ---------------------------------------------------------------------------

using ptt_mma_bf16::bf16;
using ptt_mma_bf16::pack_bf16;

namespace bf16w {

using namespace ptt_hopper;

constexpr int WG_ROWS = 64;       // resident rows a consumer warpgroup owns
constexpr int CONSUMER_WGS = 2;
constexpr int BLOCK_ROWS = CONSUMER_WGS * WG_ROWS;   // rows of a work item
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;   // + a producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// One block an SM: 168 registers a thread at launch (65536 / 384). The
// producer warpgroup gives most of its share to the consumers:
// 2 x 128 x 232 + 128 x 32 <= 384 x 168.
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 232;

// streamed rows a tile: dQ 64 keys; dK/dV 64 queries, 32 at D 128 (where
// dK and dV take 64 registers each)
constexpr int BN_DQ = 64;
template <int D>
__host__ __device__ constexpr int bn_dkv() {
  return D == 128 ? 32 : 64;
}
// ring stages: 4 (the whole K/V of a head at T 256, D 64), 2 for dQ's
// 32 KB tiles at D 128 (shared memory)
template <int D>
__host__ __device__ constexpr int stages_dq() { return D == 128 ? 2 : 4; }
constexpr int STAGES_DKV = 4;

// resident tiles: two tensors x two buffers (an item's and the next
// one's) x the warpgroups' 64 rows; then the ring; then the barriers
template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + 4 * CONSUMER_WGS * tile_bytes<D>(WG_ROWS) +
         2 * stages_dq<D>() * tile_bytes<D>(BN_DQ) +
         8 * (4 + 2 * stages_dq<D>());
}

template <int D>
__host__ __device__ constexpr size_t dkv_smem() {
  return 1024 + 4 * CONSUMER_WGS * tile_bytes<D>(WG_ROWS) +
         2 * STAGES_DKV * tile_bytes<D>(bn_dkv<D>()) +
         3 * STAGES_DKV * bn_dkv<D>() * sizeof(float) +
         8 * (4 + 2 * STAGES_DKV);
}

// x = A_x B_x^T and y = A_y B_y^T for streamed tile i (ring stage
// i % ST) once it has landed, 64 x BN each, committed as one group: A_x and
// A_y are this warpgroup's resident tiles, B_x and B_y the ring's bases
template <int D, int BN, int ST>
__device__ __forceinline__ void issue_pair(float (&x)[BN / 2],
                                           float (&y)[BN / 2],
                                           const unsigned char* ax,
                                           const unsigned char* ay,
                                           const unsigned char* bx,
                                           const unsigned char* by,
                                           uint64_t* full, int i) {
  constexpr int STR = tile_bytes<D>(BN);
  const int s = i % ST;
  mbar_wait(full + s, (i / ST) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(x, desc_k<D>(ax, WG_ROWS, kk), desc_k<D>(bx + s * STR, BN, kk),
                kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(y, desc_k<D>(ay, WG_ROWS, kk), desc_k<D>(by + s * STR, BN, kk),
                kk);
  wgmma_commit();
}

// dS in place of S (dQ), float32: register 4 j + e is row[e >> 1], key
// column k0 + 8 j + 2 t + (e & 1). MASK: rows and columns past T, and
// above the diagonal under causal masking, weigh 0.
template <int BN, bool DROP, bool MASK>
__device__ __forceinline__ void dq_scores(
    float (&sc)[BN / 2], const float (&dp)[BN / 2], int k0, int t,
    const int (&row)[2], const float (&lse2)[2], const float (&delta_r)[2],
    const uint32_t (&rkey)[2], int T, int causal, float sm_scale, float sl2,
    uint32_t thresh, float drop_scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      float w = ex2(sc[4 * j + e] * sl2 - lse2[h]);
      if (MASK && !(row[h] < T && col < T && !(causal && col > row[h])))
        w = 0.f;
      float dw = dp[4 * j + e];
      if (DROP) dw = keep(rkey[h], col, thresh) ? dw * drop_scale : 0.f;
      sc[4 * j + e] = w * (dw - delta_r[h]) * sm_scale;
    }
}

// W_drop^T in place of S^T, dS^T in place of dP^T (dK/dV), float32:
// register 4 j + e is key row krow[e >> 1], query column
// q0 + 8 j + 2 t + (e & 1). MASK as in dq_scores.
template <int BN, bool DROP, bool MASK>
__device__ __forceinline__ void dkv_scores(
    float (&sc)[BN / 2], float (&dp)[BN / 2], const float* lse_t,
    const float* delta_t, const uint32_t* rk_t, int q0, int t,
    const int (&krow)[2], int T, int causal, float sm_scale, float sl2,
    uint32_t thresh, float drop_scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int qc = 8 * j + 2 * t + p;
      const int qrow = q0 + qc;
      const uint32_t rk = DROP ? rk_t[qc] : 0u;
      const float lse_q = lse_t[qc] * LOG2E;
      const float delta_q = delta_t[qc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h + p;
        float w = ex2(sc[4 * j + e] * sl2 - lse_q);
        if (MASK && !(qrow < T && krow[h] < T && !(causal && krow[h] > qrow)))
          w = 0.f;
        float wd = w, dw = dp[4 * j + e];
        if (DROP) {
          const bool kp = keep(rk, krow[h], thresh);
          wd = kp ? w * drop_scale : 0.f;
          dw = kp ? dw * drop_scale : 0.f;
        }
        sc[4 * j + e] = wd;
        dp[4 * j + e] = w * (dw - delta_q) * sm_scale;
      }
    }
}

// One dQ tile (key tile kt, ring index i) once its S (in sc) and dP (in
// dp) have been issued: wait for them, turn S into dS in registers, run
// dQ += dS K (dS rounded to bf16 as A from registers, K MN-major) and
// release the tile's stage.
template <int D, int BN, int ST, bool DROP>
__device__ __forceinline__ void dq_tile(
    float (&sc)[BN / 2], float (&dp)[BN / 2], float (&acc)[D / 2],
    const unsigned char* Ks, uint64_t* empty, int i, int kt,
    const int (&row)[2], const float (&lse2)[2],
    const float (&delta_r)[2], const uint32_t (&rkey)[2], int t, int T,
    int causal, float sm_scale, float sl2, uint32_t thresh,
    float drop_scale) {
  constexpr int STR = tile_bytes<D>(BN);
  const int s = i % ST;
  const int k0 = kt * BN;
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);

  // masks only on a tile that reaches past T or crosses the diagonal
  const int r0 = row[0] - row[0] % WG_ROWS;   // the warpgroup's first row
  if (k0 + BN > T || r0 + WG_ROWS > T || (causal && k0 + BN - 1 > r0))
    dq_scores<BN, DROP, true>(sc, dp, k0, t, row, lse2, delta_r, rkey, T,
                              causal, sm_scale, sl2, thresh, drop_scale);
  else
    dq_scores<BN, DROP, false>(sc, dp, k0, t, row, lse2, delta_r, rkey, T,
                               causal, sm_scale, sl2, thresh, drop_scale);

  uint32_t a[BN / 16][4];
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) acc_to_a(sc, jj, a[jj]);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj)
    wgmma_rs<1>(acc, a[jj], desc_mn<D>(Ks + s * STR, BN, jj), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(empty + s);   // this stage's K and V are read
}

// One dK/dV tile (query tile qt, ring index i) once its S^T and dP^T
// have been issued: wait for them, turn them into W_drop^T and dS^T in
// registers, run dV += W_drop^T dO and dK += dS^T Q (both rounded to bf16
// as A from registers, dO and Q MN-major) and release the tile's stage.
template <int D, int BN, int ST, bool DROP>
__device__ __forceinline__ void dkv_tile(
    float (&sc)[BN / 2], float (&dp)[BN / 2], float (&dk_acc)[D / 2],
    float (&dv_acc)[D / 2], const unsigned char* Qs,
    const unsigned char* dOs, const float* lse_s, const float* delta_s,
    const uint32_t* rk_s, uint64_t* empty, int i, int qt,
    const int (&krow)[2], int t, int T, int causal, float sm_scale,
    float sl2, uint32_t thresh, float drop_scale) {
  constexpr int STR = tile_bytes<D>(BN);
  const int s = i % ST;
  const float* lse_t = lse_s + s * BN;
  const float* delta_t = delta_s + s * BN;
  const uint32_t* rk_t = rk_s + s * BN;
  const int q0 = qt * BN;
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);

  // masks only on a tile that reaches past T or crosses the diagonal
  const int kr0 = krow[0] - krow[0] % WG_ROWS;   // the warpgroup's first key
  if (q0 + BN > T || kr0 + WG_ROWS > T || (causal && kr0 + WG_ROWS - 1 > q0))
    dkv_scores<BN, DROP, true>(sc, dp, lse_t, delta_t, rk_t, q0, t, krow, T,
                               causal, sm_scale, sl2, thresh, drop_scale);
  else
    dkv_scores<BN, DROP, false>(sc, dp, lse_t, delta_t, rk_t, q0, t, krow,
                                T, causal, sm_scale, sl2, thresh,
                                drop_scale);

  uint32_t wa[BN / 16][4], sa[BN / 16][4];
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    acc_to_a(sc, jj, wa[jj]);
    acc_to_a(dp, jj, sa[jj]);
  }
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj)
    wgmma_rs<1>(dv_acc, wa[jj], desc_mn<D>(dOs + s * STR, BN, jj), 1);
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj)
    wgmma_rs<1>(dk_acc, sa[jj], desc_mn<D>(Qs + s * STR, BN, jj), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv_acc);
  fence_regs(dk_acc);
  mbar_arrive(empty + s);   // this stage's Q, dO, lse, delta, keys are read
}

// Work item w of a persistent block: row block rb (BLOCK_ROWS query rows
// for dQ, key rows for dK/dV) of head bh. The row blocks of a head are
// neighbouring items, so blocks running side by side read one head's
// streamed tiles together (one read from memory, the rest from L2). The
// launch makes the grid a multiple of n_rb when it can; each round of
// the grid then holds whole heads, and odd rounds take a head's row blocks
// in reverse, so that under causal masking every block alternates costly
// and cheap items.
__device__ __forceinline__ void work_item(int w, int n_rb, int& rb,
                                          int& bh) {
  bh = w / n_rb;
  rb = w - bh * n_rb;
  if (gridDim.x % n_rb == 0 && ((w / gridDim.x) & 1)) rb = n_rb - 1 - rb;
}

}  // namespace bf16w

template <int D, bool DROP>
__global__ void __launch_bounds__(bf16w::THREADS, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dq,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int n_bh, int T,
                     float sm_scale, int causal,
                     uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale) {
  using namespace bf16w;
  constexpr int BN = BN_DQ, ST = stages_dq<D>(), PW = panel_cols<D>();
  constexpr int RES = tile_bytes<D>(WG_ROWS), STR = tile_bytes<D>(BN);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);         // [2][CONSUMER_WGS][RES]
  unsigned char* dOs = Qs + 2 * CONSUMER_WGS * RES;  // [2][CONSUMER_WGS][RES]
  unsigned char* Ks = dOs + 2 * CONSUMER_WGS * RES;  // [ST][STR]
  unsigned char* Vs = Ks + ST * STR;                 // [ST][STR]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(Vs + ST * STR);  // [2]
  uint64_t* res_empty = res_full + 2;              // [2]
  uint64_t* full = res_empty + 2;                  // [ST]
  uint64_t* empty = full + ST;                     // [ST]

  const int tid = threadIdx.x;
  const int n_kv = (T + BN - 1) / BN;
  const int n_rb = (T + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_items = n_rb * n_bh;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full + b, 1);
      mbar_init(res_empty + b, CONSUMERS);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: per item, each warpgroup's Q and dO into the item's
    // resident buffer, then K and V tiles through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int g = 0;   // tiles issued
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int rb, bh;
        work_item(w, n_rb, rb, bh);
        const int q0 = rb * BLOCK_ROWS;
        // causal: key tiles past the item's last query row are not loaded
        const int n_tiles =
            causal ? min(n_kv, (q0 + BLOCK_ROWS - 1) / BN + 1) : n_kv;
        const int b = it & 1;
        mbar_wait(res_empty + b, ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(res_full + b, 2 * CONSUMER_WGS * RES);
        for (int c = 0; c < CONSUMER_WGS; ++c) {
          const int r = q0 + c * WG_ROWS;
          tma_tile<D>(Qs + (b * CONSUMER_WGS + c) * RES, &tm_q,
                      res_full + b, r, bh, WG_ROWS);
          tma_tile<D>(dOs + (b * CONSUMER_WGS + c) * RES, &tm_do,
                      res_full + b, r, bh, WG_ROWS);
        }
        for (int kt = 0; kt < n_tiles; ++kt, ++g) {
          const int s = g % ST;
          mbar_wait(empty + s, ((g / ST) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, 2 * STR);
          tma_tile<D>(Ks + s * STR, &tm_k, full + s, kt * BN, bh, BN);
          tma_tile<D>(Vs + s * STR, &tm_v, full + s, kt * BN, bh, BN);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = 16 * warp + g;   // this thread's rows: wr, wr + 8
    const float sl2 = sm_scale * LOG2E;
    // Ping-pong: the two warpgroups take turns issuing a tile's first
    // products (named barriers 1 and 2), so each one's CUDA-core pass
    // runs while the other's products use the tensor cores. Every tile,
    // computed or skipped, takes a turn; warpgroup 0 has the first.
    if (wg == 1) named_bar_arrive(1, CONSUMERS);
    int gt = 0;   // tiles consumed

    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      int rb, bh;
      work_item(w, n_rb, rb, bh);
      const int q0 = rb * BLOCK_ROWS;
      const int n_tiles =
          causal ? min(n_kv, (q0 + BLOCK_ROWS - 1) / BN + 1) : n_kv;
      const int r0 = q0 + wg * WG_ROWS;   // this warpgroup's first row
      // key tiles this warpgroup reads; it only releases the others
      const int my_tiles =
          r0 >= T ? 0 : causal ? min(n_tiles, (r0 + WG_ROWS - 1) / BN + 1)
                               : n_tiles;
      const size_t rbase = (size_t)bh * T;
      const int row[2] = {r0 + wr, r0 + wr + 8};
      float lse2[2], delta_r[2];
      uint32_t rkey[2];
      const uint32_t bk = DROP ? bh_key(seed, bh0 + bh) : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[h] = row[h] < T ? lse[rbase + row[h]] * LOG2E : 0.f;
        delta_r[h] = row[h] < T ? delta[rbase + row[h]] : 0.f;
        rkey[h] = DROP ? row_key(bk, row[h]) : 0u;
      }

      float acc[D / 2];   // dQ, 64 x D
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      const int b = it & 1;
      const unsigned char* Qw = Qs + (b * CONSUMER_WGS + wg) * RES;
      const unsigned char* dOw = dOs + (b * CONSUMER_WGS + wg) * RES;
      mbar_wait(res_full + b, (it >> 1) & 1);
      // per tile: S = Q K^T and dP = dO V^T (64 x BN each, A from shared
      // memory, K and V K-major), then dq_tile
      float sc[BN / 2], dp[BN / 2];
      for (int kt = 0; kt < my_tiles; ++kt) {
        named_bar_sync(1 + wg, CONSUMERS);   // this warpgroup's turn
        issue_pair<D, BN, ST>(sc, dp, Qw, dOw, Ks, Vs, full, gt + kt);
        named_bar_arrive(2 - wg, CONSUMERS);   // the other's turn
        dq_tile<D, BN, ST, DROP>(sc, dp, acc, Ks, empty, gt + kt, kt, row,
                                 lse2, delta_r, rkey, t, T, causal, sm_scale,
                                 sl2, thresh, drop_scale);
      }
      // tiles past this warpgroup's rows (causal) or all (rows >= T): the
      // turns are taken all the same
      for (int kt = my_tiles; kt < n_tiles; ++kt) {
        const int s = (gt + kt) % ST;
        named_bar_sync(1 + wg, CONSUMERS);
        named_bar_arrive(2 - wg, CONSUMERS);
        mbar_wait(full + s, ((gt + kt) / ST) & 1);
        mbar_arrive(empty + s);
      }
      gt += n_tiles;
      // dQ out: this warpgroup's Q slot is free (its products are done);
      // the tile goes in as TMA lays it out and leaves by one bulk store,
      // rows past T clipped
      if (r0 < T) {
        unsigned char* out = Qs + (b * CONSUMER_WGS + wg) * RES;
        store_acc_tile<D>(out, acc, warp, g, t);
        fence_proxy_async();
        named_bar_sync(3 + wg, 128);
        if ((tid & 127) == 0) {
#pragma unroll
          for (int p = 0; p < D / PW; ++p)
            tma_store_3d(&tm_dq, out + p * WG_ROWS * PW * 2, p * PW, r0, bh);
          tma_store_commit();
          tma_store_wait<true>();   // before the slot is released
        }
      }
      mbar_arrive(res_empty + b);   // Q and dO of this item are read
    }
    if ((tid & 127) == 0) tma_store_wait<false>();
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(bf16w::THREADS, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_dk,
                      const __grid_constant__ CUtensorMap tm_dv,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int n_bh, int T,
                      float sm_scale, int causal, uint32_t seed, uint32_t bh0,
                      uint32_t thresh,
                      float drop_scale) {
  using namespace bf16w;
  constexpr int BN = bn_dkv<D>(), ST = STAGES_DKV, PW = panel_cols<D>();
  constexpr int RES = tile_bytes<D>(WG_ROWS), STR = tile_bytes<D>(BN);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);         // [2][CONSUMER_WGS][RES]
  unsigned char* Vs = Ks + 2 * CONSUMER_WGS * RES;   // [2][CONSUMER_WGS][RES]
  unsigned char* Qs = Vs + 2 * CONSUMER_WGS * RES;   // [ST][STR]
  unsigned char* dOs = Qs + ST * STR;                // [ST][STR]
  float* lse_s = reinterpret_cast<float*>(dOs + ST * STR);   // [ST][BN]
  float* delta_s = lse_s + ST * BN;                          // [ST][BN]
  uint32_t* rk_s =
      reinterpret_cast<uint32_t*>(delta_s + ST * BN);         // [ST][BN]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(rk_s + ST * BN);
  uint64_t* res_empty = res_full + 2;              // [2]
  uint64_t* full = res_empty + 2;                  // [ST]
  uint64_t* empty = full + ST;                     // [ST]

  const int tid = threadIdx.x;
  const int n_q = (T + BN - 1) / BN;
  const int n_rb = (T + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_items = n_rb * n_bh;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full + b, 1);
      mbar_init(res_empty + b, CONSUMERS);
    }
    for (int s = 0; s < ST; ++s) {
      // the producer warp's 32 cp.async arrivals and its lane 0's
      // arrival with the TMA bytes
      mbar_init(full + s, 33);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: per item, each warpgroup's K and V into the item's
    // resident buffer, then Q and dO tiles by TMA and their lse, delta and
    // dropout row keys, through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = tid - CONSUMERS;
    if (lane < 32) {
      int g = 0;   // tiles issued
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int rb, bh;
        work_item(w, n_rb, rb, bh);
        const int k0 = rb * BLOCK_ROWS;
        const size_t rbase = (size_t)bh * T;
        // causal: query tiles ending before the item's first key row see
        // none of it; k0 is a multiple of BN
        const int qt0 = causal ? k0 / BN : 0;
        const int b = it & 1;
        if (lane == 0) {
          mbar_wait(res_empty + b, ((it >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(res_full + b, 2 * CONSUMER_WGS * RES);
          for (int c = 0; c < CONSUMER_WGS; ++c) {
            const int r = k0 + c * WG_ROWS;
            tma_tile<D>(Ks + (b * CONSUMER_WGS + c) * RES, &tm_k,
                        res_full + b, r, bh, WG_ROWS);
            tma_tile<D>(Vs + (b * CONSUMER_WGS + c) * RES, &tm_v,
                        res_full + b, r, bh, WG_ROWS);
          }
        }
        const uint32_t bk = DROP ? bh_key(seed, bh0 + bh) : 0u;
        for (int qt = qt0; qt < n_q; ++qt, ++g) {
          const int s = g % ST;
          const int r0 = qt * BN;
          mbar_wait(empty + s, ((g / ST) & 1) ^ 1);
          // lse and delta by cp.async, which arrives on the stage's full
          // barrier once they have landed (no load latency held here);
          // the dropout row keys (flash_common.cuh) computed and stored
#pragma unroll
          for (int c = 0; c < BN / 32; ++c) {
            const int j = lane + 32 * c, r = r0 + j;
            const size_t src = rbase + (r < T ? r : 0);
            cp_async4(lse_s + s * BN + j, lse + src, r < T);
            cp_async4(delta_s + s * BN + j, delta + src, r < T);
            if (DROP) rk_s[s * BN + j] = row_key(bk, r);
          }
          cp_async_mbar_arrive(full + s);
          __syncwarp();   // every lane's row keys before lane 0's arrival
          if (lane == 0) {
            mbar_arrive_expect_tx(full + s, 2 * STR);
            tma_tile<D>(Qs + s * STR, &tm_q, full + s, r0, bh, BN);
            tma_tile<D>(dOs + s * STR, &tm_do, full + s, r0, bh, BN);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = 16 * warp + g;   // this thread's key rows: wr, wr + 8
    const float sl2 = sm_scale * LOG2E;
    // Ping-pong: the two warpgroups take turns issuing a tile's first
    // products (named barriers 1 and 2), so each one's CUDA-core pass
    // runs while the other's products use the tensor cores. Every tile,
    // computed or skipped, takes a turn; warpgroup 0 has the first.
    if (wg == 1) named_bar_arrive(1, CONSUMERS);
    int gt = 0;   // tiles consumed

    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      int rb, bh;
      work_item(w, n_rb, rb, bh);
      const int k0 = rb * BLOCK_ROWS;
      const int qt0 = causal ? k0 / BN : 0;
      const int kr0 = k0 + wg * WG_ROWS;   // this warpgroup's first key row
      // the first query tile this warpgroup reads (causal: the first that
      // reaches its key rows); it only releases the ones before it
      const int my_qt0 = kr0 >= T ? n_q : causal ? kr0 / BN : qt0;
      const int krow[2] = {kr0 + wr, kr0 + wr + 8};

      float dk_acc[D / 2], dv_acc[D / 2];   // 64 x D each
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

      for (int qt = qt0; qt < my_qt0; ++qt) {
        const int s = (gt + qt - qt0) % ST;
        named_bar_sync(1 + wg, CONSUMERS);   // turns as in the dQ kernel
        named_bar_arrive(2 - wg, CONSUMERS);
        mbar_wait(full + s, ((gt + qt - qt0) / ST) & 1);
        mbar_arrive(empty + s);
      }
      const int b = it & 1;
      const unsigned char* Kw = Ks + (b * CONSUMER_WGS + wg) * RES;
      const unsigned char* Vw = Vs + (b * CONSUMER_WGS + wg) * RES;
      mbar_wait(res_full + b, (it >> 1) & 1);
      // per tile: S^T = K Q^T and dP^T = V dO^T (64 keys x BN queries
      // each, A from shared memory, Q and dO K-major), then dkv_tile
      float sc[BN / 2], dp[BN / 2];
      for (int qt = my_qt0; qt < n_q; ++qt) {
        const int i = gt + qt - qt0;
        named_bar_sync(1 + wg, CONSUMERS);
        issue_pair<D, BN, ST>(sc, dp, Kw, Vw, Qs, dOs, full, i);
        named_bar_arrive(2 - wg, CONSUMERS);
        dkv_tile<D, BN, ST, DROP>(sc, dp, dk_acc, dv_acc, Qs, dOs, lse_s,
                                  delta_s, rk_s, empty, i, qt, krow, t, T,
                                  causal, sm_scale, sl2, thresh, drop_scale);
      }
      gt += n_q - qt0;
      // dK and dV out through this warpgroup's K and V slots, as in the
      // dQ kernel
      if (kr0 < T) {
        unsigned char* ok = Ks + (b * CONSUMER_WGS + wg) * RES;
        unsigned char* ov = Vs + (b * CONSUMER_WGS + wg) * RES;
        store_acc_tile<D>(ok, dk_acc, warp, g, t);
        fence_regs(dv_acc);   // dV's packing after dK's stores (registers)
        store_acc_tile<D>(ov, dv_acc, warp, g, t);
        fence_proxy_async();
        named_bar_sync(3 + wg, 128);
        if ((tid & 127) == 0) {
#pragma unroll
          for (int p = 0; p < D / PW; ++p) {
            tma_store_3d(&tm_dk, ok + p * WG_ROWS * PW * 2, p * PW, kr0, bh);
            tma_store_3d(&tm_dv, ov + p * WG_ROWS * PW * 2, p * PW, kr0, bh);
          }
          tma_store_commit();
          tma_store_wait<true>();   // before the slots are released
        }
      }
      mbar_arrive(res_empty + b);   // K and V of this item are read
    }
    if ((tid & 127) == 0) tma_store_wait<false>();
  }
}

// ---- host: tensor maps and launches ----------------------------------------

using ptt_hopper::encode_bf16_map;
using ptt_hopper::persistent_blocks;

// the four maps of q, k, v, dout: `res_rows`-row boxes for the two
// resident tensors (q, dout for dQ; k, v for dK/dV), `str_rows` for the
// streamed ones
template <int D>
int encode_bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                    const void* v, const void* dout, int bh, int T,
                    bool q_resident, int str_rows) {
  const int rq = q_resident ? 64 : str_rows, rk = q_resident ? str_rows : 64;
  int err;
  if ((err = encode_bf16_map<D>(&m[0], q, bh, T, rq))) return err;
  if ((err = encode_bf16_map<D>(&m[1], k, bh, T, rk))) return err;
  if ((err = encode_bf16_map<D>(&m[2], v, bh, T, rk))) return err;
  return encode_bf16_map<D>(&m[3], dout, bh, T, rq);
}

template <int D>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   bf16* dq, int bh, int T, float sm_scale, int causal,
                   uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale,
                   cudaStream_t stream) {
  CUtensorMap m[4], mdq;
  int err = encode_bwd_maps<D>(m, q, k, v, dout, bh, T, true,
                               bf16w::BN_DQ);
  if (err || (err = encode_bf16_map<D>(&mdq, dq, bh, T, bf16w::WG_ROWS)))
    return err;
  const size_t smem = bf16w::dq_smem<D>();
  auto kernel = thresh ? flash_dq_bf16_kernel<D, true>
                       : flash_dq_bf16_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks;
  if ((err = persistent_blocks(
           (T + bf16w::BLOCK_ROWS - 1) / bf16w::BLOCK_ROWS, bh, &blocks)))
    return err;
  kernel<<<blocks, bf16w::THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], mdq, lse, delta, bh, T, sm_scale, causal,
      seed, bh0, thresh, drop_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, const float* delta,
                    bf16* dk, bf16* dv, int bh, int T, float sm_scale,
                    int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                    float drop_scale, cudaStream_t stream) {
  CUtensorMap m[4], mdk, mdv;
  int err = encode_bwd_maps<D>(m, q, k, v, dout, bh, T, false,
                               bf16w::bn_dkv<D>());
  if (err || (err = encode_bf16_map<D>(&mdk, dk, bh, T, bf16w::WG_ROWS)) ||
      (err = encode_bf16_map<D>(&mdv, dv, bh, T, bf16w::WG_ROWS)))
    return err;
  const size_t smem = bf16w::dkv_smem<D>();
  auto kernel = thresh ? flash_dkv_bf16_kernel<D, true>
                       : flash_dkv_bf16_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks;
  if ((err = persistent_blocks(
           (T + bf16w::BLOCK_ROWS - 1) / bf16w::BLOCK_ROWS, bh, &blocks)))
    return err;
  kernel<<<blocks, bf16w::THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], mdk, mdv, lse, delta, bh, T, sm_scale,
      causal, seed, bh0, thresh, drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: [bh, T, d] float32, contiguous; lse, delta: [bh, T]
// float32. seed / thresh / drop_scale as for ptt_flash_fwd_f32. Returns a
// cudaError_t (0 on success); d must be 32, 64 or 128.
extern "C" int ptt_flash_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int T,
                                int d, float sm_scale, int causal,
                                uint32_t seed, uint32_t bh0, uint32_t thresh,
                                float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* gf = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dq<32>(qf, kf, vf, of, lf, df, gf, bh, T, sm_scale,
                                       causal, seed, bh0, thresh, drop_scale, s);
    case 64: return (int)launch_dq<64>(qf, kf, vf, of, lf, df, gf, bh, T, sm_scale,
                                       causal, seed, bh0, thresh, drop_scale, s);
    case 128: return (int)launch_dq<128>(qf, kf, vf, of, lf, df, gf, bh, T, sm_scale,
                                         causal, seed, bh0, thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As ptt_flash_dq_f32, writing dk and dv ([bh, T, d] float32).
extern "C" int ptt_flash_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh,
                                 int T, int d, float sm_scale, int causal,
                                 uint32_t seed, uint32_t bh0, uint32_t thresh,
                                 float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_dkv<32>(qf, kf, vf, of, lf, df, gk, gv, bh, T,
                                        sm_scale, causal, seed, bh0, thresh, drop_scale, s);
    case 64: return (int)launch_dkv<64>(qf, kf, vf, of, lf, df, gk, gv, bh, T,
                                        sm_scale, causal, seed, bh0, thresh, drop_scale, s);
    case 128: return (int)launch_dkv<128>(qf, kf, vf, of, lf, df, gk, gv, bh, T,
                                          sm_scale, causal, seed, bh0, thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the dQ (dkv == 0) or dK/dV (dkv != 0)
// kernel takes at head dim d, in bytes; -1 for another d.
extern "C" int ptt_flash_bwd_smem_bytes(int dkv, int d) {
  switch (d) {
    case 32: return (int)(dkv ? dkv_smem_bytes<32>() : dq_smem_bytes<32>());
    case 64: return (int)(dkv ? dkv_smem_bytes<64>() : dq_smem_bytes<64>());
    case 128: return (int)(dkv ? dkv_smem_bytes<128>() : dq_smem_bytes<128>());
    default: return -1;
  }
}

// As ptt_flash_dq_f32, with q, k, v, dout and dq bf16 ([bh, T, d]); lse
// and delta stay float32.
extern "C" int ptt_flash_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int T,
                                 int d, float sm_scale, int causal,
                                 uint32_t seed, uint32_t bh0, uint32_t thresh,
                                 float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  bf16* gb = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq_bf16<32>(qb, kb, vb, ob, lf, df, gb, bh, T,
                                            sm_scale, causal, seed, bh0, thresh,
                                            drop_scale, s);
    case 64: return launch_dq_bf16<64>(qb, kb, vb, ob, lf, df, gb, bh, T,
                                            sm_scale, causal, seed, bh0, thresh,
                                            drop_scale, s);
    case 128: return launch_dq_bf16<128>(qb, kb, vb, ob, lf, df, gb, bh,
                                              T, sm_scale, causal, seed, bh0,
                                              thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As ptt_flash_dq_bf16, writing dk and dv ([bh, T, d] bf16).
extern "C" int ptt_flash_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int T, int d, float sm_scale,
                                  int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                                  float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv_bf16<32>(qb, kb, vb, ob, lf, df, gk, gv, bh,
                                             T, sm_scale, causal, seed, bh0, thresh,
                                             drop_scale, s);
    case 64: return launch_dkv_bf16<64>(qb, kb, vb, ob, lf, df, gk, gv, bh,
                                             T, sm_scale, causal, seed, bh0, thresh,
                                             drop_scale, s);
    case 128: return launch_dkv_bf16<128>(qb, kb, vb, ob, lf, df, gk, gv,
                                               bh, T, sm_scale, causal, seed, bh0,
                                               thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the bf16 dQ (dkv == 0) or dK/dV
// (dkv != 0) kernel takes at head dim d, in bytes; -1 for another d.
extern "C" int ptt_flash_bwd_bf16_smem_bytes(int dkv, int d) {
  switch (d) {
    case 32: return (int)(dkv ? bf16w::dkv_smem<32>() : bf16w::dq_smem<32>());
    case 64: return (int)(dkv ? bf16w::dkv_smem<64>() : bf16w::dq_smem<64>());
    case 128: return (int)(dkv ? bf16w::dkv_smem<128>() : bf16w::dq_smem<128>());
    default: return -1;
  }
}
