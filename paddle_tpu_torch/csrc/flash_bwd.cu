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
// The bf16 instantiations (flash_dq_bf16_kernel, flash_dkv_bf16_kernel,
// for bf16 mixed precision) are kernel templates of their own, as in
// flash_fwd.cu: one mma.sync m16n8k16 bf16 with float32 accumulation a
// product (mma_bf16.cuh), so the float32 kernels above stay as they
// were. They round where the TPU kernels round in bf16: S, W, dP, delta
// and dS are float32; dQ rounds dS to bf16 for dS K; dK/dV rounds W_drop
// and dS to bf16 for W_drop^T dO and dS^T Q; dQ, dK and dV are written as
// bf16. Their shape is the float32 kernels': the same grids, warps,
// 32-row streamed tiles in a two-stage cp.async ring, resident tiles in
// shared memory, W_drop and dS fed from the accumulators as A operands
// (acc_pair_as_a); the operand read as it is stored (K for dS K, dO and
// Q for the dK/dV products) comes by ldmatrix.trans. At the train shape
// each moves 42 (dQ) or 50 (dK/dV) MB against 6.4 or 8.6 GFLOP: bound by
// bytes at 989 TFLOP/s. First, simple kernels: wgmma and TMA are for a
// later one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

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
                uint32_t seed, uint32_t thresh, float drop_scale) {
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
  const uint32_t bk = DROP ? bh_key(seed, blockIdx.y) : 0u;
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
                 float sm_scale, int causal, uint32_t seed, uint32_t thresh,
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
  const uint32_t bk = DROP ? bh_key(seed, blockIdx.y) : 0u;

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
                      uint32_t seed, uint32_t thresh, float drop_scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = thresh ? flash_dq_kernel<D, true> : flash_dq_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, T, sm_scale, causal, seed, thresh,
      drop_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse, const float* delta,
                       float* dk, float* dv, int bh, int T, float sm_scale,
                       int causal, uint32_t seed, uint32_t thresh,
                       float drop_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = thresh ? flash_dkv_kernel<D, true> : flash_dkv_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, T, sm_scale, causal, seed, thresh,
      drop_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

using ptt_mma_bf16::bf16;
using ptt_mma_bf16::load_tile_bf16;

template <int D, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int T, float sm_scale, int causal, uint32_t seed,
                     uint32_t thresh, float drop_scale) {
  using namespace ptt_mma_bf16;
  constexpr int SD = D + 8;
  constexpr int NS = BS / 8;         // 8-key n-tiles of S
  constexpr int KD = D / 16;         // 16-deep k steps of S and dP
  constexpr int ND = D / 8;          // 8-wide n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem16);  // [BR][SD]
  bf16* dOs = Qs + BR * SD;          // [BR][SD]
  bf16* Ks = dOs + BR * SD;          // [2][BS][SD]
  bf16* Vs = Ks + 2 * BS * SD;       // [2][BS][SD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BR;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;

  const int n_kv = (T + BS - 1) / BS;
  const int n_tiles = causal ? min(n_kv, (q0 + BR - 1) / BS + 1) : n_kv;

  load_tile_bf16<D, BR, BWD_THREADS>(Qs, q + base, q0, T, tid);
  load_tile_bf16<D, BR, BWD_THREADS>(dOs, dout + base, q0, T, tid);
  load_tile_bf16<D, BS, BWD_THREADS>(Ks, k + base, 0, T, tid);
  load_tile_bf16<D, BS, BWD_THREADS>(Vs, v + base, 0, T, tid);
  cp_async_commit();

  const int wr = 16 * warp + g;
  const int row[2] = {q0 + wr, q0 + wr + 8};
  float lse_r[2], delta_r[2];
  uint32_t rkey[2];
  const uint32_t bk = DROP ? bh_key(seed, blockIdx.y) : 0u;
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
      load_tile_bf16<D, BS, BWD_THREADS>(Ks + st * BS * SD, k + base,
                                         (kt + 1) * BS, T, tid);
      load_tile_bf16<D, BS, BWD_THREADS>(Vs + st * BS * SD, v + base,
                                         (kt + 1) * BS, T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * BS * SD;
    const bf16* Vt = Vs + (kt & 1) * BS * SD;
    const int k0 = kt * BS;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BS keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<SD>(Qs, wr, 16 * kk + 2 * t, qa);
      load_a<SD>(dOs, wr, 16 * kk + 2 * t, oa);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t b[2];
        load_b_t<SD>(Kt, 8 * j + g, 16 * kk + 2 * t, b);
        mma_bf16(s[j], qa, b);
        load_b_t<SD>(Vt, 8 * j + g, 16 * kk + 2 * t, b);
        mma_bf16(dp[j], oa, b);
      }
    }

    // dS in place of S, float32: element e of n-tile j is row[e >> 1], key
    // column k0 + 8 j + 2 t + (e & 1)
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

    // dQ += dS K, dS rounded to bf16
#pragma unroll
    for (int jj = 0; jj < NS / 2; ++jj) {
      uint32_t a[4];
      acc_pair_as_a(s[2 * jj], s[2 * jj + 1], a);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b0[2], b1[2];
        load_b_x4_trans<SD>(Kt, 16 * jj, 8 * n, lane, b0, b1);
        mma_bf16(acc[n], a, b0);
        mma_bf16(acc[n + 1], a, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] < T) {
      bf16* dst = dq + base + (size_t)row[h] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int T, float sm_scale,
                      int causal, uint32_t seed, uint32_t thresh,
                      float drop_scale) {
  using namespace ptt_mma_bf16;
  constexpr int SD = D + 8;
  constexpr int NS = BS / 8;         // 8-query n-tiles of S^T
  constexpr int KD = D / 16;         // 16-deep k steps of S^T and dP^T
  constexpr int ND = D / 8;          // 8-wide n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* Ks = reinterpret_cast<bf16*>(smem16);  // [BR][SD]
  bf16* Vs = Ks + BR * SD;           // [BR][SD]
  bf16* Qs = Vs + BR * SD;           // [2][BS][SD]
  bf16* dOs = Qs + 2 * BS * SD;      // [2][BS][SD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BS * SD);  // [2][BS]
  float* delta_s = lse_s + 2 * BS;   // [2][BS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BR;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;
  const uint32_t bk = DROP ? bh_key(seed, blockIdx.y) : 0u;

  const int n_q = (T + BS - 1) / BS;
  const int qt0 = causal ? k0 / BS : 0;

  load_tile_bf16<D, BR, BWD_THREADS>(Ks, k + base, k0, T, tid);
  load_tile_bf16<D, BR, BWD_THREADS>(Vs, v + base, k0, T, tid);
  load_tile_bf16<D, BS, BWD_THREADS>(Qs, q + base, qt0 * BS, T, tid);
  load_tile_bf16<D, BS, BWD_THREADS>(dOs, dout + base, qt0 * BS, T, tid);
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
      load_tile_bf16<D, BS, BWD_THREADS>(Qs + st * BS * SD, q + base, r0,
                                         T, tid);
      load_tile_bf16<D, BS, BWD_THREADS>(dOs + st * BS * SD, dout + base, r0,
                                         T, tid);
      load_rows<BS>(lse_s + st * BS, lse + rbase, r0, T, tid);
      load_rows<BS>(delta_s + st * BS, delta + rbase, r0, T, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (i & 1) * BS * SD;
    const bf16* dOt = dOs + (i & 1) * BS * SD;
    const float* lse_t = lse_s + (i & 1) * BS;
    const float* delta_t = delta_s + (i & 1) * BS;
    const int q0 = qt * BS;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows x BS
    // queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a<SD>(Ks, wr, 16 * kk + 2 * t, ka);
      load_a<SD>(Vs, wr, 16 * kk + 2 * t, va);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t b[2];
        load_b_t<SD>(Qt, 8 * j + g, 16 * kk + 2 * t, b);
        mma_bf16(s[j], ka, b);
        load_b_t<SD>(dOt, 8 * j + g, 16 * kk + 2 * t, b);
        mma_bf16(dp[j], va, b);
      }
    }

    // W_drop^T in place of S^T, dS^T in place of dP^T, float32: element e
    // of n-tile j is key row krow[e >> 1], query column q0 + 8 j + 2 t +
    // (e & 1)
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

    // dV += W_drop^T dO, dK += dS^T Q, W_drop and dS rounded to bf16
#pragma unroll
    for (int jj = 0; jj < NS / 2; ++jj) {
      uint32_t wa[4], sa[4];
      acc_pair_as_a(s[2 * jj], s[2 * jj + 1], wa);
      acc_pair_as_a(dp[2 * jj], dp[2 * jj + 1], sa);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b0[2], b1[2];
        load_b_x4_trans<SD>(dOt, 16 * jj, 8 * n, lane, b0, b1);
        mma_bf16(dv_acc[n], wa, b0);
        mma_bf16(dv_acc[n + 1], wa, b1);
        load_b_x4_trans<SD>(Qt, 16 * jj, 8 * n, lane, b0, b1);
        mma_bf16(dk_acc[n], sa, b0);
        mma_bf16(dk_acc[n + 1], sa, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] < T) {
      bf16* dkr = dk + base + (size_t)krow[h] * D + 2 * t;
      bf16* dvr = dv + base + (size_t)krow[h] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * n) =
            pack_bf16(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvr + 8 * n) =
            pack_bf16(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * BR + 4 * BS) * (D + 8);
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return dq_bf16_smem_bytes<D>() + sizeof(float) * 4 * BS;
}

template <int D>
cudaError_t launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                           const bf16* dout, const float* lse,
                           const float* delta, bf16* dq, int bh, int T,
                           float sm_scale, int causal, uint32_t seed,
                           uint32_t thresh, float drop_scale,
                           cudaStream_t stream) {
  const size_t smem = dq_bf16_smem_bytes<D>();
  auto kernel = thresh ? flash_dq_bf16_kernel<D, true>
                       : flash_dq_bf16_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, T, sm_scale, causal, seed, thresh,
      drop_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dout, const float* lse,
                            const float* delta, bf16* dk, bf16* dv, int bh,
                            int T, float sm_scale, int causal, uint32_t seed,
                            uint32_t thresh, float drop_scale,
                            cudaStream_t stream) {
  const size_t smem = dkv_bf16_smem_bytes<D>();
  auto kernel = thresh ? flash_dkv_bf16_kernel<D, true>
                       : flash_dkv_bf16_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, T, sm_scale, causal, seed, thresh,
      drop_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: [bh, T, d] float32, contiguous; lse, delta: [bh, T]
// float32. seed / thresh / drop_scale as for ptt_flash_fwd_f32. Returns a
// cudaError_t (0 on success); d must be 32, 64 or 128.
extern "C" int ptt_flash_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int T,
                                int d, float sm_scale, int causal,
                                uint32_t seed, uint32_t thresh,
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
                                       causal, seed, thresh, drop_scale, s);
    case 64: return (int)launch_dq<64>(qf, kf, vf, of, lf, df, gf, bh, T, sm_scale,
                                       causal, seed, thresh, drop_scale, s);
    case 128: return (int)launch_dq<128>(qf, kf, vf, of, lf, df, gf, bh, T, sm_scale,
                                         causal, seed, thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As ptt_flash_dq_f32, writing dk and dv ([bh, T, d] float32).
extern "C" int ptt_flash_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int bh,
                                 int T, int d, float sm_scale, int causal,
                                 uint32_t seed, uint32_t thresh,
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
                                        sm_scale, causal, seed, thresh, drop_scale, s);
    case 64: return (int)launch_dkv<64>(qf, kf, vf, of, lf, df, gk, gv, bh, T,
                                        sm_scale, causal, seed, thresh, drop_scale, s);
    case 128: return (int)launch_dkv<128>(qf, kf, vf, of, lf, df, gk, gv, bh, T,
                                          sm_scale, causal, seed, thresh, drop_scale, s);
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
                                 uint32_t seed, uint32_t thresh,
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
    case 32: return (int)launch_dq_bf16<32>(qb, kb, vb, ob, lf, df, gb, bh, T,
                                            sm_scale, causal, seed, thresh,
                                            drop_scale, s);
    case 64: return (int)launch_dq_bf16<64>(qb, kb, vb, ob, lf, df, gb, bh, T,
                                            sm_scale, causal, seed, thresh,
                                            drop_scale, s);
    case 128: return (int)launch_dq_bf16<128>(qb, kb, vb, ob, lf, df, gb, bh,
                                              T, sm_scale, causal, seed,
                                              thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As ptt_flash_dq_bf16, writing dk and dv ([bh, T, d] bf16).
extern "C" int ptt_flash_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int T, int d, float sm_scale,
                                  int causal, uint32_t seed, uint32_t thresh,
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
    case 32: return (int)launch_dkv_bf16<32>(qb, kb, vb, ob, lf, df, gk, gv, bh,
                                             T, sm_scale, causal, seed, thresh,
                                             drop_scale, s);
    case 64: return (int)launch_dkv_bf16<64>(qb, kb, vb, ob, lf, df, gk, gv, bh,
                                             T, sm_scale, causal, seed, thresh,
                                             drop_scale, s);
    case 128: return (int)launch_dkv_bf16<128>(qb, kb, vb, ob, lf, df, gk, gv,
                                               bh, T, sm_scale, causal, seed,
                                               thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the bf16 dQ (dkv == 0) or dK/dV
// (dkv != 0) kernel takes at head dim d, in bytes; -1 for another d.
extern "C" int ptt_flash_bwd_bf16_smem_bytes(int dkv, int d) {
  switch (d) {
    case 32: return (int)(dkv ? dkv_bf16_smem_bytes<32>() : dq_bf16_smem_bytes<32>());
    case 64: return (int)(dkv ? dkv_bf16_smem_bytes<64>() : dq_bf16_smem_bytes<64>());
    case 128: return (int)(dkv ? dkv_bf16_smem_bytes<128>() : dq_bf16_smem_bytes<128>());
    default: return -1;
  }
}
