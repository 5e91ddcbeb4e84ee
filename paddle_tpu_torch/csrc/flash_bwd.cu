// FlashAttention-2 backward, float32, for sm_90a: two kernels.
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
// from Q, K, V, dO, lse and delta.
//
// What bounds them on the H100: at the train path's shapes (T 256, D 64)
// dQ does 3 products of 2*T^2*D per (b, h) and dK/dV 4, against reading
// 5 (dQ) or 6 (dK/dV) [T, D] tensors: about T/2 operations per byte, so
// both are bound by arithmetic. This first version computes on the
// float32 CUDA cores (67 TFLOP/s peak); a wgmma/TMA bf16 path is later work.
//
// Design (the forward's, flash_fwd.cu, turned around):
// - dQ: grid (ceil(T/64), B*H), one block per 64-row Q tile. The Q and dO
//   tile, and its lse and delta rows, stay in shared memory / registers; a
//   loop over 64-row K/V tiles takes the place of the TPU kernel's
//   sequential grid axis. 256 threads as 16 x 16, each owning 4 rows x 4
//   columns of the 64 x 64 S and dP tiles (two register tiles); dS goes
//   through shared memory into dQ, accumulated in registers (4 rows x D/16
//   columns a thread) and written once.
// - dK/dV: grid (ceil(T/64), B*H), one block per 64-row K/V tile, looping
//   over Q tiles (from the first live one when causal). The transposed
//   tiles W_drop^T and dS^T go through shared memory; dK and dV are
//   accumulated in registers and written once, with no atomics, so the
//   results repeat exactly from run to run.
// - causal: tiles wholly above the diagonal are skipped, the diagonal tile
//   is masked. Any T: rows and columns >= T are masked (W = 0) and rows
//   >= T are loaded as zeros, never read, and never written.
// - dropout regenerates the forward's mask from (seed, bh, row, column),
//   independent of tiling; it is a template flag, and rate 0 (thresh == 0)
//   launches the instantiation without it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace ptt_flash;

// rows [r0, r0 + 64) of a [T, D] slice -> shared, row stride D + 1, zeros
// past T (float4 loads along each row)
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int T, int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < BM * D / 4; i += NTHREADS) {
    const int r = (i * 4) / D, c = (i * 4) % D;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    float* d = dst + r * DP + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int T, float sm_scale, int causal,
                uint32_t seed, uint32_t thresh, float drop_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BN + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * DP;
  float* Ks = dOs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* dSs = Vs + BN * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;

  load_tile<D>(Qs, q + base, q0, T, tid);
  load_tile<D>(dOs, dout + base, q0, T, tid);

  float lse_r[4], delta_r[4], acc[4][DC];
  uint32_t rkey[4];
  const uint32_t bk = DROP ? bh_key(seed, blockIdx.y) : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < T ? lse[rbase + row] : 0.f;
    delta_r[i] = row < T ? delta[rbase + row] : 0.f;
    rkey[i] = DROP ? row_key(bk, row) : 0u;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kv = (T + BN - 1) / BN;
  const int n_tiles = causal ? min(n_kv, (q0 + BM - 1) / BN + 1) : n_kv;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's K/V/dS are no longer read
    load_tile<D>(Ks, k + base, k0, T, tid);
    load_tile<D>(Vs, v + base, k0, T, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        ov[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = row < T && col < T && !(causal && col > row);
        const float w = live ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        float dw = dp[i][j];
        if (DROP) dw = keep(rkey[i], col, thresh) ? dw * drop_scale : 0.f;
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = w * (dw - delta_r[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float kv[DC];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) kv[jd] = Ks[c * DP + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] = fmaf(ds, kv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < T) {
      float* dst = dq + base + (size_t)row * D;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) dst[tx + 16 * jd] = acc[i][jd];
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int T,
                 float sm_scale, int causal, uint32_t seed, uint32_t thresh,
                 float drop_scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BM + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * DP;
  float* Qs = Vs + BN * DP;
  float* dOs = Qs + BM * DP;
  float* Ws = dOs + BM * DP;     // W_drop^T tile: [key row][query row]
  float* dSs = Ws + BN * PP;     // dS^T tile
  float* lse_s = dSs + BN * PP;
  float* delta_s = lse_s + BM;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BN;
  const size_t base = (size_t)blockIdx.y * T * D;
  const size_t rbase = (size_t)blockIdx.y * T;
  const uint32_t bk = DROP ? bh_key(seed, blockIdx.y) : 0u;

  load_tile<D>(Ks, k + base, k0, T, tid);
  load_tile<D>(Vs, v + base, k0, T, tid);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;

  const int n_q = (T + BM - 1) / BM;
  // causal: query tiles ending before this key tile's first row see none
  // of it; with BM == BN the first live one is this tile's own index
  const int qt0 = causal ? k0 / BM : 0;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // the previous tile's Q/dO/W/dS are no longer read
    load_tile<D>(Qs, q + base, q0, T, tid);
    load_tile<D>(dOs, dout + base, q0, T, tid);
    if (tid < BM) {
      const int row = q0 + tid;
      lse_s[tid] = row < T ? lse[rbase + row] : 0.f;
      delta_s[tid] = row < T ? delta[rbase + row] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T tiles: this thread's key rows ty + 16 i, query rows
    // tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * DP + d];
        vv[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * DP + d];
        ov[j] = dOs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = tx + 16 * j;
      const int qrow = q0 + qc;
      const uint32_t rk = DROP ? row_key(bk, qrow) : 0u;
      const float lse_q = lse_s[qc];
      const float delta_q = delta_s[qc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty + 16 * i;
        const int krow = k0 + kr;
        const bool live = qrow < T && krow < T && !(causal && krow > qrow);
        const float w = live ? expf(s[i][j] * sm_scale - lse_q) : 0.f;
        float wd = w, dw = dp[i][j];
        if (DROP) {
          const bool kp = keep(rk, krow, thresh);
          wd = kp ? w * drop_scale : 0.f;
          dw = kp ? dw * drop_scale : 0.f;
        }
        Ws[kr * PP + qc] = wd;
        dSs[kr * PP + qc] = w * (dw - delta_q) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BM; ++c) {
      float qv[DC], ov[DC];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        qv[jd] = Qs[c * DP + tx + 16 * jd];
        ov[jd] = dOs[c * DP + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wv = Ws[(ty + 16 * i) * PP + c];
        const float dsv = dSs[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) {
          dv_acc[i][jd] = fmaf(wv, ov[jd], dv_acc[i][jd]);
          dk_acc[i][jd] = fmaf(dsv, qv[jd], dk_acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < T) {
      float* dkr = dk + base + (size_t)row * D;
      float* dvr = dv + base + (size_t)row * D;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        dkr[tx + 16 * jd] = dk_acc[i][jd];
        dvr[tx + 16 * jd] = dv_acc[i][jd];
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BN * (D + 1) + 2 * BM * (D + 1) + 2 * BN * (BM + 1) + 2 * BM);
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
  dim3 grid((T + BM - 1) / BM, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
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
  dim3 grid((T + BN - 1) / BN, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
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
