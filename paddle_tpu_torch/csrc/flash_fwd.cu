// FlashAttention-2 forward, float32, for sm_90a.
//
// Replaces paddle_tpu/ops/pallas_attention.py::_flash_fwd_kernel (launched
// by _flash_forward). Computes O = softmax(Q K^T * sm_scale) V and the
// row logsumexp over q/k/v laid out [B*H, T, D], optionally causal, without
// ever writing the [T, T] score matrix to device memory.
//
// What bounds it on the H100: at the prefill shapes (T 128..512, D 64) the
// work is 2*B*H*T^2*D FMA-operations (causal half) against 4*B*H*T*D*4
// bytes, about T/4 operations per byte, so it is bound by arithmetic.
// This first version computes on the float32 CUDA cores (67 TFLOP/s peak),
// not on the tensor cores: a wgmma/TMA bf16 path is later work.
//
// Design:
// - grid (ceil(T/64), B*H): one block per 64-row Q tile of one (b, h);
//   256 threads as a 16 x 16 grid, each owning 4 rows x 4 columns of the
//   64 x 64 score tile (rows ty + 16*i, columns tx + 16*j);
// - a loop over 64-row K/V tiles inside the block takes the place of the
//   TPU kernel's sequential grid axis; the online-softmax state (row max m,
//   row sum l, the 64 x D accumulator) stays in registers in float32;
// - Q, K, V and the probability tile P sit in dynamic shared memory; Q and
//   K rows are padded by one float so the column walks of Q K^T do not hit
//   one bank, and rows of V are read by consecutive threads;
// - row max and row sum are reduced across the 16 threads of a row with
//   warp shuffles (xor offsets 8..1 stay inside a half-warp);
// - causal: K tiles wholly above the diagonal are skipped, the diagonal
//   tile is masked; a ragged T is handled by masking columns >= T and not
//   writing rows >= T, so T needs no padding to a multiple of 64 or 128;
// - attention-weight dropout (training): the TPU kernel re-seeds its PRNG
//   per (bh, q-tile, k-tile), which Hopper cannot reproduce. Here a
//   counter hash keys every weight on (seed, bh, query row, key column)
//   (flash_common.cuh), so the mask depends on no tile size and the dQ and
//   dK/dV kernels (flash_bwd.cu) regenerate it bit for bit. As in the TPU
//   kernel, p is dropped and scaled after the row sum l is updated, so l
//   counts the undropped weights. Dropout is a template flag: at rate 0
//   (thresh == 0, the serving path) the launch takes the instantiation
//   without it, the same code as before dropout existed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace ptt_flash;

template <int D, bool DROP>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, float sm_scale, int causal,
                 uint32_t seed, uint32_t thresh, float drop_scale) {
  constexpr int DP = D + 1;   // padded row stride of Q and K tiles
  constexpr int PP = BN + 1;  // padded row stride of the P tile
  constexpr int DC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* Ps = Vs + BN * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BM;
  const size_t base = (size_t)blockIdx.y * T * D;
  uint32_t rkey[4];
  if (DROP) {
    const uint32_t bk = bh_key(seed, blockIdx.y);
#pragma unroll
    for (int i = 0; i < 4; ++i) rkey[i] = row_key(bk, q0 + ty + 16 * i);
  }

  // Q tile -> shared, float4 loads along each row, zeros past T
  for (int i = tid; i < BM * D / 4; i += NTHREADS) {
    const int r = (i * 4) / D, c = (i * 4) % D;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T)
      val = *reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * D + c);
    float* dst = Qs + r * DP + c;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) acc[i][jd] = 0.f;
  }

  const int n_kv = (T + BN - 1) / BN;
  // causal: tiles starting past this block's last row see nothing
  const int n_tiles = causal ? min(n_kv, (q0 + BM - 1) / BN + 1) : n_kv;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int i = tid; i < BN * D / 4; i += NTHREADS) {
      const int r = (i * 4) / D, c = (i * 4) % D;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < T) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      float* kd = Ks + r * DP + c;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (col >= T || (causal && col > row)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m_new);
        rs += p;
        if (DROP) p = keep(rkey[i], k0 + tx + 16 * j, thresh) ? p * drop_scale : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float vv[DC];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) vv[jd] = Vs[c * D + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < T) {
      const float lsafe = fmaxf(l[i], 1e-20f);
      const float inv = 1.f / lsafe;
      float* dst = o + base + (size_t)row * D;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) dst[tx + 16 * jd] = acc[i][jd] * inv;
      if (tx == 0) lse[(size_t)blockIdx.y * T + row] = m[i] + logf(lsafe);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int T, float sm_scale, int causal,
                   uint32_t seed, uint32_t thresh, float drop_scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = thresh ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BM - 1) / BM, bh);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, lse, T, sm_scale, causal, seed, thresh, drop_scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: [bh, T, d] float32, contiguous; lse: [bh, T] float32.
// Dropout keeps a weight when its hash >= thresh (thresh = rate * 2^32;
// 0 = no dropout) and scales it by drop_scale = 1 / (1 - rate).
// Returns a cudaError_t (0 on success); d must be 32, 64 or 128.
extern "C" int ptt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int T, int d,
                                 float sm_scale, int causal, uint32_t seed,
                                 uint32_t thresh, float drop_scale, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch<32>(qf, kf, vf, of, lf, bh, T, sm_scale, causal,
                                       seed, thresh, drop_scale, s);
    case 64: return (int)launch<64>(qf, kf, vf, of, lf, bh, T, sm_scale, causal,
                                       seed, thresh, drop_scale, s);
    case 128: return (int)launch<128>(qf, kf, vf, of, lf, bh, T, sm_scale, causal,
                                       seed, thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
