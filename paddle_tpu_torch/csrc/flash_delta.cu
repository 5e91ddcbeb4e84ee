// delta = rowsum(dO * O), the flash backward's per-row term, in one pass.
//
// The JAX package has no Pallas kernel for it: paddle_tpu/ops/
// pallas_attention.py:387 computes sum(f32(dO) * f32(O), axis=-1) in XLA
// before its dQ and dK/dV kernels. The port computed it as three PyTorch
// passes (an upcast copy of dO, the product, the sum), about ten times its
// bound; this kernel reads each tensor once.
//
// delta[r] = sum_d dO[r, d] O[r, d] over rows r of [rows, D] float32 or
// bf16 tensors, summed in float32 (a bf16 product is exact in float32).
//
// What bounds it on the H100: bytes, 2 x rows x D x (2 or 4) in and 4 a
// row out (train-base-amp, B 64 H 8 T 256 D 64 bf16: 34 MB, 10.2 us at
// 3.35 TB/s); one multiply-add an element is nothing beside that.
//
// Design: a row is read by the L = D x (element bytes) / 16 lanes that
// cover it, one 16-byte vector load a lane (bf16 D 64: 8 lanes, 128 bytes),
// so a warp reads 512 contiguous bytes of each tensor a load; each lane
// takes UNROLL rows at once, so that a block of 256 threads has 32 KB of
// loads in flight (2 or 8 rows a lane, 128- or 512-thread blocks ran no
// faster on an H100 at train-base-amp's shape). A lane sums
// its chunk's products in order, then the L lanes of the row reduce by
// __shfl_xor_sync in a fixed order: every lane ends with the same value,
// and two launches give equal bits.
//
// Head dims: every multiple of 8 from 8 to 256, as the flash kernels take.
// D 32, 64 and 128 run in their exact instantiations (PAD false), the
// design above instruction for instruction. Any other D runs in the padded
// instantiation of the smallest power-of-two width DW from 8 to 256 that
// covers it: a row gets the lanes of DW, L = min(32, DW x (element bytes)
// / 16), a power of two, so that 32 / L rows share a warp and the xor
// shuffles stay within a row; a lane takes NC = DW x (element bytes) /
// (16 L) chunks (2 only at float32 DW 256, whose 1 KB row is two warps'
// loads), and lanes whose chunk lies past D load nothing and add 0. The
// padding costs idle lanes, never bytes: a row of D 24 float32 is 6 chunks
// on 8 lanes, D 136 bf16 17 on 32. bf16 DW 8 is one lane a row (L 1, no
// shuffle); the row stride stays D, and nothing is copied.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using ptt_mma_bf16::bf16;
using ptt_mma_bf16::unpack_bf16;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;   // rows a lane takes at once

// sum of the products of one 16-byte chunk of dO and O, in order
__device__ __forceinline__ float chunk_dot(const uint4& d, const uint4& o,
                                           const bf16*) {
  const uint32_t dw[4] = {d.x, d.y, d.z, d.w}, ow[4] = {o.x, o.y, o.z, o.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = unpack_bf16(dw[i]), b = unpack_bf16(ow[i]);
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
  return s;
}

__device__ __forceinline__ float chunk_dot(const uint4& d, const uint4& o,
                                           const float*) {
  float s = __uint_as_float(d.x) * __uint_as_float(o.x);
  s = fmaf(__uint_as_float(d.y), __uint_as_float(o.y), s);
  s = fmaf(__uint_as_float(d.z), __uint_as_float(o.z), s);
  return fmaf(__uint_as_float(d.w), __uint_as_float(o.w), s);
}

// 16 bytes of a tensor read once: no L1 line, and a 256-byte L2 prefetch
// (the neighbouring lanes' rows). On an H100 at train-base-amp's shape
// the kernel took 0.0187 ms so, and 0.0210 with read-only (__ldg) loads.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

// lanes a row at width DW: the chunks of a DW-wide row, at most a warp
template <typename E, int DW>
__host__ __device__ constexpr int row_lanes() {
  return DW * (int)sizeof(E) / 16 < 32 ? DW * (int)sizeof(E) / 16 : 32;
}

// DW: the width (D itself unless PAD); PAD: rows are [rows, d], and the
// chunks of a lane past d load nothing
template <typename E, int DW, bool PAD>
__device__ __forceinline__ void delta_rows(const E* __restrict__ o,
                                           const E* __restrict__ dout,
                                           float* __restrict__ delta,
                                           int rows, int d) {
  constexpr int L = row_lanes<E, DW>();        // lanes a row: 1 .. 32
  constexpr int NC = DW * (int)sizeof(E) / 16 / L;   // chunks a lane: 1, 2
  constexpr int RPW = 32 / L;                  // rows a warp loads at once
  constexpr int EPC = 16 / (int)sizeof(E);     // elements a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % L;
  const int ld = PAD ? d : DW;                 // the row stride
  const long first = ((long)blockIdx.x * (THREADS / 32) + warp) * RPW * UNROLL
                     + lane / L;
  uint4 dv[UNROLL][NC], ov[UNROLL][NC];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long r = first + u * RPW;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int e0 = (c + n * L) * EPC;        // the chunk's first column
      if (r < rows && (!PAD || e0 < d)) {
        const size_t off = (size_t)r * ld + e0;
        dv[u][n] = ld_stream(dout + off);
        ov[u][n] = ld_stream(o + off);
      } else {
        dv[u][n] = ov[u][n] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    float s = chunk_dot(dv[u][0], ov[u][0], o);
#pragma unroll
    for (int n = 1; n < NC; ++n) s += chunk_dot(dv[u][n], ov[u][n], o);
#pragma unroll
    for (int x = L / 2; x >= 1; x >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, x);
    const long r = first + u * RPW;
    if (c == 0 && r < rows) delta[r] = s;
  }
}

// rows handled by one block
template <typename E, int DW>
constexpr int block_rows() {
  return THREADS / 32 * (32 / row_lanes<E, DW>()) * UNROLL;
}

template <int DW, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_delta_f32_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  delta_rows<float, DW, PAD>(o, dout, delta, rows, d);
}

template <int DW, bool PAD>
__global__ void __launch_bounds__(THREADS)
flash_delta_bf16_kernel(const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        float* __restrict__ delta, int rows, int d) {
  delta_rows<bf16, DW, PAD>(o, dout, delta, rows, d);
}

template <typename E, int DW, typename K>
int launch(K kernel, const void* o, const void* dout, void* delta, int rows,
           int d, cudaStream_t stream) {
  constexpr int R = block_rows<E, DW>();
  const int blocks = (int)(((long)rows + R - 1) / R);
  kernel<<<blocks, THREADS, 0, stream>>>(static_cast<const E*>(o),
                                         static_cast<const E*>(dout),
                                         static_cast<float*>(delta), rows, d);
  return (int)cudaGetLastError();
}

// The padded width that serves head dim d: the smallest power of two from
// 8 to 256 that covers it; 0 for a d no instantiation takes.
inline int delta_width(int d) {
  if (d < 8 || d > 256 || d % 8 != 0) return 0;
  int w = 8;
  while (w < d) w *= 2;
  return w;
}

}  // namespace

// o, dout: [rows, d] float32, contiguous, 16-byte aligned; delta: [rows]
// float32. Returns a cudaError_t (0 on success); d must be a multiple of 8
// from 8 to 256.
extern "C" int ptt_flash_delta_f32(const void* o, const void* dout,
                                   void* delta, int rows, int d, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DELTA(E, K, DW, PAD) \
  return launch<E, DW>(K<DW, PAD>, o, dout, delta, rows, d, s)
  switch (d) {
    case 32: PTT_DELTA(float, flash_delta_f32_kernel, 32, false);
    case 64: PTT_DELTA(float, flash_delta_f32_kernel, 64, false);
    case 128: PTT_DELTA(float, flash_delta_f32_kernel, 128, false);
  }
  switch (delta_width(d)) {
    case 8: PTT_DELTA(float, flash_delta_f32_kernel, 8, true);
    case 16: PTT_DELTA(float, flash_delta_f32_kernel, 16, true);
    case 32: PTT_DELTA(float, flash_delta_f32_kernel, 32, true);
    case 64: PTT_DELTA(float, flash_delta_f32_kernel, 64, true);
    case 128: PTT_DELTA(float, flash_delta_f32_kernel, 128, true);
    case 256: PTT_DELTA(float, flash_delta_f32_kernel, 256, true);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As ptt_flash_delta_f32, with o and dout bf16; delta stays float32.
extern "C" int ptt_flash_delta_bf16(const void* o, const void* dout,
                                    void* delta, int rows, int d, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: PTT_DELTA(bf16, flash_delta_bf16_kernel, 32, false);
    case 64: PTT_DELTA(bf16, flash_delta_bf16_kernel, 64, false);
    case 128: PTT_DELTA(bf16, flash_delta_bf16_kernel, 128, false);
  }
  switch (delta_width(d)) {
    case 8: PTT_DELTA(bf16, flash_delta_bf16_kernel, 8, true);
    case 16: PTT_DELTA(bf16, flash_delta_bf16_kernel, 16, true);
    case 32: PTT_DELTA(bf16, flash_delta_bf16_kernel, 32, true);
    case 64: PTT_DELTA(bf16, flash_delta_bf16_kernel, 64, true);
    case 128: PTT_DELTA(bf16, flash_delta_bf16_kernel, 128, true);
    case 256: PTT_DELTA(bf16, flash_delta_bf16_kernel, 256, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_DELTA
}
