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

template <typename E, int D>
__device__ __forceinline__ void delta_rows(const E* __restrict__ o,
                                           const E* __restrict__ dout,
                                           float* __restrict__ delta,
                                           int rows) {
  constexpr int L = D * (int)sizeof(E) / 16;   // lanes a row: 2 .. 32
  constexpr int RPW = 32 / L;                  // rows a warp loads at once
  constexpr int EPC = 16 / (int)sizeof(E);     // elements a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % L;
  const long first = ((long)blockIdx.x * (THREADS / 32) + warp) * RPW * UNROLL
                     + lane / L;
  uint4 dv[UNROLL], ov[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long r = first + u * RPW;
    if (r < rows) {
      const size_t off = (size_t)r * D + c * EPC;
      dv[u] = ld_stream(dout + off);
      ov[u] = ld_stream(o + off);
    } else {
      dv[u] = ov[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    float s = chunk_dot(dv[u], ov[u], o);
#pragma unroll
    for (int x = L / 2; x >= 1; x >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, x);
    const long r = first + u * RPW;
    if (c == 0 && r < rows) delta[r] = s;
  }
}

// rows handled by one block
template <typename E, int D>
constexpr int block_rows() {
  return THREADS / 32 * (32 / (D * (int)sizeof(E) / 16)) * UNROLL;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_delta_f32_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  delta_rows<float, D>(o, dout, delta, rows);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_delta_bf16_kernel(const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        float* __restrict__ delta, int rows) {
  delta_rows<bf16, D>(o, dout, delta, rows);
}

template <typename E, int D, typename K>
int launch(K kernel, const void* o, const void* dout, void* delta, int rows,
           cudaStream_t stream) {
  constexpr int R = block_rows<E, D>();
  const int blocks = (int)(((long)rows + R - 1) / R);
  kernel<<<blocks, THREADS, 0, stream>>>(static_cast<const E*>(o),
                                         static_cast<const E*>(dout),
                                         static_cast<float*>(delta), rows);
  return (int)cudaGetLastError();
}

}  // namespace

// o, dout: [rows, d] float32, contiguous, 16-byte aligned; delta: [rows]
// float32. Returns a cudaError_t (0 on success); d must be 32, 64 or 128.
extern "C" int ptt_flash_delta_f32(const void* o, const void* dout,
                                   void* delta, int rows, int d, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<float, 32>(flash_delta_f32_kernel<32>, o, dout,
                                      delta, rows, s);
    case 64: return launch<float, 64>(flash_delta_f32_kernel<64>, o, dout,
                                      delta, rows, s);
    case 128: return launch<float, 128>(flash_delta_f32_kernel<128>, o, dout,
                                        delta, rows, s);
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
    case 32: return launch<bf16, 32>(flash_delta_bf16_kernel<32>, o, dout,
                                     delta, rows, s);
    case 64: return launch<bf16, 64>(flash_delta_bf16_kernel<64>, o, dout,
                                     delta, rows, s);
    case 128: return launch<bf16, 128>(flash_delta_bf16_kernel<128>, o, dout,
                                       delta, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
