// The bf16 type and its packing, shared by the bf16 kernels: dropout.cu,
// flash_delta.cu and the wgmma kernels of flash_fwd.cu and flash_bwd_bf16.cu
// (through wgmma_bf16.cuh, whose acc_to_a and store_acc_tile pack float32
// accumulators into bf16 operands and tiles).
//
// A register holds two bf16, the lower column (or k) in its low half, as
// the tensor cores' fragments and a row-major tile in memory hold them.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt_mma_bf16 {

using bf16 = __nv_bfloat16;

// two floats rounded to bf16 (to nearest, ties to even, as a cast in
// PyTorch or JAX rounds), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the two bf16 of a register as floats (exact): .x the low half
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

}  // namespace ptt_mma_bf16
