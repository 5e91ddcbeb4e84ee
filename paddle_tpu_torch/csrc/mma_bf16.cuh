// Tensor-core bf16 products with float32 accumulation, and bf16 copies, for
// the bf16 instantiation of flash_fwd.cu (and the bf16 packing that
// dropout.cu and flash_bwd.cu's wgmma kernels share).
//
// A product of two bf16 values is exact in float32 (8 + 8 significant bits
// of 24), so one mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 takes
// a bf16 product at float32 accumulation: the 3xTF32 split of
// mma_tf32.cuh, which rebuilds float32 operands from two TF32 halves,
// has no counterpart here.
//
// Fragments, for lane = 4 g + t (g = groupID 0..7, t = threadID_in_group
// 0..3); each 32-bit register holds two bf16, the lower column (or k) in
// its low half:
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So the accumulators of two neighbouring 8-column n-tiles, rounded to
// bf16 and packed in pairs, are the A fragment of one 16-deep k step
// (acc_pair_as_a): P, W_drop and dS feed their next product from registers.
//
// Shared tiles are row-major bf16 with a row stride of D + 8 elements
// (D / 2 + 4 words): the eight rows g of a fragment load, four words t
// each, and the eight 16-byte rows of an ldmatrix, fall on 32 distinct
// banks at D = 32, 64 and 128.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt_mma_bf16 {

using bf16 = __nv_bfloat16;

// d += a b on the tensor cores, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r, r + 8 of a row-major tile (row stride SD), k
// columns c .. c + 1 and c + 8 .. c + 9, c = k0 + 2t
template <int SD>
__device__ __forceinline__ void load_a(const bf16* tile, int r, int c,
                                       uint32_t (&a)[4]) {
  a[0] = ld32(tile + r * SD + c);
  a[1] = ld32(tile + (r + 8) * SD + c);
  a[2] = ld32(tile + r * SD + c + 8);
  a[3] = ld32(tile + (r + 8) * SD + c + 8);
}

// B fragment whose element (k, n) is tile[n * SD + k] (a row-major tile
// read transposed, B = tile^T), for the row n = n0 + g and c = k0 + 2t
template <int SD>
__device__ __forceinline__ void load_b_t(const bf16* tile, int n, int c,
                                         uint32_t (&b)[2]) {
  b[0] = ld32(tile + n * SD + c);
  b[1] = ld32(tile + n * SD + c + 8);
}

// B fragments of the two n-tiles n0 .. n0 + 7 and n0 + 8 .. n0 + 15 whose
// element (k, n) is tile[k * SD + n] (a row-major tile read as it is), k
// rows k0 .. k0 + 15: one ldmatrix.x4.trans. Lanes 8 m .. 8 m + 7 give
// the row addresses of matrix m: rows k0 + (m & 1) 8 + i, columns
// n0 + (m >> 1) 8; the transposed load hands lane 4g + t the elements
// (2t, g) and (2t + 1, g) of each matrix, which is b0 (m 0, 2) and b1
// (m 1, 3).
template <int SD>
__device__ __forceinline__ void load_b_x4_trans(const bf16* tile, int k0,
                                                int n0, int lane,
                                                uint32_t (&b_lo)[2],
                                                uint32_t (&b_hi)[2]) {
  const int i = lane & 7, m = lane >> 3;
  const bf16* p = tile + (k0 + i + (m & 1) * 8) * SD + n0 + (m >> 1) * 8;
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(b_lo[0]), "=r"(b_lo[1]), "=r"(b_hi[0]), "=r"(b_hi[1])
      : "r"(s));
}

// The accumulators of n-tiles j and j + 1 (columns 16 jj .. 16 jj + 15,
// j = 2 jj), rounded to bf16, as the A fragment of one k step
__device__ __forceinline__ void acc_pair_as_a(const float (&c0)[4],
                                              const float (&c1)[4],
                                              uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16-byte copy (8 bf16) global -> shared that lands asynchronously; with
// `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// rows [r0, r0 + ROWS) of a [T, D] bf16 slice -> shared (row stride
// D + 8), asynchronously, by a block of NTHREADS threads; rows >= T are
// zero-filled and not read
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int r0, int T, int tid) {
  constexpr int SD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert((ROWS * CPR) % NTHREADS == 0, "tile / thread mismatch");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < T;
    cp_async16(dst + r * SD + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

}  // namespace ptt_mma_bf16
