// Tensor-core float32 products in the 3xTF32 scheme, and cp.async copies,
// for flash_bwd.cu.
//
// An fp32 value x is split in registers into two TF32 values,
//   hi = to_tf32(x),  lo = to_tf32(x - hi)   (cvt.rna.tf32.f32 rounding),
// (x - hi is exact in fp32), so x = hi + lo to about 2^-22 relative. A
// product a * b is then taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, the
// small terms first, each on the tensor cores with fp32 accumulation;
// lo_a lo_b (about 2^-22 |a b|) is dropped. This keeps fp32 accuracy at
// three TF32 products (CUTLASS's OpMultiplyAddFastF32). One TF32 product
// alone keeps 11 significant bits and would not.
//
// The tensor cores' fp32 accumulation truncates where IEEE addition would
// round to nearest, so each mma can lose about one ulp of the accumulator.
// Where a sum feeds exp() (the scores), the two small terms therefore go
// into an accumulator of their own (mma_3xtf32_sep), whose values are
// 2^-11 of the big one's and lose nothing that counts, and are added to
// the hi_a hi_b accumulator once at the end. Added into the big
// accumulator (three roundings per k step instead of one), they made the
// backward miss its tolerance where the scores are peaked.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for
// lane = 4 g + t (g = groupID 0..7, t = threadID_in_group 0..3):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)                      [k, n]
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <stdint.h>

namespace ptt_mma {

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10 mantissa
// bits) done in integer arithmetic: add half an ulp of the 10-bit mantissa
// to the magnitude and clear the 13 low bits. For finite x it gives
// cvt.rna's bits; ptxas lowers the cvt itself to a longer sequence (a
// compare and selects around it), which made the split the kernels'
// largest cost.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on the tensor cores, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: lo_a hi_b, then hi_a lo_b, then hi_a hi_b
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// the same with the small terms into their own accumulator: d += hi_a hi_b,
// d_small += lo_a hi_b + hi_a lo_b
__device__ __forceinline__ void mma_3xtf32_sep(float (&d)[4], float (&d_small)[4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               const uint32_t (&bh)[2],
                                               const uint32_t (&bl)[2]) {
  mma_tf32(d_small, al, bh);
  mma_tf32(d_small, ah, bl);
  mma_tf32(d, ah, bh);
}

// A fragment of rows r, r + 8 and columns c, c + 4 of a row-major tile
// with row stride SD, split
template <int SD>
__device__ __forceinline__ void load_a(const float* t, int r, int c,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(t[r * SD + c], hi[0], lo[0]);
  split(t[(r + 8) * SD + c], hi[1], lo[1]);
  split(t[r * SD + c + 4], hi[2], lo[2]);
  split(t[(r + 8) * SD + c + 4], hi[3], lo[3]);
}

// B fragment whose element (k, n) is t[n * SD + k] (a row-major tile read
// transposed: B = tile^T), for n = n0 + g and k = k0 + t; split
template <int SD>
__device__ __forceinline__ void load_b_t(const float* t, int n, int k,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split(t[n * SD + k], hi[0], lo[0]);
  split(t[n * SD + k + 4], hi[1], lo[1]);
}

// An accumulator tile used as the A operand of the next product. The
// thread holds columns 2t and 2t + 1 where A wants t and t + 4, so the k
// index is permuted: k slot t stands for column 2t, slot t + 4 for 2t + 1.
// The B operand must take the same permutation (load_b_perm).
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// B fragment of a row-major tile (element (k, n) at t[k * SD + n]) under
// acc_as_a's k permutation: b0 = row k0 + 2t, b1 = row k0 + 2t + 1, at
// column n = n0 + g; split
template <int SD>
__device__ __forceinline__ void load_b_perm(const float* t, int k2, int n,
                                            uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split(t[k2 * SD + n], hi[0], lo[0]);
  split(t[(k2 + 1) * SD + n], hi[1], lo[1]);
}

// 16-byte copy global -> shared that lands asynchronously; with `valid`
// false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// the same for one float (rows of lse / delta, which are 4-byte aligned)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace ptt_mma
