// Shared by flash_fwd.cu and flash_bwd.cu: tile sizes and the
// attention-weight dropout hash.
//
// The mask is keyed per weight on (seed, bh, query row, key column), not
// per tile, so the forward, dQ and dK/dV kernels, whatever their tiling
// and loop order, regenerate it bit for bit, and so does the plain PyTorch
// version (ops/flash_attention.py::_attention_keep). Every step is
// murmur3's fmix32 avalanche in uint32 arithmetic:
//   bk   = fmix32(seed ^ bh * 0x9E3779B9)          once per block
//   rk   = fmix32(bk + row)                        once per query row
//   bits = fmix32(rk ^ col * 0x85EBCA77)           once per weight
// and a weight is kept when bits >= thresh, thresh = rate * 2^32, so it
// survives with probability 1 - rate (to 2^-32). bh is bh0 + the block's
// (batch, head) row: a rank that holds batch rows b0.. of a batch split
// over ranks passes bh0 = b0 * H, so it draws the mask one device would.

#pragma once

#include <stdint.h>

namespace ptt_flash {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // key rows per tile
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score value

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t bh_key(uint32_t seed, uint32_t bh) {
  return fmix32(seed ^ (bh * 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t row_key(uint32_t bk, uint32_t row) {
  return fmix32(bk + row);
}

__device__ __forceinline__ bool keep(uint32_t rk, uint32_t col,
                                     uint32_t thresh) {
  return fmix32(rk ^ (col * 0x85EBCA77u)) >= thresh;
}

}  // namespace ptt_flash
