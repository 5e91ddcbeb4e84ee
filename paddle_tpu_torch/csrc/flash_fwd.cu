// FlashAttention-2 forward, float32, for sm_90a, on the tensor cores in
// 3xTF32.
//
// Replaces paddle_tpu/ops/pallas_attention.py::_flash_fwd_kernel (launched
// by _flash_forward). Computes O = softmax(Q K^T * sm_scale) V and the
// row logsumexp over q/k/v laid out [B*H, T, D], optionally causal, with
// optional attention-weight dropout, without ever writing the [T, T] score
// matrix to device memory.
//
// What bounds it on the H100: 4*B*H*T^2*D operations (causal half) against
// 4*B*H*T*D*4 bytes, about T/4 operations per byte, so it is bound by
// arithmetic. Both products run on the tensor cores as mma.sync m16n8k8
// TF32 in the 3xTF32 split (mma_tf32.cuh): three TF32 products per fp32
// product, a ceiling of 495 / 3 = 165 TFLOP/s against the 67 TFLOP/s of
// the fp32 CUDA cores that the first version used. One TF32 product keeps
// 11 significant bits, and out or lse then misses the 1e-4 tolerance
// (tests/test_torch_tf32_split.py).
//
// Design (the backward's, flash_bwd.cu, turned around):
// - grid (ceil(T/64), B*H), 4 warps, one block per 64 query rows, 16 rows
//   a warp. blockIdx.x counts q-tiles from the last: under a causal mask
//   the last q-tile walks the most K/V tiles, and it starts first.
// - Q is split into hi/lo once per block: into registers at D <= 64, in
//   shared memory at D 128 (whose 2 x 64 split values a thread would not
//   hold), never again per K/V tile.
// - K and V tiles of BS rows stream through a two-stage cp.async ring,
//   with one __syncthreads a tile: after it, the tile has landed for every
//   thread and every warp has finished the previous tile, whose stage the
//   copy issued next refills while this tile computes.
// - S = Q K^T takes the small terms in their own accumulator
//   (mma_3xtf32_sep): S feeds exp(). The sum over d is taken in a permuted
//   order (k slot t <-> column 2t, slot t + 4 <-> 2t + 1 of each 8-column
//   step), the same for Q and K, so a lane reads its two K values of a
//   fragment with one 8-byte load. Q and K rows have stride D + 8 floats,
//   which keeps those loads free of bank conflicts.
// - The online softmax runs per warp in registers. A row's values lie in
//   the four lanes of one quad: its max takes two __shfl_xor_sync (1, 2) a
//   tile; its sum is kept per lane and reduced once at the end.
// - O += P V takes P straight from the S accumulator as the A operand
//   (acc_as_a) and V's rows in the same permuted order (load_b_perm), so P
//   never goes through shared memory. V rows have stride D + 4.
// - Each warp splits the K and V values it reads into hi/lo. Splitting
//   each streamed tile once per block into shared memory instead (a
//   quarter of the split work, at twice the shared-memory reads and 1.7x
//   the shared memory a block) ran no faster on an H100 at the train and
//   serve shapes, so the split is not what bounds this loop, and the
//   per-warp split keeps the smaller block.
// - causal: tiles wholly above the diagonal are skipped by the block, and
//   by a warp whose 16 rows all lie above a tile; the diagonal tile is
//   masked. A ragged T: the copy zero-fills rows >= T (src-size 0, nothing
//   read), columns >= T are masked and rows >= T never written.
// - Attention-weight dropout is a template flag with the per-weight hash
//   of flash_common.cuh, keyed on (seed, bh, query row, key column), so
//   the dQ and dK/dV kernels regenerate the mask bit for bit. As in the
//   TPU kernel, a weight is dropped and scaled after the row sum l takes
//   it, so l counts the undropped weights. Rate 0 (thresh == 0, serving)
//   launches the instantiation without it.
// - No atomics and a fixed order of every sum: two launches on the same
//   inputs give equal bits.
//
// The bf16 instantiation (flash_fwd_bf16_kernel, for bf16 mixed precision)
// is its own kernel template: its products are one mma.sync m16n8k16 bf16
// each with float32 accumulation (mma_bf16.cuh), where 3xTF32 takes three
// m16n8k8, so fragments, tile loop and shared layout differ, and the
// float32 kernel above stays as it was instruction for instruction. It
// rounds where the TPU kernel rounds in bf16: S, m, l and the dropout are
// float32 (bf16 x bf16 products are exact in float32, and sm_scale
// applies to the float32 sum); P = exp(S - m) is rounded to bf16 for
// P V, and O = acc / l is written as bf16; lse stays float32. Its shape:
// the float32 kernel's grid, warps and heaviest-first order, 64-row K/V
// tiles in a two-stage cp.async ring with one __syncthreads a tile, Q's
// A fragments loaded once into registers, P fed from the S accumulator as
// the A operand (acc_pair_as_a), V's B fragments by ldmatrix.trans. With
// a quarter of float32's bytes a product and one mma where 3xTF32 takes
// three, the bf16 forward at the train shape has about 4.3 GFLOP against
// 34 MB: it is bound by bytes at 989 TFLOP/s. It is a first, simple
// kernel: wgmma and TMA are for a later one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace ptt_flash;
using namespace ptt_mma;

constexpr int FWD_THREADS = 128;  // 4 warps
constexpr int BR = 64;            // query rows a block: 16 a warp
// key rows of a streamed tile (64-row tiles ran slower on an H100)
constexpr int BS = 32;

// blocks an SM must hold (caps registers at 65536 / (128 n)). At 2, D 64
// takes 168 registers, so 3 blocks fit all the same, and on an H100 it ran
// a little faster than a bound of 3 (164 registers) at every shape timed.
template <int D>
constexpr int min_blocks() { return D <= 64 ? 2 : 1; }

// rows [r0, r0 + ROWS) of a [T, D] slice -> shared (row stride SD),
// asynchronously; rows >= T are zero-filled and not read. Thread tid
// copies chunks tid, tid + 128, ... (split_tile walks the same ones).
template <int D, int ROWS, int SD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int T, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert((ROWS * CPR) % FWD_THREADS == 0, "tile / thread mismatch");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / FWD_THREADS; ++it) {
    const int i = tid + it * FWD_THREADS;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r0 + r < T;
    cp_async16(dst + r * SD + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// Split the chunks this thread copied with load_tile (landed: cp.async's
// writes are visible to the thread that issued them after its wait) into
// hi, in place, and lo; the block's next barrier shows them to every warp.
template <int D, int ROWS, int SD>
__device__ __forceinline__ void split_tile(float* t, uint32_t* lo, int tid) {
  constexpr int CPR = D / 4;
#pragma unroll
  for (int it = 0; it < ROWS * CPR / FWD_THREADS; ++it) {
    const int i = tid + it * FWD_THREADS;
    const int off = (i / CPR) * SD + (i % CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Two values of row r at columns c, c + 1 (c even) as a fragment pair
// under the permuted d order: fp32 in shared memory, split here ...
template <int SD>
__device__ __forceinline__ void load_pair(const float* t, int r, int c,
                                          uint32_t& h0, uint32_t& l0,
                                          uint32_t& h1, uint32_t& l1) {
  const float2 x = *reinterpret_cast<const float2*>(t + r * SD + c);
  split(x.x, h0, l0);
  split(x.y, h1, l1);
}

// ... or already split (hi in place of the fp32 values, lo beside: Q at
// D 128)
template <int SD>
__device__ __forceinline__ void load_pair(const uint32_t* hi, const uint32_t* lo,
                                          int r, int c, uint32_t& h0,
                                          uint32_t& l0, uint32_t& h1,
                                          uint32_t& l1) {
  const uint2 h = *reinterpret_cast<const uint2*>(hi + r * SD + c);
  const uint2 l = *reinterpret_cast<const uint2*>(lo + r * SD + c);
  h0 = h.x; h1 = h.y; l0 = l.x; l1 = l.y;
}

template <int D>
constexpr size_t smem_floats() {
  constexpr size_t q = (size_t)BR * (D + 8);
  constexpr size_t kv = 2 * (size_t)BS * (D + 8) + 2 * (size_t)BS * (D + 4);
  return q + kv + (D > 64 ? q : 0);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(FWD_THREADS, min_blocks<D>())
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, float sm_scale, int causal,
                 uint32_t seed, uint32_t thresh, float drop_scale) {
  constexpr int SK = D + 8;          // row stride of Q and K
  constexpr int SV = D + 4;          // row stride of V
  constexpr int NS = BS / 8;         // 8-key n-tiles of S, k-tiles of P V
  constexpr int ND = D / 8;          // 8-wide k-tiles of S, n-tiles of O
  constexpr bool Q_REGS = D <= 64;   // Q's split in registers
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BR][SK]; at D 128 Q's hi after the split
  float* Ks = Qs + BR * SK;          // [2][BS][SK]
  float* Vs = Ks + 2 * BS * SK;      // [2][BS][SV]
  uint32_t* Qlo = reinterpret_cast<uint32_t*>(Vs + 2 * BS * SV);  // D 128: [BR][SK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;  // heaviest first
  const size_t base = (size_t)blockIdx.y * T * D;

  const int n_kv = (T + BS - 1) / BS;
  const int n_tiles = causal ? min(n_kv, (q0 + BR - 1) / BS + 1) : n_kv;

  load_tile<D, BR, SK>(Qs, q + base, q0, T, tid);
  load_tile<D, BS, SK>(Ks, k + base, 0, T, tid);
  load_tile<D, BS, SV>(Vs, v + base, 0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (!Q_REGS) split_tile<D, BR, SK>(Qs, Qlo, tid);
  __syncthreads();

  // this thread's query rows: wr and wr + 8 of the tile
  const int wr = 16 * warp + g;
  const int row[2] = {q0 + wr, q0 + wr + 8};
  // causal: the last key column any of this warp's rows sees
  const int warp_last = q0 + 16 * warp + 15;
  uint32_t rkey[2] = {0u, 0u};
  if (DROP) {
    const uint32_t bk = bh_key(seed, blockIdx.y);
    rkey[0] = row_key(bk, row[0]);
    rkey[1] = row_key(bk, row[1]);
  }

  // Q's A fragments, split once: slot t <-> column 8 kk + 2t, slot t + 4
  // <-> 8 kk + 2t + 1
  uint32_t qh[Q_REGS ? ND : 1][4], ql[Q_REGS ? ND : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      load_pair<SK>(Qs, wr, 8 * kk + 2 * t, qh[kk][0], ql[kk][0], qh[kk][2],
                    ql[kk][2]);
      load_pair<SK>(Qs, wr + 8, 8 * kk + 2 * t, qh[kk][1], ql[kk][1],
                    qh[kk][3], ql[kk][3]);
    }
  }

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt > 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (kt + 1 < n_tiles) {
      const int nx = (kt + 1) & 1;
      load_tile<D, BS, SK>(Ks + nx * BS * SK, k + base, (kt + 1) * BS, T, tid);
      load_tile<D, BS, SV>(Vs + nx * BS * SV, v + base, (kt + 1) * BS, T, tid);
      cp_async_commit();
    }
    const int k0 = kt * BS;
    if (causal && k0 > warp_last) continue;  // every row of the warp masks it
    const float* Kt = Ks + st * BS * SK;
    const float* Vt = Vs + st * BS * SV;

    // S = Q K^T for this warp's 16 rows x BS keys
    float s[NS][4], s_small[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s_small[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        const uint32_t* Qh = reinterpret_cast<const uint32_t*>(Qs);
        load_pair<SK>(Qh, Qlo, wr, 8 * kk + 2 * t, ah[0], al[0], ah[2], al[2]);
        load_pair<SK>(Qh, Qlo, wr + 8, 8 * kk + 2 * t, ah[1], al[1], ah[3],
                      al[3]);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bh[2], bl[2];
        load_pair<SK>(Kt, 8 * j + g, 8 * kk + 2 * t, bh[0], bl[0], bh[1],
                      bl[1]);
        mma_3xtf32_sep(s[j], s_small[j], ah, al, bh, bl);
      }
    }

    // online softmax: element e of n-tile j is row[e >> 1], key column
    // k0 + 8 j + 2 t + (e & 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = (s[j][e] + s_small[j][e]) * sm_scale;
        if (col >= T || (causal && col > row[h])) x = NEG_INF;
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = expf(s[j][e] - m[h]);
        rs[h] += p;
        if (DROP)
          p = keep(rkey[h], k0 + 8 * j + 2 * t + (e & 1), thresh)
                  ? p * drop_scale : 0.f;
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t ah[4], al[4];
      acc_as_a(s[j], ah, al);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        load_b_perm<SV>(Vt, 8 * j + 2 * t, 8 * n + g, bh, bl);
        mma_3xtf32(acc[n], ah, al, bh, bl);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] < T) {
      const float lsafe = fmaxf(l[h], 1e-20f);
      const float inv = 1.f / lsafe;
      float* dst = o + base + (size_t)row[h] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      if (t == 0) lse[(size_t)blockIdx.y * T + row[h]] = m[h] + logf(lsafe);
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int T, float sm_scale, int causal,
                   uint32_t seed, uint32_t thresh, float drop_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = thresh ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(
      q, k, v, o, lse, T, sm_scale, causal, seed, thresh, drop_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

using ptt_mma_bf16::bf16;
using ptt_mma_bf16::load_tile_bf16;

constexpr int BS16 = 64;          // key rows of a streamed bf16 tile

template <int D>
constexpr size_t smem_bf16_elems() {
  return (size_t)(BR + 4 * BS16) * (D + 8);  // Q, then K and V x 2 stages
}

template <int D, bool DROP>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int T, float sm_scale,
                      int causal, uint32_t seed, uint32_t thresh,
                      float drop_scale) {
  using namespace ptt_mma_bf16;
  constexpr int SD = D + 8;          // row stride of every tile
  constexpr int NS = BS16 / 8;       // 8-key n-tiles of S
  constexpr int KD = D / 16;         // 16-deep k steps of S
  constexpr int ND = D / 8;          // 8-wide n-tiles of O
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem16);  // [BR][SD]
  bf16* Ks = Qs + BR * SD;           // [2][BS16][SD]
  bf16* Vs = Ks + 2 * BS16 * SD;     // [2][BS16][SD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;  // heaviest first
  const size_t base = (size_t)blockIdx.y * T * D;

  const int n_kv = (T + BS16 - 1) / BS16;
  const int n_tiles = causal ? min(n_kv, (q0 + BR - 1) / BS16 + 1) : n_kv;

  load_tile_bf16<D, BR, FWD_THREADS>(Qs, q + base, q0, T, tid);
  load_tile_bf16<D, BS16, FWD_THREADS>(Ks, k + base, 0, T, tid);
  load_tile_bf16<D, BS16, FWD_THREADS>(Vs, v + base, 0, T, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this thread's query rows: wr and wr + 8 of the tile
  const int wr = 16 * warp + g;
  const int row[2] = {q0 + wr, q0 + wr + 8};
  const int warp_last = q0 + 16 * warp + 15;
  uint32_t rkey[2] = {0u, 0u};
  if (DROP) {
    const uint32_t bk = bh_key(seed, blockIdx.y);
    rkey[0] = row_key(bk, row[0]);
    rkey[1] = row_key(bk, row[1]);
  }
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a<SD>(Qs, wr, 16 * kk + 2 * t, qa[kk]);

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    if (kt > 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (kt + 1 < n_tiles) {
      const int nx = (kt + 1) & 1;
      load_tile_bf16<D, BS16, FWD_THREADS>(Ks + nx * BS16 * SD, k + base,
                                           (kt + 1) * BS16, T, tid);
      load_tile_bf16<D, BS16, FWD_THREADS>(Vs + nx * BS16 * SD, v + base,
                                           (kt + 1) * BS16, T, tid);
      cp_async_commit();
    }
    const int k0 = kt * BS16;
    if (causal && k0 > warp_last) continue;  // every row of the warp masks it
    const bf16* Kt = Ks + st * BS16 * SD;
    const bf16* Vt = Vs + st * BS16 * SD;

    // S = Q K^T for this warp's 16 rows x BS16 keys, float32
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t b[2];
        load_b_t<SD>(Kt, 8 * j + g, 16 * kk + 2 * t, b);
        mma_bf16(s[j], qa[kk], b);
      }

    // online softmax in float32: element e of n-tile j is row[e >> 1], key
    // column k0 + 8 j + 2 t + (e & 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * sm_scale;
        if (col >= T || (causal && col > row[h])) x = NEG_INF;
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = expf(s[j][e] - m[h]);
        rs[h] += p;
        if (DROP)
          p = keep(rkey[h], k0 + 8 * j + 2 * t + (e & 1), thresh)
                  ? p * drop_scale : 0.f;
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V, P rounded to bf16
#pragma unroll
    for (int jj = 0; jj < NS / 2; ++jj) {
      uint32_t pa[4];
      acc_pair_as_a(s[2 * jj], s[2 * jj + 1], pa);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b0[2], b1[2];
        load_b_x4_trans<SD>(Vt, 16 * jj, 8 * n, lane, b0, b1);
        mma_bf16(acc[n], pa, b0);
        mma_bf16(acc[n + 1], pa, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] < T) {
      const float lsafe = fmaxf(l[h], 1e-20f);
      const float inv = 1.f / lsafe;
      bf16* dst = o + base + (size_t)row[h] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
      if (t == 0) lse[(size_t)blockIdx.y * T + row[h]] = m[h] + logf(lsafe);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* lse, int bh, int T, float sm_scale, int causal,
                        uint32_t seed, uint32_t thresh, float drop_scale,
                        cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * smem_bf16_elems<D>();
  auto kernel = thresh ? flash_fwd_bf16_kernel<D, true>
                       : flash_fwd_bf16_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(
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

// Dynamic shared memory a block of the forward kernel takes at head dim
// d, in bytes; -1 for another d.
extern "C" int ptt_flash_fwd_smem_bytes(int d) {
  switch (d) {
    case 32: return (int)(sizeof(float) * smem_floats<32>());
    case 64: return (int)(sizeof(float) * smem_floats<64>());
    case 128: return (int)(sizeof(float) * smem_floats<128>());
    default: return -1;
  }
}

// As ptt_flash_fwd_f32, with q, k, v and o bf16 ([bh, T, d]); lse stays
// float32.
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int T, int d,
                                  float sm_scale, int causal, uint32_t seed,
                                  uint32_t thresh, float drop_scale,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_bf16<32>(qb, kb, vb, ob, lf, bh, T, sm_scale,
                                         causal, seed, thresh, drop_scale, s);
    case 64: return (int)launch_bf16<64>(qb, kb, vb, ob, lf, bh, T, sm_scale,
                                         causal, seed, thresh, drop_scale, s);
    case 128: return (int)launch_bf16<128>(qb, kb, vb, ob, lf, bh, T, sm_scale,
                                           causal, seed, thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the bf16 forward kernel takes at head
// dim d, in bytes; -1 for another d.
extern "C" int ptt_flash_fwd_bf16_smem_bytes(int d) {
  switch (d) {
    case 32: return (int)(sizeof(bf16) * smem_bf16_elems<32>());
    case 64: return (int)(sizeof(bf16) * smem_bf16_elems<64>());
    case 128: return (int)(sizeof(bf16) * smem_bf16_elems<128>());
    default: return -1;
  }
}

// The message of an entry's return code: a cudaError_t, or (from
// flash_bwd.cu's bf16 entries) 100000 + the CUresult of a failed
// cuTensorMapEncodeTiled.
extern "C" const char* ptt_error_string(int err) {
  if (err >= 100000)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
