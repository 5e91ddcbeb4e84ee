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
// The bf16 kernel (flash_fwd_bf16_kernel, for bf16 mixed precision) is a
// kernel of its own on Hopper's wgmma, TMA and mbarriers (wgmma_bf16.cuh,
// as the bf16 dQ and dK/dV kernels of flash_bwd.cu), so the float32 kernel
// above stays as it was instruction for instruction. It rounds where the
// TPU kernel rounds in bf16: S, m, l, lse and the dropout are float32
// (bf16 x bf16 products are exact in float32, and sm_scale applies to the
// float32 sum); P = exp(S - m), after dropout, is rounded to bf16 for
// P V, and O = acc / l is written as bf16.
//
// What bounds it at train-base-amp's shape (B 64, H 8, T 256, D 64):
// bytes, 67 MB of q, k, v and o, 20.2 us at 3.35 TB/s, against 8.6 GFLOP
// of products (9 us at 989 TFLOP/s). Beside them the CUDA-core pass over
// 33.5 M weights: one ex2 a weight on the special-function unit (16 a
// clock an SM: 9 us), about 5 more instructions a weight at rate 0 (max,
// FFMA, the row sum, half a bf16 pack, half an O rescale) and some 9
// integer ones for the keep hash at rate 0.1 (at 64 a clock an SM, 15 us).
// Variants timed by tools/torch_flash_bwd_bench.py on an H100 (700 W):
// the loads and the O store alone (no softmax, no P V) 0.032 ms; the
// products and the softmax alone (no loads, no store) 0.038 ms at rate 0
// and 0.050 at 0.1, against 0.041 and 0.055 for the kernel. So the chain
// of S, softmax and P V that each warpgroup walks, two key tiles an item
// at T 256, bounds it, not the bytes: two warpgroups an SM hide too
// little of that chain's latency.
//
// Design:
// - Persistent blocks, one an SM, each walking work items of 128 query
//   rows of one head; the row blocks of a head are neighbouring items, so
//   blocks side by side read its K and V once from memory and then from
//   L2; under a causal mask the heaviest items go first. A block is two
//   consumer warpgroups, 64 rows each (wgmma's m64), and a producer
//   warpgroup of which one thread works. ptxas compiles every thread of a
//   384-thread block for at most 168 registers: setmaxnreg moves the
//   producer's share to the consumers at run time, but a 240-register
//   request, or a block of 288 threads, changed neither registers nor
//   spills, so the consumers' accumulators must fit in 168.
// - The producer TMA-loads each item's Q into one of two buffers, so the
//   next item's lands while this one computes, then streams K and V tiles
//   through a ring of 128 KB with full and empty mbarriers: at T 256 and
//   D 64 it holds two items' K and V. 3-D tensor maps [B*H, T, D] make
//   TMA fill rows >= T of a head with zeros.
// - Key tiles are 128 keys, and 64 under a causal mask (a template flag):
//   a warpgroup's 64 rows then end on a tile's last key, so no tile
//   stands half above the diagonal; with 128-key tiles the causal case ran
//   slower than the non-causal one. D 128 takes 64-key tiles as well.
// - S = Q K^T is a wgmma with both operands K-major from shared memory;
//   O += P V takes P from the S accumulator in registers (acc_to_a) and V
//   MN-major through the transpose bit. The two warpgroups take turns at
//   issuing their S (named barriers), so that one's softmax runs on the
//   CUDA cores while the other's products use the tensor cores.
// - The online softmax runs in registers: a row's values lie in the four
//   lanes of a quad (max: two __shfl_xor_sync a tile; the sum is kept per
//   lane and reduced once at the end). The running max stays in the
//   scores' unit, so each weight costs one FFMA and one ex2.approx (log2 e
//   folded into the scale); the wrapper negates q for a negative sm_scale.
//   Only a tile that reaches past T or crosses the diagonal tests columns;
//   tiles wholly above the diagonal are not loaded.
// - Epilogue: O / l is rounded to bf16 into the warpgroup's Q slot (free
//   once its last S is done), in TMA's layout, and leaves by one bulk TMA
//   store that clips rows >= T; lse is float32 a row.
// - Attention-weight dropout keys each weight on (seed, bh, row, column)
//   with flash_common.cuh's hash, as above, so the dQ and dK/dV kernels
//   regenerate the mask bit for bit; its first xor-shift is split between
//   the row and the column (keep_split). No atomics and a fixed order of
//   every sum: two launches give equal bits. Any T >= 1; D 32, 64 or 128.
// - Tried on an H100 and not kept (PERF.md, section 6): each
//   warpgroup issuing tile t + 1's S beside tile t's P V (it spilled under
//   dropout, and gained little at rate 0); the keep bits hashed while S
//   runs, into a bit mask (no faster); a tree for the row max with four
//   partial row sums (slower: more live registers); holding a
//   warpgroup's turn until its P V is issued (slower); one mbarrier
//   arrival a warp in place of a thread, and 6 ring stages in place of 4
//   (no faster); 128-key tiles under a causal mask (160 bytes spilled
//   under dropout, and slower than the non-causal case); the column keys
//   of each tile made by the producer warp into shared memory (0.0581 ms
//   against 0.0549 at rate 0.1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

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
                 uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale) {
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
    const uint32_t bk = bh_key(seed, bh0 + blockIdx.y);
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
                   uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = thresh ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BR - 1) / BR, bh);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(
      q, k, v, o, lse, T, sm_scale, causal, seed, bh0, thresh, drop_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed shared memory (wgmma_bf16.cuh)
// ---------------------------------------------------------------------------

using ptt_mma_bf16::bf16;

namespace fwd16 {

using namespace ptt_hopper;

constexpr int WG_ROWS = 64;       // query rows a consumer warpgroup owns
constexpr int CONSUMER_WGS = 2;
constexpr int BLOCK_ROWS = CONSUMER_WGS * WG_ROWS;   // rows of a work item
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;   // + a producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// One block an SM: 168 registers a thread at launch (65536 / 384); the
// producer warpgroup gives most of its share to the consumers:
// 2 x 128 x 232 + 128 x 32 <= 384 x 168.
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 232;

// keys of a streamed K or V tile: 128; 64 under a causal mask (a
// warpgroup's 64 rows then end on a tile's last key, so no tile is half
// above the diagonal) and at D 128 (where O takes 64 registers a thread)
template <int D, bool CAUSAL>
__host__ __device__ constexpr int bn() {
  return CAUSAL || D == 128 ? 64 : 128;
}

// K/V ring stages: 128 KB of K and V tiles (the whole K and V of two work
// items at T 256, D 64, so the next item's loads never wait for this
// one), at most 8
template <int D, bool CAUSAL>
__host__ __device__ constexpr int stages() {
  return 131072 / (2 * tile_bytes<D>(bn<D, CAUSAL>())) < 8
             ? 131072 / (2 * tile_bytes<D>(bn<D, CAUSAL>()))
             : 8;
}

// Q: two buffers (an item's and the next one's) x the warpgroups' 64
// rows; then the K and V ring; then the barriers
template <int D, bool CAUSAL>
__host__ __device__ constexpr size_t smem_size() {
  return 1024 + 2 * CONSUMER_WGS * tile_bytes<D>(WG_ROWS) +
         2 * stages<D, CAUSAL>() * tile_bytes<D>(bn<D, CAUSAL>()) +
         8 * (4 + 2 * stages<D, CAUSAL>());
}

// Work item w of a persistent block: row block rb (BLOCK_ROWS query rows)
// of head bh. The row blocks of a head are neighbouring items, so blocks
// running side by side read its K and V once from memory and then from
// L2. Under a causal mask the last row block walks the most key tiles:
// the first round of the grid takes each head's row blocks from the last,
// and when the grid holds whole heads (persistent_blocks makes it a
// multiple of n_rb when it can) the rounds alternate, so that every block
// takes costly and cheap items in turn.
template <bool CAUSAL>
__device__ __forceinline__ void work_item(int w, int n_rb, int& rb,
                                          int& bh) {
  bh = w / n_rb;
  rb = w - bh * n_rb;
  if (CAUSAL && !(gridDim.x % n_rb == 0 && ((w / gridDim.x) & 1)))
    rb = n_rb - 1 - rb;
}

// key tiles an item whose rows start at q0 reads
template <bool CAUSAL>
__device__ __forceinline__ int item_tiles(int q0, int n_kv, int bn) {
  return CAUSAL ? min(n_kv, (q0 + BLOCK_ROWS - 1) / bn + 1) : n_kv;
}

// The dropout hash of flash_common.cuh, keep(rk, col) = fmix32(rk ^ col
// C) >= thresh, with fmix32's first xor-shift split between the row and
// the column (a logical shift distributes over xor): rx = rk ^ rk >> 16
// once a row, cx = c ^ c >> 16 (c = col C) once a column for both of a
// thread's rows; the same bits, one xor a weight in place of three.
__device__ __forceinline__ uint32_t half_key(uint32_t k) {
  return k ^ (k >> 16);
}

__device__ __forceinline__ bool keep_split(uint32_t rx, uint32_t cx,
                                           uint32_t thresh) {
  uint32_t x = (rx ^ cx) * 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// One tile's online softmax, in place of its scores, all float32:
// register 4 j + e of s is row[e >> 1], key column k0 + 8 j + 2 t +
// (e & 1). m (the running row max) is kept in the scores' own unit, before
// sm_scale (the wrapper makes sm_scale >= 0, so the max commutes with
// it), and P = 2^(s sl2 - m sl2), sl2 = sm_scale log2 e: one FFMA and one
// ex2 a weight. The row sum l takes each weight before dropout; alpha is
// the factor by which the old m rescales O and l. MASK: columns past
// lim[h] (T - 1, and the row itself under a causal mask) weigh 0. rx: the
// rows' dropout keys as half_key gives them.
template <int BN, bool DROP, bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int t, const int (&lim)[2], const uint32_t (&rx)[2], float sl2,
    uint32_t thresh, float drop_scale) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      if (MASK && k0 + 8 * j + 2 * t + (e & 1) > lim[h])
        s[4 * j + e] = NEG_INF;
      mx[h] = fmaxf(mx[h], s[4 * j + e]);
    }
  float msl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * sl2);
    m[h] = mx[h];
    msl[h] = mx[h] * sl2;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = k0 + 8 * j + 2 * t + c;
      const uint32_t cx = DROP ? half_key((uint32_t)col * 0x85EBCA77u) : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + c;
        float p = ex2(fmaf(s[i], sl2, -msl[h]));
        if (MASK && col > lim[h]) p = 0.f;
        rs[h] += p;
        if (DROP) p = keep_split(rx[h], cx, thresh) ? p * drop_scale : 0.f;
        s[i] = p;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// One key tile (kt, ring slot st) once its S = Q K^T has been issued into
// s: wait for it, run the softmax in registers, rescale O, run O += P V (P
// rounded to bf16 as A from registers, V MN-major) and release the slot.
// Only a tile that reaches past T or past the warpgroup's first row
// (under a causal mask: the diagonal tile) tests columns.
template <int D, int BN, bool DROP, bool CAUSAL>
__device__ __forceinline__ void fwd_tile(
    float (&s)[BN / 2], float (&o)[D / 2], float (&m)[2], float (&l)[2],
    const unsigned char* Vt, uint64_t* empty, int kt, int r0, int t,
    const int (&lim)[2], const uint32_t (&rkey)[2], int T, float sl2,
    uint32_t thresh, float drop_scale) {
  const int k0 = kt * BN;
  wgmma_wait<0>();
  fence_regs(s);

  float alpha[2];
  if (k0 + BN > T || (CAUSAL && k0 + BN - 1 > r0))
    softmax_tile<BN, DROP, true>(s, m, l, alpha, k0, t, lim, rkey, sl2,
                                 thresh, drop_scale);
  else
    softmax_tile<BN, DROP, false>(s, m, l, alpha, k0, t, lim, rkey, sl2,
                                  thresh, drop_scale);

  uint32_t a[BN / 16][4];
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) acc_to_a(s, jj, a[jj]);
#pragma unroll
  for (int n = 0; n < D / 2; ++n) o[n] *= alpha[(n >> 1) & 1];
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj)
    wgmma_rs<1>(o, a[jj], desc_mn<D>(Vt, BN, jj), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(empty);   // this slot's K and V are read
}

}  // namespace fwd16

template <int D, bool DROP, bool CAUSAL>
__global__ void __launch_bounds__(fwd16::THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      float* __restrict__ lse, int n_bh, int T,
                      float sm_scale, uint32_t seed, uint32_t bh0, uint32_t thresh,
                      float drop_scale) {
  using namespace fwd16;
  constexpr int BN = bn<D, CAUSAL>(), ST = stages<D, CAUSAL>();
  constexpr int PW = panel_cols<D>();
  constexpr int RES = tile_bytes<D>(WG_ROWS), STR = tile_bytes<D>(BN);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);          // [2][CONSUMER_WGS][RES]
  unsigned char* Ks = Qs + 2 * CONSUMER_WGS * RES;   // [ST][STR]
  unsigned char* Vs = Ks + ST * STR;                 // [ST][STR]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + ST * STR);  // [2]
  uint64_t* q_empty = q_full + 2;                  // [2]
  uint64_t* full = q_empty + 2;                    // [ST]
  uint64_t* empty = full + ST;                     // [ST]

  const int tid = threadIdx.x;
  const int n_kv = (T + BN - 1) / BN;
  const int n_rb = (T + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_items = n_rb * n_bh;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + b, 1);
      mbar_init(q_empty + b, CONSUMERS);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: per item, each warpgroup's Q into the item's buffer (the
    // next item's lands while this one computes), then K and V tiles
    // through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int g = 0;   // tiles issued
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int rb, bh;
        work_item<CAUSAL>(w, n_rb, rb, bh);
        const int q0 = rb * BLOCK_ROWS;
        // causal: key tiles past the item's last query row are not loaded
        const int n_tiles = item_tiles<CAUSAL>(q0, n_kv, BN);
        const int b = it & 1;
        mbar_wait(q_empty + b, ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full + b, CONSUMER_WGS * RES);
        for (int c = 0; c < CONSUMER_WGS; ++c)
          tma_tile<D>(Qs + (b * CONSUMER_WGS + c) * RES, &tm_q, q_full + b,
                      q0 + c * WG_ROWS, bh, WG_ROWS);
        for (int kt = 0; kt < n_tiles; ++kt, ++g) {
          const int s = g % ST;
          mbar_wait(empty + s, ((g / ST) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, 2 * STR);
          tma_tile<D>(Ks + s * STR, &tm_k, full + s, kt * BN, bh, BN);
          tma_tile<D>(Vs + s * STR, &tm_v, full + s, kt * BN, bh, BN);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = 16 * warp + g;   // this thread's rows: wr, wr + 8
    const float sl2 = sm_scale * LOG2E;
    // Ping-pong: the two warpgroups take turns issuing a tile's S (named
    // barriers 1 and 2), so that one's softmax runs on the CUDA cores
    // while the other's products use the tensor cores. Every tile,
    // computed or skipped, takes a turn; warpgroup 0 has the first.
    if (wg == 1) named_bar_arrive(1, CONSUMERS);
    int gt = 0;   // tiles consumed

    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      int rb, bh;
      work_item<CAUSAL>(w, n_rb, rb, bh);
      const int q0 = rb * BLOCK_ROWS;
      const int n_tiles = item_tiles<CAUSAL>(q0, n_kv, BN);
      const int r0 = q0 + wg * WG_ROWS;   // this warpgroup's first row
      // key tiles this warpgroup reads; it only releases the others.
      // Each one it reads holds column k0 <= r0, so no row of it is wholly
      // masked, and m is finite after the first.
      const int my_tiles =
          r0 >= T ? 0
                  : CAUSAL ? min(n_tiles, (r0 + WG_ROWS - 1) / BN + 1)
                           : n_tiles;
      const int row[2] = {r0 + wr, r0 + wr + 8};
      int lim[2];
      uint32_t rkey[2];   // the rows' dropout keys, as half_key gives them
      const uint32_t bk = DROP ? bh_key(seed, bh0 + bh) : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lim[h] = CAUSAL ? min(row[h], T - 1) : T - 1;
        rkey[h] = DROP ? half_key(row_key(bk, row[h])) : 0u;
      }

      float o[D / 2];   // O, 64 x D
#pragma unroll
      for (int n = 0; n < D / 2; ++n) o[n] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.f, 0.f};      // this lane's share of the row sums

      const int b = it & 1;
      unsigned char* Qw = Qs + (b * CONSUMER_WGS + wg) * RES;
      mbar_wait(q_full + b, (it >> 1) & 1);
      float s[BN / 2];   // S, then P: 64 x BN
      for (int kt = 0; kt < my_tiles; ++kt) {
        const int i = gt + kt, st = i % ST;
        named_bar_sync(1 + wg, CONSUMERS);   // this warpgroup's turn
        mbar_wait(full + st, (i / ST) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<0>(s, desc_k<D>(Qw, WG_ROWS, kk),
                      desc_k<D>(Ks + st * STR, BN, kk), kk);
        wgmma_commit();
        named_bar_arrive(2 - wg, CONSUMERS);   // the other's turn
        fwd_tile<D, BN, DROP, CAUSAL>(s, o, m, l, Vs + st * STR, empty + st,
                                      kt, r0, t, lim, rkey, T, sl2, thresh,
                                      drop_scale);
      }
      // tiles past this warpgroup's rows (causal) or all (rows >= T): the
      // turns are taken all the same
      for (int kt = my_tiles; kt < n_tiles; ++kt) {
        const int i = gt + kt, st = i % ST;
        named_bar_sync(1 + wg, CONSUMERS);
        named_bar_arrive(2 - wg, CONSUMERS);
        mbar_wait(full + st, (i / ST) & 1);
        mbar_arrive(empty + st);
      }
      gt += n_tiles;
      // O / l out: this warpgroup's Q slot is free (its products are
      // done); the tile goes in as TMA lays it out and leaves by one bulk
      // store, rows past T clipped. lse = m sm_scale + log l, float32.
      if (r0 < T) {
        float lsafe[2], inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          lsafe[h] = fmaxf(l[h], 1e-20f);
          inv[h] = 1.f / lsafe[h];
        }
#pragma unroll
        for (int n = 0; n < D / 2; ++n) o[n] *= inv[(n >> 1) & 1];
        store_acc_tile<D>(Qw, o, warp, g, t);
        fence_proxy_async();
        named_bar_sync(3 + wg, 128);
        if ((tid & 127) == 0) {
#pragma unroll
          for (int p = 0; p < D / PW; ++p)
            tma_store_3d(&tm_o, Qw + p * WG_ROWS * PW * 2, p * PW, r0, bh);
          tma_store_commit();
          tma_store_wait<true>();   // before the slot is released
        }
        if (t == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row[h] < T)
              lse[(size_t)bh * T + row[h]] = m[h] * sm_scale + logf(lsafe[h]);
        }
      }
      mbar_arrive(q_empty + b);   // Q of this item is read
    }
    if ((tid & 127) == 0) tma_store_wait<false>();
  }
}

template <int D, bool DROP, bool CAUSAL>
int launch_bf16_kernel(const CUtensorMap (&maps)[4], float* lse, int bh,
                       int T, float sm_scale, uint32_t seed, uint32_t bh0,
                       uint32_t thresh, float drop_scale,
                       cudaStream_t stream) {
  using namespace fwd16;
  const size_t smem = smem_size<D, CAUSAL>();
  auto kernel = flash_fwd_bf16_kernel<D, DROP, CAUSAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks, err;
  if ((err = persistent_blocks((T + BLOCK_ROWS - 1) / BLOCK_ROWS, bh,
                               &blocks)))
    return err;
  kernel<<<blocks, THREADS, smem, stream>>>(maps[0], maps[1], maps[2],
                                            maps[3], lse, bh, T, sm_scale,
                                            seed, bh0, thresh, drop_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                float* lse, int bh, int T, float sm_scale, int causal,
                uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale,
                cudaStream_t stream) {
  using namespace fwd16;
  const int kv_rows = causal ? bn<D, true>() : bn<D, false>();
  CUtensorMap maps[4];
  int err;
  if ((err = encode_bf16_map<D>(&maps[0], q, bh, T, WG_ROWS)) ||
      (err = encode_bf16_map<D>(&maps[1], k, bh, T, kv_rows)) ||
      (err = encode_bf16_map<D>(&maps[2], v, bh, T, kv_rows)) ||
      (err = encode_bf16_map<D>(&maps[3], o, bh, T, WG_ROWS)))
    return err;
  if (causal)
    return thresh ? launch_bf16_kernel<D, true, true>(
                        maps, lse, bh, T, sm_scale, seed, bh0, thresh, drop_scale,
                        stream)
                  : launch_bf16_kernel<D, false, true>(
                        maps, lse, bh, T, sm_scale, seed, bh0, thresh, drop_scale,
                        stream);
  return thresh ? launch_bf16_kernel<D, true, false>(
                      maps, lse, bh, T, sm_scale, seed, bh0, thresh, drop_scale,
                      stream)
                : launch_bf16_kernel<D, false, false>(
                      maps, lse, bh, T, sm_scale, seed, bh0, thresh, drop_scale,
                      stream);
}

}  // namespace

// q, k, v, o: [bh, T, d] float32, contiguous; lse: [bh, T] float32.
// Dropout keeps a weight when its hash >= thresh (thresh = rate * 2^32;
// 0 = no dropout) and scales it by drop_scale = 1 / (1 - rate).
// Returns a cudaError_t (0 on success); d must be 32, 64 or 128.
extern "C" int ptt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int T, int d,
                                 float sm_scale, int causal, uint32_t seed, uint32_t bh0,
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
                                       seed, bh0, thresh, drop_scale, s);
    case 64: return (int)launch<64>(qf, kf, vf, of, lf, bh, T, sm_scale, causal,
                                       seed, bh0, thresh, drop_scale, s);
    case 128: return (int)launch<128>(qf, kf, vf, of, lf, bh, T, sm_scale, causal,
                                       seed, bh0, thresh, drop_scale, s);
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
                                  float sm_scale, int causal, uint32_t seed, uint32_t bh0,
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
    case 32: return launch_bf16<32>(qb, kb, vb, ob, lf, bh, T, sm_scale,
                                    causal, seed, bh0, thresh, drop_scale, s);
    case 64: return launch_bf16<64>(qb, kb, vb, ob, lf, bh, T, sm_scale,
                                    causal, seed, bh0, thresh, drop_scale, s);
    case 128: return launch_bf16<128>(qb, kb, vb, ob, lf, bh, T, sm_scale,
                                      causal, seed, bh0, thresh, drop_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of the bf16 forward kernel takes at head
// dim d, in bytes (its causal instantiation: ..._causal_smem_bytes); -1
// for another d.
extern "C" int ptt_flash_fwd_bf16_smem_bytes(int d) {
  switch (d) {
    case 32: return (int)fwd16::smem_size<32, false>();
    case 64: return (int)fwd16::smem_size<64, false>();
    case 128: return (int)fwd16::smem_size<128, false>();
    default: return -1;
  }
}

extern "C" int ptt_flash_fwd_bf16_causal_smem_bytes(int d) {
  switch (d) {
    case 32: return (int)fwd16::smem_size<32, true>();
    case 64: return (int)fwd16::smem_size<64, true>();
    case 128: return (int)fwd16::smem_size<128, true>();
    default: return -1;
  }
}

// The message of an entry's return code: a cudaError_t, or (from the
// bf16 flash entries, which encode TMA tensor maps) 100000 + the CUresult
// of a failed cuTensorMapEncodeTiled.
extern "C" const char* ptt_error_string(int err) {
  if (err >= 100000)
    return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
