// FlashAttention-2 backward, bf16, for sm_90a (flash_dq_bf16_kernel,
// flash_dkv_bf16_kernel, for bf16 mixed precision): kernels of their own
// on Hopper's wgmma, TMA and mbarriers (wgmma_bf16.cuh), so the float32
// kernels (flash_bwd_f32.cuh) stay as they were. They replace
// paddle_tpu/ops/pallas_attention.py::_flash_dq_kernel and
// ::_flash_dkv_kernel in bf16 (the products and the formulas of
// flash_bwd_f32.cuh's header) and round where those round:
// S, W, dP, delta and dS are float32; dQ rounds dS to bf16 for dS K;
// dK/dV rounds W_drop and dS for W_drop^T dO and dS^T Q; dQ, dK and dV
// are written as bf16. The keep hash is flash_common.cuh's.
//
// What bounds them at train-base-amp's shape (B 64, H 8, T 256, D 64):
// bytes, 85 MB (dQ: Q, K, V, dO in, dQ out, lse and delta) and 102 MB
// (dK/dV), 25 and 30 us at 3.35 TB/s, against 12.9 and 17.2 GFLOP of
// products, 13 and 17 us at 989 TFLOP/s. Beside them the CUDA-core pass
// over 33.5 M weights a kernel (exp, masks, dS; at rate 0.1 the fmix32
// keep hash, about 11 integer operations a weight): about 20 instructions
// a weight in dQ, some 22 us of issue on 132 SMs, which the tensor cores
// cannot take.
//
// Design:
// - Persistent blocks, one an SM, each walking work items: 128 rows
//   (query rows for dQ, key rows for dK/dV) of one head; the row blocks
//   of a head are neighbouring items, so blocks side by side read its
//   streamed tiles once from memory and then from L2. A block is two
//   consumer warpgroups, 64 resident rows each, and a producer warpgroup
//   of which one warp works (setmaxnreg hands the producer's registers
//   to the consumers at run time, 232 and 32 a thread; ptxas still
//   compiles every thread for at most 168, see flash_fwd.cu).
// - The producer TMA-loads each item's resident tiles (Q and dO, or K and
//   V) into one of two buffers, so the next item's land while this one
//   computes, then streams the other two tensors through a 4-stage ring
//   (2 for dQ's 32 KB tiles at D 128) with full and empty mbarriers;
//   both warpgroups read each streamed tile, so it is loaded once per 128
//   rows. For dK/dV it also stages each query tile's lse and delta (by
//   cp.async, which arrives on the stage's full barrier when they land,
//   so no load latency holds the next TMA back) and its dropout row keys.
//   3-D tensor maps [B*H, T, D] make TMA fill rows >= T of a head with
//   zeros.
// - Tiles sit in shared memory in TMA's 128-byte swizzle (64-column
//   panels; the 64-byte swizzle at D 32), which wgmma reads directly:
//   S = Q K^T and dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV)
//   are m64nNk16 products with A and B from shared memory, both K-major.
//   dS (and W_drop) come from the accumulators in registers: the m64nN
//   accumulator, packed in pairs with cvt.rn.bf16x2, is the register A
//   operand, and the streamed tile is read MN-major through wgmma's
//   transpose bit (bf16 allows either major order for B, which tf32 does
//   not; see flash_bwd_f32.cuh) for dQ += dS K, dV += W_drop^T dO and dK += dS^T Q.
// - The CUDA-core pass: exp is ex2.approx with log2 e folded into lse and
//   the scale; tiles wholly inside T and below the diagonal run without
//   the mask tests. The two warpgroups take turns issuing a tile's S and
//   dP (named barriers), so that one's pass runs while the other's
//   products use the tensor cores.
// - Each warpgroup writes its dQ (dK and dV) tile into its own resident
//   slot, free once its products are done, in TMA's layout, and one
//   bulk TMA store sends it out (rows past T clipped): scattered 4-byte
//   stores of the outputs held dK/dV's pipeline back more than anything
//   else.
// - Tried and not kept: a warpgroup issuing the next tile's S and dP
//   behind this tile's register-A products (ptxas gives their A operand
//   the registers of the dead dP accumulator and then serializes every
//   wgmma, C7515/C7518); one consumer warpgroup a block at two blocks an
//   SM (dK/dV's accumulators spilled); 128-key dQ tiles (no faster,
//   causal slower); dropping lse and delta loads' latency was not what
//   held dK/dV back (its epilogue was).
// - Known limit: at D 128 ptxas spills about 600 bytes in dK/dV and
//   serializes its wgmmas (C7512); D 128 is correct, and off the main
//   path (the repo's models run D 64).
// - causal: key (query) tiles past (before) the item's rows are not
//   loaded, a warpgroup skips the tiles it cannot see, and the diagonal
//   tile is masked. No atomics and a fixed order of every sum: two
//   launches give equal bits. Any T >= 1.
// - Head dims: every multiple of 8 from 8 to 256, in tiles of width 32,
//   64, 128 or 256 (ptt_hopper::bf16_width: one 64-byte-swizzled panel or
//   128-byte-swizzled 64-column ones; a width of 16, 48, 80 or 96 would
//   need the 32-byte swizzle or panels of mixed width, so D 8 pads to 32,
//   4x its products, D 72 to 128, 1.78x, D 136 to 256, 1.88x). The kernel
//   of width D serves every head dim d it covers unchanged: the tensor
//   maps have inner dimension d and boxes a panel wide, so TMA fills the
//   columns d..D of every loaded tile with zeros (their products add
//   zeros) and clips them from every store; nothing is copied or padded
//   outside the kernel, and D 32, 64 and 128 are the exact instantiations.
// - D 256 (new instantiations): dQ's, dK's or dV's accumulator is 128
//   floats a thread, which the 168 registers ptxas gives a thread of a
//   384-thread block cannot hold beside the scores. A block is then one
//   consumer warpgroup and the producer (256 threads, 255 registers, no
//   setmaxnreg, no ping-pong: consumer_wgs), its streamed tiles 32 rows
//   (bn_dq, bn_dkv) in a two-stage ring: 197,696 B of shared memory for
//   dQ, 198,464 for dK/dV (four resident and double-buffered 64 x 256
//   tiles are 128 KB). dK and dV together would be 256 floats a thread,
//   so dK/dV launches twice, as the float32 kernel does: a dV launch
//   (S^T and W_drop^T dO, no dP^T) and a dK launch (DKV16_*). The m64n256
//   products take P, dS or W_drop as register A (wgmma_rs at N 256).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace ptt_flash;
using namespace ptt_mma;

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed shared memory (wgmma_bf16.cuh)
// ---------------------------------------------------------------------------

using ptt_mma_bf16::bf16;
using ptt_mma_bf16::pack_bf16;

namespace bf16w {

using namespace ptt_hopper;

constexpr int WG_ROWS = 64;       // resident rows a consumer warpgroup owns
constexpr float LOG2E = 1.4426950408889634f;

// Consumer warpgroups a block: 2, and 1 at D 256, whose dQ (or dK, or dV)
// accumulator is 128 registers a thread, more than the 168 that ptxas gives
// a thread of a 384-thread block can hold beside the scores; a block of
// one consumer and the producer (256 threads) compiles for 255.
template <int D>
__host__ __device__ constexpr int consumer_wgs() { return D > 128 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int block_rows() {   // rows of a work item
  return consumer_wgs<D>() * WG_ROWS;
}
template <int D>
__host__ __device__ constexpr int consumers() { return 128 * consumer_wgs<D>(); }
template <int D>
__host__ __device__ constexpr int threads() {   // + a producer warpgroup
  return consumers<D>() + 128;
}

// One block an SM: 168 registers a thread at launch (65536 / 384). The
// producer warpgroup gives most of its share to the consumers:
// 2 x 128 x 232 + 128 x 32 <= 384 x 168. (A block of one consumer
// warpgroup has 255 from the start and moves none.)
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 232;

// streamed rows a tile: dQ 64 keys, 32 at D 256; dK/dV 64 queries, 32 at
// D 128 and 256 (where dK and dV take 64 registers each, or one of them
// 128)
template <int D>
__host__ __device__ constexpr int bn_dq() { return D > 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int bn_dkv() {
  return D >= 128 ? 32 : 64;
}
// ring stages: 4 (the whole K/V of a head at T 256, D 64), 2 for dQ's
// 32 KB tiles at D 128 and at D 256 for both (shared memory)
template <int D>
__host__ __device__ constexpr int stages_dq() { return D >= 128 ? 2 : 4; }
template <int D>
__host__ __device__ constexpr int stages_dkv() { return D > 128 ? 2 : 4; }

// What a dK/dV launch accumulates: both (D <= 128), or, at D 256, where
// dK and dV together would be 256 floats a thread, dV in a first launch
// and dK in a second (the launch makes both, in that order).
constexpr int DKV16_BOTH = 0, DKV16_DV = 1, DKV16_DK = 2;

// resident tiles: two tensors x two buffers (an item's and the next
// one's) x the warpgroups' 64 rows; then the ring; then the barriers.
// D 256: 128 KB resident and a two-stage ring of 32-row tiles (64 KB).
template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + 4 * consumer_wgs<D>() * tile_bytes<D>(WG_ROWS) +
         2 * stages_dq<D>() * tile_bytes<D>(bn_dq<D>()) +
         8 * (4 + 2 * stages_dq<D>());
}

template <int D>
__host__ __device__ constexpr size_t dkv_smem() {
  return 1024 + 4 * consumer_wgs<D>() * tile_bytes<D>(WG_ROWS) +
         2 * stages_dkv<D>() * tile_bytes<D>(bn_dkv<D>()) +
         3 * stages_dkv<D>() * bn_dkv<D>() * sizeof(float) +
         8 * (4 + 2 * stages_dkv<D>());
}

// x = A_x B_x^T and, with PAIR, y = A_y B_y^T for streamed tile i (ring
// stage i % ST) once it has landed, 64 x BN each, committed as one group:
// A_x and A_y are this warpgroup's resident tiles, B_x and B_y the ring's
// bases
template <int D, int BN, int ST, bool PAIR = true>
__device__ __forceinline__ void issue_pair(float (&x)[BN / 2],
                                           float (&y)[BN / 2],
                                           const unsigned char* ax,
                                           const unsigned char* ay,
                                           const unsigned char* bx,
                                           const unsigned char* by,
                                           uint64_t* full, int i) {
  constexpr int STR = tile_bytes<D>(BN);
  const int s = i % ST;
  mbar_wait(full + s, (i / ST) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(x, desc_k<D>(ax, WG_ROWS, kk), desc_k<D>(bx + s * STR, BN, kk),
                kk);
  if constexpr (PAIR) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(y, desc_k<D>(ay, WG_ROWS, kk),
                  desc_k<D>(by + s * STR, BN, kk), kk);
  }
  wgmma_commit();
}

// dS in place of S (dQ), float32: register 4 j + e is row[e >> 1], key
// column k0 + 8 j + 2 t + (e & 1). MASK: rows and columns past T, and
// above the diagonal under causal masking, weigh 0.
template <int BN, bool DROP, bool MASK>
__device__ __forceinline__ void dq_scores(
    float (&sc)[BN / 2], const float (&dp)[BN / 2], int k0, int t,
    const int (&row)[2], const float (&lse2)[2], const float (&delta_r)[2],
    const uint32_t (&rkey)[2], int T, int causal, float sm_scale, float sl2,
    uint32_t thresh, float drop_scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      float w = ex2(sc[4 * j + e] * sl2 - lse2[h]);
      if (MASK && !(row[h] < T && col < T && !(causal && col > row[h])))
        w = 0.f;
      float dw = dp[4 * j + e];
      if (DROP) dw = keep(rkey[h], col, thresh) ? dw * drop_scale : 0.f;
      sc[4 * j + e] = w * (dw - delta_r[h]) * sm_scale;
    }
}

// W_drop^T in place of S^T, dS^T in place of dP^T (dK/dV), float32:
// register 4 j + e is key row krow[e >> 1], query column
// q0 + 8 j + 2 t + (e & 1). MASK as in dq_scores. PART: W_drop^T alone
// (DKV16_DV) or dS^T alone (DKV16_DK), or both.
template <int BN, bool DROP, bool MASK, int PART = DKV16_BOTH>
__device__ __forceinline__ void dkv_scores(
    float (&sc)[BN / 2], float (&dp)[BN / 2], const float* lse_t,
    const float* delta_t, const uint32_t* rk_t, int q0, int t,
    const int (&krow)[2], int T, int causal, float sm_scale, float sl2,
    uint32_t thresh, float drop_scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int qc = 8 * j + 2 * t + p;
      const int qrow = q0 + qc;
      const uint32_t rk = DROP ? rk_t[qc] : 0u;
      const float lse_q = lse_t[qc] * LOG2E;
      const float delta_q = delta_t[qc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * h + p;
        float w = ex2(sc[4 * j + e] * sl2 - lse_q);
        if (MASK && !(qrow < T && krow[h] < T && !(causal && krow[h] > qrow)))
          w = 0.f;
        float wd = w, dw = PART != DKV16_DV ? dp[4 * j + e] : 0.f;
        if (DROP) {
          const bool kp = keep(rk, krow[h], thresh);
          wd = kp ? w * drop_scale : 0.f;
          dw = kp ? dw * drop_scale : 0.f;
        }
        if (PART != DKV16_DK) sc[4 * j + e] = wd;
        if (PART != DKV16_DV) dp[4 * j + e] = w * (dw - delta_q) * sm_scale;
      }
    }
}

// One dQ tile (key tile kt, ring index i) once its S (in sc) and dP (in
// dp) have been issued: wait for them, turn S into dS in registers, run
// dQ += dS K (dS rounded to bf16 as A from registers, K MN-major) and
// release the tile's stage.
template <int D, int BN, int ST, bool DROP>
__device__ __forceinline__ void dq_tile(
    float (&sc)[BN / 2], float (&dp)[BN / 2], float (&acc)[D / 2],
    const unsigned char* Ks, uint64_t* empty, int i, int kt,
    const int (&row)[2], const float (&lse2)[2],
    const float (&delta_r)[2], const uint32_t (&rkey)[2], int t, int T,
    int causal, float sm_scale, float sl2, uint32_t thresh,
    float drop_scale) {
  constexpr int STR = tile_bytes<D>(BN);
  const int s = i % ST;
  const int k0 = kt * BN;
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);

  // masks only on a tile that reaches past T or crosses the diagonal
  const int r0 = row[0] - row[0] % WG_ROWS;   // the warpgroup's first row
  if (k0 + BN > T || r0 + WG_ROWS > T || (causal && k0 + BN - 1 > r0))
    dq_scores<BN, DROP, true>(sc, dp, k0, t, row, lse2, delta_r, rkey, T,
                              causal, sm_scale, sl2, thresh, drop_scale);
  else
    dq_scores<BN, DROP, false>(sc, dp, k0, t, row, lse2, delta_r, rkey, T,
                               causal, sm_scale, sl2, thresh, drop_scale);

  uint32_t a[BN / 16][4];
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) acc_to_a(sc, jj, a[jj]);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj)
    wgmma_rs<1>(acc, a[jj], desc_mn<D>(Ks + s * STR, BN, jj), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(empty + s);   // this stage's K and V are read
}

// One dK/dV tile (query tile qt, ring index i) once its S^T and dP^T
// have been issued: wait for them, turn them into W_drop^T and dS^T in
// registers, run dV += W_drop^T dO and dK += dS^T Q (both rounded to bf16
// as A from registers, dO and Q MN-major) and release the tile's stage.
template <int D, int BN, int ST, bool DROP, int PART = DKV16_BOTH>
__device__ __forceinline__ void dkv_tile(
    float (&sc)[BN / 2], float (&dp)[BN / 2], float (&dk_acc)[D / 2],
    float (&dv_acc)[D / 2], const unsigned char* Qs,
    const unsigned char* dOs, const float* lse_s, const float* delta_s,
    const uint32_t* rk_s, uint64_t* empty, int i, int qt,
    const int (&krow)[2], int t, int T, int causal, float sm_scale,
    float sl2, uint32_t thresh, float drop_scale) {
  constexpr int STR = tile_bytes<D>(BN);
  const int s = i % ST;
  const float* lse_t = lse_s + s * BN;
  const float* delta_t = delta_s + s * BN;
  const uint32_t* rk_t = rk_s + s * BN;
  const int q0 = qt * BN;
  constexpr bool DV = PART != DKV16_DK, DK = PART != DKV16_DV;
  wgmma_wait<0>();
  fence_regs(sc);
  if constexpr (DK) fence_regs(dp);

  // masks only on a tile that reaches past T or crosses the diagonal
  const int kr0 = krow[0] - krow[0] % WG_ROWS;   // the warpgroup's first key
  if (q0 + BN > T || kr0 + WG_ROWS > T || (causal && kr0 + WG_ROWS - 1 > q0))
    dkv_scores<BN, DROP, true, PART>(sc, dp, lse_t, delta_t, rk_t, q0, t,
                                     krow, T, causal, sm_scale, sl2, thresh,
                                     drop_scale);
  else
    dkv_scores<BN, DROP, false, PART>(sc, dp, lse_t, delta_t, rk_t, q0, t,
                                      krow, T, causal, sm_scale, sl2, thresh,
                                      drop_scale);

  uint32_t wa[BN / 16][4], sa[BN / 16][4];
#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    if constexpr (DV) acc_to_a(sc, jj, wa[jj]);
    if constexpr (DK) acc_to_a(dp, jj, sa[jj]);
  }
  if constexpr (DV) fence_regs(dv_acc);
  if constexpr (DK) fence_regs(dk_acc);
  wgmma_fence();
  if constexpr (DV) {
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj)
      wgmma_rs<1>(dv_acc, wa[jj], desc_mn<D>(dOs + s * STR, BN, jj), 1);
  }
  if constexpr (DK) {
#pragma unroll
    for (int jj = 0; jj < BN / 16; ++jj)
      wgmma_rs<1>(dk_acc, sa[jj], desc_mn<D>(Qs + s * STR, BN, jj), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (DV) fence_regs(dv_acc);
  if constexpr (DK) fence_regs(dk_acc);
  mbar_arrive(empty + s);   // this stage's Q, dO, lse, delta, keys are read
}

// Work item w of a persistent block: row block rb (BLOCK_ROWS query rows
// for dQ, key rows for dK/dV) of head bh. The row blocks of a head are
// neighbouring items, so blocks running side by side read one head's
// streamed tiles together (one read from memory, the rest from L2). The
// launch makes the grid a multiple of n_rb when it can; each round of
// the grid then holds whole heads, and odd rounds take a head's row blocks
// in reverse, so that under causal masking every block alternates costly
// and cheap items.
__device__ __forceinline__ void work_item(int w, int n_rb, int& rb,
                                          int& bh) {
  bh = w / n_rb;
  rb = w - bh * n_rb;
  if (gridDim.x % n_rb == 0 && ((w / gridDim.x) & 1)) rb = n_rb - 1 - rb;
}

}  // namespace bf16w

template <int D, bool DROP>
__global__ void __launch_bounds__(bf16w::threads<D>(), 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dq,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int n_bh, int T,
                     float sm_scale, int causal,
                     uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale) {
  using namespace bf16w;
  constexpr int BN = bn_dq<D>(), ST = stages_dq<D>(), PW = panel_cols<D>();
  constexpr int RES = tile_bytes<D>(WG_ROWS), STR = tile_bytes<D>(BN);
  constexpr int CONSUMER_WGS = consumer_wgs<D>(), CONSUMERS = consumers<D>();
  constexpr int BLOCK_ROWS = block_rows<D>();
  constexpr bool TURNS = CONSUMER_WGS == 2;   // ping-pong, see below
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);         // [2][CONSUMER_WGS][RES]
  unsigned char* dOs = Qs + 2 * CONSUMER_WGS * RES;  // [2][CONSUMER_WGS][RES]
  unsigned char* Ks = dOs + 2 * CONSUMER_WGS * RES;  // [ST][STR]
  unsigned char* Vs = Ks + ST * STR;                 // [ST][STR]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(Vs + ST * STR);  // [2]
  uint64_t* res_empty = res_full + 2;              // [2]
  uint64_t* full = res_empty + 2;                  // [ST]
  uint64_t* empty = full + ST;                     // [ST]

  const int tid = threadIdx.x;
  const int n_kv = (T + BN - 1) / BN;
  const int n_rb = (T + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_items = n_rb * n_bh;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full + b, 1);
      mbar_init(res_empty + b, CONSUMERS);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: per item, each warpgroup's Q and dO into the item's
    // resident buffer, then K and V tiles through the ring
    if constexpr (TURNS) setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int g = 0;   // tiles issued
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int rb, bh;
        work_item(w, n_rb, rb, bh);
        const int q0 = rb * BLOCK_ROWS;
        // causal: key tiles past the item's last query row are not loaded
        const int n_tiles =
            causal ? min(n_kv, (q0 + BLOCK_ROWS - 1) / BN + 1) : n_kv;
        const int b = it & 1;
        mbar_wait(res_empty + b, ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(res_full + b, 2 * CONSUMER_WGS * RES);
        for (int c = 0; c < CONSUMER_WGS; ++c) {
          const int r = q0 + c * WG_ROWS;
          tma_tile<D>(Qs + (b * CONSUMER_WGS + c) * RES, &tm_q,
                      res_full + b, r, bh, WG_ROWS);
          tma_tile<D>(dOs + (b * CONSUMER_WGS + c) * RES, &tm_do,
                      res_full + b, r, bh, WG_ROWS);
        }
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
    if constexpr (TURNS) setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = 16 * warp + g;   // this thread's rows: wr, wr + 8
    const float sl2 = sm_scale * LOG2E;
    // Ping-pong: the two warpgroups take turns issuing a tile's first
    // products (named barriers 1 and 2), so each one's CUDA-core pass
    // runs while the other's products use the tensor cores. Every tile,
    // computed or skipped, takes a turn; warpgroup 0 has the first. (One
    // consumer warpgroup, D 256: no turns.)
    if (TURNS && wg == 1) named_bar_arrive(1, CONSUMERS);
    int gt = 0;   // tiles consumed

    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      int rb, bh;
      work_item(w, n_rb, rb, bh);
      const int q0 = rb * BLOCK_ROWS;
      const int n_tiles =
          causal ? min(n_kv, (q0 + BLOCK_ROWS - 1) / BN + 1) : n_kv;
      const int r0 = q0 + wg * WG_ROWS;   // this warpgroup's first row
      // key tiles this warpgroup reads; it only releases the others
      const int my_tiles =
          r0 >= T ? 0 : causal ? min(n_tiles, (r0 + WG_ROWS - 1) / BN + 1)
                               : n_tiles;
      const size_t rbase = (size_t)bh * T;
      const int row[2] = {r0 + wr, r0 + wr + 8};
      float lse2[2], delta_r[2];
      uint32_t rkey[2];
      const uint32_t bk = DROP ? bh_key(seed, bh0 + bh) : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[h] = row[h] < T ? lse[rbase + row[h]] * LOG2E : 0.f;
        delta_r[h] = row[h] < T ? delta[rbase + row[h]] : 0.f;
        rkey[h] = DROP ? row_key(bk, row[h]) : 0u;
      }

      float acc[D / 2];   // dQ, 64 x D
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      const int b = it & 1;
      const unsigned char* Qw = Qs + (b * CONSUMER_WGS + wg) * RES;
      const unsigned char* dOw = dOs + (b * CONSUMER_WGS + wg) * RES;
      mbar_wait(res_full + b, (it >> 1) & 1);
      // per tile: S = Q K^T and dP = dO V^T (64 x BN each, A from shared
      // memory, K and V K-major), then dq_tile
      float sc[BN / 2], dp[BN / 2];
      for (int kt = 0; kt < my_tiles; ++kt) {
        if (TURNS) named_bar_sync(1 + wg, CONSUMERS);   // this warpgroup's turn
        issue_pair<D, BN, ST>(sc, dp, Qw, dOw, Ks, Vs, full, gt + kt);
        if (TURNS) named_bar_arrive(2 - wg, CONSUMERS);   // the other's turn
        dq_tile<D, BN, ST, DROP>(sc, dp, acc, Ks, empty, gt + kt, kt, row,
                                 lse2, delta_r, rkey, t, T, causal, sm_scale,
                                 sl2, thresh, drop_scale);
      }
      // tiles past this warpgroup's rows (causal) or all (rows >= T): the
      // turns are taken all the same
      for (int kt = my_tiles; kt < n_tiles; ++kt) {
        const int s = (gt + kt) % ST;
        if (TURNS) {
          named_bar_sync(1 + wg, CONSUMERS);
          named_bar_arrive(2 - wg, CONSUMERS);
        }
        mbar_wait(full + s, ((gt + kt) / ST) & 1);
        mbar_arrive(empty + s);
      }
      gt += n_tiles;
      // dQ out: this warpgroup's Q slot is free (its products are done);
      // the tile goes in as TMA lays it out and leaves by one bulk store,
      // rows past T clipped
      if (r0 < T) {
        unsigned char* out = Qs + (b * CONSUMER_WGS + wg) * RES;
        store_acc_tile<D>(out, acc, warp, g, t);
        fence_proxy_async();
        named_bar_sync(3 + wg, 128);
        if ((tid & 127) == 0) {
#pragma unroll
          for (int p = 0; p < D / PW; ++p)
            tma_store_3d(&tm_dq, out + p * WG_ROWS * PW * 2, p * PW, r0, bh);
          tma_store_commit();
          tma_store_wait<true>();   // before the slot is released
        }
      }
      mbar_arrive(res_empty + b);   // Q and dO of this item are read
    }
    if ((tid & 127) == 0) tma_store_wait<false>();
  }
}

template <int D, bool DROP, int PART>
__global__ void __launch_bounds__(bf16w::threads<D>(), 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_dk,
                      const __grid_constant__ CUtensorMap tm_dv,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int n_bh, int T,
                      float sm_scale, int causal, uint32_t seed, uint32_t bh0,
                      uint32_t thresh,
                      float drop_scale) {
  using namespace bf16w;
  constexpr int BN = bn_dkv<D>(), ST = stages_dkv<D>(), PW = panel_cols<D>();
  constexpr int RES = tile_bytes<D>(WG_ROWS), STR = tile_bytes<D>(BN);
  constexpr int CONSUMER_WGS = consumer_wgs<D>(), CONSUMERS = consumers<D>();
  constexpr int BLOCK_ROWS = block_rows<D>();
  constexpr bool TURNS = CONSUMER_WGS == 2;   // ping-pong, as in dQ
  constexpr bool DV = PART != DKV16_DK, DK = PART != DKV16_DV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);         // [2][CONSUMER_WGS][RES]
  unsigned char* Vs = Ks + 2 * CONSUMER_WGS * RES;   // [2][CONSUMER_WGS][RES]
  unsigned char* Qs = Vs + 2 * CONSUMER_WGS * RES;   // [ST][STR]
  unsigned char* dOs = Qs + ST * STR;                // [ST][STR]
  float* lse_s = reinterpret_cast<float*>(dOs + ST * STR);   // [ST][BN]
  float* delta_s = lse_s + ST * BN;                          // [ST][BN]
  uint32_t* rk_s =
      reinterpret_cast<uint32_t*>(delta_s + ST * BN);         // [ST][BN]
  uint64_t* res_full = reinterpret_cast<uint64_t*>(rk_s + ST * BN);
  uint64_t* res_empty = res_full + 2;              // [2]
  uint64_t* full = res_empty + 2;                  // [ST]
  uint64_t* empty = full + ST;                     // [ST]

  const int tid = threadIdx.x;
  const int n_q = (T + BN - 1) / BN;
  const int n_rb = (T + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int n_items = n_rb * n_bh;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full + b, 1);
      mbar_init(res_empty + b, CONSUMERS);
    }
    for (int s = 0; s < ST; ++s) {
      // the producer warp's 32 cp.async arrivals and its lane 0's
      // arrival with the TMA bytes
      mbar_init(full + s, 33);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warp: per item, each warpgroup's K and V into the item's
    // resident buffer, then Q and dO tiles by TMA and their lse, delta and
    // dropout row keys, through the ring
    if constexpr (TURNS) setmaxnreg_dec<PRODUCER_REGS>();
    const int lane = tid - CONSUMERS;
    if (lane < 32) {
      int g = 0;   // tiles issued
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int rb, bh;
        work_item(w, n_rb, rb, bh);
        const int k0 = rb * BLOCK_ROWS;
        const size_t rbase = (size_t)bh * T;
        // causal: query tiles ending before the item's first key row see
        // none of it; k0 is a multiple of BN
        const int qt0 = causal ? k0 / BN : 0;
        const int b = it & 1;
        if (lane == 0) {
          mbar_wait(res_empty + b, ((it >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(res_full + b, 2 * CONSUMER_WGS * RES);
          for (int c = 0; c < CONSUMER_WGS; ++c) {
            const int r = k0 + c * WG_ROWS;
            tma_tile<D>(Ks + (b * CONSUMER_WGS + c) * RES, &tm_k,
                        res_full + b, r, bh, WG_ROWS);
            tma_tile<D>(Vs + (b * CONSUMER_WGS + c) * RES, &tm_v,
                        res_full + b, r, bh, WG_ROWS);
          }
        }
        const uint32_t bk = DROP ? bh_key(seed, bh0 + bh) : 0u;
        for (int qt = qt0; qt < n_q; ++qt, ++g) {
          const int s = g % ST;
          const int r0 = qt * BN;
          mbar_wait(empty + s, ((g / ST) & 1) ^ 1);
          // lse and delta by cp.async, which arrives on the stage's full
          // barrier once they have landed (no load latency held here);
          // the dropout row keys (flash_common.cuh) computed and stored
#pragma unroll
          for (int c = 0; c < BN / 32; ++c) {
            const int j = lane + 32 * c, r = r0 + j;
            const size_t src = rbase + (r < T ? r : 0);
            cp_async4(lse_s + s * BN + j, lse + src, r < T);
            cp_async4(delta_s + s * BN + j, delta + src, r < T);
            if (DROP) rk_s[s * BN + j] = row_key(bk, r);
          }
          cp_async_mbar_arrive(full + s);
          __syncwarp();   // every lane's row keys before lane 0's arrival
          if (lane == 0) {
            mbar_arrive_expect_tx(full + s, 2 * STR);
            tma_tile<D>(Qs + s * STR, &tm_q, full + s, r0, bh, BN);
            tma_tile<D>(dOs + s * STR, &tm_do, full + s, r0, bh, BN);
          }
        }
      }
    }
  } else {
    if constexpr (TURNS) setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr = 16 * warp + g;   // this thread's key rows: wr, wr + 8
    const float sl2 = sm_scale * LOG2E;
    // Ping-pong: the two warpgroups take turns issuing a tile's first
    // products (named barriers 1 and 2), so each one's CUDA-core pass
    // runs while the other's products use the tensor cores. Every tile,
    // computed or skipped, takes a turn; warpgroup 0 has the first.
    if (TURNS && wg == 1) named_bar_arrive(1, CONSUMERS);
    int gt = 0;   // tiles consumed

    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      int rb, bh;
      work_item(w, n_rb, rb, bh);
      const int k0 = rb * BLOCK_ROWS;
      const int qt0 = causal ? k0 / BN : 0;
      const int kr0 = k0 + wg * WG_ROWS;   // this warpgroup's first key row
      // the first query tile this warpgroup reads (causal: the first that
      // reaches its key rows); it only releases the ones before it
      const int my_qt0 = kr0 >= T ? n_q : causal ? kr0 / BN : qt0;
      const int krow[2] = {kr0 + wr, kr0 + wr + 8};

      float dk_acc[D / 2], dv_acc[D / 2];   // 64 x D each (PART: one)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        if constexpr (DK) dk_acc[i] = 0.f;
        if constexpr (DV) dv_acc[i] = 0.f;
      }

      for (int qt = qt0; qt < my_qt0; ++qt) {
        const int s = (gt + qt - qt0) % ST;
        if (TURNS) {
          named_bar_sync(1 + wg, CONSUMERS);   // turns as in the dQ kernel
          named_bar_arrive(2 - wg, CONSUMERS);
        }
        mbar_wait(full + s, ((gt + qt - qt0) / ST) & 1);
        mbar_arrive(empty + s);
      }
      const int b = it & 1;
      const unsigned char* Kw = Ks + (b * CONSUMER_WGS + wg) * RES;
      const unsigned char* Vw = Vs + (b * CONSUMER_WGS + wg) * RES;
      mbar_wait(res_full + b, (it >> 1) & 1);
      // per tile: S^T = K Q^T and dP^T = V dO^T (64 keys x BN queries
      // each, A from shared memory, Q and dO K-major), then dkv_tile
      float sc[BN / 2], dp[BN / 2];
      for (int qt = my_qt0; qt < n_q; ++qt) {
        const int i = gt + qt - qt0;
        if (TURNS) named_bar_sync(1 + wg, CONSUMERS);
        // dP^T = V dO^T feeds dS^T only
        issue_pair<D, BN, ST, DK>(sc, dp, Kw, Vw, Qs, dOs, full, i);
        if (TURNS) named_bar_arrive(2 - wg, CONSUMERS);
        dkv_tile<D, BN, ST, DROP, PART>(sc, dp, dk_acc, dv_acc, Qs, dOs,
                                        lse_s, delta_s, rk_s, empty, i, qt,
                                        krow, t, T, causal, sm_scale, sl2,
                                        thresh, drop_scale);
      }
      gt += n_q - qt0;
      // dK and dV out through this warpgroup's K and V slots, as in the
      // dQ kernel
      if (kr0 < T) {
        unsigned char* ok = Ks + (b * CONSUMER_WGS + wg) * RES;
        unsigned char* ov = Vs + (b * CONSUMER_WGS + wg) * RES;
        if constexpr (DK) store_acc_tile<D>(ok, dk_acc, warp, g, t);
        if constexpr (DK && DV)
          fence_regs(dv_acc);   // dV's packing after dK's stores (registers)
        if constexpr (DV) store_acc_tile<D>(ov, dv_acc, warp, g, t);
        fence_proxy_async();
        named_bar_sync(3 + wg, 128);
        if ((tid & 127) == 0) {
#pragma unroll
          for (int p = 0; p < D / PW; ++p) {
            if constexpr (DK)
              tma_store_3d(&tm_dk, ok + p * WG_ROWS * PW * 2, p * PW, kr0, bh);
            if constexpr (DV)
              tma_store_3d(&tm_dv, ov + p * WG_ROWS * PW * 2, p * PW, kr0, bh);
          }
          tma_store_commit();
          tma_store_wait<true>();   // before the slots are released
        }
      }
      mbar_arrive(res_empty + b);   // K and V of this item are read
    }
    if ((tid & 127) == 0) tma_store_wait<false>();
  }
}

// ---- host: tensor maps and launches ----------------------------------------

using ptt_hopper::encode_bf16_map;
using ptt_hopper::persistent_blocks;

// the four maps of q, k, v, dout: `res_rows`-row boxes for the two
// resident tensors (q, dout for dQ; k, v for dK/dV), `str_rows` for the
// streamed ones; d the head dim (D unless a padded width)
template <int D>
int encode_bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                    const void* v, const void* dout, int bh, int T, int d,
                    bool q_resident, int str_rows) {
  const int rq = q_resident ? 64 : str_rows, rk = q_resident ? str_rows : 64;
  int err;
  if ((err = encode_bf16_map<D>(&m[0], q, bh, T, rq, d))) return err;
  if ((err = encode_bf16_map<D>(&m[1], k, bh, T, rk, d))) return err;
  if ((err = encode_bf16_map<D>(&m[2], v, bh, T, rk, d))) return err;
  return encode_bf16_map<D>(&m[3], dout, bh, T, rq, d);
}

// D: the instantiation's width; d: the head dim (d < D: a padded width,
// whose columns d..D the tensor maps zero-fill on the way in and clip on
// the way out; the kernel is the one of width D)
template <int D>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   bf16* dq, int bh, int T, int d, float sm_scale, int causal,
                   uint32_t seed, uint32_t bh0, uint32_t thresh, float drop_scale,
                   cudaStream_t stream) {
  CUtensorMap m[4], mdq;
  int err = encode_bwd_maps<D>(m, q, k, v, dout, bh, T, d, true,
                               bf16w::bn_dq<D>());
  if (err || (err = encode_bf16_map<D>(&mdq, dq, bh, T, bf16w::WG_ROWS, d)))
    return err;
  const size_t smem = bf16w::dq_smem<D>();
  auto kernel = thresh ? flash_dq_bf16_kernel<D, true>
                       : flash_dq_bf16_kernel<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks;
  if ((err = persistent_blocks(
           (T + bf16w::block_rows<D>() - 1) / bf16w::block_rows<D>(), bh,
           &blocks)))
    return err;
  kernel<<<blocks, bf16w::threads<D>(), smem, stream>>>(
      m[0], m[1], m[2], m[3], mdq, lse, delta, bh, T, sm_scale, causal,
      seed, bh0, thresh, drop_scale);
  return (int)cudaGetLastError();
}

template <int D, int PART>
int launch_dkv_bf16_part(const CUtensorMap (&m)[4], const CUtensorMap& mdk,
                         const CUtensorMap& mdv, const float* lse,
                         const float* delta, int bh, int T, float sm_scale,
                         int causal, uint32_t seed, uint32_t bh0,
                         uint32_t thresh, float drop_scale,
                         cudaStream_t stream) {
  const size_t smem = bf16w::dkv_smem<D>();
  auto kernel = thresh ? flash_dkv_bf16_kernel<D, true, PART>
                       : flash_dkv_bf16_kernel<D, false, PART>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks, err;
  if ((err = persistent_blocks(
           (T + bf16w::block_rows<D>() - 1) / bf16w::block_rows<D>(), bh,
           &blocks)))
    return err;
  kernel<<<blocks, bf16w::threads<D>(), smem, stream>>>(
      m[0], m[1], m[2], m[3], mdk, mdv, lse, delta, bh, T, sm_scale,
      causal, seed, bh0, thresh, drop_scale);
  return (int)cudaGetLastError();
}

// one launch of both, or at D 256 dV's launch, then dK's
template <int D>
int launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, const float* delta,
                    bf16* dk, bf16* dv, int bh, int T, int d, float sm_scale,
                    int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                    float drop_scale, cudaStream_t stream) {
  CUtensorMap m[4], mdk, mdv;
  int err = encode_bwd_maps<D>(m, q, k, v, dout, bh, T, d, false,
                               bf16w::bn_dkv<D>());
  if (err || (err = encode_bf16_map<D>(&mdk, dk, bh, T, bf16w::WG_ROWS, d)) ||
      (err = encode_bf16_map<D>(&mdv, dv, bh, T, bf16w::WG_ROWS, d)))
    return err;
  if constexpr (bf16w::consumer_wgs<D>() == 1) {
    if ((err = launch_dkv_bf16_part<D, bf16w::DKV16_DV>(
             m, mdk, mdv, lse, delta, bh, T, sm_scale, causal, seed, bh0,
             thresh, drop_scale, stream)))
      return err;
    return launch_dkv_bf16_part<D, bf16w::DKV16_DK>(
        m, mdk, mdv, lse, delta, bh, T, sm_scale, causal, seed, bh0, thresh,
        drop_scale, stream);
  } else {
    return launch_dkv_bf16_part<D, bf16w::DKV16_BOTH>(
        m, mdk, mdv, lse, delta, bh, T, sm_scale, causal, seed, bh0, thresh,
        drop_scale, stream);
  }
}

}  // namespace

// As ptt_flash_dq_f32, with q, k, v, dout and dq bf16 ([bh, T, d]); lse
// and delta stay float32. d: any multiple of 8 from 8 to 256
// (ptt_hopper::bf16_width).
extern "C" int ptt_flash_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int T,
                                 int d, float sm_scale, int causal,
                                 uint32_t seed, uint32_t bh0, uint32_t thresh,
                                 float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  bf16* gb = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DQ_BF16(D)                                                       \
  return launch_dq_bf16<D>(qb, kb, vb, ob, lf, df, gb, bh, T, d, sm_scale,   \
                           causal, seed, bh0, thresh, drop_scale, s)
  switch (ptt_hopper::bf16_width(d)) {
    case 32: PTT_DQ_BF16(32);
    case 64: PTT_DQ_BF16(64);
    case 128: PTT_DQ_BF16(128);
    case 256: PTT_DQ_BF16(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_DQ_BF16
}

// As ptt_flash_dq_bf16, writing dk and dv ([bh, T, d] bf16).
extern "C" int ptt_flash_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int T, int d, float sm_scale,
                                  int causal, uint32_t seed, uint32_t bh0, uint32_t thresh,
                                  float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_DKV_BF16(D)                                                      \
  return launch_dkv_bf16<D>(qb, kb, vb, ob, lf, df, gk, gv, bh, T, d,        \
                            sm_scale, causal, seed, bh0, thresh, drop_scale, \
                            s)
  switch (ptt_hopper::bf16_width(d)) {
    case 32: PTT_DKV_BF16(32);
    case 64: PTT_DKV_BF16(64);
    case 128: PTT_DKV_BF16(128);
    case 256: PTT_DKV_BF16(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_DKV_BF16
}

// Dynamic shared memory a block of the bf16 dQ (dkv == 0) or dK/dV
// (dkv != 0) kernel takes at head dim d, in bytes; -1 for another d.
extern "C" int ptt_flash_bwd_bf16_smem_bytes(int dkv, int d) {
  switch (ptt_hopper::bf16_width(d)) {
    case 32: return (int)(dkv ? bf16w::dkv_smem<32>() : bf16w::dq_smem<32>());
    case 64: return (int)(dkv ? bf16w::dkv_smem<64>() : bf16w::dq_smem<64>());
    case 128: return (int)(dkv ? bf16w::dkv_smem<128>() : bf16w::dq_smem<128>());
    case 256: return (int)(dkv ? bf16w::dkv_smem<256>() : bf16w::dq_smem<256>());
    default: return -1;
  }
}
