// Hopper helpers for bf16 kernels on sm_90a: mbarriers, TMA tile loads
// and stores, shared-memory matrix descriptors and warpgroup matrix
// multiplies (wgmma), and on the host the TMA tensor maps and the size of
// a persistent grid; used by the bf16 forward (flash_fwd.cu) and the bf16
// dQ and dK/dV kernels (flash_bwd_bf16.cu).
//
// The pattern they serve: one producer thread keeps TMA loads of tiles in
// flight into a ring of shared-memory stages; a "full" mbarrier of each
// stage completes when its bytes have landed (expect_tx / complete_tx),
// an "empty" one when every consumer thread is done reading it. A
// consumer warpgroup (4 warps, 128 threads) issues wgmma on those tiles,
// asynchronously: the products run on the tensor cores while the warps
// go on, until wgmma_wait.
//
// Tiles are row-major [rows x D] bf16 as TMA writes them with the 128-byte
// swizzle (rows of 64 elements; D 128 and 256 as two or four 64-column
// panels, one after the other) or, at D 32, the 64-byte swizzle (rows of
// 32 elements). A head dim d below the tile's width D (a padded width)
// reaches the kernels as a tile whose columns d..D TMA has zero-filled. Each
// tile starts on a 1024-byte boundary, so the swizzle pattern, which is
// a function of the address, is the one the descriptors assume (base
// offset 0). A tile feeds wgmma in two orientations:
// - K-major (desc_k): the product's reduction runs along the tile's rows
//   (S = Q K^T reads Q and K so). k-step kk of 16 columns starts 32 bytes
//   further along the row, in panel kk / (PW / 16); 8-row groups lie
//   SBO = 8 x row bytes apart.
// - MN-major (desc_mn, wgmma's transpose bit set): the reduction runs down
//   the tile's rows (dQ += dS K reads K so, N = D). k-step jj of 16 rows
//   starts 16 rows further; within it the two 8-row groups lie SBO apart,
//   and the 64-column panels (N = 128) LBO = one panel apart.
//
// Accumulators (m64nN, float32) are N / 2 registers a thread: for lane
// 4 g + t of warp w, register 4 j + e holds row 16 w + g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1) - mma.sync's m16n8 C fragment, one per
// 8-column n-tile. Two neighbouring n-tiles, rounded to bf16 and packed
// in pairs, are the register A operand of one 16-deep k-step (acc_to_a):
// products that take dS or W_drop as A read it from registers.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ptt_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// after the inits, before any thread uses the barriers (then __syncthreads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of parity `parity`. A phase that has not completed
// after 4 s means a lost arrival or transaction count: the kernel traps,
// so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// named barriers (0 is __syncthreads'): `count` threads, a multiple of
// 32, arrive in all; sync waits for the rest, arrive does not
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// ---- TMA -------------------------------------------------------------------

// the box of `map` at coordinates (c0, c1, c2) (innermost first) ->
// shared `dst`, completing its bytes on `bar`; out-of-range elements land
// as zeros and count as bytes too
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared `src` -> the box of `map` at (c0, c1, c2), asynchronously (a
// bulk group); elements past the tensor's extent are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until this thread's committed bulk stores have read their shared
// memory (READ) or also written global memory
template <bool READ>
__device__ __forceinline__ void tma_store_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// this thread's shared-memory writes, made visible to TMA (the async
// proxy), before a barrier after which one thread stores them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 4 bytes global -> shared, asynchronously (cp.async); with `valid`
// false nothing is read and the 4 bytes land as zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on `bar`, made when this thread's cp.asyncs so far have
// landed (it counts against the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// ---- tiles and descriptors -------------------------------------------------

// 64-column panels (the 128-byte swizzle), or one 32-column panel at D 32
// (the 64-byte swizzle)
template <int D>
__host__ __device__ constexpr int panel_cols() {
  return D < 64 ? D : 64;
}

// the descriptor's layout field: 1 = 128-byte swizzle, 2 = 64-byte
template <int D>
__host__ __device__ constexpr uint64_t swizzle_mode() {
  return D < 64 ? 2 : 1;
}

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= mode << 62;
  return d;
}

// k-step kk (columns 16 kk .. 16 kk + 15) of a [rows x D] tile, K-major.
// A k-step's descriptor is the tile's plus its byte offset / 16 in the
// address field (shared addresses stay below 2^18, so it cannot carry):
// one base a tile, and an immediate add a k-step.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows,
                                           int kk) {
  constexpr int PW = panel_cols<D>(), KPP = PW / 16;
  return smem_desc(tile, 16, 8 * PW * 2, swizzle_mode<D>()) +
         (uint64_t)(((kk / KPP) * rows * PW * 2 + (kk % KPP) * 32) >> 4);
}

// k-step jj (rows 16 jj .. 16 jj + 15) of a [rows x D] tile, MN-major (N =
// D): use with the transpose bit
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile,
                                            int rows, int jj) {
  constexpr int PW = panel_cols<D>();
  return smem_desc(tile, rows * PW * 2, 8 * PW * 2, swizzle_mode<D>()) +
         (uint64_t)((jj * 16 * PW * 2) >> 4);
}

// [rows x D] bf16 tile, TMA'd as panel_cols<D>()-wide panels
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// rows [r0, r0 + rows) of head bh of `map` -> the tile at `dst`, one TMA
// load a panel, completing on `bar`
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int r0, int bh,
                                         int rows) {
  constexpr int PW = panel_cols<D>();
#pragma unroll
  for (int p = 0; p < D / PW; ++p)
    tma_load_3d(dst + p * rows * PW * 2, map, bar, p * PW, r0, bh);
}

// the first 1024-byte boundary at or after p (a swizzled tile's start)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The m64 x D float32 accumulator (register 4 n + e: row 16 warp + g +
// 8 (e >> 1), column 8 n + 2 t + (e & 1)) rounded to bf16 into a 64-row
// tile laid out as TMA writes it (desc_k's layout): panel n / (PW / 8),
// 16-byte chunk n % (PW / 8) of its row, swizzled by the row (the XOR of
// address bits 7.. into bits 4..). The addresses are made from a base the
// compiler cannot see through, here and not earlier: otherwise it keeps
// them in registers across the tile loop before (and spills there).
template <int D>
__device__ __forceinline__ void store_acc_tile(unsigned char* tile,
                                               const float (&acc)[D / 2],
                                               int warp, int g, int t) {
  constexpr int SW = panel_cols<D>() * 2;   // bytes a row of a panel
  constexpr int CPR = SW / 16;              // 16-byte chunks a row
  uint32_t base = smem_u32(tile);
  asm volatile("" : "+r"(base));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t r = 16 * warp + g + 8 * h;
    const uint32_t row = base + r * SW + t * 4;
    const uint32_t x = (((r * SW) >> 7) & (CPR - 1)) << 4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t addr = row + (n / CPR) * 64 * SW + (((n % CPR) << 4) ^ x);
      asm volatile("st.shared.b32 [%0], %1;"
                   :: "r"(addr),
                      "r"(ptt_mma_bf16::pack_bf16(acc[4 * n + 2 * h],
                                                  acc[4 * n + 2 * h + 1]))
                   : "memory");
    }
  }
}

// ---- wgmma -----------------------------------------------------------------

// before the first wgmma of a batch: orders this warpgroup's earlier
// register and shared-memory writes before the products read them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// until at most N committed groups of this warp are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// pins accumulator registers at this point of the program, so the
// compiler neither reads them before a wgmma_wait nor writes them after
// an issue
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// registers of this warpgroup: the producer gives some up, the consumer
// takes them (all four warps of the warpgroup together)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(R));
}

// the accumulator registers of n-tiles 2 jj and 2 jj + 1 (columns 16 jj ..
// 16 jj + 15), rounded to bf16, as the register A operand of a k-step
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&c)[R], int jj,
                                         uint32_t (&a)[4]) {
  using ptt_mma_bf16::pack_bf16;
  a[0] = pack_bf16(c[8 * jj + 0], c[8 * jj + 1]);
  a[1] = pack_bf16(c[8 * jj + 2], c[8 * jj + 3]);
  a[2] = pack_bf16(c[8 * jj + 4], c[8 * jj + 5]);
  a[3] = pack_bf16(c[8 * jj + 6], c[8 * jj + 7]);
}

// d (m64 x N float32) = A B (+ d when `accumulate`), bf16 operands: A
// (64 x 16) and B (16 x N) from shared memory by descriptor (wgmma_ss),
// or A from registers (wgmma_rs, acc_to_a's layout); TB = 1 reads B
// MN-major. N = 32, 64 or 128, by the size of d; wgmma_rs also 256.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15,"
      "%16, %17, %18, %19,"
      "%20, %21, %22, %23,"
      "%24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15,"
      "%16, %17, %18, %19,"
      "%20, %21, %22, %23,"
      "%24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15,"
      "%16, %17, %18, %19,"
      "%20, %21, %22, %23,"
      "%24, %25, %26, %27,"
      "%28, %29, %30, %31,"
      "%32, %33, %34, %35,"
      "%36, %37, %38, %39,"
      "%40, %41, %42, %43,"
      "%44, %45, %46, %47,"
      "%48, %49, %50, %51,"
      "%52, %53, %54, %55,"
      "%56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15,"
      "%16, %17, %18, %19,"
      "%20, %21, %22, %23,"
      "%24, %25, %26, %27,"
      "%28, %29, %30, %31,"
      "%32, %33, %34, %35,"
      "%36, %37, %38, %39,"
      "%40, %41, %42, %43,"
      "%44, %45, %46, %47,"
      "%48, %49, %50, %51,"
      "%52, %53, %54, %55,"
      "%56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// m64n256 (register A only): O += P V, dQ += dS K, dV += W_drop^T dO and
// dK += dS^T Q at D 256
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3,"
      "%4, %5, %6, %7,"
      "%8, %9, %10, %11,"
      "%12, %13, %14, %15,"
      "%16, %17, %18, %19,"
      "%20, %21, %22, %23,"
      "%24, %25, %26, %27,"
      "%28, %29, %30, %31,"
      "%32, %33, %34, %35,"
      "%36, %37, %38, %39,"
      "%40, %41, %42, %43,"
      "%44, %45, %46, %47,"
      "%48, %49, %50, %51,"
      "%52, %53, %54, %55,"
      "%56, %57, %58, %59,"
      "%60, %61, %62, %63,"
      "%64, %65, %66, %67,"
      "%68, %69, %70, %71,"
      "%72, %73, %74, %75,"
      "%76, %77, %78, %79,"
      "%80, %81, %82, %83,"
      "%84, %85, %86, %87,"
      "%88, %89, %90, %91,"
      "%92, %93, %94, %95,"
      "%96, %97, %98, %99,"
      "%100, %101, %102, %103,"
      "%104, %105, %106, %107,"
      "%108, %109, %110, %111,"
      "%112, %113, %114, %115,"
      "%116, %117, %118, %119,"
      "%120, %121, %122, %123,"
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// ---- host: tensor maps and persistent grids ---------------------------------

// A failed cuTensorMapEncodeTiled returns PTT_ERR_TENSOR_MAP + its
// CUresult (ptt_error_string names it)
constexpr int PTT_ERR_TENSOR_MAP = 100000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
inline int encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return (int)cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return 0;
}

// [bh, T, d] bf16 at `base` as a 3-D map (innermost first: d, T, bh) with
// boxes of `rows` rows by one panel of a D-wide tile: rows >= T of a head
// come as zeros, never the next head's rows, and so do columns >= d where
// the tile is wider than the head dim (a padded width D > d: a box partly
// or wholly past d lands as zeros, and a store clips it at d)
template <int D>
int encode_bf16_map(CUtensorMap* map, const void* base, int bh, int T,
                    int rows, int d) {
  EncodeTiledFn fn;
  int err = encode_tiled_fn(&fn);
  if (err) return err;
  constexpr int PW = panel_cols<D>();
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)PW, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      PW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : PTT_ERR_TENSOR_MAP + (int)r;
}

// The tile width that serves head dim d in the bf16 kernels: d itself at
// 32, 64 and 128 (the exact instantiations), else the smallest of 32, 64,
// 128 and 256 that covers it, whose tiles are one 64-byte-swizzled panel or
// 64-column 128-byte-swizzled ones; 0 for a head dim no width takes. A
// width between (16, 48, 80, 96, ...) would need the 32-byte swizzle or
// panels of mixed width: the padding costs products instead (D 8 in width
// 32, 4x; D 72 in 128, 1.78x; D 136 in 256, 1.88x), never bytes, since
// TMA fills the columns past d without reading them.
inline int bf16_width(int d) {
  if (d < 8 || d > 256 || d % 8 != 0) return 0;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Blocks of a persistent kernel that holds a whole SM: one an SM, no more
// than the work items (n_rb row blocks of each of bh heads), and a
// multiple of n_rb, so that each round of the grid holds whole heads,
// unless a head has more row blocks than the card has SMs.
inline int persistent_blocks(int n_rb, int bh, int* blocks) {
  static int sms[64] = {0};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long grid = n_rb <= sms[dev] ? sms[dev] / n_rb * n_rb : sms[dev];
  const long items = (long)n_rb * bh;
  *blocks = (int)(items < grid ? items : grid);
  return 0;
}

}  // namespace ptt_hopper
