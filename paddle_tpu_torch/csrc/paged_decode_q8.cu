// Paged decode attention over an int8 cache with per-block scales, for
// sm_90a.
//
// Replaces paddle_tpu/ops/paged_attention.py::_paged_decode_kernel_q8
// (launched by _paged_attention_q8_pallas). One new query token per slot
// attends over positions [0, seq_len) of its sequence. K/V rows live as
// int8 in a block-allocated cache [num_blocks, block_size, H, Dh] reached
// through the slot's row of the block table; block b's values are
// int8 * k_scale[b] (v_scale[b]), one float32 scale per block and cache.
//
// What bounds it on the H100: every live position's K and V row is read
// once (sum(seq_len) * H * Dh * 2 bytes, a quarter of the float32 cache's)
// for 4 operations per byte read, so it is bound by memory bandwidth
// (3.35 TB/s).
//
// What held the first version back (one block per (slot, head), grid
// (H, S)): the longest slot set the time, its blocks walking up to 32x
// the positions of the shortest; each thread kept one 16-byte K and one
// 16-byte V load in flight and waited on them through a shuffle reduce
// and two expf before the next; and every 64 table entries cost a pair of
// barriers to stage them and their scales.
//
// Design (paged_split.cuh has the layout and the merge; the TPU kernel
// walks a sequential (slot, block) grid with the scales in scalar memory):
// - grid (H, S, NSPLIT): block (h, s, j) reads chunk j, positions
//   [j*P, (j+1)*P) of slot s (P = 128 from the wrapper, two passes), and a
//   chunk at or past seq_len returns at once, so no block walks more than
//   P positions. P is twice the float32 kernel's: a launched block costs
//   time even when its chunk is dead, and an int8 chunk of 64 positions
//   holds a quarter of the float32 one's bytes;
// - 128 threads split into groups of Dh/8 lanes. A head's row is Dh
//   bytes, so each lane holds 8 of its values and a group reads one
//   position's K (or V) row as Dh/8 coalesced 8-byte loads (4, 8 and 16
//   lanes a row at Dh 32, 64 and 128). Eight values a lane rather than
//   sixteen halve q's and the accumulators' registers (56 against 72 at
//   Dh 64), so more blocks fit on an SM;
// - a pass is PASS = 64 positions: each group issues the K and V loads of
//   its U = 64 / groups positions (2, 4 or 8) before the first dot, with
//   the table entry and the two scales of each position. The chunk's
//   entries and scales come through the read-only cache (a chunk spans at
//   most P / BS + 1 entries, so the block fetches each once from memory
//   and its other threads hit that line), in the same burst as the K/V
//   loads: no shared staging, so no barrier stands between the table read
//   and the first K/V load. Entries past ceil(seq_len / BS), their blocks
//   and their scales are never read;
// - the q.k dot is summed over the raw int8 values and multiplied once by
//   k_scale[blk] * sm_scale, and the weight of a V row is multiplied once
//   by v_scale[blk]: the same sums as dequantizing every element, in
//   another order;
// - each group keeps an online softmax (m, l, 8 accumulators per lane) in
//   float32 over the block's passes; the dots are reduced across the
//   group's lanes with warp shuffles in U independent chains;
// - the groups' states are merged through shared memory into the chunk's
//   record, which the merge kernel combines with the slot's other chunks
//   in split order: no atomics, reruns give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

using ptt_paged::NEG_INF;
using ptt_paged::PASS;

constexpr int NTHREADS = 128;
constexpr int VPL = 8;             // int8 values per lane: one 8-byte load

// value i (0..7) of one 8-byte load of int8, as a float
__device__ __forceinline__ float q8_at(const int2& w, int i) {
  const int word = i < 4 ? w.x : w.y;
  return (float)(int8_t)((word >> (8 * (i & 3))) & 0xff);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
paged_q8_split_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                      const int8_t* __restrict__ vc, const float* __restrict__ ks,
                      const float* __restrict__ vs, const int* __restrict__ bt,
                      const int* __restrict__ sl, float* __restrict__ part,
                      int H, int BS, int max_b, int P, int nsplit,
                      float sm_scale) {
  constexpr int LP = DH / VPL;        // lanes per position row
  constexpr int G = NTHREADS / LP;    // position groups per block
  constexpr int U = PASS / G;         // positions a group loads at once
  static_assert(U * G == PASS, "a pass is PASS positions");
  __shared__ float ms[G], ls[G], ws[G];
  __shared__ __align__(16) float accs[G][DH];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int split = blockIdx.z;
  ptt_paged::allow_merge_launch();
  const int seq_len = ptt_paged::live_len(sl, slot, max_b, BS);
  const int p_begin = split * P;
  if (p_begin >= seq_len) return;  // dead chunk: nothing read or written
  const int p_end = min(seq_len, p_begin + P);
  const int lane = tid % LP;
  const int g = tid / LP;
  float qv[VPL];
  {
    const float4* qp = reinterpret_cast<const float4*>(
        q + ((size_t)slot * H + h) * DH + lane * VPL);
#pragma unroll
    for (int i = 0; i < VPL / 4; ++i) {
      const float4 t = __ldg(qp + i);
      qv[4 * i + 0] = t.x;
      qv[4 * i + 1] = t.y;
      qv[4 * i + 2] = t.z;
      qv[4 * i + 3] = t.w;
    }
  }
  const int* row_bt = bt + (size_t)slot * max_b;

  float m = NEG_INF, l = 0.f;
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;

  // uniform trip count across the block: every lane reaches every shuffle
  for (int p0 = p_begin; p0 < p_end; p0 += PASS) {
    int2 kw[U], vw[U];
    float k_mul[U], v_mul[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * G + g;
      kw[u] = vw[u] = make_int2(0, 0);
      k_mul[u] = v_mul[u] = 0.f;
      if (p < p_end) {
        const int blk = __ldg(row_bt + p / BS);
        const size_t off =
            (((size_t)blk * BS + (p % BS)) * H + h) * DH + lane * VPL;
        kw[u] = __ldg(reinterpret_cast<const int2*>(kc + off));
        vw[u] = __ldg(reinterpret_cast<const int2*>(vc + off));
        k_mul[u] = __ldg(ks + blk);
        v_mul[u] = __ldg(vs + blk);
      }
    }
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) s += qv[i] * q8_at(kw[u], i);
      sc[u] = s;
    }
#pragma unroll
    for (int off = LP / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u * G + g < p_end) {
        sc[u] *= k_mul[u] * sm_scale;
        m_new = fmaxf(m_new, sc[u]);
      }
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u * G + g < p_end) {
        const float pr = expf(sc[u] - m_new);
        const float pw = pr * v_mul[u];
        l += pr;
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[i] += pw * q8_at(vw[u], i);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    ms[g] = m;
    ls[g] = l;
  }
#pragma unroll
  for (int i = 0; i < VPL / 4; ++i)
    reinterpret_cast<float4*>(&accs[g][lane * VPL])[i] =
        make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  __syncthreads();
  ptt_paged::write_record<DH, G, NTHREADS>(
      ms, ls, ws, &accs[0][0],
      part + (((size_t)slot * H + h) * nsplit + split) * (DH + 2));
}

template <int DH>
cudaError_t launch(const float* q, const int8_t* kc, const int8_t* vc,
                   const float* ks, const float* vs, const int* bt,
                   const int* sl, float* part, float* out, int S, int H,
                   int BS, int max_b, int P, int nsplit, float sm_scale,
                   cudaStream_t stream) {
  paged_q8_split_kernel<DH><<<dim3(H, S, nsplit), NTHREADS, 0, stream>>>(
      q, kc, vc, ks, vs, bt, sl, part, H, BS, max_b, P, nsplit, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt_paged::launch_merge<DH>(part, sl, out, S, H, BS, max_b, P, nsplit,
                                     stream);
}

}  // namespace

// q, out: [S, H, dh] float32; k_cache, v_cache: [num_blocks, bs, H, dh]
// int8; k_scale, v_scale: [num_blocks] float32; block_tables: [S, max_b]
// int32; seq_lens: [S] int32; partials: [S, H, nsplit, dh + 2] float32
// workspace, nsplit = max(1, ceil(max_b * bs / split)), split a positive
// multiple of 64; all contiguous, q 16-byte and the caches 8-byte aligned.
// Launches the split kernel and then the merge kernel on `stream`. Returns
// a cudaError_t (0 on success); dh must be 32, 64 or 128.
extern "C" int ptt_paged_decode_q8(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_scale,
                                   const void* v_scale, const void* block_tables,
                                   const void* seq_lens, void* partials,
                                   void* out, int S, int H, int dh, int bs,
                                   int max_b, int split, int nsplit,
                                   float sm_scale, int device, void* stream) {
  if (!ptt_paged::split_ok(S, split, nsplit, max_b, bs))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const int8_t* kq = static_cast<const int8_t*>(k_cache);
  const int8_t* vq = static_cast<const int8_t*>(v_cache);
  const float* ksf = static_cast<const float*>(k_scale);
  const float* vsf = static_cast<const float*>(v_scale);
  const int* btp = static_cast<const int*>(block_tables);
  const int* slp = static_cast<const int*>(seq_lens);
  float* pp = static_cast<float*>(partials);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(qf, kq, vq, ksf, vsf, btp, slp, pp, of, S, H, bs, max_b, split, nsplit, sm_scale, s);
    case 64: return (int)launch<64>(qf, kq, vq, ksf, vsf, btp, slp, pp, of, S, H, bs, max_b, split, nsplit, sm_scale, s);
    case 128: return (int)launch<128>(qf, kq, vq, ksf, vsf, btp, slp, pp, of, S, H, bs, max_b, split, nsplit, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
