// Paged decode attention, float32 cache, for sm_90a.
//
// Replaces paddle_tpu/ops/paged_attention.py::_paged_decode_kernel
// (launched by _paged_attention_pallas). One new query token per slot
// attends over positions [0, seq_len) of its sequence, whose K/V rows live
// in a block-allocated cache [num_blocks, block_size, H, Dh] reached
// through the slot's row of the block table.
//
// What bounds it on the H100: every live position's K and V row is read
// once (sum(seq_len) * H * Dh * 2 * 4 bytes) for 4 operations per float
// read, so it is bound by memory bandwidth (3.35 TB/s).
//
// What held the first version back (one block per (slot, head), grid
// (H, S)): the longest slot set the time, its H blocks walking all of its
// positions alone on H SMs while the rest of the card idled; and each
// thread kept one 16-byte K and one 16-byte V load in flight, then waited
// on them through a shuffle reduce and two expf before the next, about
// 8 KB in flight a block where the card wants about 25 KB an SM.
//
// Design (paged_split.cuh has the layout and the merge):
// - grid (H, S, NSPLIT): block (h, s, j) reads chunk j, positions
//   [j*P, (j+1)*P) of slot s (P = 64 from the wrapper, one pass), and a
//   chunk at or past seq_len returns at once, so no block walks more than
//   P positions and every SM gets work however the lengths spread;
// - 256 threads split into groups of Dh/4 lanes, each lane holding one
//   float4 of the Dh-wide row, so a group reads one position's K (or V)
//   row for head h as Dh/4 coalesced 16-byte loads;
// - a block loads PASS = 64 positions at once: each group issues the K
//   and V loads of its U = 64 / groups positions (2, 4 or 8) into
//   registers before the first dot, 16 KB (Dh 32) to 64 KB (Dh 128) in
//   flight a block; positions at or past seq_len are never read, nor are
//   table entries past ceil(seq_len / BS);
// - the U dots are reduced across the group's lanes with warp shuffles in
//   U independent chains, every lane of the warp taking part; each group
//   keeps an online softmax (m, l, a float4 accumulator) in float32 over
//   the block's passes;
// - the groups' states are merged through shared memory into the chunk's
//   record (m, l, acc), which the merge kernel combines with the slot's
//   other chunks in split order: no atomics, reruns give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

using ptt_paged::NEG_INF;
using ptt_paged::PASS;

constexpr int NTHREADS = 256;

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
paged_split_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, const int* __restrict__ bt,
                   const int* __restrict__ sl, float* __restrict__ part, int H,
                   int BS, int max_b, int P, int nsplit, float sm_scale) {
  constexpr int LP = DH / 4;          // lanes per position row
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
  const float4 qv = __ldg(
      reinterpret_cast<const float4*>(q + ((size_t)slot * H + h) * DH) + lane);
  const int* row_bt = bt + (size_t)slot * max_b;

  float m = NEG_INF, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // uniform trip count across the block: every lane reaches every shuffle
  for (int p0 = p_begin; p0 < p_end; p0 += PASS) {
    float4 kv[U], vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * G + g;
      kv[u] = vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < p_end) {
        const int blk = __ldg(row_bt + p / BS);
        const size_t off =
            (((size_t)blk * BS + (p % BS)) * H + h) * DH + lane * 4;
        kv[u] = __ldg(reinterpret_cast<const float4*>(kc + off));
        vv[u] = __ldg(reinterpret_cast<const float4*>(vc + off));
      }
    }
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      sc[u] = qv.x * kv[u].x + qv.y * kv[u].y + qv.z * kv[u].z + qv.w * kv[u].w;
#pragma unroll
    for (int off = LP / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u] *= sm_scale;
      if (p0 + u * G + g < p_end) m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
    acc.x *= alpha;
    acc.y *= alpha;
    acc.z *= alpha;
    acc.w *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u * G + g < p_end) {
        const float pr = expf(sc[u] - m_new);
        l += pr;
        acc.x += pr * vv[u].x;
        acc.y += pr * vv[u].y;
        acc.z += pr * vv[u].z;
        acc.w += pr * vv[u].w;
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    ms[g] = m;
    ls[g] = l;
  }
  reinterpret_cast<float4*>(&accs[g][0])[lane] = acc;
  __syncthreads();
  ptt_paged::write_record<DH, G, NTHREADS>(
      ms, ls, ws, &accs[0][0],
      part + (((size_t)slot * H + h) * nsplit + split) * (DH + 2));
}

template <int DH>
cudaError_t launch(const float* q, const float* kc, const float* vc,
                   const int* bt, const int* sl, float* part, float* out,
                   int S, int H, int BS, int max_b, int P, int nsplit,
                   float sm_scale, cudaStream_t stream) {
  paged_split_kernel<DH><<<dim3(H, S, nsplit), NTHREADS, 0, stream>>>(
      q, kc, vc, bt, sl, part, H, BS, max_b, P, nsplit, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt_paged::launch_merge<DH>(part, sl, out, S, H, BS, max_b, P, nsplit,
                                     stream);
}

}  // namespace

// q, out: [S, H, dh] float32; k_cache, v_cache: [num_blocks, bs, H, dh]
// float32; block_tables: [S, max_b] int32; seq_lens: [S] int32; partials:
// [S, H, nsplit, dh + 2] float32 workspace, nsplit = max(1, ceil(max_b *
// bs / split)), split a positive multiple of 64; all contiguous. Launches
// the split kernel and then the merge kernel on `stream`. Returns a
// cudaError_t (0 on success); dh must be 32, 64 or 128.
extern "C" int ptt_paged_decode_f32(const void* q, const void* k_cache,
                                    const void* v_cache, const void* block_tables,
                                    const void* seq_lens, void* partials,
                                    void* out, int S, int H, int dh, int bs,
                                    int max_b, int split, int nsplit,
                                    float sm_scale, int device, void* stream) {
  if (!ptt_paged::split_ok(S, split, nsplit, max_b, bs))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_cache);
  const float* vf = static_cast<const float*>(v_cache);
  const int* btp = static_cast<const int*>(block_tables);
  const int* slp = static_cast<const int*>(seq_lens);
  float* pp = static_cast<float*>(partials);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(qf, kf, vf, btp, slp, pp, of, S, H, bs, max_b, split, nsplit, sm_scale, s);
    case 64: return (int)launch<64>(qf, kf, vf, btp, slp, pp, of, S, H, bs, max_b, split, nsplit, sm_scale, s);
    case 128: return (int)launch<128>(qf, kf, vf, btp, slp, pp, of, S, H, bs, max_b, split, nsplit, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
