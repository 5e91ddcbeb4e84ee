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
//   other chunks in split order: no atomics, reruns give equal bits;
// - head dims (paged_split.cuh): Dh 32, 64 and 128 in the layout above,
//   exactly as before; every other multiple of 8 up to 256 in a padded
//   instantiation of width DH = 8, 16, 32, 64, 128 or 256. At DH 8 and 16
//   a row is 2 or 4 lanes, so a block is 64 or 128 threads (32 groups of
//   U = 2 positions: 256 threads would make 128 or 64 groups, more than a
//   64-position pass). At DH 256 a row would be 64 lanes, wider than a
//   warp's shuffle: a group stays at 32 lanes with two float4 a lane (the
//   lane's columns 4 lane and 128 + 4 lane, so each float4 step of the
//   warp reads 512 contiguous bytes), and U = 4 positions a group keep
//   the registers of the loads at 64 (the pass is 32 positions, two a
//   64-position chunk).

#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_split.cuh"

namespace {

using ptt_paged::NEG_INF;
using ptt_paged::PASS;

// The lane layout of instantiation width DH: LP lanes a row, F float4 a
// lane, NT threads in G = NT / LP groups of U positions, a pass of
// PB = U * G positions (a divisor of PASS).
template <int DH>
struct Layout {
  static constexpr int LP = DH / 4 < 32 ? DH / 4 : 32;
  static constexpr int F = DH / 4 / LP;
  static constexpr int NT = DH < 32 ? 8 * DH : 256;
  static constexpr int G = NT / LP;
  static constexpr int U = DH == 256 ? 4 : PASS / G;
  static constexpr int PB = U * G;
  static_assert(LP * F * 4 == DH && PASS % PB == 0 && U >= 2, "layout");
};

// d: the head dim (DH unless PAD); q, the caches and the record are d wide
template <int DH, bool PAD>
__global__ void __launch_bounds__(Layout<DH>::NT)
paged_split_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                   const float* __restrict__ vc, const int* __restrict__ bt,
                   const int* __restrict__ sl, float* __restrict__ part, int H,
                   int BS, int max_b, int P, int nsplit, float sm_scale,
                   int d) {
  using L = Layout<DH>;
  constexpr int NTHREADS = L::NT;
  constexpr int LP = L::LP;           // lanes per position row
  constexpr int F = L::F;             // float4 a lane
  constexpr int G = L::G;             // position groups per block
  constexpr int U = L::U;             // positions a group loads at once
  __shared__ float ms[G], ls[G], ws[G];
  __shared__ __align__(16) float accs[G][DH];

  const int D = PAD ? d : DH;
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
  // float4 f of this lane is columns 4 c4[f] .. 4 c4[f] + 3; a padded
  // instantiation's lanes past d read nothing and hold zeros
  int c4[F];
  bool col[F];
  float4 qv[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    c4[f] = f * LP + lane;
    col[f] = !PAD || 4 * c4[f] < D;
    qv[f] = col[f] ? __ldg(reinterpret_cast<const float4*>(
                         q + ((size_t)slot * H + h) * D) + c4[f])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* row_bt = bt + (size_t)slot * max_b;

  float m = NEG_INF, l = 0.f;
  float4 acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  // uniform trip count across the block: every lane reaches every shuffle
  for (int p0 = p_begin; p0 < p_end; p0 += L::PB) {
    float4 kv[U][F], vv[U][F];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * G + g;
#pragma unroll
      for (int f = 0; f < F; ++f)
        kv[u][f] = vv[u][f] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < p_end) {
        const int blk = __ldg(row_bt + p / BS);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          if (col[f]) {
            const size_t off =
                (((size_t)blk * BS + (p % BS)) * H + h) * D + c4[f] * 4;
            kv[u][f] = __ldg(reinterpret_cast<const float4*>(kc + off));
            vv[u][f] = __ldg(reinterpret_cast<const float4*>(vc + off));
          }
        }
      }
    }
    float sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sc[u] = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float part_dot = qv[f].x * kv[u][f].x + qv[f].y * kv[u][f].y +
                               qv[f].z * kv[u][f].z + qv[f].w * kv[u][f].w;
        sc[u] = f == 0 ? part_dot : sc[u] + part_dot;
      }
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
      sc[u] *= sm_scale;
      if (p0 + u * G + g < p_end) m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f].x *= alpha;
      acc[f].y *= alpha;
      acc[f].z *= alpha;
      acc[f].w *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u * G + g < p_end) {
        const float pr = expf(sc[u] - m_new);
        l += pr;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          acc[f].x += pr * vv[u][f].x;
          acc[f].y += pr * vv[u][f].y;
          acc[f].z += pr * vv[u][f].z;
          acc[f].w += pr * vv[u][f].w;
        }
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    ms[g] = m;
    ls[g] = l;
  }
#pragma unroll
  for (int f = 0; f < F; ++f)
    reinterpret_cast<float4*>(&accs[g][0])[c4[f]] = acc[f];
  __syncthreads();
  ptt_paged::write_record<DH, G, NTHREADS, PAD>(
      ms, ls, ws, &accs[0][0],
      part + (((size_t)slot * H + h) * nsplit + split) * (D + 2), D);
}

template <int DH, bool PAD>
cudaError_t launch(const float* q, const float* kc, const float* vc,
                   const int* bt, const int* sl, float* part, float* out,
                   int S, int H, int d, int BS, int max_b, int P, int nsplit,
                   float sm_scale, cudaStream_t stream) {
  paged_split_kernel<DH, PAD>
      <<<dim3(H, S, nsplit), Layout<DH>::NT, 0, stream>>>(
          q, kc, vc, bt, sl, part, H, BS, max_b, P, nsplit, sm_scale, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ptt_paged::launch_merge<DH, PAD>(part, sl, out, S, H, BS, max_b, P,
                                          nsplit, d, stream);
}

}  // namespace

// q, out: [S, H, dh] float32; k_cache, v_cache: [num_blocks, bs, H, dh]
// float32; block_tables: [S, max_b] int32; seq_lens: [S] int32; partials:
// [S, H, nsplit, dh + 2] float32 workspace, nsplit = max(1, ceil(max_b *
// bs / split)), split a positive multiple of 64; all contiguous. Launches
// the split kernel and then the merge kernel on `stream`. Returns a
// cudaError_t (0 on success); dh must be a multiple of 8 from 8 to 256.
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
#define PTT_PAGED_F32(DH, PAD)                                              \
  return (int)launch<DH, PAD>(qf, kf, vf, btp, slp, pp, of, S, H, dh, bs,  \
                              max_b, split, nsplit, sm_scale, s)
  switch (dh) {
    case 32: PTT_PAGED_F32(32, false);
    case 64: PTT_PAGED_F32(64, false);
    case 128: PTT_PAGED_F32(128, false);
  }
  switch (ptt_paged::padded_head_dim(dh)) {
    case 8: PTT_PAGED_F32(8, true);
    case 16: PTT_PAGED_F32(16, true);
    case 32: PTT_PAGED_F32(32, true);
    case 64: PTT_PAGED_F32(64, true);
    case 128: PTT_PAGED_F32(128, true);
    case 256: PTT_PAGED_F32(256, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_PAGED_F32
}
