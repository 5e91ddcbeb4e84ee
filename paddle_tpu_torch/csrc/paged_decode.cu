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
// Design:
// - grid (H, S): one block per (slot, head); 256 threads split into groups
//   of Dh/4 lanes, each lane holding one float4 of the Dh-wide row, so a
//   group reads one position's K (or V) row for head h as Dh/4 coalesced
//   16-byte loads (256 contiguous bytes at Dh 64);
// - the groups stride over positions p = g, g + G, ...; p maps through
//   block_tables[s, p / block_size] to its cache row; positions at or past
//   seq_len are never read, nor are table entries past ceil(seq_len/BS);
// - each group keeps its own online softmax (m, l, a float4 accumulator)
//   in float32; the q.k dot is reduced across the group's lanes with warp
//   shuffles, every lane of the warp taking part in every step;
// - the groups' partial states are merged through shared memory at the
//   end; a slot with seq_len 0 writes exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score value

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                    const float* __restrict__ vc, const int* __restrict__ bt,
                    const int* __restrict__ sl, float* __restrict__ out, int H,
                    int BS, int max_b, float sm_scale) {
  constexpr int LP = DH / 4;          // lanes per position row
  constexpr int G = NTHREADS / LP;    // position groups per block
  __shared__ float ms[G], ls[G];
  __shared__ __align__(16) float accs[G][DH];

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  // a slot holds at most max_b * BS positions (the plain version's dense
  // view); a longer seq_len must not walk past the slot's table row
  const int seq_len = min(sl[slot], max_b * BS);
  float* dst = out + ((size_t)slot * H + h) * DH;
  if (seq_len <= 0) {  // inactive slot: exact zeros, nothing read
    for (int t = tid; t < DH; t += NTHREADS) dst[t] = 0.f;
    return;
  }
  const int lane = tid % LP;
  const int g = tid / LP;
  const float4 qv =
      reinterpret_cast<const float4*>(q + ((size_t)slot * H + h) * DH)[lane];
  const int* row_bt = bt + (size_t)slot * max_b;

  float m = NEG_INF, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // uniform trip count across the block: every lane reaches every shuffle
  for (int p0 = 0; p0 < seq_len; p0 += G) {
    const int p = p0 + g;
    const bool valid = p < seq_len;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vv = kv;
    if (valid) {
      const int blk = __ldg(row_bt + p / BS);
      const size_t off = (((size_t)blk * BS + (p % BS)) * H + h) * DH + lane * 4;
      kv = __ldg(reinterpret_cast<const float4*>(kc + off));
      vv = __ldg(reinterpret_cast<const float4*>(vc + off));
    }
    float sc = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
#pragma unroll
    for (int off = LP / 2; off > 0; off >>= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
    if (valid) {
      sc *= sm_scale;
      const float m_new = fmaxf(m, sc);
      const float alpha = expf(m - m_new);
      const float pr = expf(sc - m_new);
      l = l * alpha + pr;
      acc.x = acc.x * alpha + pr * vv.x;
      acc.y = acc.y * alpha + pr * vv.y;
      acc.z = acc.z * alpha + pr * vv.z;
      acc.w = acc.w * alpha + pr * vv.w;
      m = m_new;
    }
  }

  if (lane == 0) {
    ms[g] = m;
    ls[g] = l;
  }
  reinterpret_cast<float4*>(&accs[g][0])[lane] = acc;
  __syncthreads();
  for (int t = tid; t < DH; t += NTHREADS) {
    float M = NEG_INF;
    for (int gg = 0; gg < G; ++gg) M = fmaxf(M, ms[gg]);
    float L = 0.f, o = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      const float w = expf(ms[gg] - M);  // 0 for a group that saw nothing
      L += ls[gg] * w;
      o += accs[gg][t] * w;
    }
    dst[t] = o / fmaxf(L, 1e-20f);
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* kc, const float* vc,
                   const int* bt, const int* sl, float* out, int S, int H,
                   int BS, int max_b, float sm_scale, cudaStream_t stream) {
  dim3 grid(H, S);
  paged_decode_kernel<DH><<<grid, NTHREADS, 0, stream>>>(q, kc, vc, bt, sl, out,
                                                         H, BS, max_b, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: [S, H, dh] float32; k_cache, v_cache: [num_blocks, bs, H, dh]
// float32; block_tables: [S, max_b] int32; seq_lens: [S] int32; all
// contiguous. Returns a cudaError_t (0 on success); dh must be 32, 64 or 128.
extern "C" int ptt_paged_decode_f32(const void* q, const void* k_cache,
                                    const void* v_cache, const void* block_tables,
                                    const void* seq_lens, void* out, int S, int H,
                                    int dh, int bs, int max_b, float sm_scale,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_cache);
  const float* vf = static_cast<const float*>(v_cache);
  const int* btp = static_cast<const int*>(block_tables);
  const int* slp = static_cast<const int*>(seq_lens);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(qf, kf, vf, btp, slp, of, S, H, bs, max_b, sm_scale, s);
    case 64: return (int)launch<64>(qf, kf, vf, btp, slp, of, S, H, bs, max_b, sm_scale, s);
    case 128: return (int)launch<128>(qf, kf, vf, btp, slp, of, S, H, bs, max_b, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
