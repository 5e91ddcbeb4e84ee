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
// Design (the TPU kernel walks a sequential (slot, block) grid with the
// scales in scalar memory; here a block of threads owns one (slot, head)):
// - grid (H, S), 256 threads split into groups of Dh/16 lanes. A head's
//   row is Dh bytes, so each lane holds 16 of its values and a group reads
//   one position's K (or V) row as Dh/16 coalesced 16-byte loads: the lane
//   width is chosen so that every load is a full 16 bytes, which Dh 32, 64
//   and 128 allow (2, 4 and 8 lanes a row, 128, 64 and 32 groups a block);
// - the slot's table entries and the two scales of each entry are staged
//   in shared memory, TABLE_CHUNK entries at a time, by one thread per
//   entry: a scale is loaded once per block, not once per row, and entries
//   past ceil(seq_len / BS), their blocks and their scales are never read;
// - the groups stride over the chunk's positions; the q.k dot is summed
//   over the raw int8 values and multiplied once by k_scale[blk] *
//   sm_scale, and the weight of a V row is multiplied once by
//   v_scale[blk]: the same sums as dequantizing every element, in another
//   order;
// - each group keeps its own online softmax (m, l, 16 accumulators per
//   lane) in float32; the dot is reduced across the group's lanes with
//   warp shuffles, every lane of the warp taking part in every step;
// - the groups' partial states are merged through shared memory at the
//   end; a slot with seq_len 0 writes exact zeros and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int TABLE_CHUNK = 64;    // table entries staged at a time
constexpr int VPL = 16;            // int8 values per lane: one 16-byte load
constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score value

// the 16 int8 values of one 16-byte load, as floats
__device__ __forceinline__ void unpack16(const int4& w, float (&f)[VPL]) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i + 0] = (float)(int8_t)(words[i] & 0xff);
    f[4 * i + 1] = (float)(int8_t)((words[i] >> 8) & 0xff);
    f[4 * i + 2] = (float)(int8_t)((words[i] >> 16) & 0xff);
    f[4 * i + 3] = (float)(int8_t)((words[i] >> 24) & 0xff);
  }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_q8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                       const int8_t* __restrict__ vc, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ bt,
                       const int* __restrict__ sl, float* __restrict__ out, int H,
                       int BS, int max_b, float sm_scale) {
  constexpr int LP = DH / VPL;        // lanes per position row
  constexpr int G = NTHREADS / LP;    // position groups per block
  __shared__ float ms[G], ls[G];
  __shared__ float accs[G][DH];
  __shared__ int sblk[TABLE_CHUNK];
  __shared__ float sks[TABLE_CHUNK], svs[TABLE_CHUNK];

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
  float qv[VPL];
  {
    const float4* qp = reinterpret_cast<const float4*>(
        q + ((size_t)slot * H + h) * DH + lane * VPL);
#pragma unroll
    for (int i = 0; i < VPL / 4; ++i) {
      const float4 t = qp[i];
      qv[4 * i + 0] = t.x;
      qv[4 * i + 1] = t.y;
      qv[4 * i + 2] = t.z;
      qv[4 * i + 3] = t.w;
    }
  }
  const int* row_bt = bt + (size_t)slot * max_b;
  const int n_live = (seq_len + BS - 1) / BS;  // table entries in use

  float m = NEG_INF, l = 0.f;
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;

  // every bound below is uniform across the block: every thread reaches
  // every barrier and every lane every shuffle
  for (int j0 = 0; j0 < n_live; j0 += TABLE_CHUNK) {
    __syncthreads();  // the previous chunk's readers are done
    if (tid < TABLE_CHUNK && j0 + tid < n_live) {
      const int b = __ldg(row_bt + j0 + tid);
      sblk[tid] = b;
      sks[tid] = __ldg(ks + b) * sm_scale;
      svs[tid] = __ldg(vs + b);
    }
    __syncthreads();
    const int p_end = min(seq_len, (j0 + TABLE_CHUNK) * BS);
    for (int p0 = j0 * BS; p0 < p_end; p0 += G) {
      const int p = p0 + g;
      const bool valid = p < p_end;
      float kf[VPL], vf[VPL];
      float k_mul = 0.f, v_mul = 0.f;
      if (valid) {
        const int j = p / BS - j0;
        const size_t off =
            (((size_t)sblk[j] * BS + (p % BS)) * H + h) * DH + lane * VPL;
        const int4 kw = __ldg(reinterpret_cast<const int4*>(kc + off));
        const int4 vw = __ldg(reinterpret_cast<const int4*>(vc + off));
        unpack16(kw, kf);
        unpack16(vw, vf);
        k_mul = sks[j];
        v_mul = svs[j];
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) kf[i] = vf[i] = 0.f;
      }
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) sc += qv[i] * kf[i];
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (valid) {
        sc *= k_mul;
        const float m_new = fmaxf(m, sc);
        const float alpha = expf(m - m_new);
        const float pr = expf(sc - m_new);
        const float pw = pr * v_mul;
        l = l * alpha + pr;
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[i] = acc[i] * alpha + pw * vf[i];
        m = m_new;
      }
    }
  }

  if (lane == 0) {
    ms[g] = m;
    ls[g] = l;
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) accs[g][lane * VPL + i] = acc[i];
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
cudaError_t launch(const float* q, const int8_t* kc, const int8_t* vc,
                   const float* ks, const float* vs, const int* bt,
                   const int* sl, float* out, int S, int H, int BS, int max_b,
                   float sm_scale, cudaStream_t stream) {
  dim3 grid(H, S);
  paged_decode_q8_kernel<DH><<<grid, NTHREADS, 0, stream>>>(
      q, kc, vc, ks, vs, bt, sl, out, H, BS, max_b, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: [S, H, dh] float32; k_cache, v_cache: [num_blocks, bs, H, dh]
// int8; k_scale, v_scale: [num_blocks] float32; block_tables: [S, max_b]
// int32; seq_lens: [S] int32; all contiguous, q and the caches 16-byte
// aligned. Returns a cudaError_t (0 on success); dh must be 32, 64 or 128.
extern "C" int ptt_paged_decode_q8(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_scale,
                                   const void* v_scale, const void* block_tables,
                                   const void* seq_lens, void* out, int S, int H,
                                   int dh, int bs, int max_b, float sm_scale,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const int8_t* kq = static_cast<const int8_t*>(k_cache);
  const int8_t* vq = static_cast<const int8_t*>(v_cache);
  const float* ksf = static_cast<const float*>(k_scale);
  const float* vsf = static_cast<const float*>(v_scale);
  const int* btp = static_cast<const int*>(block_tables);
  const int* slp = static_cast<const int*>(seq_lens);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(qf, kq, vq, ksf, vsf, btp, slp, of, S, H, bs, max_b, sm_scale, s);
    case 64: return (int)launch<64>(qf, kq, vq, ksf, vsf, btp, slp, of, S, H, bs, max_b, sm_scale, s);
    case 128: return (int)launch<128>(qf, kq, vq, ksf, vsf, btp, slp, of, S, H, bs, max_b, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
