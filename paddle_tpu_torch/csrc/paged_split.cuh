// Shared by paged_decode.cu and paged_decode_q8.cu: the split-sequence
// ("flash-decoding") layout of a decode read and the kernel that merges
// its chunks.
//
// The read of slot s, head h over positions [0, seq_len) is cut into
// chunks of P positions (P a multiple of PASS, chosen by the wrapper).
// Chunk j covers [j*P, min((j+1)*P, seq_len)) and is live when
// j*P < seq_len. Block (h, s, j) of the split kernel reads a live chunk
// and writes its float32 softmax state to a workspace
// [S, H, NSPLIT, Dh + 2], NSPLIT = max(1, ceil(max_b * BS / P)):
//   part[s, h, j, 0:Dh]  acc = sum_p e^{score_p - m} v_p
//   part[s, h, j, Dh]    m   = max_p score_p
//   part[s, h, j, Dh+1]  l   = sum_p e^{score_p - m}
// A dead chunk's block returns at once: it reads nothing and its record
// is neither written nor read. The grid depends only on shapes, so the
// host never reads seq_lens and the launch stays asynchronous.
//
// The merge is a second kernel, grid (H, S), launched by the same C entry
// on the same stream as a programmatic dependent launch: each split block
// lets it launch as soon as it starts, so the merge blocks are resident
// and have read seq_lens when the split kernel's last block ends, and wait
// (griddepcontrol.wait) only before reading the records. A last-block
// ticket saves the launch but ran no faster on an H100 (the last block of
// a long slot merges alone at the end), and its counters must start at
// zero: a buffer that outlives the launch, one per stream.
// The merge combines the live records in split order,
//   M = max_j m_j,  L = sum_j l_j e^{m_j - M},
//   o = sum_j acc_j e^{m_j - M} / max(L, 1e-20),
// so reruns give equal bits; a slot with one live chunk gives acc / l,
// and seq_len 0 gives exact zeros.
//
// Head dims: both kernels take every multiple of 8 from 8 to 256, as the
// TPU kernels take any. An instantiation has a width DH and a flag PAD.
// Dh 32, 64 and 128 run in their exact instantiations (PAD false, the
// head dim a compile-time constant). Any other Dh runs in the padded one
// of the smallest power-of-two width that covers it (padded_head_dim): a
// row's lanes then split evenly and reduce by xor shuffles. Lanes whose
// columns lie at or past Dh load nothing and hold zeros, so a padded
// width costs idle lanes but no bytes; the record stays Dh + 2 wide.

#pragma once

#include <cuda_runtime.h>

namespace ptt_paged {

constexpr int PASS = 64;           // positions a split block loads at once
constexpr int MAX_GRID_YZ = 65535;
constexpr float NEG_INF = -1e30f;  // the JAX package's masked-score value

// a slot holds at most max_b * BS positions (the plain version's dense
// view); a longer seq_len must not walk past the slot's table row
__device__ __forceinline__ int live_len(const int* sl, int slot, int max_b,
                                        int BS) {
  return min(__ldg(sl + slot), max_b * BS);
}

inline bool split_ok(int S, int P, int nsplit, int max_b, int BS) {
  if (S > MAX_GRID_YZ || P <= 0 || P % PASS != 0) return false;
  const long long span = (long long)max_b * BS;
  const long long want = span > 0 ? (span + P - 1) / P : 1;
  return nsplit == want && nsplit <= MAX_GRID_YZ;
}

// The instantiation width that serves head dim d: the smallest power of
// two from 8 that covers it; 0 for a head dim no kernel takes (d not a
// multiple of 8, or outside [8, 256]).
inline int padded_head_dim(int d) {
  if (d < 8 || d > 256 || d % 8 != 0) return 0;
  int w = 8;
  while (w < d) w *= 2;
  return w;
}

// The chunk's record (acc, M, l) from a split block's G groups, whose
// states (m_g, l_g, acc_g, DH wide) are in shared memory: each group's
// weight e^{m_g - M} is taken once (ws), and a group that saw nothing
// weighs 0. The record is D = Dh wide (d; DH unless PAD). Every thread of
// the block (NT of them) calls it after a barrier.
template <int DH, int G, int NT, bool PAD>
__device__ __forceinline__ void write_record(const float* ms, const float* ls,
                                             float* ws, const float* accs,
                                             float* rec, int d) {
  const int D = PAD ? d : DH;
  const int tid = threadIdx.x;
  float M = NEG_INF;
  for (int g = 0; g < G; ++g) M = fmaxf(M, ms[g]);
  for (int g = tid; g < G; g += NT) ws[g] = expf(ms[g] - M);
  __syncthreads();
  for (int t = tid; t < D + 2; t += NT) {
    float s = M;
    if (t != D) {
      const float* x = t < D ? accs + t : ls;  // acc column t, or l
      const int stride = t < D ? DH : 1;
      s = 0.f;
      for (int g = 0; g < G; ++g) s += x[g * stride] * ws[g];
    }
    rec[t] = s;
  }
}

// The merge's threads a block: one an output column, a whole warp at
// least (its max is a full-warp shuffle).
template <int DH>
__host__ __device__ constexpr int merge_threads() {
  return DH < 32 ? 32 : DH;
}

// One block of merge_threads<DH>() threads per (slot, head), thread t
// owning output column t (in a padded instantiation, threads at or past
// Dh own none). The records are read in rounds of NT: in each, thread j
// stages record j's weight e^{m_j - M} and l_j e^{m_j - M} in shared
// memory, and every thread then sums the round's records in split order,
// its acc loads unrolled so that they are in flight together (one
// dependent load a record would cost a memory round trip each).
template <int DH, bool PAD>
__global__ void __launch_bounds__(merge_threads<DH>())
paged_merge_kernel(const float* __restrict__ part, const int* __restrict__ sl,
                   float* __restrict__ out, int H, int BS, int max_b, int P,
                   int nsplit, int d) {
  constexpr int NT = merge_threads<DH>();
  constexpr int NWARPS = NT / 32;
  // every thread owns a column (the exact instantiations: no test)
  constexpr bool ALL_OWN = !PAD && NT == DH;
  const int D = PAD ? d : DH;
  const int REC = D + 2;
  __shared__ float sw[NT], swl[NT], wmax[NWARPS];
  const int t = threadIdx.x;
  const bool owns = ALL_OWN || t < D;
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int seq_len = live_len(sl, slot, max_b, BS);
  float* dst = out + ((size_t)slot * H + h) * D;
  if (seq_len <= 0) {  // inactive slot: exact zeros, no record read
    if (owns) dst[t] = 0.f;
    return;
  }
  const int n_live = (seq_len + P - 1) / P;
  const float* rec = part + ((size_t)slot * H + h) * nsplit * REC;
  // the split kernel's records are complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // M = max_j m_j: a max is exact in any order
  float M = NEG_INF;
  for (int j = t; j < n_live; j += NT) M = fmaxf(M, rec[(size_t)j * REC + D]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (NWARPS > 1) {
    if (t % 32 == 0) wmax[t / 32] = M;
    __syncthreads();
    M = wmax[0];
    for (int w = 1; w < NWARPS; ++w) M = fmaxf(M, wmax[w]);
  }
  float L = 0.f, o = 0.f;
  for (int j0 = 0; j0 < n_live; j0 += NT) {
    __syncthreads();  // the previous round's readers are done
    if (j0 + t < n_live) {
      const float* r = rec + (size_t)(j0 + t) * REC;
      const float w = expf(r[D] - M);
      sw[t] = w;
      swl[t] = r[D + 1] * w;
    }
    __syncthreads();
    if (owns) {
      const int n = min(NT, n_live - j0);
      const float* a = rec + (size_t)j0 * REC + t;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        L += swl[i];
        o += a[(size_t)i * REC] * sw[i];
      }
    }
  }
  if (owns) dst[t] = o / fmaxf(L, 1e-20f);
}

// the split kernels call this first: the merge grid may launch once every
// split block has started (it waits for their records itself)
__device__ __forceinline__ void allow_merge_launch() {
  asm volatile("griddepcontrol.launch_dependents;");
}

template <int DH, bool PAD>
cudaError_t launch_merge(const float* part, const int* sl, float* out, int S,
                         int H, int BS, int max_b, int P, int nsplit, int d,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, S);
  cfg.blockDim = dim3(merge_threads<DH>());
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<DH, PAD>, part, sl, out,
                            H, BS, max_b, P, nsplit, d);
}

}  // namespace ptt_paged
