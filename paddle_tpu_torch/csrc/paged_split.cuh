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

// The chunk's record (acc, M, l) from a split block's G groups, whose
// states (m_g, l_g, acc_g) are in shared memory: each group's weight
// e^{m_g - M} is taken once (ws), and a group that saw nothing weighs 0.
// Every thread of the block (NT of them) calls it after a barrier.
template <int DH, int G, int NT>
__device__ __forceinline__ void write_record(const float* ms, const float* ls,
                                             float* ws, const float* accs,
                                             float* rec) {
  const int tid = threadIdx.x;
  float M = NEG_INF;
  for (int g = 0; g < G; ++g) M = fmaxf(M, ms[g]);
  for (int g = tid; g < G; g += NT) ws[g] = expf(ms[g] - M);
  __syncthreads();
  for (int t = tid; t < DH + 2; t += NT) {
    float s = M;
    if (t != DH) {
      const float* x = t < DH ? accs + t : ls;  // acc column t, or l
      const int stride = t < DH ? DH : 1;
      s = 0.f;
      for (int g = 0; g < G; ++g) s += x[g * stride] * ws[g];
    }
    rec[t] = s;
  }
}

// One block of Dh threads per (slot, head), thread t owning output column
// t. The records are read in rounds of Dh: in each, thread j stages record
// j's weight e^{m_j - M} and l_j e^{m_j - M} in shared memory, and every
// thread then sums the round's records in split order, its acc loads
// unrolled so that they are in flight together (one dependent load a
// record would cost a memory round trip each).
template <int DH>
__global__ void __launch_bounds__(DH)
paged_merge_kernel(const float* __restrict__ part, const int* __restrict__ sl,
                   float* __restrict__ out, int H, int BS, int max_b, int P,
                   int nsplit) {
  constexpr int REC = DH + 2;
  constexpr int NWARPS = DH / 32;
  __shared__ float sw[DH], swl[DH], wmax[NWARPS];
  const int t = threadIdx.x;
  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int seq_len = live_len(sl, slot, max_b, BS);
  float* dst = out + ((size_t)slot * H + h) * DH;
  if (seq_len <= 0) {  // inactive slot: exact zeros, no record read
    dst[t] = 0.f;
    return;
  }
  const int n_live = (seq_len + P - 1) / P;
  const float* rec = part + ((size_t)slot * H + h) * nsplit * REC;
  // the split kernel's records are complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // M = max_j m_j: a max is exact in any order
  float M = NEG_INF;
  for (int j = t; j < n_live; j += DH) M = fmaxf(M, rec[(size_t)j * REC + DH]);
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
  for (int j0 = 0; j0 < n_live; j0 += DH) {
    __syncthreads();  // the previous round's readers are done
    if (j0 + t < n_live) {
      const float* r = rec + (size_t)(j0 + t) * REC;
      const float w = expf(r[DH] - M);
      sw[t] = w;
      swl[t] = r[DH + 1] * w;
    }
    __syncthreads();
    const int n = min(DH, n_live - j0);
    const float* a = rec + (size_t)j0 * REC + t;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      L += swl[i];
      o += a[(size_t)i * REC] * sw[i];
    }
  }
  dst[t] = o / fmaxf(L, 1e-20f);
}

// the split kernels call this first: the merge grid may launch once every
// split block has started (it waits for their records itself)
__device__ __forceinline__ void allow_merge_launch() {
  asm volatile("griddepcontrol.launch_dependents;");
}

template <int DH>
cudaError_t launch_merge(const float* part, const int* sl, float* out, int S,
                         int H, int BS, int max_b, int P, int nsplit,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, S);
  cfg.blockDim = dim3(DH);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<DH>, part, sl, out, H, BS,
                            max_b, P, nsplit);
}

}  // namespace ptt_paged
