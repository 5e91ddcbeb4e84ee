// The float32 dQ entry: D 32, 64 and 128 exact, the padded widths 8, 16,
// 32 and 64 here, the wider ones in flash_dq_f32_wide.cu
// (flash_bwd_f32.cuh holds the kernel and its design).

#include "flash_bwd_f32.cuh"

// q, k, v, dout, dq: [bh, T, d] float32, contiguous; lse, delta: [bh, T]
// float32. seed / thresh / drop_scale as for ptt_flash_fwd_f32. Returns a
// cudaError_t (0 on success); d must be a multiple of 8 from 8 to 256.
extern "C" int ptt_flash_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int T,
                                int d, float sm_scale, int causal,
                                uint32_t seed, uint32_t bh0, uint32_t thresh,
                                float drop_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gf = static_cast<float*>(dq);
  if (bwd_wide(d))
    return (int)ptt_flash_bwd::dq_f32_wide(qf, kf, vf, of, lf, df, gf, bh, T,
                                           d, sm_scale, causal, seed, bh0,
                                           thresh, drop_scale, s);
#define PTT_DQ_F32(D, PAD)                                                   \
  return (int)launch_dq<D, PAD>(qf, kf, vf, of, lf, df, gf, bh, T, d,        \
                                sm_scale, causal, seed, bh0, thresh,         \
                                drop_scale, s)
  switch (d) {
    case 32: PTT_DQ_F32(32, false);
    case 64: PTT_DQ_F32(64, false);
    case 128: PTT_DQ_F32(128, false);
  }
  switch (bwd_width(d)) {
    case 8: PTT_DQ_F32(8, true);
    case 16: PTT_DQ_F32(16, true);
    case 32: PTT_DQ_F32(32, true);
    case 64: PTT_DQ_F32(64, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_DQ_F32
}

// Dynamic shared memory a block of the dQ (dkv == 0) or dK/dV (dkv != 0)
// kernel takes at head dim d (that of the instantiation serving d), in
// bytes; -1 for a d no instantiation takes.
extern "C" int ptt_flash_bwd_smem_bytes(int dkv, int d) {
  switch (bwd_width(d)) {
    case 8: return (int)(dkv ? dkv_smem_bytes<8>() : dq_smem_bytes<8>());
    case 16: return (int)(dkv ? dkv_smem_bytes<16>() : dq_smem_bytes<16>());
    case 32: return (int)(dkv ? dkv_smem_bytes<32>() : dq_smem_bytes<32>());
    case 64: return (int)(dkv ? dkv_smem_bytes<64>() : dq_smem_bytes<64>());
    case 96: return (int)(dkv ? dkv_smem_bytes<96>() : dq_smem_bytes<96>());
    case 128: return (int)(dkv ? dkv_smem_bytes<128>() : dq_smem_bytes<128>());
    case 256: return (int)(dkv ? dkv_smem_bytes<256>() : dq_smem_bytes<256>());
    default: return -1;
  }
}
