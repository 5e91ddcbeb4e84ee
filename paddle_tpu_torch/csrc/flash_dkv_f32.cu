// The float32 dK/dV entry: D 32, 64 and 128 exact, the padded widths 8,
// 16, 32 and 64 here, the wider ones in flash_dkv_f32_wide.cu
// (flash_bwd_f32.cuh holds the kernel and its design).

#include "flash_bwd_f32.cuh"

// As ptt_flash_dq_f32, writing dk and dv ([bh, T, d] float32).
extern "C" int ptt_flash_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int bh, int T, int d, float sm_scale,
                                 int causal, uint32_t seed, uint32_t bh0,
                                 uint32_t thresh, float drop_scale,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  if (bwd_wide(d))
    return (int)ptt_flash_bwd::dkv_f32_wide(qf, kf, vf, of, lf, df, gk, gv,
                                            bh, T, d, sm_scale, causal, seed,
                                            bh0, thresh, drop_scale, s);
#define PTT_DKV_F32(D, PAD)                                                  \
  return (int)launch_dkv<D, PAD>(qf, kf, vf, of, lf, df, gk, gv, bh, T, d,   \
                                 sm_scale, causal, seed, bh0, thresh,        \
                                 drop_scale, s)
  switch (d) {
    case 32: PTT_DKV_F32(32, false);
    case 64: PTT_DKV_F32(64, false);
    case 128: PTT_DKV_F32(128, false);
  }
  switch (bwd_width(d)) {
    case 8: PTT_DKV_F32(8, true);
    case 16: PTT_DKV_F32(16, true);
    case 32: PTT_DKV_F32(32, true);
    case 64: PTT_DKV_F32(64, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PTT_DKV_F32
}
