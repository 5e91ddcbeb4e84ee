// The float32 dK/dV at the padded widths 96, 128 and 256, for
// flash_dkv_f32.cu's entry (flash_bwd_f32.cuh holds the kernel and its
// design).

#include "flash_bwd_f32.cuh"

namespace ptt_flash_bwd {

cudaError_t dkv_f32_wide(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int bh,
                         int T, int d, float sm_scale, int causal,
                         uint32_t seed, uint32_t bh0, uint32_t thresh,
                         float drop_scale, cudaStream_t stream) {
#define PTT_DKV_F32(D)                                                       \
  return launch_dkv<D, true>(q, k, v, dout, lse, delta, dk, dv, bh, T, d,    \
                             sm_scale, causal, seed, bh0, thresh,            \
                             drop_scale, stream)
  switch (bwd_wide(d) ? bwd_width(d) : 0) {
    case 96: PTT_DKV_F32(96);
    case 128: PTT_DKV_F32(128);
    case 256: PTT_DKV_F32(256);
    default: return cudaErrorInvalidValue;
  }
#undef PTT_DKV_F32
}

}  // namespace ptt_flash_bwd
