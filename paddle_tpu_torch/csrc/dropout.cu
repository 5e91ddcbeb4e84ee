// Upscale-in-train dropout with the mask made in the kernel, for sm_90a.
//
// Replaces paddle_tpu/ops/pallas_dropout.py::_dropout_kernel (launched by
// _run, wrapped by dropout_tpu): out = keep ? x * 1/(1 - rate) : 0, the
// keep bits drawn in the kernel and never stored, so the backward pass is
// the same kernel on dy with the same seed.
//
// What bounds it on the H100: one read and one write of the tensor, 8
// bytes an element (12 when the op's Mask output is written too), for
// about 20 integer operations, so it is bound by memory bandwidth
// (3.35 TB/s).
//
// Design:
// - the TPU kernel reseeds a hardware generator per (seed, tile); this
//   card has none, so the bits are a counter hash of (seed, linear element
//   index), tile-free by construction: the mask does not depend on the
//   grid, the vector width or the tensor's shape, and the plain PyTorch
//   version (ops/dropout_kernel.py::dropout_reference) regenerates it bit
//   for bit. With the 64-bit index split into words (hi, lo):
//     key  = fmix32(seed ^ hi * 0x9E3779B9)
//     bits = fmix32(key ^ lo * 0x85EBCA77)
//   (fmix32 of flash_common.cuh), and an element is kept when the full
//   32-bit word bits >= thresh, thresh = rate * 2^32. The index is
//   base + the element's offset: a rank that holds rows of a batch split
//   over ranks passes its first row's index in the whole batch, so every
//   rank draws the bits one device would (base a multiple of eight, so a
//   vector's elements still share hi);
// - grid-stride over 16-byte vectors (four elements share hi, since a
//   vector starts at a multiple of four), a scalar loop for the tail and
//   for pointers that are not 16-byte aligned;
// - the op's Mask output (1.0 kept, 0.0 dropped) is written in the same
//   pass through an optional pointer, never by a second launch, and only
//   when something reads it (ops/nn.py): 12 bytes an element, else 8.
//
// The bf16 instantiation (dropout_bf16_kernel, for bf16 mixed precision)
// is the same pass over 2-byte elements, eight to a 16-byte vector (all
// eight share hi: a vector starts at a multiple of eight): 4 bytes an
// element, 6 with Mask. It keeps the same elements as the float32 kernel
// for the same seed and index, and multiplies each kept one by inv
// already rounded to bf16 by the wrapper (1.109375 at rate 0.1, as the
// TPU kernel's jnp.asarray(inv, x.dtype)): the product of two bf16 is
// exact in float32, so its one rounding to bf16 is PyTorch's and JAX's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace {

using ptt_flash::fmix32;

constexpr int NTHREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint32_t index_key(uint32_t seed, uint32_t hi) {
  return fmix32(seed ^ (hi * 0x9E3779B9u));
}

__device__ __forceinline__ bool keep(uint32_t key, uint32_t lo,
                                     uint32_t thresh) {
  return fmix32(key ^ (lo * 0x85EBCA77u)) >= thresh;
}

template <bool MASK>
__global__ void __launch_bounds__(NTHREADS)
dropout_kernel(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ mask, size_t n, size_t nvec,
               unsigned long long base, uint32_t seed,
               uint32_t thresh, float inv) {
  const size_t stride = (size_t)gridDim.x * NTHREADS;
  const size_t first = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  for (size_t v = first; v < nvec; v += stride) {
    const size_t i = v * 4;
    const unsigned long long g = base + i;
    const uint32_t key = index_key(seed, (uint32_t)(g >> 32));
    const uint32_t lo = (uint32_t)g;
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + v);
    const bool k0 = keep(key, lo, thresh);
    const bool k1 = keep(key, lo + 1u, thresh);
    const bool k2 = keep(key, lo + 2u, thresh);
    const bool k3 = keep(key, lo + 3u, thresh);
    reinterpret_cast<float4*>(out)[v] =
        make_float4(k0 ? xv.x * inv : 0.f, k1 ? xv.y * inv : 0.f,
                    k2 ? xv.z * inv : 0.f, k3 ? xv.w * inv : 0.f);
    if (MASK)
      reinterpret_cast<float4*>(mask)[v] = make_float4(
          k0 ? 1.f : 0.f, k1 ? 1.f : 0.f, k2 ? 1.f : 0.f, k3 ? 1.f : 0.f);
  }
  for (size_t i = nvec * 4 + first; i < n; i += stride) {
    const unsigned long long g = base + i;
    const bool k = keep(index_key(seed, (uint32_t)(g >> 32)), (uint32_t)g, thresh);
    out[i] = k ? x[i] * inv : 0.f;
    if (MASK) mask[i] = k ? 1.f : 0.f;
  }
}

using ptt_mma_bf16::bf16;
using ptt_mma_bf16::pack_bf16;
using ptt_mma_bf16::unpack_bf16;

constexpr uint32_t BF16_ONE = 0x3F80u;  // bf16 1.0

template <bool MASK>
__global__ void __launch_bounds__(NTHREADS)
dropout_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                    bf16* __restrict__ mask, size_t n, size_t nvec,
                    unsigned long long base, uint32_t seed, uint32_t thresh, float inv) {
  const size_t stride = (size_t)gridDim.x * NTHREADS;
  const size_t first = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  for (size_t v = first; v < nvec; v += stride) {
    const size_t i = v * 8;
    const unsigned long long g = base + i;
    const uint32_t key = index_key(seed, (uint32_t)(g >> 32));
    const uint32_t lo = (uint32_t)g;
    const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x) + v);
    const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
    uint32_t ow[4], mw[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 f = unpack_bf16(xw[p]);
      const bool k0 = keep(key, lo + 2u * p, thresh);
      const bool k1 = keep(key, lo + 2u * p + 1u, thresh);
      ow[p] = pack_bf16(k0 ? f.x * inv : 0.f, k1 ? f.y * inv : 0.f);
      mw[p] = (k0 ? BF16_ONE : 0u) | (k1 ? BF16_ONE << 16 : 0u);
    }
    reinterpret_cast<uint4*>(out)[v] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    if (MASK)
      reinterpret_cast<uint4*>(mask)[v] =
          make_uint4(mw[0], mw[1], mw[2], mw[3]);
  }
  for (size_t i = nvec * 8 + first; i < n; i += stride) {
    const unsigned long long g = base + i;
    const bool k = keep(index_key(seed, (uint32_t)(g >> 32)), (uint32_t)g, thresh);
    out[i] = __float2bfloat16_rn(k ? __bfloat162float(x[i]) * inv : 0.f);
    if (MASK) mask[i] = __float2bfloat16_rn(k ? 1.f : 0.f);
  }
}

// both instantiations: a grid of 16-byte vectors (per_vec elements each),
// at most BLOCKS_PER_SM blocks an SM, grid-striding; a scalar loop when a
// pointer is not 16-byte aligned
template <typename T, typename Kernel>
int launch(Kernel kernel_mask, Kernel kernel_nomask, const void* x, void* out,
           void* mask, unsigned long long n, int per_vec,
           unsigned long long base, uint32_t seed,
           uint32_t thresh, float inv, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((uintptr_t)x | (uintptr_t)out | (uintptr_t)mask) % 16 == 0;
  const size_t nvec = aligned ? (size_t)n / per_vec : 0;
  const size_t work = nvec ? nvec : (size_t)n;
  size_t blocks = (work + NTHREADS - 1) / NTHREADS;
  const size_t cap = (size_t)sms * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  T* mt = static_cast<T*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mt != nullptr)
    kernel_mask<<<(unsigned)blocks, NTHREADS, 0, s>>>(
        xt, ot, mt, (size_t)n, nvec, base, seed, thresh, inv);
  else
    kernel_nomask<<<(unsigned)blocks, NTHREADS, 0, s>>>(
        xt, ot, mt, (size_t)n, nvec, base, seed, thresh, inv);
  return cudaGetLastError();
}

}  // namespace

// x, out, mask: n contiguous float32 elements; mask may be null (no Mask
// output wanted). keep when hash(seed, base + index) >= thresh (base a
// multiple of 8); kept elements are
// multiplied by inv. Returns a cudaError_t (0 on success).
extern "C" int ptt_dropout_f32(const void* x, void* out, void* mask,
                               unsigned long long n,
                               unsigned long long base, uint32_t seed,
                               uint32_t thresh, float inv, int device,
                               void* stream) {
  return launch<float>(dropout_kernel<true>, dropout_kernel<false>, x, out,
                       mask, n, 4, base, seed, thresh, inv, device, stream);
}

// As ptt_dropout_f32 over n contiguous bf16 elements (x, out, mask); inv
// is 1 / (1 - rate) already rounded to bf16.
extern "C" int ptt_dropout_bf16(const void* x, void* out, void* mask,
                                unsigned long long n,
                               unsigned long long base, uint32_t seed,
                                uint32_t thresh, float inv, int device,
                                void* stream) {
  return launch<bf16>(dropout_bf16_kernel<true>, dropout_bf16_kernel<false>,
                      x, out, mask, n, 8, base, seed, thresh, inv, device, stream);
}
