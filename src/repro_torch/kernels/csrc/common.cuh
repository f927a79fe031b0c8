// Shared helpers of the hand-written elementwise sweeps (sm_90a).
//
// The mix and the fused updates are bandwidth-bound sweeps over flat
// buffers, in 16-byte vectors of the bucket (4 fp32 or 8 bf16 elements)
// where every pointer is aligned for its vector, then a masked scalar edge
// for the remainder, so a ragged tail needs no separate pass. The fused
// sweeps (fused_*.cu) run one grid-stride loop with 64-bit indices
// (grid_for); gossip_mix.cu runs one wave of blocks, a chunk each, of its
// own. One launch covers a whole replica-stacked bucket (up to 622 M
// elements for qwen3-0.6b's embedding at dp=4).
//
// A partner stream may be narrower than the bucket: bf16 on an fp32 bucket,
// or int8 / float8_e4m3fn wire codes with one fp32 scale per 128-element
// tile. Its vector holds as many elements as the bucket's (so 4 or 8 bytes
// for codes). A vector starts at a multiple of its width, which divides 128,
// so it never straddles a scale tile; bucket rows are 128-multiples, so it
// never straddles a replica row either.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace gossip {

constexpr int64_t kLane = 128;  // elements per wire-scale tile

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF8 = 3 };

// float8_e4m3fn code (one byte); a distinct type from the int8 code
struct Fp8 {
  unsigned char bits;
};

template <typename T> struct Conv;
template <> struct Conv<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct Conv<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as torch's and XLA's fp32 -> bf16 casts
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};
// wire codes decode exactly: every int8 and every e4m3 value is an fp32
template <> struct Conv<int8_t> {
  static __device__ __forceinline__ float to_f(int8_t x) {
    return static_cast<float>(x);
  }
};
template <> struct Conv<Fp8> {
  static __device__ __forceinline__ float to_f(Fp8 x) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.bits, __NV_E4M3)));
  }
};

// N elements of T loaded or stored as one access (at most 16 bytes aligned)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};
template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));
template <typename T> using Vec = Pack<T, kVec<T>>;

inline bool aligned_to(const void* p, size_t q) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % q) == 0;
}

// The mix coefficients: static floats (keep, take), or a device pointer to
// fp32 alpha of shape () (row_len 0) or one value per replica row of
// row_len elements, with keep = 1 - alpha formed in fp32 here, as the
// reference's traced path does (gossip_mix.py:114-118).
struct Alpha {
  float keep, take;
  const float* ptr;
  int64_t row_len;
  __device__ __forceinline__ void at(int64_t e, float& k, float& t) const {
    if (ptr == nullptr) {
      k = keep;
      t = take;
      return;
    }
    const float a = ptr[row_len > 0 ? e / row_len : 0];
    k = __fsub_rn(1.0f, a);
    t = a;
  }
};

// partner element to fp32: decode first (f32(code) * scale, as
// kernels/quantize.py:dequant_flat), then the mix in the reference's op
// order; __fmul_rn / __fadd_rn keep nvcc from contracting into an FMA
template <typename B, bool kScaled>
__device__ __forceinline__ float partner_f(B b, float scale) {
  const float x = Conv<B>::to_f(b);
  return kScaled ? __fmul_rn(x, scale) : x;
}
__device__ __forceinline__ float mix_f(float a, float b, float keep,
                                       float take) {
  return __fadd_rn(__fmul_rn(a, keep), __fmul_rn(b, take));
}

// Blocks for a grid-stride sweep over `work` items: enough to fill every SM
// (8 resident blocks of 256 threads each), never more than the work needs.
inline int grid_for(int64_t work, int threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int64_t want = (work + threads - 1) / threads;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  if (want < 1) want = 1;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace gossip
