// Shared helpers of the hand-written elementwise sweeps (sm_90a).
//
// Both kernels of the port are bandwidth-bound sweeps over flat buffers:
// one grid-stride loop over 16-byte vectors (4 fp32 or 8 bf16 elements)
// where every pointer is 16-byte aligned, then a masked scalar edge for the
// remainder, so a ragged tail needs no separate pass. Indices are 64-bit:
// one launch covers a whole replica-stacked bucket (up to 622 M elements for
// qwen3-0.6b's embedding at dp=4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gossip {

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1 };

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

template <typename T> struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16) == 0;
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
