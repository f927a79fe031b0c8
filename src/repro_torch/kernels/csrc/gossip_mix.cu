// Gossip arrival mix, in place:  a <- cast_a(keep * f32(a) + take * f32(b)).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py: gossip_mix_2d
// (pl.pallas_call at :83 for a static alpha, :93 for a traced one; bodies
// _mix_kernel and _mix_kernel_dyn). The reference aliases its output onto
// `a` (input_output_aliases); this kernel writes `a` in place.
//
// Bound on the H100: device-memory bytes. Each element is read from a and b
// once and written to a once, 3 * n * sizeof(T) bytes for 3 flops, far
// below the card's ~295 flop/byte ridge. The design therefore only moves
// bytes well: one grid-stride sweep of 16-byte vector loads and stores, a
// masked scalar edge for the remainder, no shared memory.
//
// keep = 1 - alpha and take = alpha arrive as floats that the wrapper
// computes as the reference does (a static alpha rounds 1.0 - alpha from a
// double, a traced one subtracts in fp32), so static and traced alpha are one
// kernel. The arithmetic is written with __fmul_rn / __fadd_rn in the
// reference's op order, which stops nvcc from contracting it into an FMA:
// the kernel agrees bit for bit with kernels/gossip_mix.py:gossip_mix_plain.
#include "common.cuh"

namespace gossip {
namespace {

template <typename T>
__device__ __forceinline__ T mix_one(T a, T b, float keep, float take) {
  const float r = __fadd_rn(__fmul_rn(Conv<T>::to_f(a), keep),
                            __fmul_rn(Conv<T>::to_f(b), take));
  return Conv<T>::from_f(r);
}

template <typename T>
__global__ void gossip_mix_kernel(T* __restrict__ a, const T* __restrict__ b,
                                  int64_t n, int64_t n_vec, float keep,
                                  float take) {
  constexpr int V = Vec<T>::kN;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Vec<T>* av = reinterpret_cast<Vec<T>*>(a);
  const Vec<T>* bv = reinterpret_cast<const Vec<T>*>(b);
  for (int64_t i = tid; i < n_vec; i += stride) {
    Vec<T> x = av[i];
    const Vec<T> y = bv[i];
#pragma unroll
    for (int j = 0; j < V; ++j) x.v[j] = mix_one(x.v[j], y.v[j], keep, take);
    av[i] = x;
  }
  for (int64_t i = n_vec * V + tid; i < n; i += stride) {
    a[i] = mix_one(a[i], b[i], keep, take);
  }
}

template <typename T>
void launch(void* a, const void* b, int64_t n, float keep, float take,
            cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const int64_t n_vec = (aligned16(a) && aligned16(b)) ? n / V : 0;
  const int threads = 256;
  const int blocks = grid_for(n_vec > 0 ? n_vec : n, threads);
  gossip_mix_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(a), static_cast<const T*>(b), n, n_vec, keep, take);
}

}  // namespace
}  // namespace gossip

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int gossip_mix_launch(int dtype, void* a, const void* b,
                                 long long n, float keep, float take,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gossip::kF32:
      gossip::launch<float>(a, b, n, keep, take, s);
      break;
    case gossip::kBF16:
      gossip::launch<__nv_bfloat16>(a, b, n, keep, take, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
