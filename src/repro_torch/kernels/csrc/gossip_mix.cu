// Gossip arrival mix, in place:  a <- cast_a(keep * f32(a) + take * f32(b)).
//
// Two entry points over one kernel template:
//
// * gossip_mix_launch replaces the TPU kernel src/repro/kernels/gossip_mix.py:
//   gossip_mix_2d (pl.pallas_call at :83 for a static alpha, :93 for a traced
//   one; bodies _mix_kernel and _mix_kernel_dyn). The partner b is fp32 or
//   bf16, of the bucket's dtype or narrower (a bf16 wire on an fp32 bucket),
//   promoted to fp32 as the reference does.
// * gossip_mix_q_launch replaces gossip_mix_q2d (pl.pallas_call at :142
//   static, :152 traced; bodies _mix_kernel_q and _mix_kernel_q_dyn): the
//   partner arrives as int8 or float8_e4m3fn wire codes with one fp32 scale
//   per 128-element tile, decoded in the same sweep as f32(code) * scale
//   (the decode multiply first, as kernels/quantize.py:dequant_flat).
//
// The reference aliases its output onto `a` (input_output_aliases); these
// kernels write `a` in place.
//
// Bound on the H100: device-memory bytes. Each element reads a and the
// partner once and writes a once (for bf16 a and int8 codes 2 + 1 + 4/128 +
// 2 bytes, about 5 bytes, for 4 flops), far below the card's ~295 flop/byte
// ridge. The design therefore only moves bytes well: one grid-stride sweep
// whose thread loads 16 bytes of `a` and the matching 4-16 bytes of partner
// codes, one scale per vector (a vector never straddles a 128-tile), a
// masked scalar edge for the remainder, no shared memory.
//
// alpha is either two floats (keep, take) that the wrapper forms as the
// reference does for a static alpha, or a device pointer to fp32 alpha of
// shape () or (rows,) (the async ring's per-replica masked alpha), read in
// the kernel: no host round trip. __fmul_rn / __fadd_rn in the reference's
// op order and -fmad=false: the kernel agrees bit for bit with
// kernels/gossip_mix.py:gossip_mix_plain and gossip_mix_q_plain.
#include "common.cuh"

namespace gossip {
namespace {

template <typename T, typename B, bool kScaled>
__global__ void gossip_mix_kernel(T* __restrict__ a, const B* __restrict__ b,
                                  const float* __restrict__ s, int64_t n,
                                  int64_t n_vec, Alpha al) {
  constexpr int V = kVec<T>;
  using PB = Pack<B, V>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Vec<T>* av = reinterpret_cast<Vec<T>*>(a);
  const PB* bv = reinterpret_cast<const PB*>(b);
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = i * V;
    float keep, take;
    al.at(e, keep, take);
    const float sc = kScaled ? s[e / kLane] : 1.0f;
    Vec<T> x = av[i];
    const PB y = bv[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      x.v[j] = Conv<T>::from_f(mix_f(Conv<T>::to_f(x.v[j]),
                                     partner_f<B, kScaled>(y.v[j], sc),
                                     keep, take));
    }
    av[i] = x;
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    float keep, take;
    al.at(e, keep, take);
    const float sc = kScaled ? s[e / kLane] : 1.0f;
    a[e] = Conv<T>::from_f(mix_f(Conv<T>::to_f(a[e]),
                                 partner_f<B, kScaled>(b[e], sc), keep, take));
  }
}

template <typename T, typename B, bool kScaled>
int launch(void* a, const void* b, const float* s, int64_t n, const Alpha& al,
           cudaStream_t stream) {
  constexpr int V = kVec<T>;
  // the vector path needs every stream aligned for its vector and rows of
  // whole vectors (so one alpha per vector)
  const bool vec = aligned_to(a, 16) && aligned_to(b, alignof(Pack<B, V>)) &&
                   al.row_len % V == 0;
  const int64_t n_vec = vec ? n / V : 0;
  const int threads = 256;
  const int blocks = grid_for(n_vec > 0 ? n_vec : n, threads);
  gossip_mix_kernel<T, B, kScaled><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(a), static_cast<const B*>(b), s, n, n_vec, al);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_raw(int pcode, void* a, const void* b, int64_t n, const Alpha& al,
               cudaStream_t s) {
  switch (pcode) {
    case kF32:
      return launch<T, float, false>(a, b, nullptr, n, al, s);
    case kBF16:
      return launch<T, __nv_bfloat16, false>(a, b, nullptr, n, al, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_q(int qcode, void* a, const void* q, const float* sc, int64_t n,
             const Alpha& al, cudaStream_t s) {
  switch (qcode) {
    case kI8:
      return launch<T, int8_t, true>(a, q, sc, n, al, s);
    case kF8:
      return launch<T, Fp8, true>(a, q, sc, n, al, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace gossip

// Plain C entry points (bound with ctypes). `alpha` may be null (static
// keep/take). Each returns the cudaError_t of the launch; 0 means it was
// accepted.
extern "C" int gossip_mix_launch(int dtype, int pcode, void* a, const void* b,
                                 long long n, float keep, float take,
                                 const float* alpha, long long row_len,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const gossip::Alpha al{keep, take, alpha, row_len};
  switch (dtype) {
    case gossip::kF32:
      return gossip::launch_raw<float>(pcode, a, b, n, al, s);
    case gossip::kBF16:
      return gossip::launch_raw<__nv_bfloat16>(pcode, a, b, n, al, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gossip_mix_q_launch(int dtype, int qcode, void* a,
                                   const void* q, const float* scales,
                                   long long n, float keep, float take,
                                   const float* alpha, long long row_len,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const gossip::Alpha al{keep, take, alpha, row_len};
  switch (dtype) {
    case gossip::kF32:
      return gossip::launch_q<float>(qcode, a, q, scales, n, al, s);
    case gossip::kBF16:
      return gossip::launch_q<__nv_bfloat16>(qcode, a, q, scales, n, al, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
