// Single-sweep fused gossip mix + SGD-momentum update, in place over p and m.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py: fused_sgd_1d
// (body _sgd_kernel, tiler _tiled_call, pl.pallas_call at :233). Per element,
// in fp32 whatever the bucket dtype, in the reference's op order
// (_mix_f32 and _sgd_math, fused_update.py:82-110):
//
//   p   = f32(p)
//   p   = f32(cast_T(p * keep + f32(partner) * take))    if a partner is given
//   g   = f32(g) + wd * p                                 if wd != 0
//   m   = mu * f32(m) + g;  p = p - lr * m                if m is given
//   p   = p - lr * g                                      otherwise
//   store cast_T(p) over p and cast_T(m) over m
//
// The reference aliases param and momentum outputs onto their inputs
// (input_output_aliases); this kernel writes both in place. The partner must
// not alias p: the engine hands it a gathered copy (core/gossip.py:exchange).
// A null partner (the wrapper passes none for a static alpha of 0, as the
// reference drops that read) or a null momentum select a kernel without
// that stream.
//
// Bound on the H100: device-memory bytes. With a partner and a momentum it
// reads p, g, partner and m once and writes p and m once, 6 * n * sizeof(T)
// bytes for about 10 flops per element. The design moves bytes well and
// nothing else: one grid-stride sweep of 16-byte vector loads and stores, a
// masked scalar edge for the remainder (the reference's ragged-tail jnp
// epilogue), one launch per bucket with 64-bit indices.
//
// keep, take, lr, mu and wd are float arguments, so a static and a traced
// alpha are one kernel. __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from
// contracting into FMAs: the kernel agrees bit for bit with
// kernels/fused_update.py:fused_sgd_plain.
#include "common.cuh"

namespace gossip {
namespace {

struct Coef {
  float keep, take, lr, mu, wd;
};

template <typename T, bool kPartner, bool kMom>
__device__ __forceinline__ void sgd_one(T& p, T g, T b, T& m, const Coef& c) {
  float p32 = Conv<T>::to_f(p);
  if (kPartner) {
    const float mixed = __fadd_rn(__fmul_rn(p32, c.keep),
                                  __fmul_rn(Conv<T>::to_f(b), c.take));
    p32 = Conv<T>::to_f(Conv<T>::from_f(mixed));  // round trip, as _mix_f32
  }
  float g32 = Conv<T>::to_f(g);
  if (c.wd != 0.0f) g32 = __fadd_rn(g32, __fmul_rn(c.wd, p32));
  if (kMom) {
    const float m32 = __fadd_rn(__fmul_rn(c.mu, Conv<T>::to_f(m)), g32);
    p32 = __fsub_rn(p32, __fmul_rn(c.lr, m32));
    m = Conv<T>::from_f(m32);
  } else {
    p32 = __fsub_rn(p32, __fmul_rn(c.lr, g32));
  }
  p = Conv<T>::from_f(p32);
}

template <typename T, bool kPartner, bool kMom>
__global__ void fused_sgd_kernel(T* __restrict__ p, const T* __restrict__ g,
                                 const T* __restrict__ b, T* __restrict__ m,
                                 int64_t n, int64_t n_vec, Coef c) {
  constexpr int V = Vec<T>::kN;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Vec<T>* pv = reinterpret_cast<Vec<T>*>(p);
  const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(g);
  const Vec<T>* bv = reinterpret_cast<const Vec<T>*>(b);
  Vec<T>* mv = reinterpret_cast<Vec<T>*>(m);
  for (int64_t i = tid; i < n_vec; i += stride) {
    Vec<T> xp = pv[i];
    const Vec<T> xg = gv[i];
    const Vec<T> xb = kPartner ? bv[i] : xp;  // xp stands in for an absent
    Vec<T> xm = kMom ? mv[i] : xp;            // stream; sgd_one ignores it
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sgd_one<T, kPartner, kMom>(xp.v[j], xg.v[j], xb.v[j], xm.v[j], c);
    }
    pv[i] = xp;
    if (kMom) mv[i] = xm;
  }
  for (int64_t i = n_vec * V + tid; i < n; i += stride) {
    T xp = p[i];
    T xb = kPartner ? b[i] : xp;
    T xm = kMom ? m[i] : xp;
    sgd_one<T, kPartner, kMom>(xp, g[i], xb, xm, c);
    p[i] = xp;
    if (kMom) m[i] = xm;
  }
}

template <typename T, bool kPartner, bool kMom>
void launch_one(void* p, const void* g, const void* b, void* m, int64_t n,
                const Coef& c, cudaStream_t stream) {
  constexpr int V = Vec<T>::kN;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(b) && aligned16(m);
  const int64_t n_vec = vec ? n / V : 0;
  const int threads = 256;
  const int blocks = grid_for(n_vec > 0 ? n_vec : n, threads);
  fused_sgd_kernel<T, kPartner, kMom><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(m), n, n_vec, c);
}

template <typename T>
void launch(void* p, const void* g, const void* b, void* m, int64_t n,
            const Coef& c, cudaStream_t s) {
  if (b != nullptr && m != nullptr) {
    launch_one<T, true, true>(p, g, b, m, n, c, s);
  } else if (b != nullptr) {
    launch_one<T, true, false>(p, g, b, m, n, c, s);
  } else if (m != nullptr) {
    launch_one<T, false, true>(p, g, b, m, n, c, s);
  } else {
    launch_one<T, false, false>(p, g, b, m, n, c, s);
  }
}

}  // namespace
}  // namespace gossip

// Plain C entry point (bound with ctypes). `b` and `m` may be null. Returns
// the cudaError_t of the launch; 0 means it was accepted.
extern "C" int fused_sgd_launch(int dtype, void* p, const void* g,
                                const void* b, void* m, long long n,
                                float keep, float take, float lr, float mu,
                                float wd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const gossip::Coef c{keep, take, lr, mu, wd};
  switch (dtype) {
    case gossip::kF32:
      gossip::launch<float>(p, g, b, m, n, c, s);
      break;
    case gossip::kBF16:
      gossip::launch<__nv_bfloat16>(p, g, b, m, n, c, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
