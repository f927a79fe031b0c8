// Single-sweep fused gossip mix + LARS momentum update with a per-row trust
// scale, in place over p and m.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py: fused_lars_1d
// (body _lars_kernel, tiler _tiled_call, pl.pallas_call at :233). Per
// element, in fp32 whatever the bucket dtype, in the reference's op order
// (_mix_f32 and _lars_math, fused_update.py:82-132):
//
//   p   = f32(p)
//   p   = f32(cast_T(p * keep + f32(partner) * take))   if a partner is given
//   g   = f32(g) + wd * p                                if wd != 0
//   m   = mu * m + g * scale[e / 128]
//   p   = p - lr * m
//   store cast_T(p) over p and m over m (m is fp32)
//
// `scale` holds one fp32 trust ratio per 128-element row of the
// replica-stacked bucket, from the norm prepass of optim/optimizers.py
// (lars); bucket slots start at multiples of 128, so a row never spans two
// layers. Buffers are LANE-aligned (n a multiple of 128). The partner is raw
// fp32 or bf16 and may be wider than the bucket: the reference decodes a
// quantized wire partner to fp32 before the prepass (optimizers.py:239-243),
// so a bf16 bucket meets an fp32 partner.
//
// Bound on the H100: device-memory bytes. With a partner of the bucket's
// dtype it reads p, g, partner, m and a 128th of a scale once and writes p
// and m once: 4 * sizeof(T) + 8 + 4/128 bytes per element (16.03 for
// bf16; 18.03 with an fp32 partner on bf16), for about 9 fp32 operations.
// The design is the fused_sgd sweep's: one grid-stride loop of 16-byte
// vectors of the bucket, one scale load per vector (a vector never straddles a
// row), a masked scalar edge for the remainder (only reached when a buffer
// is not 16-byte aligned), one launch per replica-stacked bucket, 64-bit
// indices.
//
// keep/take (a static alpha) or a device alpha pointer of shape () or
// (rows,), as in fused_sgd.cu. __fmul_rn / __fadd_rn / __fsub_rn and
// -fmad=false: the kernel agrees bit for bit with
// kernels/fused_update.py:fused_lars_plain.
#include "common.cuh"

namespace gossip {
namespace {

struct LarsCoef {
  float lr, mu, wd;
};

struct LarsBufs {
  void* p;
  const void* g;
  const void* b;
  float* m;
  const float* scale;
  int64_t n;
};

template <typename T, bool kPartner>
__device__ __forceinline__ void lars_one(T& p, T g, float b32, float& m,
                                         float s, float keep, float take,
                                         const LarsCoef& c) {
  float p32 = Conv<T>::to_f(p);
  if (kPartner) {  // round trip through T, as _mix_f32
    p32 = Conv<T>::to_f(Conv<T>::from_f(mix_f(p32, b32, keep, take)));
  }
  float g32 = Conv<T>::to_f(g);
  if (c.wd != 0.0f) g32 = __fadd_rn(g32, __fmul_rn(c.wd, p32));
  m = __fadd_rn(__fmul_rn(c.mu, m), __fmul_rn(g32, s));
  p = Conv<T>::from_f(__fsub_rn(p32, __fmul_rn(c.lr, m)));
}

template <typename T, typename B, bool kPartner>
__global__ void fused_lars_kernel(T* __restrict__ p, const T* __restrict__ g,
                                  const B* __restrict__ b,
                                  float* __restrict__ m,
                                  const float* __restrict__ scale, int64_t n,
                                  int64_t n_vec, Alpha al, LarsCoef c) {
  constexpr int V = kVec<T>;
  using PB = Pack<B, V>;
  using PF = Pack<float, V>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Vec<T>* pv = reinterpret_cast<Vec<T>*>(p);
  const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(g);
  const PB* bv = reinterpret_cast<const PB*>(b);
  PF* mv = reinterpret_cast<PF*>(m);
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = i * V;
    Vec<T> xp = pv[i];
    const Vec<T> xg = gv[i];
    PF xm = mv[i];
    const float s = scale[e / kLane];
    float keep = 1.0f, take = 0.0f;
    float b32[V];
    if constexpr (kPartner) {
      al.at(e, keep, take);
      const PB xb = bv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) b32[j] = Conv<B>::to_f(xb.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) b32[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      lars_one<T, kPartner>(xp.v[j], xg.v[j], b32[j], xm.v[j], s, keep, take,
                            c);
    }
    pv[i] = xp;
    mv[i] = xm;
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    T xp = p[e];
    float xm = m[e];
    float keep = 1.0f, take = 0.0f, b32 = 0.0f;
    if constexpr (kPartner) {
      al.at(e, keep, take);
      b32 = Conv<B>::to_f(b[e]);
    }
    lars_one<T, kPartner>(xp, g[e], b32, xm, scale[e / kLane], keep, take, c);
    p[e] = xp;
    m[e] = xm;
  }
}

template <typename T, typename B, bool kPartner>
int launch_one(const LarsBufs& x, const Alpha& al, const LarsCoef& c,
               cudaStream_t stream) {
  constexpr int V = kVec<T>;
  const bool vec = aligned_to(x.p, 16) && aligned_to(x.g, 16) &&
                   aligned_to(x.m, 16) &&
                   aligned_to(x.b, alignof(Pack<B, V>)) && al.row_len % V == 0;
  const int64_t n_vec = vec ? x.n / V : 0;
  const int threads = 256;
  const int blocks = grid_for(n_vec > 0 ? n_vec : x.n, threads);
  fused_lars_kernel<T, B, kPartner><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(x.p), static_cast<const T*>(x.g),
      static_cast<const B*>(x.b), x.m, x.scale, x.n, n_vec, al, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_partner(int pcode, const LarsBufs& x, const Alpha& al,
               const LarsCoef& c, cudaStream_t s) {
  if (x.b == nullptr) return launch_one<T, T, false>(x, al, c, s);
  switch (pcode) {
    case kF32:
      return launch_one<T, float, true>(x, al, c, s);
    case kBF16:
      return launch_one<T, __nv_bfloat16, true>(x, al, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace gossip

// Plain C entry point (bound with ctypes). `b` and `alpha` may be null; `m`
// and `scale` are fp32, `scale` one value per 128 elements of p. Returns
// the cudaError_t of the launch; 0 means it was accepted.
extern "C" int fused_lars_launch(int dtype, int pcode, void* p, const void* g,
                                 const void* b, float* m, const float* scale,
                                 long long n, float keep, float take,
                                 const float* alpha, long long row_len,
                                 float lr, float mu, float wd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const gossip::LarsBufs x{p, g, b, m, scale, n};
  const gossip::Alpha al{keep, take, alpha, row_len};
  const gossip::LarsCoef c{lr, mu, wd};
  switch (dtype) {
    case gossip::kF32:
      return gossip::by_partner<float>(pcode, x, al, c, s);
    case gossip::kBF16:
      return gossip::by_partner<__nv_bfloat16>(pcode, x, al, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
