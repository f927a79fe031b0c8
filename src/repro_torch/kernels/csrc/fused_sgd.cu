// Single-sweep fused gossip mix + SGD-momentum update, in place over p and m.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py: fused_sgd_1d
// (body _sgd_kernel, tiler _tiled_call, pl.pallas_call at :233), its
// partner_scales variant included. Per element, in fp32 whatever the bucket
// dtype, in the reference's op order (_mix_f32 and _sgd_math,
// fused_update.py:82-110):
//
//   p   = f32(p)
//   b   = f32(partner), times its tile's scale for int8 / e4m3 wire codes
//   p   = f32(cast_T(p * keep + b * take))                if a partner is given
//   g   = f32(g) + wd * p                                 if wd != 0
//   m   = mu * f32(m) + g;  p = p - lr * m                if m is given
//   p   = p - lr * g                                      otherwise
//   store cast_T(p) over p and cast_T(m) over m
//
// The reference aliases param and momentum outputs onto their inputs
// (input_output_aliases); this kernel writes both in place. The partner must
// not alias p: the engines hand it an exchanged copy (core/gossip.py). A
// null partner (the wrapper passes none for a static alpha of 0, as the
// reference drops that read) or a null momentum select a kernel without
// that stream. The partner may be fp32, bf16 (promoted, as the reference's
// _mix_f32 does), or int8 / float8_e4m3fn codes with one fp32 scale per
// 128-element tile (the quantized wire).
//
// Bound on the H100: device-memory bytes. With a partner and a momentum it
// reads p, g, partner and m once and writes p and m once: 6 * sizeof(T)
// bytes per element with a raw partner of the bucket's dtype, 5 * sizeof(T)
// + 1 + 4/128 with wire codes, for about 10 flops. The design moves bytes
// well and nothing else: one grid-stride sweep of 16-byte vector loads and
// stores (the code vector is 4 or 8 bytes, one scale per vector since a
// vector never straddles a 128-tile), a masked scalar edge for the
// remainder (the reference's ragged-tail jnp epilogue), one launch per
// bucket with 64-bit indices.
//
// keep/take (a static alpha) or a device alpha pointer of shape () or
// (rows,) (the async ring's per-replica masked alpha, keep = 1 - alpha in
// fp32 in the kernel), and lr, mu, wd as float arguments.
// __fmul_rn / __fadd_rn / __fsub_rn and -fmad=false: the kernel agrees bit
// for bit with kernels/fused_update.py:fused_sgd_plain.
#include "common.cuh"

namespace gossip {
namespace {

struct Coef {
  float lr, mu, wd;
};

struct Bufs {
  void* p;
  const void* g;
  const void* b;
  const float* bs;
  void* m;
  int64_t n;
};

template <typename T, bool kPartner, bool kMom>
__device__ __forceinline__ void sgd_one(T& p, T g, float b32, T& m, float keep,
                                        float take, const Coef& c) {
  float p32 = Conv<T>::to_f(p);
  if (kPartner) {  // round trip through T, as _mix_f32
    p32 = Conv<T>::to_f(Conv<T>::from_f(mix_f(p32, b32, keep, take)));
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

template <typename T, typename B, bool kPartner, bool kScaled, bool kMom>
__global__ void fused_sgd_kernel(T* __restrict__ p, const T* __restrict__ g,
                                 const B* __restrict__ b,
                                 const float* __restrict__ bs,
                                 T* __restrict__ m, int64_t n, int64_t n_vec,
                                 Alpha al, Coef c) {
  constexpr int V = kVec<T>;
  using PB = Pack<B, V>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Vec<T>* pv = reinterpret_cast<Vec<T>*>(p);
  const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(g);
  const PB* bv = reinterpret_cast<const PB*>(b);
  Vec<T>* mv = reinterpret_cast<Vec<T>*>(m);
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = i * V;
    Vec<T> xp = pv[i];
    const Vec<T> xg = gv[i];
    Vec<T> xm = kMom ? mv[i] : xp;  // xp stands in for an absent momentum
    float keep = 1.0f, take = 0.0f, sc = 1.0f;
    float b32[V];
    if constexpr (kPartner) {
      al.at(e, keep, take);
      if constexpr (kScaled) sc = bs[e / kLane];
      const PB xb = bv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) b32[j] = partner_f<B, kScaled>(xb.v[j], sc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) b32[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sgd_one<T, kPartner, kMom>(xp.v[j], xg.v[j], b32[j], xm.v[j], keep,
                                 take, c);
    }
    pv[i] = xp;
    if (kMom) mv[i] = xm;
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    T xp = p[e];
    T xm = kMom ? m[e] : xp;
    float keep = 1.0f, take = 0.0f, b32 = 0.0f;
    if constexpr (kPartner) {
      al.at(e, keep, take);
      b32 = partner_f<B, kScaled>(b[e], kScaled ? bs[e / kLane] : 1.0f);
    }
    sgd_one<T, kPartner, kMom>(xp, g[e], b32, xm, keep, take, c);
    p[e] = xp;
    if (kMom) m[e] = xm;
  }
}

template <typename T, typename B, bool kPartner, bool kScaled, bool kMom>
int launch_one(const Bufs& x, const Alpha& al, const Coef& c,
               cudaStream_t stream) {
  constexpr int V = kVec<T>;
  const bool vec = aligned_to(x.p, 16) && aligned_to(x.g, 16) &&
                   aligned_to(x.m, 16) &&
                   aligned_to(x.b, alignof(Pack<B, V>)) && al.row_len % V == 0;
  const int64_t n_vec = vec ? x.n / V : 0;
  const int threads = 256;
  const int blocks = grid_for(n_vec > 0 ? n_vec : x.n, threads);
  fused_sgd_kernel<T, B, kPartner, kScaled, kMom>
      <<<blocks, threads, 0, stream>>>(
          static_cast<T*>(x.p), static_cast<const T*>(x.g),
          static_cast<const B*>(x.b), x.bs, static_cast<T*>(x.m), x.n, n_vec,
          al, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B, bool kPartner, bool kScaled>
int by_mom(const Bufs& x, const Alpha& al, const Coef& c, cudaStream_t s) {
  return x.m != nullptr ? launch_one<T, B, kPartner, kScaled, true>(x, al, c, s)
                        : launch_one<T, B, kPartner, kScaled, false>(x, al, c, s);
}

template <typename T>
int by_partner(int pcode, const Bufs& x, const Alpha& al, const Coef& c,
               cudaStream_t s) {
  if (x.b == nullptr) return by_mom<T, T, false, false>(x, al, c, s);
  const bool scaled = x.bs != nullptr;
  switch (pcode) {
    case kF32:
      if (!scaled) return by_mom<T, float, true, false>(x, al, c, s);
      break;
    case kBF16:
      if (!scaled) return by_mom<T, __nv_bfloat16, true, false>(x, al, c, s);
      break;
    case kI8:
      if (scaled) return by_mom<T, int8_t, true, true>(x, al, c, s);
      break;
    case kF8:
      if (scaled) return by_mom<T, Fp8, true, true>(x, al, c, s);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace gossip

// Plain C entry point (bound with ctypes). `b`, `bs`, `m` and `alpha` may be
// null; `bs` is given exactly when `b` holds int8 / e4m3 codes. Returns the
// cudaError_t of the launch; 0 means it was accepted.
extern "C" int fused_sgd_launch(int dtype, int pcode, void* p, const void* g,
                                const void* b, const float* bs, void* m,
                                long long n, float keep, float take,
                                const float* alpha, long long row_len,
                                float lr, float mu, float wd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const gossip::Bufs x{p, g, b, bs, m, n};
  const gossip::Alpha al{keep, take, alpha, row_len};
  const gossip::Coef c{lr, mu, wd};
  switch (dtype) {
    case gossip::kF32:
      return gossip::by_partner<float>(pcode, x, al, c, s);
    case gossip::kBF16:
      return gossip::by_partner<__nv_bfloat16>(pcode, x, al, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
