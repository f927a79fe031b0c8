// Single-sweep fused gossip mix + AdamW update, in place over p, m and v.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py: fused_adamw_1d
// (body _adamw_kernel, tiler _tiled_call, pl.pallas_call at :233), its
// partner_scales variant and its ragged-tail jnp epilogue included. Per
// element, in fp32 whatever the bucket dtype, in the reference's op order
// (_mix_f32 and _adamw_math, fused_update.py:82-122):
//
//   p   = f32(p)
//   b   = f32(partner), times its tile's scale for int8 / e4m3 wire codes
//   p   = f32(cast_T(p * keep + b * take))              if a partner is given
//   g   = f32(g)
//   m   = b1 * m + (1 - b1) * g
//   v   = b2 * v + (1 - b2) * (g * g)
//   u   = (m / c1) / (sqrt(v / c2) + eps)
//   u   = u + wd * p                                    if wd != 0
//   p   = p - lr * u
//   store cast_T(p) over p, m over m, v over v (m and v are fp32)
//
// (1 - b1) and (1 - b2) are formed by the host in double and rounded once
// to fp32, as the reference's weak-typed Python scalars are: in fp32,
// 1.0f - 0.9f is 0x3DCCCCD0, not float32(1 - 0.9) = 0x3DCCCCCD. c1 and c2
// are the bias corrections of the new step count, computed on the host.
//
// Bound on the H100: device-memory bytes. With a raw partner of the
// bucket's dtype it reads p, g, partner, m and v once and writes p, m and v
// once: 4 * sizeof(T) + 16 bytes per element (24 for bf16), and
// 3 * sizeof(T) + 1 + 4/128 + 16 with wire codes (23.03 for bf16). About
// 20 fp32 operations per element (a square root and three divisions among
// them) keep it well under the fp32 rate. The design is the fused_sgd sweep's: one grid-stride
// loop of 16-byte vectors of the bucket (the fp32 moments then take one or
// two 16-byte accesses per vector, the codes 4 or 8 bytes, one scale per
// vector since a vector never straddles a 128-tile), a masked scalar edge
// for the remainder, one launch per replica-stacked bucket, 64-bit indices.
//
// keep/take (a static alpha) or a device alpha pointer of shape () or
// (rows,) (the async ring's per-replica masked alpha), as in fused_sgd.cu.
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn and -fmad=false: the kernel
// agrees bit for bit with kernels/fused_update.py:fused_adamw_plain.
#include "common.cuh"

namespace gossip {
namespace {

struct AdamCoef {
  float lr, c1, c2, b1, b2, omb1, omb2, eps, wd;
};

struct AdamBufs {
  void* p;
  const void* g;
  const void* b;
  const float* bs;
  float* m;
  float* v;
  int64_t n;
};

template <typename T, bool kPartner>
__device__ __forceinline__ void adamw_one(T& p, T g, float b32, float& m,
                                          float& v, float keep, float take,
                                          const AdamCoef& c) {
  float p32 = Conv<T>::to_f(p);
  if (kPartner) {  // round trip through T, as _mix_f32
    p32 = Conv<T>::to_f(Conv<T>::from_f(mix_f(p32, b32, keep, take)));
  }
  const float g32 = Conv<T>::to_f(g);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g32));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g32, g32)));
  float u = __fdiv_rn(__fdiv_rn(m, c.c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c.c2)), c.eps));
  if (c.wd != 0.0f) u = __fadd_rn(u, __fmul_rn(c.wd, p32));
  p = Conv<T>::from_f(__fsub_rn(p32, __fmul_rn(c.lr, u)));
}

template <typename T, typename B, bool kPartner, bool kScaled>
__global__ void fused_adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
                                   const B* __restrict__ b,
                                   const float* __restrict__ bs,
                                   float* __restrict__ m, float* __restrict__ v,
                                   int64_t n, int64_t n_vec, Alpha al,
                                   AdamCoef c) {
  constexpr int V = kVec<T>;
  using PB = Pack<B, V>;
  using PF = Pack<float, V>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Vec<T>* pv = reinterpret_cast<Vec<T>*>(p);
  const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(g);
  const PB* bv = reinterpret_cast<const PB*>(b);
  PF* mv = reinterpret_cast<PF*>(m);
  PF* vv = reinterpret_cast<PF*>(v);
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = i * V;
    Vec<T> xp = pv[i];
    const Vec<T> xg = gv[i];
    PF xm = mv[i];
    PF xv = vv[i];
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
      adamw_one<T, kPartner>(xp.v[j], xg.v[j], b32[j], xm.v[j], xv.v[j], keep,
                             take, c);
    }
    pv[i] = xp;
    mv[i] = xm;
    vv[i] = xv;
  }
  for (int64_t e = n_vec * V + tid; e < n; e += stride) {
    T xp = p[e];
    float xm = m[e], xv = v[e];
    float keep = 1.0f, take = 0.0f, b32 = 0.0f;
    if constexpr (kPartner) {
      al.at(e, keep, take);
      b32 = partner_f<B, kScaled>(b[e], kScaled ? bs[e / kLane] : 1.0f);
    }
    adamw_one<T, kPartner>(xp, g[e], b32, xm, xv, keep, take, c);
    p[e] = xp;
    m[e] = xm;
    v[e] = xv;
  }
}

template <typename T, typename B, bool kPartner, bool kScaled>
int launch_one(const AdamBufs& x, const Alpha& al, const AdamCoef& c,
               cudaStream_t stream) {
  constexpr int V = kVec<T>;
  const bool vec = aligned_to(x.p, 16) && aligned_to(x.g, 16) &&
                   aligned_to(x.m, 16) && aligned_to(x.v, 16) &&
                   aligned_to(x.b, alignof(Pack<B, V>)) && al.row_len % V == 0;
  const int64_t n_vec = vec ? x.n / V : 0;
  const int threads = 256;
  const int blocks = grid_for(n_vec > 0 ? n_vec : x.n, threads);
  fused_adamw_kernel<T, B, kPartner, kScaled><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(x.p), static_cast<const T*>(x.g),
      static_cast<const B*>(x.b), x.bs, x.m, x.v, x.n, n_vec, al, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_partner(int pcode, const AdamBufs& x, const Alpha& al,
               const AdamCoef& c, cudaStream_t s) {
  if (x.b == nullptr) return launch_one<T, T, false, false>(x, al, c, s);
  const bool scaled = x.bs != nullptr;
  switch (pcode) {
    case kF32:
      if (!scaled) return launch_one<T, float, true, false>(x, al, c, s);
      break;
    case kBF16:
      if (!scaled) return launch_one<T, __nv_bfloat16, true, false>(x, al, c, s);
      break;
    case kI8:
      if (scaled) return launch_one<T, int8_t, true, true>(x, al, c, s);
      break;
    case kF8:
      if (scaled) return launch_one<T, Fp8, true, true>(x, al, c, s);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace gossip

// Plain C entry point (bound with ctypes). `b`, `bs` and `alpha` may be
// null; `bs` is given exactly when `b` holds int8 / e4m3 codes. `m` and `v`
// are fp32 whatever the bucket dtype. Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int fused_adamw_launch(int dtype, int pcode, void* p, const void* g,
                                  const void* b, const float* bs, float* m,
                                  float* v, long long n, float keep,
                                  float take, const float* alpha,
                                  long long row_len, float lr, float c1,
                                  float c2, float b1, float b2, float omb1,
                                  float omb2, float eps, float wd,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const gossip::AdamBufs x{p, g, b, bs, m, v, n};
  const gossip::Alpha al{keep, take, alpha, row_len};
  const gossip::AdamCoef c{lr, c1, c2, b1, b2, omb1, omb2, eps, wd};
  switch (dtype) {
    case gossip::kF32:
      return gossip::by_partner<float>(pcode, x, al, c, s);
    case gossip::kBF16:
      return gossip::by_partner<__nv_bfloat16>(pcode, x, al, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
