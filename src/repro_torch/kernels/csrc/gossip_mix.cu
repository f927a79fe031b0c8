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
// ridge. The design therefore only moves bytes well. It is the fastest of
// the designs that tools/time_mix_designs.py timed on the H100 (a
// grid-stride loop with one vector in flight a thread, the same loop
// persistent with four, one wave of blocks with one to eight, each with
// and without cache hints, and a ring of 1-D bulk copies through shared
// memory): one wave of blocks, each owning one chunk of kU * 256 16-byte
// vectors of a (4 fp32 or 8 bf16 elements) and the matching 4-16 bytes of
// partner. A thread issues every load of its kU vectors (a, the partner and,
// for codes, the scale of each vector) before any arithmetic, addresses them
// by 32-bit offsets from the chunk's 64-bit base, and takes alpha's replica
// row once per chunk (a division per element only where a chunk straddles
// two rows) and a scale's tile by a shift. A vector never straddles a scale
// tile (its width divides 128) nor a replica row (the launch requires rows
// of whole vectors). Plain loads and stores: evict-first and no-allocate
// hints measured no faster. Misaligned pointers, and the ragged tail, take a
// masked scalar loop in the same launch.
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

constexpr int kThreads = 256;
constexpr int kU = 4;                    // vectors a thread keeps in flight
constexpr int kChunk = kThreads * kU;    // vectors a block owns

template <int kBytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned; };

// one vector of 4-16 bytes, aligned to its size, as a single load (an fp32
// partner of a bf16 bucket, 32 bytes, as two)
template <typename P>
__device__ __forceinline__ P load_vec(const P* p) {
  if constexpr (sizeof(P) > 16) {
    return *p;
  } else {
    using R = typename Raw<sizeof(P)>::T;
    P out;
    *reinterpret_cast<R*>(&out) = *reinterpret_cast<const R*>(p);
    return out;
  }
}

// (keep, take) for the elements [e0, e0 + len) of one chunk: one pair for
// the chunk when alpha is static, a () tensor, or one replica row holds the
// chunk; else the row of each element
struct ChunkAlpha {
  float keep, take;
  const float* ptr;
  int64_t row, off, row_len;
  __device__ __forceinline__ ChunkAlpha(const Alpha& al, int64_t e0,
                                        int64_t len) {
    ptr = nullptr;
    keep = al.keep;
    take = al.take;
    if (al.ptr == nullptr) return;
    if (al.row_len == 0) {
      take = al.ptr[0];
      keep = __fsub_rn(1.0f, take);
      return;
    }
    row = e0 / al.row_len;
    off = e0 - row * al.row_len;
    if (off + len <= al.row_len) {
      take = al.ptr[row];
      keep = __fsub_rn(1.0f, take);
      return;
    }
    ptr = al.ptr;
    row_len = al.row_len;
  }
  // e: the element's offset from e0
  __device__ __forceinline__ void at(int e, float& k, float& t) const {
    if (ptr == nullptr) {
      k = keep;
      t = take;
      return;
    }
    t = ptr[row + (off + e) / row_len];
    k = __fsub_rn(1.0f, t);
  }
};

// Block c mixes vectors [c * kChunk, (c + 1) * kChunk) of the first n_vec;
// then every thread takes its share of the elements [n_vec * V, n).
template <typename T, typename B, bool kScaled>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(T* __restrict__ a, const B* __restrict__ b,
                  const float* __restrict__ s, int64_t n, int64_t n_vec,
                  Alpha al) {
  constexpr int V = kVec<T>;
  constexpr int kTileShift = V == 8 ? 4 : 5;  // vector -> its scale's tile
  static_assert(kLane == V << kTileShift, "a vector lies in one tile");
  using PB = Pack<B, V>;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  if (first < n_vec) {
    const int rem = n_vec - first < kChunk ? static_cast<int>(n_vec - first)
                                           : kChunk;
    Vec<T>* av = reinterpret_cast<Vec<T>*>(a) + first;
    const PB* bv = reinterpret_cast<const PB*>(b) + first;
    const ChunkAlpha ca(al, first * V, static_cast<int64_t>(rem) * V);
    Vec<T> x[kU];
    PB y[kU];
    float sc[kU];
    // a whole chunk loads unpredicated: with one predicate over whole and
    // partial chunks the int8 mix read 1.254 ms on the largest bucket in
    // one call, this form 1.020 in another (NVIDIA H100 80GB HBM3, 700 W)
    if (rem == kChunk) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = threadIdx.x + kThreads * u;
        x[u] = load_vec(av + j);
        y[u] = load_vec(bv + j);
        sc[u] = kScaled ? __ldg(s + ((first + j) >> kTileShift)) : 1.0f;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = threadIdx.x + kThreads * u;
        if (j < rem) {
          x[u] = load_vec(av + j);
          y[u] = load_vec(bv + j);
          sc[u] = kScaled ? __ldg(s + ((first + j) >> kTileShift)) : 1.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = threadIdx.x + kThreads * u;
      if (j < rem) {
        float keep, take;
        ca.at(j * V, keep, take);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          x[u].v[i] = Conv<T>::from_f(
              mix_f(Conv<T>::to_f(x[u].v[i]),
                    partner_f<B, kScaled>(y[u].v[i], sc[u]), keep, take));
        }
        av[j] = x[u];
      }
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = n_vec * V + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       e < n; e += stride) {
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
  // one chunk a block; a bucket with no vector path takes the scalar loop
  // on a grid that fills the card
  int64_t blocks = (n_vec + kChunk - 1) / kChunk;
  if (n_vec == 0) blocks = grid_for(n, kThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gossip_mix_kernel<T, B, kScaled>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
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
