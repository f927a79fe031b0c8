// Design variants of the gossip arrival mix, timed against each other by
// tools/time_mix_designs.py. Not part of the port: the port's kernel is
// src/repro_torch/kernels/csrc/gossip_mix.cu, which keeps the design that
// measured fastest here. Every variant computes what that kernel computes,
//   a <- bf16(f32(a) * keep + partner_f32 * take),
// in place over a bf16 bucket, against a bf16 partner (row 1 of the kernel
// table) or int8 codes with one fp32 scale per 128 elements (row 2), with a
// static alpha or one alpha per replica row, in the reference's op order.
//
//   design 0, "grid-stride": the port's kernel before this comparison: one
//     16-byte vector of a and one of the partner per thread per iteration of
//     a grid-stride loop (8 blocks of 256 threads per SM), 64-bit indices,
//     alpha's row and the scale's tile by a 64-bit division per vector.
//   design 1, "batched": each block owns chunks of 256 * U vectors; a thread
//     loads its U vectors of a and of the partner before any arithmetic;
//     32-bit offsets from the chunk's 64-bit base; alpha's row once per
//     chunk (a division only where a chunk straddles two rows). Grid: one
//     chunk per block over the whole bucket ("wave"), or 8 blocks per SM
//     looping over chunks ("persistent"). Cache hints, a bit mask: 1 the
//     partner by ld.global.cs (evict first), 2 the partner by
//     ld.global.nc.L1::no_allocate, 4 a by ld.global.cs, 8 a stored by
//     st.global.cs; 0 none.
//   design 2, "bulk": a ring of `stages` chunks of a and of the partner in
//     shared memory, filled by 1-D cp.async.bulk copies that complete on
//     mbarriers (expect_tx) issued by one producer warp; 8 consumer warps mix
//     in shared memory and one of them writes each chunk back with a
//     cp.async.bulk store; one block per SM walks its chunks. Whole chunks
//     only: the rest of the bucket goes to design 1.
//
// Build: nvcc with the port's flags and -I src/repro_torch/kernels/csrc.
#include "common.cuh"

namespace gossip {
namespace {

constexpr int kThreads = 256;

// ---- loads and stores with cache hints -----------------------------------

template <int kBytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned; };

template <int kHint, typename P>
__device__ __forceinline__ P ld(const P* p) {
  using R = typename Raw<sizeof(P)>::T;
  R r;
  if constexpr (kHint == 0) {
    r = *reinterpret_cast<const R*>(p);
  } else if constexpr (sizeof(P) == 16) {
    if constexpr (kHint == 1)
      asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    else
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  } else if constexpr (sizeof(P) == 8) {
    if constexpr (kHint == 1)
      asm volatile("ld.global.cs.v2.u32 {%0, %1}, [%2];"
                   : "=r"(r.x), "=r"(r.y) : "l"(p));
    else
      asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                   : "=r"(r.x), "=r"(r.y) : "l"(p));
  } else {
    if constexpr (kHint == 1)
      asm volatile("ld.global.cs.u32 %0, [%1];" : "=r"(r) : "l"(p));
    else
      asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                   : "=r"(r) : "l"(p));
  }
  P out;
  *reinterpret_cast<R*>(&out) = r;
  return out;
}

template <bool kStream, typename P>
__device__ __forceinline__ void st(P* p, const P& x) {
  static_assert(sizeof(P) == 16, "a is stored as 16-byte vectors");
  if constexpr (kStream) {
    const uint4 r = *reinterpret_cast<const uint4*>(&x);
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "r"(r.x), "r"(r.y), "r"(r.z), "r"(r.w)
                 : "memory");
  } else {
    *p = x;
  }
}

// ---- the mix coefficients over one chunk ----------------------------------

// (keep, take) for the elements [e0, e0 + len): one pair for the chunk when
// alpha is static, a () tensor, or the chunk lies in one replica row; else
// the row of each element (a chunk that straddles rows).
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
  // e: element offset from e0
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

template <typename T, typename B, bool kScaled>
__device__ __forceinline__ void mix_vec(Vec<T>& x, const Pack<B, kVec<T>>& y,
                                        float keep, float take, float sc) {
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j)
    x.v[j] = Conv<T>::from_f(mix_f(Conv<T>::to_f(x.v[j]),
                                   partner_f<B, kScaled>(y.v[j], sc), keep,
                                   take));
}

// ---- design 0: the grid-stride sweep --------------------------------------

template <typename T, typename B, bool kScaled>
__global__ void grid_stride(T* __restrict__ a, const B* __restrict__ b,
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
    mix_vec<T, B, kScaled>(x, y, keep, take, sc);
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

// elements [e0, n), one a thread (the masked edge of designs 1 and 2)
template <typename T, typename B, bool kScaled>
__global__ void edge(T* __restrict__ a, const B* __restrict__ b,
                     const float* __restrict__ s, int64_t e0, int64_t n,
                     Alpha al) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = e0 + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < n; e += stride) {
    float keep, take;
    al.at(e, keep, take);
    const float sc = kScaled ? s[e / kLane] : 1.0f;
    a[e] = Conv<T>::from_f(mix_f(Conv<T>::to_f(a[e]),
                                 partner_f<B, kScaled>(b[e], sc), keep, take));
  }
}

// ---- design 1: the batched sweep ------------------------------------------

// vectors [v0, v0 + n_vec) of a and b
template <typename T, typename B, bool kScaled, int U, int kHint>
__global__ void __launch_bounds__(kThreads)
batched(T* __restrict__ a, const B* __restrict__ b,
        const float* __restrict__ s, int64_t v0, int64_t n_vec, Alpha al) {
  constexpr int V = kVec<T>;
  constexpr int kChunk = kThreads * U;       // vectors per chunk
  constexpr int kTileShift = kVec<T> == 8 ? 4 : 5;  // log2(128 / V)
  constexpr int kHintB = kHint & 2 ? 2 : kHint & 1;
  constexpr int kHintA = kHint & 4 ? 1 : 0;
  constexpr bool kStreamA = (kHint & 8) != 0;
  using PB = Pack<B, V>;
  for (int64_t c = blockIdx.x; c * kChunk < n_vec; c += gridDim.x) {
    const int64_t first = v0 + c * kChunk;
    const int64_t left = n_vec - c * kChunk;
    const int rem = left < kChunk ? static_cast<int>(left) : kChunk;
    Vec<T>* av = reinterpret_cast<Vec<T>*>(a) + first;
    const PB* bv = reinterpret_cast<const PB*>(b) + first;
    const ChunkAlpha ca(al, first * V, static_cast<int64_t>(rem) * V);
    // every load of the chunk (a, the partner, its scales) before any
    // arithmetic
    Vec<T> x[U];
    PB y[U];
    float sc[U];
    if (rem == kChunk) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = threadIdx.x + kThreads * u;
        x[u] = ld<kHintA>(av + j);
        y[u] = ld<kHintB>(bv + j);
        sc[u] = kScaled ? __ldg(s + ((first + j) >> kTileShift)) : 1.0f;
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = threadIdx.x + kThreads * u;
        if (j < rem) {
          x[u] = ld<kHintA>(av + j);
          y[u] = ld<kHintB>(bv + j);
          sc[u] = kScaled ? __ldg(s + ((first + j) >> kTileShift)) : 1.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = threadIdx.x + kThreads * u;
      if (j < rem) {
        float keep, take;
        ca.at(j * V, keep, take);
        mix_vec<T, B, kScaled>(x[u], y[u], keep, take, sc[u]);
        st<kStreamA>(av + j, x[u]);
      }
    }
  }
}

// ---- design 2: the bulk-copy ring -----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

constexpr int kConsumers = 256;  // 8 warps; the producer is a 9th

// chunks of CH elements: [0, n_chunks); a's bytes a multiple of 16, the
// partner's too, both pointers 16-byte aligned (the launch checks)
template <typename T, typename B, bool kScaled, int CH>
__global__ void __launch_bounds__(kConsumers + 32)
bulk(T* __restrict__ a, const B* __restrict__ b, const float* __restrict__ s,
     int64_t n_chunks, int stages, Alpha al) {
  constexpr int V = kVec<T>;
  constexpr uint32_t AB = CH * sizeof(T), BB = CH * sizeof(B);
  using PB = Pack<B, V>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sa = smem;
  uint8_t* sb = smem + stages * AB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sb + stages * BB);
  const uint32_t full = smem_u32(bars), empty = full + 8 * stages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      int i = 0;
      for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, ++i) {
        const int st = i % stages;
        if (i >= stages) mbar_wait(empty + 8 * st, (i / stages - 1) & 1);
        mbar_expect_tx(full + 8 * st, AB + BB);
        bulk_load(smem_u32(sa + st * AB), a + c * CH, AB, full + 8 * st);
        bulk_load(smem_u32(sb + st * BB), b + c * CH, BB, full + 8 * st);
      }
    }
    return;
  }
  int i = 0;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, ++i) {
    const int st = i % stages;
    mbar_wait(full + 8 * st, (i / stages) & 1);
    Vec<T>* av = reinterpret_cast<Vec<T>*>(sa + st * AB);
    const PB* bv = reinterpret_cast<const PB*>(sb + st * BB);
    const ChunkAlpha ca(al, c * CH, CH);
#pragma unroll 4
    for (int j = threadIdx.x; j < CH / V; j += kConsumers) {
      float keep, take;
      ca.at(j * V, keep, take);
      const float sc = kScaled ? s[(c * CH + j * V) / kLane] : 1.0f;
      Vec<T> x = av[j];
      mix_vec<T, B, kScaled>(x, bv[j], keep, take, sc);
      av[j] = x;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (threadIdx.x == 0) {
      bulk_store(a + c * CH, smem_u32(sa + st * AB), AB);
      // the previous chunk's store has read its stage: hand it back
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int sms() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename T, typename B, bool kScaled, int U, int kHint>
int launch_batched(T* a, const B* b, const float* s, int64_t v0,
                   int64_t n_vec, int persistent, const Alpha& al,
                   cudaStream_t stream) {
  if (n_vec <= 0) return 0;
  constexpr int64_t kChunk = kThreads * U;
  int64_t blocks = (n_vec + kChunk - 1) / kChunk;
  if (persistent && blocks > 8LL * sms()) blocks = 8LL * sms();
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  batched<T, B, kScaled, U, kHint>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, b, s, v0,
                                                               n_vec, al);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename B, bool kScaled, int U>
int by_hint(int hint, T* a, const B* b, const float* s, int64_t v0,
            int64_t n_vec, int persistent, const Alpha& al, cudaStream_t st) {
#define GOSSIP_HINT(h)                                                 \
  case h:                                                              \
    return launch_batched<T, B, kScaled, U, h>(a, b, s, v0, n_vec,     \
                                               persistent, al, st);
  switch (hint) {
    GOSSIP_HINT(0) GOSSIP_HINT(1) GOSSIP_HINT(5) GOSSIP_HINT(8)
    GOSSIP_HINT(9) GOSSIP_HINT(10) GOSSIP_HINT(13)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOSSIP_HINT
}

template <typename T, typename B, bool kScaled>
int run(int design, int unroll, int hint, int persistent, int stages,
        int chunk_kb, T* a, const B* b, const float* s, int64_t n,
        const Alpha& al, cudaStream_t st) {
  constexpr int V = kVec<T>;
  const bool vec = aligned_to(a, 16) && aligned_to(b, alignof(Pack<B, V>)) &&
                   al.row_len % V == 0;
  const int64_t n_vec = vec ? n / V : 0;
  if (design == 0) {
    const int blocks = grid_for(n_vec > 0 ? n_vec : n, kThreads);
    grid_stride<T, B, kScaled><<<blocks, kThreads, 0, st>>>(a, b, s, n, n_vec, al);
    return static_cast<int>(cudaGetLastError());
  }
  // the masked edge (and every element when the pointers are misaligned)
  // goes to the edge kernel: a separate launch here
  int64_t done = 0;
  int rc = 0;
  if (design == 2) {
    // whole chunks of CH elements by bulk copies; CH = chunk_kb KB of a
    constexpr int CH8 = 8192 / sizeof(T) * 1;  // elements in 8 KB of a
    const int CH = chunk_kb * 1024 / static_cast<int>(sizeof(T));
    if (!(aligned_to(a, 16) && aligned_to(b, 16) &&
          (CH == CH8 || CH == 2 * CH8) && stages >= 2 && stages <= 8))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_chunks = vec ? n / CH : 0;
    if (n_chunks > 0) {
      const size_t smem = static_cast<size_t>(stages) *
                              CH * (sizeof(T) + sizeof(B)) + 16 * stages;
      const int blocks = static_cast<int>(n_chunks < sms() ? n_chunks : sms());
      cudaError_t err;
      if (CH == CH8) {
        err = cudaFuncSetAttribute(bulk<T, B, kScaled, CH8>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        bulk<T, B, kScaled, CH8><<<blocks, kConsumers + 32, smem, st>>>(
            a, b, s, n_chunks, stages, al);
      } else {
        err = cudaFuncSetAttribute(bulk<T, B, kScaled, 2 * CH8>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        bulk<T, B, kScaled, 2 * CH8><<<blocks, kConsumers + 32, smem, st>>>(
            a, b, s, n_chunks, stages, al);
      }
      rc = static_cast<int>(cudaGetLastError());
      if (rc) return rc;
      done = n_chunks * CH / V;
    }
  }
  switch (unroll) {
    case 1: rc = by_hint<T, B, kScaled, 1>(hint, a, b, s, done, n_vec - done, persistent, al, st); break;
    case 2: rc = by_hint<T, B, kScaled, 2>(hint, a, b, s, done, n_vec - done, persistent, al, st); break;
    case 4: rc = by_hint<T, B, kScaled, 4>(hint, a, b, s, done, n_vec - done, persistent, al, st); break;
    case 8: rc = by_hint<T, B, kScaled, 8>(hint, a, b, s, done, n_vec - done, persistent, al, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc || n_vec * V == n) return rc;
  const int blocks = grid_for(n - n_vec * V, kThreads);
  edge<T, B, kScaled><<<blocks, kThreads, 0, st>>>(a, b, s, n_vec * V, n, al);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gossip

// design, unroll (1, 2, 4, 8), hint (a mask of 1, 2, 4, 8: the ones
// instantiated in by_hint), persistent (0, 1), stages and
// chunk_kb (design 2); pcode 1: a bf16 partner, 2: int8 codes with scales.
// a is a bf16 bucket of n elements.
extern "C" int mix_design_launch(int design, int unroll, int hint,
                                 int persistent, int stages, int chunk_kb,
                                 int pcode, void* a, const void* b,
                                 const float* scales, long long n, float keep,
                                 float take, const float* alpha,
                                 long long row_len, void* stream) {
  using namespace gossip;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Alpha al{keep, take, alpha, row_len};
  auto* a16 = static_cast<__nv_bfloat16*>(a);
  if (pcode == 1)
    return run<__nv_bfloat16, __nv_bfloat16, false>(
        design, unroll, hint, persistent, stages, chunk_kb, a16,
        static_cast<const __nv_bfloat16*>(b), nullptr, n, al, st);
  if (pcode == 2)
    return run<__nv_bfloat16, int8_t, true>(
        design, unroll, hint, persistent, stages, chunk_kb, a16,
        static_cast<const int8_t*>(b), scales, n, al, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
