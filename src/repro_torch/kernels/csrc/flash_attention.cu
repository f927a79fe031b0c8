// Blocked softmax attention with an online softmax ("flash attention"):
// o = softmax(mask(q k^T * scale)) v for q (BH, S, d), k and v (BH, T, d),
// full heads (GQA repeated beforehand), causal and sliding-window masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (pl.pallas_call at :97, body _flash_kernel). As there, each
// input is cast to fp32 as it is loaded, whatever its own dtype (RoPE leaves
// q and k in fp32 beside a bf16 v, and the kernel reads the three as given), the running max m, sum l and accumulator acc are
// fp32, a masked score is the finite NEG_INF = -1e30 (never -inf: when a
// live tile is fully masked for a row that has seen no key yet, m stays
// -1e30 and exp(m_prev - m_new) = 0 wipes the tile's bogus terms once a real
// key arrives), a key tile that the liveness rule of :43-48 finds fully
// above the diagonal or outside the window is skipped, the result is
// acc / max(l, 1e-30), cast to q's dtype.
//
// Design. One block of 256 threads per (head, 64-query tile); it walks the
// key tiles of 64 in order. Q, the K and V tiles and the probability tile P
// sit in shared memory as fp32 (d padded with zeros to 64, 128 or 256; 115
// KB at d = 128, 211 KB at d = 256). Thread (ty, tx), ty, tx in 0..15, owns
// query rows ty + 16 i (i < 4): for the scores it holds keys tx + 16 j
// (j < 4), a 4 x 4 tile built from 16-byte shared loads of Q and K; the 16
// threads of a row are 16 lanes of one warp, so the row's max and sum are
// shuffle butterflies (every lane gets the same bits). For P V it holds
// output columns 4 tx + 64 c + e, so a whole query row is spread over 16
// threads and no thread holds one (a thread holding a row of d = 128 would
// spill). Products are fp32 fused multiply-adds on the CUDA cores, written
// as __fmaf_rn so that -fmad=false leaves them fused.
//
// Bound on the H100: operations. Per live (query, key) pair 2 d multiply-
// adds (q.k and p v): 4 B H S T d / 2 flops for causal attention. Each
// product's floor is its inputs' peak rate: 989 TFLOP/s on the tensor cores
// for bf16 and fp16 (their products are exact in fp32, the reference's own
// arithmetic), 67 TFLOP/s for fp32. This kernel runs every product as an
// fp32 FMA on the CUDA cores, so it can reach the fp32 rate at best; wgmma
// is the later redesign. Bytes (q, k, v read once, o written once) are far
// below the operations. Heavy causal tiles (the last query
// tiles) are launched first, so the tail of the grid holds the light ones.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBK + 4;  // row stride of the P tile (floats)
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 4 };

template <int DM>
constexpr int smem_bytes() {
  // Q and K with rows padded by 4 floats (16-byte loads of 8 neighbouring
  // rows fall in distinct bank groups), V, P
  return static_cast<int>(sizeof(float)) *
         (kBQ * (DM + 4) + kBK * (DM + 4) + kBK * DM + kBQ * kPS);
}

// element i of a matrix of the given dtype, as fp32 (the branch is uniform
// across the grid)
__device__ __forceinline__ float load_f(const void* __restrict__ src,
                                        int dtype, int64_t i) {
  switch (dtype) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i]);
    case kF16: return __half2float(static_cast<const __half*>(src)[i]);
    default: return static_cast<const float*>(src)[i];
  }
}

// rows [r0, r0 + rows) of the (len, d) matrix that starts at element base
// of src into a (rows, stride) fp32 tile, zero beyond len and beyond d
template <int DM>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const void* __restrict__ src,
                                          int dtype, int64_t base, int64_t r0,
                                          int64_t len, int d, int rows) {
  for (int idx = threadIdx.x; idx < rows * DM; idx += kThreads) {
    const int r = idx / DM, c = idx - (idx / DM) * DM;
    const int64_t row = r0 + r;
    dst[r * stride + c] =
        (row < len && c < d) ? load_f(src, dtype, base + row * d + c) : 0.0f;
  }
}

__device__ __forceinline__ void store_f(void* __restrict__ dst, int dtype,
                                        int64_t i, float x) {
  switch (dtype) {
    case kBF16: static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16_rn(x); break;
    case kF16: static_cast<__half*>(dst)[i] = __float2half_rn(x); break;
    default: static_cast<float*>(dst)[i] = x;
  }
}

// dt: the dtype codes of q (and o), k and v
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const void* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, void* __restrict__ o, int3 dt,
             int64_t bh, int64_t S, int64_t T_len, int d, float scale,
             int causal, int has_window, int64_t window) {
  constexpr int QS = DM + 4;
  constexpr int NC = DM / 64;  // 16-byte column groups of a thread's output
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * DM;

  const int64_t n_qt = (S + kBQ - 1) / kBQ;
  const int64_t head = blockIdx.x % bh;
  const int64_t q0 = (n_qt - 1 - blockIdx.x / bh) * kBQ;  // heavy tiles first
  const int64_t qh = head * S * d, kvh = head * T_len * d;  // head offsets
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<DM>(sQ, QS, q, dt.x, qh, q0, S, d, kBQ);

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < T_len; k0 += kBK) {
    // the reference's tile liveness (block-uniform, so the barriers below
    // are reached by every thread or by none)
    if (causal && k0 > q0 + kBQ - 1) continue;
    if (has_window && k0 + kBK - 1 < q0 - window + 1) continue;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<DM>(sK, QS, k, dt.y, kvh, k0, T_len, d, kBK);
    load_tile<DM>(sV, DM, v, dt.z, kvh, k0, T_len, d, kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < DM; kk += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * QS + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * QS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = __fmaf_rn(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kj = k0 + tx + 16 * j;
        bool keep = true;
        if (causal) keep = keep && kj <= qi;
        if (has_window) keep = keep && (qi - kj) < window;
        // a key past T is no key at all: -inf, so its p is exactly 0
        s[i][j] = kj >= T_len ? -INFINITY
                              : (keep ? __fmul_rn(s[i][j], scale) : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_new));
        sum = __fadd_rn(sum, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      corr[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty + 16 * i) * kPS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = __fmul_rn(acc[i][c][e], corr[i]);
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * kPS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vb = *reinterpret_cast<const float4*>(
              sV + (kk + u) * DM + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                          : u == 2 ? pa[i].z : pa[i].w;
            acc[i][c][0] = __fmaf_rn(p, vb.x, acc[i][c][0]);
            acc[i][c][1] = __fmaf_rn(p, vb.y, acc[i][c][1]);
            acc[i][c][2] = __fmaf_rn(p, vb.z, acc[i][c][2]);
            acc[i][c][3] = __fmaf_rn(p, vb.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < d)
          store_f(o, dt.x, qh + qi * d + col, __fdiv_rn(acc[i][c][e], li));
      }
  }
}

template <int DM>
int launch(const void* q, const void* k, const void* v, void* o, int3 dt,
           int64_t bh, int64_t S, int64_t T_len, int d, float scale,
           int causal, int has_window, int64_t window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (S + kBQ - 1) / kBQ * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<DM><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      q, k, v, o, dt, bh, S, T_len, d, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

bool known(int dtype) { return dtype == kF32 || dtype == kBF16 || dtype == kF16; }

}  // namespace

// Plain C entry point (bound with ctypes): q (bh, S, d), k and v (bh, T, d),
// o (bh, S, d) of q's dtype, all contiguous; each of q, k and v has its own
// dtype code (0 fp32, 1 bf16, 4 fp16); 1 <= d <= 256; window is read only
// when has_window. Returns the cudaError_t of the launch; 0 means it was
// accepted.
extern "C" int flash_attention_launch(int q_dtype, int k_dtype, int v_dtype,
                                      const void* q, const void* k,
                                      const void* v, void* o, long long bh,
                                      long long S, long long T, int d,
                                      float scale, int causal, int has_window,
                                      long long window, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d < 1 || !known(q_dtype) || !known(k_dtype) || !known(v_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int3 dt = make_int3(q_dtype, k_dtype, v_dtype);
  if (d <= 64)
    return launch<64>(q, k, v, o, dt, bh, S, T, d, scale, causal, has_window,
                      window, s);
  if (d <= 128)
    return launch<128>(q, k, v, o, dt, bh, S, T, d, scale, causal,
                       has_window, window, s);
  if (d <= 256)
    return launch<256>(q, k, v, o, dt, bh, S, T, d, scale, causal,
                       has_window, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
