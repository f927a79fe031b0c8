// Adjoint of the Mamba selective scan  h_t = dA_t * h_{t-1} + dBx_t  (from
// h_{-1} = 0) along the sequence axis of (B, S, D, N) fp32: given the
// forward's dA and h and the gradient dh of every h_t, walks
//   g_t = dA_{t+1} * g_{t+1} + dh_t   from g_S = 0 and dA_S = 0,
//   ddBx_t = g_t,   ddA_t = g_t * h_{t-1}   (h_{-1} = 0)
// from t = S - 1 down to 0, and writes ddA and ddBx.
//
// Replaces no TPU kernel. The reference's Pallas scan
// (src/repro/kernels/ssm_scan.py: ssm_scan_chunked) is forward-only, and its
// train path lets XLA differentiate the jnp scan (src/repro/models/mamba.py:
// ssm_scan_chunked_jnp, an associative scan inside lax.scan). Autograd
// through the port's copy of that scan runs every recursion level as
// slices, stacks and concatenations of state-sized buffers; this kernel and
// ssm_scan.cu are the pair that kernels/ssm_scan_kernel.py: ssm_scan_train
// puts under one torch.autograd.Function instead.
//
// Bound on the H100: device-memory bytes, 20 per element per step (read dh,
// dA and h, write ddA and ddBx) for two multiplies and one add. The design
// is ssm_scan.cu's, walked backwards: one thread owns one (b, d, n) state
// element and walks all of S with g in a register; threads of a block take
// neighbouring (d, n), so each time step's loads and stores are contiguous
// rows of D * N fp32. No load depends on g, so the time loop is unrolled by
// kUnroll and an unrolled group's 3 * kUnroll loads (dh_t, dA_t for the next
// step down, h_{t-1}) are all in flight before its dependent chain. Loads and
// stores bypass L1 reuse (streaming hints): every byte is touched once.
//
// __fmul_rn then __fadd_rn, with -fmad=false: the kernel equals the plain
// loop of kernels/ref.py: ssm_scan_bwd_ref bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kUnroll = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ dA, const float* __restrict__ h,
                    const float* __restrict__ dh, float* __restrict__ ddA,
                    float* __restrict__ ddBx, int64_t batch, int64_t seq,
                    int64_t row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * row) return;
  const int64_t b = i / row;
  const int64_t j = i - b * row;
  // element (b, t, j) of the (B, S, row) view, from t = S - 1
  int64_t off = (b * seq + seq - 1) * row + j;
  float g = 0.0f, a_next = 0.0f;
  int64_t t = seq - 1;
  // whole groups t, t - 1, ..., t - kUnroll + 1 whose h_{t-1} all exist
  for (; t >= kUnroll; t -= kUnroll) {
    float d[kUnroll], a[kUnroll], hp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = __ldcs(dh + off - u * row);
      a[u] = __ldcs(dA + off - u * row);
      hp[u] = __ldcs(h + off - (u + 1) * row);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g = __fadd_rn(__fmul_rn(a_next, g), d[u]);
      __stcs(ddBx + off - u * row, g);
      __stcs(ddA + off - u * row, __fmul_rn(g, hp[u]));
      a_next = a[u];
    }
    off -= kUnroll * row;
  }
  for (; t >= 0; --t, off -= row) {
    g = __fadd_rn(__fmul_rn(a_next, g), __ldcs(dh + off));
    __stcs(ddBx + off, g);
    __stcs(ddA + off, __fmul_rn(g, t > 0 ? __ldcs(h + off - row) : 0.0f));
    if (t > 0) a_next = __ldcs(dA + off);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): dA, h, dh, ddA, ddBx are
// contiguous (batch, seq, row) fp32 with row = D * N. Returns the
// cudaError_t of the launch; 0 means it was accepted.
extern "C" int ssm_scan_bwd_launch(const float* dA, const float* h,
                                   const float* dh, float* ddA, float* ddBx,
                                   long long batch, long long seq,
                                   long long row, void* stream) {
  const long long threads = batch * row;
  if (threads <= 0 || seq <= 0) return 0;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      dA, h, dh, ddA, ddBx, batch, seq, row);
  return static_cast<int>(cudaGetLastError());
}
