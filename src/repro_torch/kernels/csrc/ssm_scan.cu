// Mamba selective scan  h_t = dA_t * h_{t-1} + dBx_t  along the sequence
// axis of (B, S, D, N) fp32, from h_0 = 0; writes every h_t.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py: ssm_scan_chunked
// (pl.pallas_call at :58, body _scan_kernel). That kernel tiles channels,
// streams S through in chunks and carries h in VMEM scratch from one chunk
// grid step to the next, relying on the TPU running grid steps in order
// (ssm_scan.py:3-8). CUDA blocks run in no order, so nothing carries between
// them here: one thread owns one (b, d, n) state element and walks all of S
// itself, with h in a register. Threads of a block take neighbouring (d, n),
// so each time step's loads and stores are contiguous across the block (one
// (b, t) row is D * N fp32, 131,072 at falcon-mamba width). S and D need no
// padding: the kernel takes any shape.
//
// Bound on the H100: device-memory bytes, 12 per element per step (read dA
// and dBx, write h) for one multiply and one add. The loads do not depend on
// h, so the time loop is unrolled by kUnroll and every step's loads of an
// unrolled group are issued before its dependent multiply-add chain: each
// thread keeps 2 * kUnroll loads in flight, and the chain waits on memory
// once per group, not once per step. Loads and stores bypass L1 reuse
// (streaming hints): every byte is touched once.
//
// __fmul_rn then __fadd_rn, with -fmad=false: the kernel equals the plain
// loop h = dA[:, t] * h + dBx[:, t] (kernels/ref.py: ssm_scan_ref) bit for
// bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kUnroll = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                float* __restrict__ h_out, int64_t batch, int64_t seq,
                int64_t row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * row) return;
  const int64_t b = i / row;
  const int64_t j = i - b * row;
  int64_t off = b * seq * row + j;  // element (b, t, j) of the (B, S, row) view
  float h = 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldcs(dA + off + u * row);
      x[u] = __ldcs(dBx + off + u * row);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(a[u], h), x[u]);
      __stcs(h_out + off + u * row, h);
    }
    off += kUnroll * row;
  }
  for (; t < seq; ++t, off += row) {
    h = __fadd_rn(__fmul_rn(__ldcs(dA + off), h), __ldcs(dBx + off));
    __stcs(h_out + off, h);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): dA, dBx, h are contiguous
// (batch, seq, row) fp32 with row = D * N. Returns the cudaError_t of the
// launch; 0 means it was accepted.
extern "C" int ssm_scan_launch(const float* dA, const float* dBx, float* h,
                               long long batch, long long seq, long long row,
                               void* stream) {
  const long long threads = batch * row;
  if (threads <= 0 || seq <= 0) return 0;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      dA, dBx, h, batch, seq, row);
  return static_cast<int>(cudaGetLastError());
}
