// Blocked softmax attention with an online softmax ("flash attention"):
// o = softmax(mask(q k^T * scale)) v for q (BH, S, d), k and v (BH, T, d),
// full heads (GQA repeated beforehand), causal and sliding-window masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (pl.pallas_call at :97, body _flash_kernel). As there, the
// arithmetic is fp32: every input is taken at its fp32 value (RoPE leaves q
// and k in fp32 beside a bf16 v, and the kernel reads the three as given),
// q.k^T and p.v are fp32 products summed in fp32, and the running max m,
// sum l and accumulator acc are fp32. A masked score is the finite NEG_INF =
// -1e30 (never -inf: when a live tile is fully masked for a row that has
// seen no key yet, m stays -1e30 and exp(m_prev - m_new) = 0 wipes the
// tile's bogus terms once a real key arrives), a key past T is -inf, a key
// tile that the liveness rule of :43-48 finds fully above the diagonal or
// outside the window is skipped, and the result is acc / max(l, 1e-30),
// cast to q's dtype.
//
// The kernel applies that rule to its own 64-key tiles. For a row with an
// admissible key that changes only the order of the sums (a masked key's p
// is exp(-1e30 - m) = 0 once m is real). A row with none keeps m = -1e30,
// so each key of every live tile counts with p = 1 and the reference's
// output is the mean of v over the keys of the tiles live at the caller's
// (bq, bk) = (min(block_q, S), min(block_k, T)) for the row's query block:
// it depends on the blocks. Such rows form the suffix [r0, S) (a window w:
// r0 = T + w - 1; causal with w < 1: every row), and masked_rows_kernel
// writes them after flash_kernel by the reference's rule, summing each live
// tile's keys in fp32 as the reference adds p . v tile by tile.
//
// Arithmetic: split-bf16 passes on the tensor cores (wgmma, fp32
// accumulators). A bf16 x bf16 (or f16 x f16) product is exact in fp32, so
// a 16-bit operand is one pass. An fp32 value x splits exactly into three
// bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
// (round to nearest; bf16 has fp32's exponent range and 3 x 8 bits cover
// the 24-bit significand; exact for every fp32 normal below bf16's largest
// finite value), and an fp16 value into two. A product then runs the cross
// terms of pieces whose orders sum to at most 2 (hi 0, mid 1, lo 2): 6
// passes for fp32 x fp32, 3 for fp32 x bf16, 5 for fp32 x fp16. The
// dropped terms (mid.lo, lo.mid, lo.lo) lie below 2^-24 of the product.
//   q.k^T: one bf16 pass when q and k are both bf16, one f16 pass when both
//          are fp16; otherwise each side in bf16 pieces (A and B of one
//          wgmma share a type), fp32 q and k 6 passes.
//   p.v:   p (fp32, in registers after the softmax) in 3 bf16 pieces when
//          the output is fp32 and in 2 when it is 16-bit (2^-17 relative,
//          far below a 16-bit ulp); v bf16 as it is, fp16 in 2 pieces, fp32
//          in 3: 3 passes for fp32 p with bf16 v, 6 with fp32 v.
// The passes run smallest terms first.
//
// Design (sm_90a). One block of one warpgroup (128 threads) per (head,
// 64-query tile), heavy causal tiles launched first; it walks its live
// 64-key tiles in order. Q, K and V sit in shared memory as bf16 (or f16)
// pieces in wgmma's 128-byte-swizzled layout, d zero-padded to DM = 64, 128
// or 256 by the loads (zero columns change neither q.k^T nor the kept
// output columns). S = Q K^T is m64n64k16 wgmma with both operands from
// shared memory (K-major); the online softmax runs on the fp32 accumulator
// fragment (a row's 64 scores live in the 4 lanes of a quad: max and sum
// are two shuffles), in the reference's order (m_new, exp(s - m_new), corr
// = exp(m_prev - m_new), then l and acc rescaled); the C fragment of S is
// re-packed in registers as the A fragments of m64n64k16 for p.v, with V
// the B operand from shared memory (MN-major, transposed by the
// instruction), d in 64-column slices. The tensor cores round each
// accumulation step, so for an fp32 output the sums are kept short at DM
// <= 128 (see flash_kernel); at DM = 256 the output's 128 registers a
// thread leave no room for that.
//
// Loads: one buffer each for K and V; V_t loads while S_t's wgmma runs,
// K_{t+1} while p.v_t's runs (a split K after it for an fp32 output, whose
// registers are full then), two barriers per tile. A 16-bit operand stored
// as it is goes by cp.async (16 bytes, no registers); an fp32 or fp16 one
// by 16-byte vector loads through registers that split it into its pieces
// as they store (scalar loads where d % 8 != 0 or a pointer is unaligned).
// Where Q, K and V exceed the 227 KB of shared memory (DM = 256, fp32 k and
// a v that is not bf16) K and V share one buffer and load in turn. Shared
// memory at DM = 128 (16 KB a piece tile): 112 KB for the path's fp32 q
// and k with bf16 v (two blocks per SM), 48 KB for bf16 (three, by
// registers), 144 KB for fp32. (Staging every tile by cp.async a tile
// ahead, with the split done in shared memory, measured no faster on the
// H100: it needs 160 KB on the path, one block per SM.)
//
// Bound on the H100: operations. Per live (query, key) pair 2 d multiply-
// adds (q.k and p.v): 4 B H S T d / 2 flops for causal attention, each at
// the split-pass rate of its operands: 989 TFLOP/s for two 16-bit
// operands, 989/3 with one fp32 operand, 989/6 with two. Bytes (q, k, v
// read once, o written once) are far below.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block (one wgmma M)
constexpr int kBK = 64;        // keys per tile (the scores' wgmma N)
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // 227 KB a block can use on the H100

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 4 };

// one input matrix as the loads see it
struct Operand {
  const void* ptr;  // the head's (len, d) matrix
  int len;          // rows (below 2^30, as every index the kernel forms)
  int dtype;
  int pieces;  // 1: 16-bit as it is; 2 or 3: bf16 pieces of the fp32 value
  int vec;     // 16-byte loads: d % 8 == 0 and the pointer 16-byte aligned
};

struct Params {
  Operand q, k, v;
  void* o;
  int64_t bh;
  int S, T;
  int d;
  float scale;
  int causal, has_window;
  int window;  // clamped to +-2^30 by the launch: the same masks
  int qk_f16;     // q and k both fp16: the scores run as f16 wgmma
  int shared_kv;  // K and V share one buffer
};

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared(uint32_t a, uint32_t x, uint32_t y,
                                          uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x),
               "r"(y), "r"(z), "r"(w)
               : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps a register that an in-flight wgmma reads or writes where it is
// until the wait (the compiler does not know the instruction is async)
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// 16 bytes from global to shared memory without registers; src_bytes 0
// fills the chunk with zeros
__device__ __forceinline__ void cp_async16(uint32_t a, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x, as a value the compiler cannot see through: addresses built from it
// are recomputed where they are used (a few integer operations) instead of
// being hoisted out of the tile loop, where dozens would pin registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}
__device__ __forceinline__ int tid() { return static_cast<int>(opaque(threadIdx.x)); }

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define FA_ACC32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FA_OUT32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 fp32) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared,
// K-major); scale_d 0 overwrites d
template <bool kF16In>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kF16In) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " FA_ACC32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_OUT32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_ACC32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_OUT32(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x 64 fp32) (+)= A (64 x 16 bf16, registers) B (16 x 64 bf16,
// shared, MN-major: the instruction transposes it)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- the split -------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16_bits(float x, float& back) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  back = __bfloat162float(b);
  return static_cast<uint32_t>(__bfloat16_as_ushort(b));
}

// x0 (low half) and x1 in up to three packed bf16 pieces
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  float b0, b1;
  hi = bf16_bits(x0, b0) | (bf16_bits(x1, b1) << 16);
  x0 = __fsub_rn(x0, b0);
  x1 = __fsub_rn(x1, b1);
  mid = bf16_bits(x0, b0) | (bf16_bits(x1, b1) << 16);
  x0 = __fsub_rn(x0, b0);
  x1 = __fsub_rn(x1, b1);
  lo = bf16_bits(x0, b0) | (bf16_bits(x1, b1) << 16);
}

__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid) {
  float b0, b1;
  hi = bf16_bits(x0, b0) | (bf16_bits(x1, b1) << 16);
  mid = bf16_bits(__fsub_rn(x0, b0), b0) |
        (bf16_bits(__fsub_rn(x1, b1), b1) << 16);
}

// ---- loads -----------------------------------------------------------------

// 8 elements of row `row` from column `col` as raw bits: fp32 in w[0..8),
// 16-bit packed in w[0..4); zeros past len and d
__device__ __forceinline__ void fetch(const Operand& op, int d, int row,
                                      int col, uint32_t (&w)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e] = 0u;
  if (row >= op.len || col >= d) return;
  const bool wide = op.dtype == kF32;
  const int64_t at = static_cast<int64_t>(row) * d + col;
  if (op.vec) {
    if (wide) {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const float*>(op.ptr) + at);
      const uint4 a = __ldg(p), b = __ldg(p + 1);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(op.ptr) + at));
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (col + e >= d) break;
    if (wide) {
      w[e] = __float_as_uint(static_cast<const float*>(op.ptr)[at + e]);
    } else {
      const uint32_t h = static_cast<const uint16_t*>(op.ptr)[at + e];
      w[e / 2] |= (e % 2) ? h << 16 : h;
    }
  }
}

// the chunk's pieces into shared memory at a, a + ps, a + 2 ps
__device__ __forceinline__ void put(uint32_t a, uint32_t ps,
                                    const Operand& op, const uint32_t (&w)[8]) {
  if (op.pieces == 1) {
    st_shared(a, w[0], w[1], w[2], w[3]);
    return;
  }
  float x[8];
  if (op.dtype == kF32) {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __uint_as_float(w[e]);
  } else {  // fp16 (bf16 is always one piece)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[e] & 0xFFFFu)));
      x[2 * e + 1] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[e] >> 16)));
    }
  }
  uint32_t hi[4], mid[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split2(x[2 * e], x[2 * e + 1], hi[e], mid[e], lo[e]);
  st_shared(a, hi[0], hi[1], hi[2], hi[3]);
  st_shared(a + ps, mid[0], mid[1], mid[2], mid[3]);
  if (op.pieces == 3) st_shared(a + 2 * ps, lo[0], lo[1], lo[2], lo[3]);
}

// Rows [r0, r0 + 64) of the operand into its pieces at sbase: each piece a
// (DM / 64) x 64 x 128-byte array of 64-column slices, 16-byte chunk c of
// row r at chunk c ^ (r % 8) (the 128-byte swizzle), zero-padded. Thread
// tid owns chunks tid + 128 i of the tile (row-major, 8 elements each).
// load_async: a 16-bit operand stored as it is with 16-byte loads, by
// cp.async (no registers; the caller waits).
// kLean recomputes each chunk's addresses from the thread index instead of
// stepping shared ones, for a call where registers are full. (The row step
// is opaque so that its multiples are not hoisted out of the tile loop.)
template <int DM, bool kLean = false>
__device__ __forceinline__ void load_async(uint32_t sbase, const Operand& op,
                                           int d, int r0) {
  constexpr int kChunksPerRow = DM / 8;
  constexpr int kPerThread = kBK * kChunksPerRow / kThreads;  // DM / 16
  constexpr int kRowStep = kThreads / kChunksPerRow;  // rows between chunks
  // the thread's chunks share a column and step kRowStep rows
  int t = tid();
  int r = t / kChunksPerRow, ch = t % kChunksPerRow;
  const int64_t step = static_cast<int64_t>(kRowStep) * opaque(d);
  const uint16_t* src = static_cast<const uint16_t*>(op.ptr) +
                        static_cast<int64_t>(r0 + r) * d + ch * 8;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (kLean && i > 0) {
      t = tid();
      r = t / kChunksPerRow + kRowStep * i;
      ch = t % kChunksPerRow;
      src = static_cast<const uint16_t*>(op.ptr) +
            static_cast<int64_t>(r0 + r) * d + ch * 8;
    } else if (i > 0) {
      r += kRowStep;
      src += step;
    }
    const bool in = ch * 8 < d && r0 + r < op.len;
    cp_async16(sbase + (ch / 8) * 8192 + r * 128 + (((ch % 8) ^ (r % 8)) << 4),
               in ? static_cast<const void*>(src) : op.ptr, in ? 16 : 0);
  }
}

// load_tile: any operand; by load_async where it can, else through
// registers, kBatch 16-byte chunks in flight a thread
template <int DM, int kBatch>
__device__ __forceinline__ void load_tile(uint32_t sbase, const Operand& op,
                                          int d, int r0) {
  constexpr int kChunksPerRow = DM / 8;
  constexpr int kPerThread = kBK * kChunksPerRow / kThreads;  // DM / 16
  constexpr uint32_t ps = DM * 128;         // bytes of one piece tile
  if (op.pieces == 1 && op.vec) {
    load_async<DM>(sbase, op, d, r0);
    return;
  }
#pragma unroll 1
  for (int b = 0; b < kPerThread; b += kBatch) {
    uint32_t w[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = tid() + kThreads * (b + u);
      fetch(op, d, r0 + idx / kChunksPerRow, (idx % kChunksPerRow) * 8, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = tid() + kThreads * (b + u);
      const int r = idx / kChunksPerRow, ch = idx % kChunksPerRow;
      put(sbase + (ch / 8) * 8192 + r * 128 + (((ch % 8) ^ (r % 8)) << 4), ps,
          op, w[u]);
    }
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

__device__ __forceinline__ int64_t elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : 2;
}

__device__ __forceinline__ float load_f(const void* __restrict__ src,
                                        int dtype, int64_t i) {
  switch (dtype) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(src)[i]);
    case kF16: return __half2float(static_cast<const __half*>(src)[i]);
    default: return static_cast<const float*>(src)[i];
  }
}

// ---- rows with no admissible key -------------------------------------------

// One block per (head, query block of bq rows that holds rows >= r0); a
// thread per output column. The live key tiles of the block form one run
// [t_lo, t_hi] (the reference's rule at (bq, bk)); every key in it counts
// with p = 1: o = (sum over tiles of the tile's sum of v) / keys, 0 where no
// tile is live.
__global__ void __launch_bounds__(kThreads)
masked_rows_kernel(const Params prm, int bq, int bk, int r0) {
  const int first_qb = r0 / bq;
  const int nqb = (prm.S - 1) / bq - first_qb + 1;
  const int64_t head = blockIdx.x / nqb;
  const int64_t q0 = static_cast<int64_t>(first_qb + blockIdx.x % nqb) * bq;
  const int64_t n_kt = (prm.T + bk - 1) / bk;
  int64_t t_hi = n_kt - 1;
  if (prm.causal && (q0 + bq - 1) / bk < t_hi) t_hi = (q0 + bq - 1) / bk;
  int64_t t_lo = 0;
  if (prm.has_window) {  // live iff k0 + bk - 1 >= q0 - window + 1
    const int64_t need = q0 - prm.window + 1 - (bk - 1);
    if (need > 0) t_lo = (need + bk - 1) / bk;
  }
  const int d = prm.d;
  const int64_t vbase = head * prm.T * d, obase = head * prm.S * d;
  const int64_t row_lo = q0 > r0 ? q0 : r0;
  const int64_t row_hi = q0 + bq < prm.S ? q0 + bq : prm.S;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float acc = 0.0f, l = 0.0f;
    for (int64_t t = t_lo; t <= t_hi; ++t) {
      const int64_t k1 = (t + 1) * bk < prm.T ? (t + 1) * bk : prm.T;
      float part = 0.0f;
      for (int64_t j = t * bk; j < k1; ++j)
        part = __fadd_rn(part, load_f(prm.v.ptr, prm.v.dtype, vbase + j * d + col));
      acc = __fadd_rn(acc, part);
      l = __fadd_rn(l, static_cast<float>(k1 - t * bk));
    }
    const float o = __fdiv_rn(acc, fmaxf(l, 1e-30f));
    for (int64_t r = row_lo; r < row_hi; ++r)
      store_f(prm.o, prm.q.dtype, obase + r * d + col, o);
  }
}

// ---- the kernel --------------------------------------------------------------

// kExact: the output is fp32, so the sums keep fp32 grade: p in 3 pieces
// and, at DM <= 128 (registers), short accumulation chains (the tensor
// cores round each step): the scores' hi.hi chain in two accumulators, and
// each tile's p.v in a fresh one added to acc * corr in fp32, as the
// reference adds jnp.dot(p, v). A 16-bit output (ulp 2^-8 or 2^-11) takes
// p in 2 pieces and one accumulator for each product, and at DM <= 128 fits
// 168 registers, three blocks per SM.
template <int DM, bool kExact>
__global__ void __launch_bounds__(kThreads, !kExact && DM <= 128 ? 3 : 1)
flash_kernel(const Params prm) {
  constexpr int NB = DM / 64;         // 64-column slices of the output
  constexpr uint32_t PT = DM * 128;   // bytes of one 64-row piece tile
  constexpr int NP = kExact ? 3 : 2;  // pieces of p
  constexpr bool kSplitAcc = kExact && DM <= 128;
  constexpr bool kThreeBlocks = !kExact && DM <= 128;
  // Loads through registers (a split operand, or an unaligned one): Q, K of
  // the first tile and V_t (during S's wgmma) one chunk at a time; a split
  // K_{t+1} during p.v's wgmma with 168 registers, else after it, where
  // the freed registers keep two chunks in flight at DM <= 128. (Every
  // batch size here is the largest at which ptxas spills nothing.)
  constexpr int kBatchV = 1;
  constexpr int kBatchK = kThreeBlocks || DM > 128 ? 1 : 2;
  constexpr bool kOverlapSplitK = kThreeBlocks;
  extern __shared__ uint8_t smem_raw[];
  const bool shared = prm.shared_kv;
  const int nq = prm.q.pieces, nk = prm.k.pieces, nv = prm.v.pieces;
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + nq * PT;
  const uint32_t sV = shared ? sK : sK + nk * PT;
  const int d = prm.d;

  const int n_qt = (prm.S + kBQ - 1) / kBQ;
  const int64_t head = blockIdx.x % prm.bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / prm.bh)) * kBQ;
  // (heavy causal tiles first)
  Operand Q = prm.q, K = prm.k, V = prm.v;
  Q.ptr = static_cast<const char*>(Q.ptr) + head * prm.S * d * elem_bytes(Q.dtype);
  K.ptr = static_cast<const char*>(K.ptr) + head * prm.T * d * elem_bytes(K.dtype);
  V.ptr = static_cast<const char*>(V.ptr) + head * prm.T * d * elem_bytes(V.dtype);
  // K_{t+1} during p.v's wgmma: by cp.async when it is 16-bit as it is
  const bool k_early = !shared && ((nk == 1 && K.vec) || kOverlapSplitK);

  // the live key tiles form one run [t_lo, t_hi] (the reference's rule)
  int t_hi = (prm.T + kBK - 1) / kBK - 1;
  if (prm.causal && (q0 + kBQ - 1) / kBK < t_hi) t_hi = (q0 + kBQ - 1) / kBK;
  int t_lo = 0;
  if (prm.has_window) {  // live iff k0 + kBK - 1 >= q0 - window + 1
    const int need = q0 - prm.window + 1 - (kBK - 1);
    if (need > 0) t_lo = (need + kBK - 1) / kBK;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int qrow[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  if (t_lo <= t_hi) {
    load_tile<DM, kBatchV>(sQ, Q, d, q0);
    load_tile<DM, kBatchV>(sK, K, d, t_lo * kBK);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }
#pragma unroll 1
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    const bool more = t < t_hi;
    const uint32_t sVt = opaque(sV);
    // descriptors of piece 0; a piece, k-step or slice adds its byte
    // offset / 16 to the start-address field (no carry: shared memory is
    // below 256 KB)
    const uint64_t dQ = desc(opaque(sQ), 16, 1024),
                   dK = desc(opaque(sK), 16, 1024);
    // ---- S = Q K^T, the cross terms of the pieces, smallest first; with
    // kSplitAcc the hi.hi pass's first half of d sums into s2 (with the
    // small terms), the second half into s
    float s[32], s2[kSplitAcc ? 32 : 1];
    // (the pass guards read the piece counts afresh each tile: hoisted, they
    // are held through the loop)
    const int nqt = static_cast<int>(opaque(nq)), nkt = static_cast<int>(opaque(nk));
    wgmma_fence();
    int first = 1, first2 = 1;
#pragma unroll
    for (int ord = 2; ord >= 0; --ord)
#pragma unroll
      for (int i = 0; i <= ord; ++i) {
        const int j = ord - i;
        if (i >= nqt || j >= nkt) continue;
#pragma unroll
        for (int ks = 0; ks < DM / 16; ++ks) {
          const uint32_t off = (ks / 4) * 8192 + (ks % 4) * 32;
          const uint64_t da = dQ + ((i * PT + off) >> 4);
          const uint64_t db = dK + ((j * PT + off) >> 4);
          const bool f16 = ord == 0 && prm.qk_f16;
          if constexpr (kSplitAcc) {
            if (ord > 0 || ks < DM / 32) {
              if (f16)
                wgmma_ss<true>(s2, da, db, first2 ? 0 : 1);
              else
                wgmma_ss<false>(s2, da, db, first2 ? 0 : 1);
              first2 = 0;
              continue;
            }
          }
          if (f16)
            wgmma_ss<true>(s, da, db, first ? 0 : 1);
          else
            wgmma_ss<false>(s, da, db, first ? 0 : 1);
          first = 0;
        }
      }
    wgmma_commit();
    if (!shared) load_tile<DM, kBatchV>(sVt, V, d, k0);  // during S's wgmma
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      keep(s[i]);
      if constexpr (kSplitAcc) {
        keep(s2[i]);
        s[i] = __fadd_rn(s2[i], s[i]);
      }
    }

    // ---- online softmax on the accumulator fragment: element 4 j + e is
    // row 16 warp + g + 8 (e / 2), key 8 j + 2 c + e % 2. Masks are formed
    // only where the tile is not wholly visible to all 64 rows.
    const bool whole = (!prm.causal || k0 + kBK - 1 <= q0) &&
                       (!prm.has_window || q0 + kBQ - 1 - k0 < prm.window) &&
                       k0 + kBK <= prm.T;
    float mx[2] = {kNegInf, kNegInf};
    // (opaque: the 32 thresholds qrow - key offset are loop-invariant, and
    // hoisted out of the tile loop they would pin 32 registers)
    const int kc = k0 + 2 * static_cast<int>(opaque(c));
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i % 4) / 2;
      if (whole) {
        s[i] = __fmul_rn(s[i], prm.scale);
      } else {
        const int kj = kc + 8 * (i / 4) + (i % 2);
        bool live = true;
        if (prm.causal) live = live && kj <= qrow[rr];
        if (prm.has_window) live = live && (qrow[rr] - kj) < prm.window;
        // a key past T is no key at all: -inf, so its p is exactly 0
        s[i] = kj >= prm.T ? -INFINITY
                           : (live ? __fmul_rn(s[i], prm.scale) : kNegInf);
      }
      mx[rr] = fmaxf(mx[rr], s[i]);
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      mx[rr] = fmaxf(m[rr], mx[rr]);  // m_new
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int rr = (i % 4) / 2;
      s[i] = expf(__fsub_rn(s[i], mx[rr]));
      sum[rr] = __fadd_rn(sum[rr], s[i]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] = __fadd_rn(sum[rr], __shfl_xor_sync(0xffffffffu, sum[rr], 1));
      sum[rr] = __fadd_rn(sum[rr], __shfl_xor_sync(0xffffffffu, sum[rr], 2));
      corr[rr] = expf(__fsub_rn(m[rr], mx[rr]));
      l[rr] = __fadd_rn(__fmul_rn(l[rr], corr[rr]), sum[rr]);
      m[rr] = mx[rr];
    }
    // p as the A fragments of 4 k-steps of 16 keys, in pieces: register r
    // of step ks packs accumulator elements 8 ks + 2 r and 8 ks + 2 r + 1
    uint32_t pf[NP][4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * ks + 2 * r], x1 = s[8 * ks + 2 * r + 1];
        if constexpr (NP == 3)
          split2(x0, x1, pf[0][ks][r], pf[1][ks][r], pf[2][ks][r]);
        else
          split2(x0, x1, pf[0][ks][r], pf[1][ks][r]);
      }
    if constexpr (!kSplitAcc) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          o[nb][i] = __fmul_rn(o[nb][i], corr[(i % 4) / 2]);
    }

    if (shared) {
      __syncthreads();  // every warp is done reading K
      load_tile<DM, kBatchV>(sVt, V, d, k0);
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // V_t is in place

    // ---- acc = acc * corr + P V, smallest terms first, one 64-column
    // slice at a time
    const uint64_t dV = desc(opaque(sV), 1024, 1024);
    const int nvt = static_cast<int>(opaque(nv));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float pv[kSplitAcc ? 32 : 1];
      if constexpr (!kSplitAcc) {
#pragma unroll
        for (int i = 0; i < 32; ++i) keep(o[nb][i]);
      }
      wgmma_fence();
      int fresh = 1;
#pragma unroll
      for (int ord = 2; ord >= 0; --ord)
#pragma unroll
        for (int i = 0; i <= ord; ++i) {
          const int j = ord - i;
          if (i >= NP || j >= nvt) continue;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t db = dV + ((j * PT + nb * 8192 + ks * 2048) >> 4);
            if constexpr (kSplitAcc)
              wgmma_rs(pv, pf[i][ks], db, fresh ? 0 : 1);
            else
              wgmma_rs(o[nb], pf[i][ks], db, 1);
            fresh = 0;
          }
        }
      wgmma_commit();
      if (nb == 0 && more && k_early) {  // K_{t+1} while P V's wgmma runs
        if constexpr (kOverlapSplitK)
          load_tile<DM, kBatchK>(sK, K, d, k0 + kBK);
        else
          load_async<DM, true>(sK, K, d, k0 + kBK);
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) keep(pf[i][ks][r]);
      if constexpr (kSplitAcc) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          keep(pv[i]);
          o[nb][i] = __fadd_rn(__fmul_rn(o[nb][i], corr[(i % 4) / 2]), pv[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) keep(o[nb][i]);
      }
    }
    if (more && !k_early) {
      if (shared) __syncthreads();  // every warp is done reading V
      load_tile<DM, kBatchK>(sK, K, d, k0 + kBK);
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // K_{t+1} is in place; V_t is no longer read
  }

  // ---- o = acc / max(l, 1e-30), in q's dtype
  // (recomputed here from an opaque block index: computed at entry, it
  // would sit in registers, or spill, through the whole loop)
  const int64_t obase = (opaque(blockIdx.x) % prm.bh) * prm.S * d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qrow[rr] >= prm.S) continue;
    const float li = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nb * 64 + 8 * j + 2 * c + e;
          if (col < d)
            store_f(prm.o, prm.q.dtype,
                    obase + static_cast<int64_t>(qrow[rr]) * d + col,
                    __fdiv_rn(o[nb][4 * j + 2 * rr + e], li));
        }
  }
}

template <int DM, bool kExact>
int launch_as(Params prm, cudaStream_t stream) {
  constexpr uint32_t PT = DM * 128;
  // Q, K and V pieces (+ 1024 for the alignment); K and V in one buffer
  // where the three do not fit
  uint32_t bytes = (prm.q.pieces + prm.k.pieces + prm.v.pieces) * PT + 1024;
  prm.shared_kv = bytes > kMaxSmem;
  if (prm.shared_kv)
    bytes = (prm.q.pieces + (prm.k.pieces > prm.v.pieces ? prm.k.pieces
                                                         : prm.v.pieces)) *
                PT + 1024;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DM, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (prm.S + kBQ - 1) / kBQ * prm.bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<DM, kExact>
      <<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <int DM>
int launch(const Params& prm, cudaStream_t stream) {
  return prm.q.dtype == kF32 ? launch_as<DM, true>(prm, stream)
                             : launch_as<DM, false>(prm, stream);
}

bool known(int dtype) { return dtype == kF32 || dtype == kBF16 || dtype == kF16; }

Operand operand(const void* p, int len, int dtype, int pieces, int d) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) % 16) == 0;
  return Operand{p, len, dtype, pieces, d % 8 == 0 && aligned};
}

// pieces of an operand: a 16-bit one as it is when it is bf16 (or fp16 in
// an f16 product), else bf16 pieces of its fp32 value
int pieces(int dtype, bool f16_native) {
  if (dtype == kF32) return 3;
  if (dtype == kBF16 || f16_native) return 1;
  return 2;
}

}  // namespace

// Plain C entry point (bound with ctypes): q (bh, S, d), k and v (bh, T, d),
// o (bh, S, d) of q's dtype, all contiguous; each of q, k and v has its own
// dtype code (0 fp32, 1 bf16, 4 fp16); 1 <= d <= 256; window is read only
// when has_window; bq and bk are the caller's blocks (min(block_q, S),
// min(block_k, T)), which decide the rows with no admissible key. Returns
// the cudaError_t of the launches; 0 means they were accepted.
extern "C" int flash_attention_launch(int q_dtype, int k_dtype, int v_dtype,
                                      const void* q, const void* k,
                                      const void* v, void* o, long long bh,
                                      long long S, long long T, int d,
                                      float scale, int causal, int has_window,
                                      long long window, long long bq,
                                      long long bk, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  constexpr long long kMaxLen = 1 << 30;  // every index stays in 32 bits
  if (d < 1 || !known(q_dtype) || !known(k_dtype) || !known(v_dtype) ||
      S < 0 || T < 0 || S >= kMaxLen || T >= kMaxLen || bq < 1 || bk < 1 ||
      bq >= kMaxLen || bk >= kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f16 = q_dtype == kF16 && k_dtype == kF16;
  Params prm{};
  prm.S = static_cast<int>(S);
  prm.T = static_cast<int>(T);
  prm.q = operand(q, prm.S, q_dtype, pieces(q_dtype, f16), d);
  prm.k = operand(k, prm.T, k_dtype, pieces(k_dtype, f16), d);
  prm.v = operand(v, prm.T, v_dtype, pieces(v_dtype, false), d);
  prm.o = o;
  prm.bh = bh;
  prm.d = d;
  prm.scale = scale;
  prm.causal = causal;
  prm.has_window = has_window;
  // |q - k| < 2^30 for every pair, so a window past +-2^30 masks as that
  prm.window = static_cast<int>(window > kMaxLen    ? kMaxLen
                                : window < -kMaxLen ? -kMaxLen
                                                    : window);
  prm.qk_f16 = f16;
  const int rc = d <= 64    ? launch<64>(prm, s)
                 : d <= 128 ? launch<128>(prm, s)
                 : d <= 256 ? launch<256>(prm, s)
                            : static_cast<int>(cudaErrorInvalidValue);
  // the first row with no admissible key: i >= T + w - 1 leaves none in
  // the window; causal with w < 1 none at all
  long long r0 = S;
  if (has_window)
    r0 = causal && prm.window < 1 ? 0 : T + prm.window - 1;
  if (r0 < 0) r0 = 0;
  if (rc != 0 || r0 >= S) return rc;
  const long long blocks = ((S - 1) / bq - r0 / bq + 1) * bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  masked_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      prm, static_cast<int>(bq), static_cast<int>(bk), static_cast<int>(r0));
  return static_cast<int>(cudaGetLastError());
}
