// Shared main loop of the BC level kernels (frontier_spmm.cu and
// dependency_spmm.cu on a square adjacency, partial_spmm.cu on a
// rectangular 2-D block, sparse_spmm.cu over a list of stored tiles): a
// classic shared-memory tiled SGEMM in which the right-hand operand is
// *computed while it is loaded* instead of being read from device memory.
//
// One thread block owns one [BM x BS] tile of the [m, s] output.  The
// loop over k inside the block takes the place of the TPU kernels'
// sequential k grid axis and VMEM accumulator: on Hopper blocks run in
// parallel in no order, so nothing carries over between them.  Each step
//   * loads an A[BM x BK] tile (f32 or bf16, converted to f32) into
//     shared memory, transposed so that a thread reads its rows as float4;
//   * builds the [BK x BS] operand tile with the caller's functor (the
//     masked frontier or the dependency quotient g), so that operand never
//     exists in device memory;
//   * accumulates an 8x8 register micro-tile per thread with f32 FFMA.
// No tensor cores and no TF32: σ holds exact integer path counts, which
// TF32 or bf16 operands would round; a bf16 A only saves bytes.
//
// Bound (n = 65536, s = 128, one level): 2·n²·s = 1.10e12 FLOP, i.e.
// 16.4 ms at the H100's 67 TFLOP/s of f32 FFMA, against 5.1 ms (f32 A) or
// 2.6 ms (bf16 A) to stream A at 3.35 TB/s — so these kernels are bound by
// f32 compute, and the design spends its effort on keeping the FFMA pipe
// fed from registers (8x8 micro-tiles, float4 shared-memory reads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace bc {

constexpr int BM = 128;      // output rows per block (the dense kernels)
constexpr int BS = 128;      // output columns (sources) per block
constexpr int BK = 16;       // contraction depth per shared-memory step
constexpr int THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int TM = 8;
constexpr int TN = 8;

// Threads of a block that owns TBM output rows: (TBM / 8) x 16 threads
// with an 8 x 8 micro-tile each (256 at TBM = BM).
template <int TBM>
__host__ __device__ constexpr int threads_for() { return 2 * TBM; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Row (or column) of the i-th micro-tile entry of thread coordinate t:
// two groups of 4 consecutive indices, `half` apart (half the block's
// extent on that side), so that neighbouring threads read contiguous
// shared memory as float4.
__device__ __forceinline__ int frag_offset(int t, int i, int half = 64) {
  return (i < 4) ? t * 4 + i : half + t * 4 + (i - 4);
}

// The operand of a forward level: the masked frontier σ ⊙ [d == lvl-1]
// of a row-major [k, s] state.
struct FrontierOperand {
  const float* sigma;
  const int* depth;
  int s;
  int prev;  // lvl - 1

  __device__ __forceinline__ float operator()(int k, int j) const {
    const size_t o = static_cast<size_t>(k) * s + j;
    return depth[o] == prev ? sigma[o] : 0.f;
  }
};

// The operand of a dependency level: g = (1 + δ + ω) / σ̂ on d == lvl+1
// (0 elsewhere; σ̂ = σ, or 1 where σ ≤ 0), divided in IEEE f32.
struct DependencyOperand {
  const float* sigma;
  const int* depth;
  const float* delta;
  const float* omega;
  int s;
  int next;  // lvl + 1

  __device__ __forceinline__ float operator()(int k, int j) const {
    const size_t o = static_cast<size_t>(k) * s + j;
    if (depth[o] != next) return 0.f;
    const float sg = sigma[o];
    const float safe = sg > 0.f ? sg : 1.f;
    return (1.f + delta[o] + omega[k]) / safe;
  }
};

// acc[i][j] += sum_k A[row0 + frag_offset(ty, i, TBM/2), k]
//                   * op(k_op + k, col0 + frag_offset(tx, j))
// with tx = threadIdx.x % 16, ty = threadIdx.x / 16 (threads_for<TBM>()
// threads), for a row-major A of `rows` rows and kdim columns with row
// stride lda.  Rows >= rows, columns >= s and k >= kdim contribute zero,
// so any shape is accepted.  A dense block passes its whole matrix and
// k_op = 0; a stored BCSR tile passes the tile (lda = bk) and the first
// operand row of its tile column.  The caller zeroes acc.
template <int TBM, typename AT, typename Operand>
__device__ __forceinline__ void tile_accumulate(const AT* __restrict__ A, size_t lda, int rows,
                                                int kdim, int s, int row0, int col0, int k_op,
                                                const Operand& op, float (&acc)[TM][TN]) {
  constexpr int NT = threads_for<TBM>();
  // +4 padding: the transposed A store hits 2-way instead of 16-way bank
  // conflicts, and rows stay 16-byte aligned for the float4 reads.
  __shared__ __align__(16) float As[BK][TBM + 4];
  __shared__ __align__(16) float Bs[BK][BS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (TBM * BK) / NT; ++r) {
      const int e = tid + r * NT;
      const int tr = e / BK;  // neighbouring threads walk along k: coalesced
      const int kk = e % BK;
      const int gr = row0 + tr;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gr < rows && gk < kdim) v = to_f32(A[static_cast<size_t>(gr) * lda + gk]);
      As[kk][tr] = v;
    }
    // at most 8 operand elements in flight per thread: the 32 of a 64-thread
    // block, fully unrolled, each with its global loads, spill registers
#pragma unroll 8
    for (int r = 0; r < (BK * BS) / NT; ++r) {
      const int e = tid + r * NT;
      const int kk = e / BS;
      const int j = e % BS;   // neighbouring threads walk along s: coalesced
      const int gk = k0 + kk;
      const int gj = col0 + j;
      Bs[kk][j] = (gk < kdim && gj < s) ? op(k_op + gk, gj) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][TBM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc = the [BM x BS] tile at (row0, col0) of A @ op for a row-major
// A [m, kdim]; the square level kernels pass m = kdim = n.
template <typename AT, typename Operand>
__device__ __forceinline__ void tile_product(const AT* __restrict__ A, int m, int kdim, int s,
                                             int row0, int col0, const Operand& op,
                                             float (&acc)[TM][TN]) {
  zero(acc);
  tile_accumulate<BM>(A, static_cast<size_t>(kdim), m, kdim, s, row0, col0, 0, op, acc);
}

inline dim3 level_grid(int m, int s) {
  // columns fastest: the blocks that share one A row-tile run side by
  // side, so a second column tile (s > BS) finds that tile in L2
  return dim3((s + BS - 1) / BS, (m + BM - 1) / BM);
}

}  // namespace bc
