// Main loop of the dense forward level kernels K1 (frontier_spmm.cu, on
// a square adjacency) and K3 (the frontier half of partial_spmm.cu, on a
// rectangular 2-D block): a classic shared-memory tiled SGEMM in which
// the right-hand operand is *computed while it is loaded* instead of being
// read from device memory.  Only K1/K3 use it; the dependency kernels
// K2/K4 run the pipelined loop of level_gemm.cuh over an operand written
// once a launch, and the operand functors of every level kernel live in
// level_operand.cuh.
//
// One thread block owns one [BM x BS] tile of the [m, s] output.  The
// loop over k inside the block takes the place of the TPU kernels'
// sequential k grid axis and VMEM accumulator: on Hopper blocks run in
// parallel in no order, so nothing carries over between them.  Each step
//   * loads an A[BM x BK] tile (f32 or bf16, converted to f32) into
//     shared memory, transposed so that a thread reads its rows as float4;
//   * builds the [BK x BS] operand tile with the caller's functor (the
//     masked frontier), so that operand never exists in device memory;
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

#include "level_operand.cuh"

namespace bc {

constexpr int BM = 128;      // output rows per block
constexpr int BS = 128;      // output columns (sources) per block
constexpr int BK = 16;       // contraction depth per shared-memory step
constexpr int THREADS = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int TM = 8;
constexpr int TN = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Row (or column) of the i-th micro-tile entry of thread coordinate t:
// two groups of 4 consecutive indices, 64 apart, so that 16 neighbouring
// threads read 256 contiguous bytes of shared memory as float4.
__device__ __forceinline__ int frag_offset(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// acc[i][j] = sum_k A[row0 + frag_offset(ty, i), k] * op(k, col0 + frag_offset(tx, j))
// with tx = threadIdx.x % 16, ty = threadIdx.x / 16, for a row-major A of
// m rows and kdim columns (row stride kdim).  Rows >= m, columns >= s and
// k >= kdim contribute zero, so any shape is accepted; the square level
// kernels pass m = kdim = n.
template <typename AT, typename Operand>
__device__ __forceinline__ void tile_product(const AT* __restrict__ A, int m, int kdim, int s,
                                             int row0, int col0, const Operand& op,
                                             float (&acc)[TM][TN]) {
  // +4 padding: the transposed A store hits 2-way instead of 16-way bank
  // conflicts, and rows stay 16-byte aligned for the float4 reads.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int tr = e / BK;  // neighbouring threads walk along k: coalesced
      const int kk = e % BK;
      const int gr = row0 + tr;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gr < m && gk < kdim) v = to_f32(A[static_cast<size_t>(gr) * kdim + gk]);
      As[kk][tr] = v;
    }
#pragma unroll
    for (int r = 0; r < (BK * BS) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e / BS;
      const int j = e % BS;   // neighbouring threads walk along s: coalesced
      const int gk = k0 + kk;
      const int gj = col0 + j;
      Bs[kk][j] = (gk < kdim && gj < s) ? op(gk, gj) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
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

inline dim3 level_grid(int m, int s) {
  // columns fastest: the blocks that share one A row-tile run side by
  // side, so a second column tile (s > BS) finds that tile in L2
  return dim3((s + BS - 1) / BS, (m + BM - 1) / BM);
}

}  // namespace bc
