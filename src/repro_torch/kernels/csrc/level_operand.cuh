// The right-hand operands of the BC level kernels, and the pass that
// writes one into device memory.
//
//   FrontierOperand    σ ⊙ [d == lvl-1]                     (K1, K3, K5)
//   DependencyOperand  g = (1 + δ + ω) / σ̂ on d == lvl+1    (K2, K4, K6)
//
// Every level kernel runs operand_kernel first, once a launch, into a
// [k, ld] f32 scratch that the wrapper allocates: the main loops of
// K1-K4 (level_gemm.cuh) and the gathers of K5/K6 (sparse_spmm.cu) then
// read the operand from device memory (L2) instead of rebuilding it from
// σ, d (δ, ω) in every row block — g with its IEEE division.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace bc {

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

// Each translation unit keeps its own copy of the kernel (no relocatable
// device code links the .cu files).
namespace {

// out[k, j] = op(k, j) for j < s and 0 for s <= j < ld (the row stride):
// grid-stride over rows, threads over columns.
template <typename Operand>
__global__ void operand_kernel(Operand op, float* __restrict__ out, int kdim, int s, int ld) {
  for (int k = blockIdx.x; k < kdim; k += gridDim.x) {
    float* row = out + static_cast<size_t>(k) * ld;
    for (int j = threadIdx.x; j < ld; j += blockDim.x) row[j] = j < s ? op(k, j) : 0.f;
  }
}

// Launch the operand pass on `stream` (nothing for kdim == 0).
template <typename Operand>
void write_operand(const Operand& op, float* out, int kdim, int s, int ld, cudaStream_t stream) {
  if (kdim <= 0) return;
  const int blocks = kdim < 132 * 16 ? kdim : 132 * 16;
  operand_kernel<<<blocks, 128, 0, stream>>>(op, out, kdim, s, ld);
}

}  // namespace
}  // namespace bc
