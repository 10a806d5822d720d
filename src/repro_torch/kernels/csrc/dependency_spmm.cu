// K2 — fused backward dependency level on a dense adjacency.
//
// Replaces the TPU kernel kernels/dependency_spmm.py:dependency_spmm_kernel
// (wrapper dependency_spmm_pallas, padding in ops.dependency_spmm) of the
// JAX package.  Per level of the dependency sweep (checking successors):
//
//     g   = (1 + δ + ω) / σ̂   on  d == lvl+1   (0 elsewhere; σ̂ = σ, or 1 where σ ≤ 0)
//     t   = A @ g
//     δ'  = δ + σ ⊙ t          on  d == lvl
//
// g is recomputed from the (σ, d, δ, ω) tiles while the operand tile is
// loaded, so it never reaches device memory, and the δ update runs in the
// epilogue.  The division is IEEE f32 (the library is built without
// --use_fast_math) and σ·t is rounded before the add (__fmul_rn), as in
// the reference.  Main loop and bound: see level_tile.cuh (f32 compute
// bound).  Ragged n and s are masked in the kernel.
#include "level_tile.cuh"

namespace {

template <typename AT>
__global__ void __launch_bounds__(bc::THREADS)
    dependency_spmm_kernel(const AT* __restrict__ A, const float* __restrict__ sigma,
                           const int* __restrict__ depth, const float* __restrict__ delta,
                           const float* __restrict__ omega, float* __restrict__ delta_out,
                           int n, int s, int lvl) {
  const int row0 = blockIdx.y * bc::BM;
  const int col0 = blockIdx.x * bc::BS;
  float acc[bc::TM][bc::TN];
  bc::tile_product(A, n, n, s, row0, col0,
                   bc::DependencyOperand{sigma, depth, delta, omega, s, lvl + 1}, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < bc::TM; ++i) {
    const int r = row0 + bc::frag_offset(ty, i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < bc::TN; ++j) {
      const int c = col0 + bc::frag_offset(tx, j);
      if (c >= s) continue;
      const size_t o = static_cast<size_t>(r) * s + c;
      const float upd = depth[o] == lvl ? __fmul_rn(sigma[o], acc[i][j]) : 0.f;
      delta_out[o] = delta[o] + upd;
    }
  }
}

template <typename AT>
int launch(const void* A, const void* sigma, const void* depth, const void* delta,
           const void* omega, void* delta_out, int n, int s, int lvl, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dependency_spmm_kernel<AT><<<bc::level_grid(n, s), bc::THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AT*>(A), static_cast<const float*>(sigma),
      static_cast<const int*>(depth), static_cast<const float*>(delta),
      static_cast<const float*>(omega), static_cast<float*>(delta_out), n, s, lvl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dependency_spmm_f32(const void* A, const void* sigma, const void* depth,
                                   const void* delta, const void* omega, void* delta_out,
                                   int n, int s, int lvl, int device, void* stream) {
  return launch<float>(A, sigma, depth, delta, omega, delta_out, n, s, lvl, device, stream);
}

extern "C" int dependency_spmm_bf16(const void* A, const void* sigma, const void* depth,
                                    const void* delta, const void* omega, void* delta_out,
                                    int n, int s, int lvl, int device, void* stream) {
  return launch<__nv_bfloat16>(A, sigma, depth, delta, omega, delta_out, n, s, lvl, device,
                               stream);
}
