// K1 — fused forward BFS level on a dense adjacency (one launch per level).
//
// Replaces the TPU kernel kernels/frontier_spmm.py:frontier_spmm_kernel
// (wrapper frontier_spmm_pallas, padding in ops.frontier_spmm) of the JAX
// package.  Per level:
//
//     t      = A @ (σ ⊙ [d == lvl-1])
//     newly  = (t > 0) ∧ (d < 0)
//     d'     = lvl on newly;      σ' = σ + t on newly
//
// The masked frontier is formed while the operand tile is loaded and the
// state update runs in the epilogue, so per level the device-memory
// traffic is A once, σ/d once in (plus re-reads of the k-side tiles,
// which L2 serves) and σ'/d' once out.  Main loop and bound: see
// level_tile.cuh (f32 compute bound: 16.4 ms per level at n = 65536,
// s = 128 on an H100).  Ragged n and s are masked in the kernel; nothing
// is padded on the host.
#include "level_tile.cuh"

namespace {

template <typename AT>
__global__ void __launch_bounds__(bc::THREADS)
    frontier_spmm_kernel(const AT* __restrict__ A, const float* __restrict__ sigma,
                         const int* __restrict__ depth, float* __restrict__ sigma_out,
                         int* __restrict__ depth_out, int n, int s, int lvl) {
  const int row0 = blockIdx.y * bc::BM;
  const int col0 = blockIdx.x * bc::BS;
  float acc[bc::TM][bc::TN];
  bc::tile_product(A, n, n, s, row0, col0, bc::FrontierOperand{sigma, depth, s, lvl - 1},
                   acc);

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
      const float t = acc[i][j];
      const int d = depth[o];
      const bool newly = (t > 0.f) && (d < 0);
      depth_out[o] = newly ? lvl : d;
      sigma_out[o] = sigma[o] + (newly ? t : 0.f);
    }
  }
}

template <typename AT>
int launch(const void* A, const void* sigma, const void* depth, void* sigma_out,
           void* depth_out, int n, int s, int lvl, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  frontier_spmm_kernel<AT><<<bc::level_grid(n, s), bc::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AT*>(A), static_cast<const float*>(sigma),
      static_cast<const int*>(depth), static_cast<float*>(sigma_out),
      static_cast<int*>(depth_out), n, s, lvl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int frontier_spmm_f32(const void* A, const void* sigma, const void* depth,
                                 void* sigma_out, void* depth_out, int n, int s, int lvl,
                                 int device, void* stream) {
  return launch<float>(A, sigma, depth, sigma_out, depth_out, n, s, lvl, device, stream);
}

extern "C" int frontier_spmm_bf16(const void* A, const void* sigma, const void* depth,
                                  void* sigma_out, void* depth_out, int n, int s, int lvl,
                                  int device, void* stream) {
  return launch<__nv_bfloat16>(A, sigma, depth, sigma_out, depth_out, n, s, lvl, device,
                               stream);
}
