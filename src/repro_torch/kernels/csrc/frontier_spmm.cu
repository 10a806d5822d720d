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
// Bound: 2·n²·s FLOP of f32 FFMA, 16.4 ms at n = 65536, s = 128 on an
// H100 (67 TFLOP/s), against 5.1 ms (f32 A) or 2.6 ms (bf16 A) to stream
// A: f32 compute.  No tensor cores and no TF32: σ holds exact integer path
// counts, which TF32 or bf16 operands would round; a bf16 A only saves
// bytes.
//
// Design, two launches on the caller's stream (K2's, dependency_spmm.cu):
//   1. the operand pass (level_operand.cuh) writes the masked frontier
//      once into the wrapper's [n, ld] f32 scratch, ld = s rounded up to
//      4 with zero pad columns.  Built inside the k-loop instead, it would
//      be selected again by each of the n/128 row blocks: 512 reads of σ
//      and d a launch at n = 65536;
//   2. the pipelined f32 main loop of level_gemm.cuh (cp.async ring, one
//      column tile of 64, 128 or 192 chosen by the wrapper from s, 8x8
//      FFMA micro-tiles) computes t, and the state update runs in its
//      epilogue.  σ' and d' are written out of place: the operand pass of
//      the same level reads σ and d.
// Ragged n and s are masked in the kernel; nothing is padded on the host.
#include "level_gemm.cuh"

namespace {

template <typename AT, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    frontier_spmm_kernel(const AT* __restrict__ A, const float* __restrict__ x, int ld,
                         const float* __restrict__ sigma, const int* __restrict__ depth,
                         float* __restrict__ sigma_out, int* __restrict__ depth_out, int n,
                         int s, int lvl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.y * T::BM;
  const int col0 = blockIdx.x * T::BS;
  float acc[bc::gemm::TM][bc::gemm::TN];
  bc::gemm::main_loop<AT, T>(A, n, n, x, ld, row0, col0, smem, acc);

#pragma unroll
  for (int i = 0; i < bc::gemm::TM; ++i) {
    const int r = row0 + bc::gemm::frag_row<T>(i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < bc::gemm::TN; ++j) {
      const int c = col0 + bc::gemm::frag_col<T>(j);
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

// operand: the wrapper's [n, ld] f32 scratch; bs: the column tile; fast:
// 16-byte copies of A (only for 16-byte aligned rows).
template <typename AT>
int launch(const void* A, const void* sigma, const void* depth, void* sigma_out,
           void* depth_out, void* operand, int n, int s, int ld, int lvl, int bs, int fast,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = bc::gemm::check<AT>(A, operand, n, n, s, ld, fast != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<float*>(operand);
  const auto* sg = static_cast<const float*>(sigma);
  const auto* dp = static_cast<const int*>(depth);
  bc::write_operand(bc::FrontierOperand{sg, dp, s, lvl - 1}, x, n, s, ld, st);
  err = bc::gemm::dispatch(bs, fast != 0, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = frontier_spmm_kernel<AT, T>;
    constexpr int smem = bc::gemm::shared_bytes<AT, T>();
    const cudaError_t e = bc::gemm::prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<bc::gemm::grid<T>(n, s), T::THREADS, smem, st>>>(
        static_cast<const AT*>(A), x, ld, sg, dp, static_cast<float*>(sigma_out),
        static_cast<int*>(depth_out), n, s, lvl);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int frontier_spmm_f32(const void* A, const void* sigma, const void* depth,
                                 void* sigma_out, void* depth_out, void* operand, int n, int s,
                                 int ld, int lvl, int bs, int fast, int device, void* stream) {
  return launch<float>(A, sigma, depth, sigma_out, depth_out, operand, n, s, ld, lvl, bs, fast,
                       device, stream);
}

extern "C" int frontier_spmm_bf16(const void* A, const void* sigma, const void* depth,
                                  void* sigma_out, void* depth_out, void* operand, int n, int s,
                                  int ld, int lvl, int bs, int fast, int device, void* stream) {
  return launch<__nv_bfloat16>(A, sigma, depth, sigma_out, depth_out, operand, n, s, ld, lvl,
                               bs, fast, device, stream);
}
