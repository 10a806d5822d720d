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
// Bound: 2·n²·s FLOP of f32 FFMA, 24.6 ms at n = 65536, s = 192 on an
// H100 (67 TFLOP/s), against 5.1 ms (f32 A) or 2.6 ms (bf16 A) to stream
// A: f32 compute.
//
// Design, two launches on the caller's stream:
//   1. the operand pass (level_operand.cuh) writes g once into the
//      wrapper's [n, ld] f32 scratch, ld = s rounded up to 4 — one IEEE
//      division per element (no --use_fast_math).  Built inside the
//      k-loop instead, g would be computed again by each of the n/128 row
//      blocks: 6.4e9 guarded divisions and 512 reads of σ, d and δ a
//      launch at n = 65536, s = 192;
//   2. the pipelined f32 main loop of level_gemm.cuh (cp.async ring, one
//      column tile of 64, 128 or 192 chosen by the wrapper from s, 8x8
//      FFMA micro-tiles) computes t, and the δ update runs in its
//      epilogue: σ·t rounded before the add (__fmul_rn), as the reference
//      computes it.
// Ragged n and s are masked in the kernel; nothing is padded on the host.
#include "level_gemm.cuh"

namespace {

template <typename AT, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    dependency_spmm_kernel(const AT* __restrict__ A, const float* __restrict__ g, int ld,
                           const float* __restrict__ sigma, const int* __restrict__ depth,
                           const float* __restrict__ delta, float* __restrict__ delta_out,
                           int n, int s, int lvl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.y * T::BM;
  const int col0 = blockIdx.x * T::BS;
  float acc[bc::gemm::TM][bc::gemm::TN];
  bc::gemm::main_loop<AT, T>(A, n, n, g, ld, row0, col0, smem, acc);

#pragma unroll
  for (int i = 0; i < bc::gemm::TM; ++i) {
    const int r = row0 + bc::gemm::frag_row<T>(i);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < bc::gemm::TN; ++j) {
      const int c = col0 + bc::gemm::frag_col<T>(j);
      if (c >= s) continue;
      const size_t o = static_cast<size_t>(r) * s + c;
      const float upd = depth[o] == lvl ? __fmul_rn(sigma[o], acc[i][j]) : 0.f;
      delta_out[o] = delta[o] + upd;
    }
  }
}

// operand: the wrapper's [n, ld] f32 scratch; bs: the column tile; fast:
// 16-byte copies of A (only for 16-byte aligned rows).
template <typename AT>
int launch(const void* A, const void* sigma, const void* depth, const void* delta,
           const void* omega, void* delta_out, void* operand, int n, int s, int ld, int lvl,
           int bs, int fast, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = bc::gemm::check<AT>(A, operand, n, n, s, ld, fast != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<float*>(operand);
  const auto* sg = static_cast<const float*>(sigma);
  const auto* dp = static_cast<const int*>(depth);
  const auto* dl = static_cast<const float*>(delta);
  bc::write_operand(bc::DependencyOperand{sg, dp, dl, static_cast<const float*>(omega), s,
                                          lvl + 1},
                    g, n, s, ld, st);
  err = bc::gemm::dispatch(bs, fast != 0, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = dependency_spmm_kernel<AT, T>;
    constexpr int smem = bc::gemm::shared_bytes<AT, T>();
    const cudaError_t e = bc::gemm::prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<bc::gemm::grid<T>(n, s), T::THREADS, smem, st>>>(
        static_cast<const AT*>(A), g, ld, sg, dp, dl, static_cast<float*>(delta_out), n, s,
        lvl);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dependency_spmm_f32(const void* A, const void* sigma, const void* depth,
                                   const void* delta, const void* omega, void* delta_out,
                                   void* operand, int n, int s, int ld, int lvl, int bs,
                                   int fast, int device, void* stream) {
  return launch<float>(A, sigma, depth, delta, omega, delta_out, operand, n, s, ld, lvl, bs,
                       fast, device, stream);
}

extern "C" int dependency_spmm_bf16(const void* A, const void* sigma, const void* depth,
                                    const void* delta, const void* omega, void* delta_out,
                                    void* operand, int n, int s, int ld, int lvl, int bs,
                                    int fast, int device, void* stream) {
  return launch<__nv_bfloat16>(A, sigma, depth, delta, omega, delta_out, operand, n, s, ld,
                               lvl, bs, fast, device, stream);
}

// Dynamic shared memory a K1-K4 launch asks for at column tile bs (bf16 != 0:
// a bf16 A), or -1 for a column tile without an instantiation.
extern "C" int level_gemm_shared_bytes(int bs, int bf16) {
  int bytes = -1;
  bc::gemm::dispatch(bs, true, [&](auto tile) {
    using T = decltype(tile);
    bytes = bf16 != 0 ? bc::gemm::shared_bytes<__nv_bfloat16, T>()
                      : bc::gemm::shared_bytes<float, T>();
    return cudaSuccess;
  });
  return bytes;
}
