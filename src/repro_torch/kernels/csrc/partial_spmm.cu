// K3 and K4 — pre-fold partial level products on one device's block of a
// 2-D decomposed adjacency (the block-local compute of the distributed
// fused engines, one launch per level and device).
//
// Replaces the TPU kernels of the JAX package
//   K3  kernels/frontier_spmm.py:frontier_partial_kernel and
//       frontier_partial_acc_kernel (wrapper frontier_partial_pallas,
//       padding in ops.frontier_spmm_partial);
//   K4  kernels/dependency_spmm.py:dependency_partial_kernel and
//       dependency_partial_acc_kernel (wrapper dependency_partial_pallas,
//       padding in ops.dependency_spmm_partial).
// On the [m, k] block A_blk (m = C·chunk fold rows, k = R·chunk gathered
// columns) and the gathered [k, s] state:
//
//     K3:  t = A_blk @ (σ ⊙ [d == lvl-1])
//     K4:  t = A_blk @ g,   g = (1 + δ + ω) / σ̂ on d == lvl+1
//     acc mode (t_in non-null):  t = t_in + A_blk @ operand
//
// There is no epilogue beyond the store: the state update needs the t
// summed over the grid row, so it runs after the fold.  The acc mode is
// the running combine of the ring-pipelined expand, added in the store
// instead of as a separate [m, s] pass.  Ragged m, k and s are masked in
// the kernels (the JAX wrapper's padding of A, σ with 0 and d with -1
// becomes those masks); nothing is padded on the host.
//
// Bound: 2·m·k·s FLOP of f32 FFMA.  At the 1×1 grid of n = 65536 this is
// K1's/K2's work (24.6 ms per level at s = 192 on an H100, against 5.1 ms
// to stream an f32 A); at the [32768, 16384] block of a 2×4 grid it is
// 3.08 ms against 0.64 ms of A — f32 compute either way, and no tensor
// cores (σ holds exact integer path counts).
//
// Both are K1's and K2's design (frontier_spmm.cu, dependency_spmm.cu):
// the operand pass (level_operand.cuh) writes the masked frontier or g
// once a launch into the wrapper's [k, ld] f32 scratch (g with one IEEE
// division per element, no --use_fast_math), then the pipelined main loop
// of level_gemm.cuh (cp.async ring, a column tile of 64, 128 or 192 chosen
// from s, 8x8 FFMA micro-tiles) computes t.  The two kernels differ only
// in name, so that a trace tells K3 from K4.
#include "level_gemm.cuh"

#include <type_traits>

namespace {

// t = [t_in +] A @ X over the operand scratch X [kdim, ld]: the main loop,
// then the store.
template <typename AT, typename T>
__device__ __forceinline__ void partial_product(const AT* __restrict__ A,
                                                const float* __restrict__ x, int ld,
                                                const float* __restrict__ t_in,
                                                float* __restrict__ t_out, int m, int kdim,
                                                int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.y * T::BM;
  const int col0 = blockIdx.x * T::BS;
  float acc[bc::gemm::TM][bc::gemm::TN];
  bc::gemm::main_loop<AT, T>(A, m, kdim, x, ld, row0, col0, smem, acc);

#pragma unroll
  for (int i = 0; i < bc::gemm::TM; ++i) {
    const int r = row0 + bc::gemm::frag_row<T>(i);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < bc::gemm::TN; ++j) {
      const int c = col0 + bc::gemm::frag_col<T>(j);
      if (c >= s) continue;
      const size_t o = static_cast<size_t>(r) * s + c;
      t_out[o] = t_in != nullptr ? t_in[o] + acc[i][j] : acc[i][j];
    }
  }
}

// K3
template <typename AT, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    frontier_partial_kernel(const AT* __restrict__ A, const float* __restrict__ x, int ld,
                            const float* __restrict__ t_in, float* __restrict__ t_out, int m,
                            int kdim, int s) {
  partial_product<AT, T>(A, x, ld, t_in, t_out, m, kdim, s);
}

// K4
template <typename AT, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    dependency_partial_kernel(const AT* __restrict__ A, const float* __restrict__ g, int ld,
                              const float* __restrict__ t_in, float* __restrict__ t_out, int m,
                              int kdim, int s) {
  partial_product<AT, T>(A, g, ld, t_in, t_out, m, kdim, s);
}

// operand: the wrapper's [kdim, ld] f32 scratch, which the pass of `op`
// fills; bs: the column tile; fast: 16-byte copies of A (only for
// 16-byte aligned rows).
template <typename AT, typename Operand>
int launch(const void* A, const Operand& op, const void* t_in, void* t_out, void* operand, int m,
           int kdim, int s, int ld, int bs, int fast, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = bc::gemm::check<AT>(A, operand, m, kdim, s, ld, fast != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<float*>(operand);
  bc::write_operand(op, x, kdim, s, ld, st);
  err = bc::gemm::dispatch(bs, fast != 0, [&](auto tile) {
    using T = decltype(tile);
    const auto kernel = std::is_same_v<Operand, bc::FrontierOperand>
                            ? frontier_partial_kernel<AT, T>
                            : dependency_partial_kernel<AT, T>;
    constexpr int smem = bc::gemm::shared_bytes<AT, T>();
    const cudaError_t e = bc::gemm::prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<bc::gemm::grid<T>(m, s), T::THREADS, smem, st>>>(
        static_cast<const AT*>(A), x, ld, static_cast<const float*>(t_in),
        static_cast<float*>(t_out), m, kdim, s);
    return cudaSuccess;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bc::FrontierOperand frontier(const void* sigma, const void* depth, int s, int lvl) {
  return bc::FrontierOperand{static_cast<const float*>(sigma), static_cast<const int*>(depth),
                             s, lvl - 1};
}

bc::DependencyOperand dependency(const void* sigma, const void* depth, const void* delta,
                                 const void* omega, int s, int lvl) {
  return bc::DependencyOperand{static_cast<const float*>(sigma), static_cast<const int*>(depth),
                               static_cast<const float*>(delta),
                               static_cast<const float*>(omega), s, lvl + 1};
}

}  // namespace

// For all four: t_in may be NULL (plain mode), otherwise the acc mode adds
// it to the product; operand: [kdim, ld] f32 scratch, ld = s rounded up to
// 4; bs: 64, 128 or 192; fast: 16-byte copies of A (16-byte aligned rows
// only).
extern "C" int frontier_partial_f32(const void* A, const void* sigma, const void* depth,
                                    const void* t_in, void* t_out, void* operand, int m,
                                    int kdim, int s, int ld, int lvl, int bs, int fast,
                                    int device, void* stream) {
  return launch<float>(A, frontier(sigma, depth, s, lvl), t_in, t_out, operand, m, kdim, s, ld,
                       bs, fast, device, stream);
}

extern "C" int frontier_partial_bf16(const void* A, const void* sigma, const void* depth,
                                     const void* t_in, void* t_out, void* operand, int m,
                                     int kdim, int s, int ld, int lvl, int bs, int fast,
                                     int device, void* stream) {
  return launch<__nv_bfloat16>(A, frontier(sigma, depth, s, lvl), t_in, t_out, operand, m, kdim,
                               s, ld, bs, fast, device, stream);
}

extern "C" int dependency_partial_f32(const void* A, const void* sigma, const void* depth,
                                      const void* delta, const void* omega, const void* t_in,
                                      void* t_out, void* operand, int m, int kdim, int s, int ld,
                                      int lvl, int bs, int fast, int device, void* stream) {
  return launch<float>(A, dependency(sigma, depth, delta, omega, s, lvl), t_in, t_out, operand,
                       m, kdim, s, ld, bs, fast, device, stream);
}

extern "C" int dependency_partial_bf16(const void* A, const void* sigma, const void* depth,
                                       const void* delta, const void* omega, const void* t_in,
                                       void* t_out, void* operand, int m, int kdim, int s,
                                       int ld, int lvl, int bs, int fast, int device,
                                       void* stream) {
  return launch<__nv_bfloat16>(A, dependency(sigma, depth, delta, omega, s, lvl), t_in, t_out,
                               operand, m, kdim, s, ld, bs, fast, device, stream);
}
