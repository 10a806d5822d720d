// K5 and K6 — pre-fold partial level products over a blocked-sparse (BCSR)
// adjacency block: only the stored (bm x bk) tiles of one device's block of
// the 2-D decomposition are read (the block-local compute of the
// fused_sparse engine and of the sparse-chosen cells of fused_hybrid).
//
// Replaces the TPU kernels of the JAX package
//   K5  kernels/blocked_spmm.py:frontier_sparse_kernel and
//       frontier_sparse_acc_kernel (factory make_sparse_kernel, row-run
//       flags _row_run_bounds, wrapper frontier_sparse_pallas, column
//       padding in ops.frontier_spmm_sparse);
//   K6  kernels/blocked_spmm.py:dependency_sparse_kernel and
//       dependency_sparse_acc_kernel (wrapper dependency_sparse_pallas,
//       ops.dependency_spmm_sparse).
// With tiles [T, bm, bk] (row-major f32), their operand tile column
// tile_cols [T] and the CSR row pointer row_ptr [m/bm + 1] of the
// row-sorted tile list (tile-row r owns tiles [row_ptr[r], row_ptr[r+1])):
//
//     K5:  t = Σ_tiles A_tile @ (σ ⊙ [d == lvl-1])[tile_cols·bk : +bk]
//     K6:  t = Σ_tiles A_tile @ g[tile_cols·bk : +bk],
//          g = (1 + δ + ω) / σ̂ on d == lvl+1
//     acc mode (t_in non-null):  t = t_in + the sum
//
// Design.  The Pallas kernels walk a sequential grid over T and carry a
// VMEM accumulator from the first tile of a tile-row run to its last.
// Hopper blocks run in no order, so here one thread block owns one
// (tile-row, 128-column s-block) output tile and loops over its run
// itself, accumulating each stored tile through the shared main loop of
// level_tile.cuh: the A tile is loaded once per 16-deep k step, and the
// [bk, 128] operand tile is built *while it loads* from the gathered rows
// tile_cols[t]·bk + k of σ/d (and δ, ω), so neither the masked frontier nor
// g reaches device memory.  Operand rows are gathered by tile_cols, so
// their reuse between the blocks of a column comes from L2, not from the
// layout.  The block writes its [bm, 128] output once at the end, adding
// t_in in acc mode: every output row is written exactly once — also in a
// tile-row with no tile, or only an all-zero filler — with no atomics, no
// zero pre-fill and a summation order that is fixed run to run.  The
// reference's trailing pad tiles (zero data on the last tile-row) add
// zeros and harm nothing.
//
// Tile shape.  bm and bk are any divisors of the partition chunk (5 in
// the small CPU cases, 32 at --tile 32, 128 by default).  The kernel is
// instantiated for TBM = 32, 64 and 128 output rows per block (64, 128
// and 256 threads, an 8 x 8 micro-tile each) and the launcher takes the
// smallest TBM >= bm, so a 32-row tile does not pay for 128 rows of FFMA;
// a tile-row taller than 128 is split over ceil(bm / 128) blocks.  Rows
// >= bm and k >= bk are masked in the kernel, and a tile is addressed
// with a size_t offset (256 655 tiles of 128 x 128 are 4.2e9 elements).
//
// Bound: max(bytes / 3.35 TB/s, 2·stored·bm·bk·s FLOP / 67 TFLOP/s of f32
// FFMA).  At s = 128: R-MAT scale 16 on a 1x1 grid at tile 128 (256 655
// stored tiles, 15.7 GiB) 16.1 ms of FLOP against 5.0 ms of bytes; at tile
// 32 (1 213 472 tiles) 4.75 ms against 1.5 ms; the 512 x 512 grid graph
// at tile 128 (9 208 tiles) 0.58 ms against 0.26 ms.  K6 at s = 192 is
// 1.5x that.  So K5/K6 are bound by f32 compute, like K1-K4, and share
// their design: no tensor cores and no TF32 (σ holds exact integer path
// counts), 8 x 8 register micro-tiles fed from float4 shared-memory reads,
// IEEE division for g (no --use_fast_math).
#include <climits>

#include "level_tile.cuh"

namespace {

// 256 / TBM resident blocks (512 threads an SM) cap the registers at 128 a
// thread, as K1-K4 use: unbounded, the tile loop took 177-255 and one
// block of 256 threads filled an SM.
template <int TBM, typename Operand>
__global__ void __launch_bounds__(2 * TBM, 256 / TBM)
    bcsr_spmm_kernel(const float* __restrict__ tiles, const int* __restrict__ tile_cols,
                     const int* __restrict__ row_ptr, Operand op,
                     const float* __restrict__ t_in, float* __restrict__ t_out, int kdim,
                     int s, int bm, int bk, int row_blocks, int col_blocks) {
  // blocks of one tile-row are neighbours, so a second s-block finds the
  // row's tiles in L2
  const int cb = blockIdx.x % col_blocks;
  const int rest = blockIdx.x / col_blocks;
  const int rb = rest % row_blocks;
  const int r = rest / row_blocks;  // tile-row
  const int row0 = rb * TBM;        // first row of this block inside the tile-row
  const int col0 = cb * bc::BS;

  float acc[bc::TM][bc::TN];
  bc::zero(acc);
  const size_t tile_elems = static_cast<size_t>(bm) * bk;
  const int end = row_ptr[r + 1];
  for (int t = row_ptr[r]; t < end; ++t) {
    const int k_op = tile_cols[t] * bk;
    const int k_valid = min(bk, kdim - k_op);  // never reads past the operand
    bc::tile_accumulate<TBM>(tiles + static_cast<size_t>(t) * tile_elems,
                             static_cast<size_t>(bk), bm, k_valid, s, row0, col0, k_op, op,
                             acc);
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < bc::TM; ++i) {
    const int lr = row0 + bc::frag_offset(ty, i, TBM / 2);
    if (lr >= bm) continue;
    const size_t row = static_cast<size_t>(r) * bm + lr;
#pragma unroll
    for (int j = 0; j < bc::TN; ++j) {
      const int c = col0 + bc::frag_offset(tx, j);
      if (c >= s) continue;
      const size_t o = row * s + c;
      t_out[o] = t_in != nullptr ? t_in[o] + acc[i][j] : acc[i][j];
    }
  }
}

template <int TBM, typename Operand>
int launch_tbm(const void* tiles, const void* tile_cols, const void* row_ptr, const Operand& op,
               const void* t_in, void* t_out, int m, int kdim, int s, int bm, int bk,
               cudaStream_t stream) {
  const int row_blocks = (bm + TBM - 1) / TBM;
  const int col_blocks = (s + bc::BS - 1) / bc::BS;
  const long long blocks = static_cast<long long>(m / bm) * row_blocks * col_blocks;
  if (blocks <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  bcsr_spmm_kernel<TBM, Operand><<<static_cast<unsigned>(blocks), bc::threads_for<TBM>(), 0,
                                   stream>>>(
      static_cast<const float*>(tiles), static_cast<const int*>(tile_cols),
      static_cast<const int*>(row_ptr), op, static_cast<const float*>(t_in),
      static_cast<float*>(t_out), kdim, s, bm, bk, row_blocks, col_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename Operand>
int launch(const void* tiles, const void* tile_cols, const void* row_ptr, const Operand& op,
           const void* t_in, void* t_out, int m, int kdim, int s, int bm, int bk, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bm <= 0 || bk <= 0 || m % bm != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (bm <= 32)
    return launch_tbm<32>(tiles, tile_cols, row_ptr, op, t_in, t_out, m, kdim, s, bm, bk, st);
  if (bm <= 64)
    return launch_tbm<64>(tiles, tile_cols, row_ptr, op, t_in, t_out, m, kdim, s, bm, bk, st);
  return launch_tbm<128>(tiles, tile_cols, row_ptr, op, t_in, t_out, m, kdim, s, bm, bk, st);
}

}  // namespace

// t_in may be NULL (plain mode); otherwise the acc mode adds it to the sum.
extern "C" int frontier_sparse_f32(const void* tiles, const void* tile_cols, const void* row_ptr,
                                   const void* sigma, const void* depth, const void* t_in,
                                   void* t_out, int m, int kdim, int s, int bm, int bk, int lvl,
                                   int device, void* stream) {
  const bc::FrontierOperand op{static_cast<const float*>(sigma), static_cast<const int*>(depth),
                               s, lvl - 1};
  return launch(tiles, tile_cols, row_ptr, op, t_in, t_out, m, kdim, s, bm, bk, device, stream);
}

extern "C" int dependency_sparse_f32(const void* tiles, const void* tile_cols,
                                     const void* row_ptr, const void* sigma, const void* depth,
                                     const void* delta, const void* omega, const void* t_in,
                                     void* t_out, int m, int kdim, int s, int bm, int bk,
                                     int lvl, int device, void* stream) {
  const bc::DependencyOperand op{static_cast<const float*>(sigma),
                                 static_cast<const int*>(depth),
                                 static_cast<const float*>(delta),
                                 static_cast<const float*>(omega), s, lvl + 1};
  return launch(tiles, tile_cols, row_ptr, op, t_in, t_out, m, kdim, s, bm, bk, device, stream);
}
