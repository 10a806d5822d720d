// K5 and K6 — pre-fold partial level products over a blocked-sparse (BCSR)
// adjacency block (the block-local compute of the fused_sparse engine and
// of the sparse-chosen cells of fused_hybrid), done as a gather-sum over
// the block's nonzeros so that a launch's work follows nnz·s, not the
// stored tile area T·bm·bk·s.
//
// Replaces the TPU kernels of the JAX package
//   K5  kernels/blocked_spmm.py:frontier_sparse_kernel and
//       frontier_sparse_acc_kernel (factory make_sparse_kernel, row-run
//       flags _row_run_bounds, wrapper frontier_sparse_pallas, column
//       padding in ops.frontier_spmm_sparse);
//   K6  kernels/blocked_spmm.py:dependency_sparse_kernel and
//       dependency_sparse_acc_kernel (wrapper dependency_sparse_pallas,
//       ops.dependency_spmm_sparse).
// With the stored tiles A_tile [bm, bk] at tile column tile_cols:
//
//     K5:  t = Σ_tiles A_tile @ (σ ⊙ [d == lvl-1])[tile_cols·bk : +bk]
//     K6:  t = Σ_tiles A_tile @ g[tile_cols·bk : +bk],
//          g = (1 + δ + ω) / σ̂ on d == lvl+1
//     acc mode (t_in non-null):  t = t_in + the sum
//
// Input.  Not the tiles but their nonzero index, built once per layout on
// the device (blocked_spmm.py:nonzero_index): a row-CSR of the block's
// nonzero entries, col i32 [nnz] (operand row tile_cols·bk + c, ascending
// within a row) and val f32 [nnz] (the tile entry, so weighted or test
// tiles stay right), and the work list seg i32 [S, 3] of (row, lo, hi)
// ranges of col/val: first the segments of the L rows longer than one
// segment (at most SEGMENT nonzeros each, in row and position order;
// long_ptr i32 [L + 1] says which belong to which row), then every other
// row whole, empty rows included.  Fillers and the reference's trailing
// pad tiles are all zero, so they have no entry and add nothing.
//
// Design, three launches on the caller's stream:
//   1. operand pass (level_operand.cuh, shared with K1-K4): the masked
//      frontier (K5) or g (K6) is written once into a [k, s] f32 scratch
//      (one IEEE division per element for g, no --use_fast_math).
//      Gathering σ, d (and δ, ω) per nonzero instead would read 2 (K5) or
//      3 (K6) gathered rows per entry and repeat the division nnz/k times;
//      the pass costs 3·k·s·4 bytes for K5 (33.5 MB a tensor at R-MAT
//      scale 16, s = 128), 4·k·s·4 + 4·k for K6.
//   2. gather pass: one warp per work segment walks its entries in index
//      order: 32 (col, val) pairs load at once, coalesced, and are
//      broadcast by shuffle; the operand rows of four entries are loaded
//      before any is summed, so their latencies overlap.  Each lane holds
//      NV vectors of VEC columns of the [s] sum (float4 at s = 128, 3 x
//      float2 at s = 192) and accumulates with f32 FMA, no tensor cores
//      and no TF32: σ holds exact integer path counts.  A whole row is
//      written to t_out (adding t_in in acc mode); a long row's segment
//      writes its partial [s] to a scratch slot.  Long rows' segments come
//      first, so the heaviest work starts first (R-MAT rows are skewed: a
//      few hold thousands of nonzeros, many none).
//   3. combine pass (only when L > 0): one block per long row sums its
//      partials in segment order, adds t_in, writes the row.
// Every output row is written exactly once, with no atomics and no zero
// pre-fill, and the summation order is fixed by the index: a launch is
// bitwise reproducible.  K5's integer sums below 2^24 are exact in any
// order, so K5 equals its plain version bit for bit; K6 agrees to f32
// rounding.  Offsets are formed as size_t (col·s reaches 5e7 at the strip
// graph and the operand has no 2^31 cap).
//
// Changed edge case.  The dense tile product multiplies the zero entries
// of a stored tile too, so a non-finite operand row gives 0·inf = NaN in
// every row of that tile; the index has no zero entries, so here such a
// row reaches only the rows adjacent to it — what the arc-list engine
// gives.  It matters only past the f32 σ limit (ROADMAP Queue 3).
//
// Bound: bytes.  The function must read the index (col and val, 8 bytes
// a nonzero, and one row structure, ptr), σ and d (K6: and δ, ω) once
// and write t once; the work list is the kernel's own choice, not
// counted.  R-MAT scale 16 on a 1x1 grid (1 818 806 nonzeros), K5 at
// s = 128: 14.8 MB of index + 67.1 MB + 33.5 MB = 115.5 MB, 0.034 ms at
// 3.35 TB/s; K6 at s = 192: 216 MB, 0.065 ms.  FLOP are
// 2·nnz·s (0.47 GFLOP for K5), far under the f32 rate.
// The gathered rows are nnz·s·4 bytes (0.93 GB for K5 at s = 128): the
// design gets near the bound only while the [k, s] operand stays in L2
// (50 MB: 33.5 MB at s = 128, 50 MB at s = 192), so those reads are L2
// hits, not HBM traffic.  The strips' operand (135 MB at s = 128) does not
// fit; their rows touch operand rows within ±1024 of their own, and the
// short rows run in row order, so the rows in flight share a window of
// the operand that L2 does hold.
#include <algorithm>

#include "level_operand.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;     // warps (work segments) per block of the gather pass
constexpr int BATCH = 4;     // entries whose operand rows load before any is summed

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load_vec(const float* p) {
  return *reinterpret_cast<const typename Vec<VEC>::T*>(p);
}

__device__ __forceinline__ void fma_vec(float (&acc)[1], float v, float x) {
  acc[0] = fmaf(v, x, acc[0]);
}
__device__ __forceinline__ void fma_vec(float (&acc)[2], float v, float2 x) {
  acc[0] = fmaf(v, x.x, acc[0]);
  acc[1] = fmaf(v, x.y, acc[1]);
}
__device__ __forceinline__ void fma_vec(float (&acc)[4], float v, float4 x) {
  acc[0] = fmaf(v, x.x, acc[0]);
  acc[1] = fmaf(v, x.y, acc[1]);
  acc[2] = fmaf(v, x.z, acc[2]);
  acc[3] = fmaf(v, x.w, acc[3]);
}

// 2. One warp per work segment; lane `lane` owns columns
// c0 + (v·32 + lane)·VEC + [0, VEC) for v < NV, over passes of
// W = 32·VEC·NV columns.  s is a multiple of VEC (the launcher's choice).
// At least 4 blocks an SM (64 registers a thread): with no minimum ptxas
// kept the s = 128 instance at 40 registers and spilled 44 bytes.
template <int VEC, int NV>
__global__ void __launch_bounds__(32 * WARPS, 4)
    gather_kernel(const float* __restrict__ operand, const int* __restrict__ col,
                  const float* __restrict__ val, const int* __restrict__ seg, int n_seg,
                  int n_long_seg, const float* __restrict__ t_in, float* __restrict__ t_out,
                  float* __restrict__ partials, int kdim, int s) {
  using V = typename Vec<VEC>::T;
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= n_seg) return;  // warp-uniform: no shuffle below misses a lane
  const int lane = threadIdx.x % 32;
  const int row = seg[3 * w];
  const int lo = seg[3 * w + 1];
  const int hi = seg[3 * w + 2];
  const bool partial = w < n_long_seg;
  float* dst = partial ? partials + static_cast<size_t>(w) * s
                       : t_out + static_cast<size_t>(row) * s;
  const float* add = partial || t_in == nullptr ? nullptr : t_in + static_cast<size_t>(row) * s;

  for (int c0 = 0; c0 < s; c0 += 32 * VEC * NV) {
    float acc[NV][VEC];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int x = 0; x < VEC; ++x) acc[v][x] = 0.f;
    bool mine[NV];  // this lane's vector v lies inside s
#pragma unroll
    for (int v = 0; v < NV; ++v) mine[v] = c0 + (v * 32 + lane) * VEC < s;

    for (int base = lo; base < hi; base += 32) {
      const int e = base + lane;
      int my_col = 0;
      float my_val = 0.f;
      if (e < hi) {
        my_col = col[e];
        my_val = val[e];
      }
      const int n = min(32, hi - base);
      int i = 0;
      for (; i + BATCH <= n; i += BATCH) {
        int c[BATCH];
        float a[BATCH];
        V x[BATCH][NV];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          c[u] = __shfl_sync(FULL, my_col, i + u);
          a[u] = __shfl_sync(FULL, my_val, i + u);
          if (c[u] >= kdim) a[u] = 0.f;  // past the operand: adds nothing, reads nothing
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const float* src = operand + static_cast<size_t>(c[u]) * s + c0 + lane * VEC;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            x[u][v] = mine[v] && c[u] < kdim ? load_vec<VEC>(src + v * 32 * VEC) : V{};
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
#pragma unroll
          for (int v = 0; v < NV; ++v) fma_vec(acc[v], a[u], x[u][v]);
      }
      for (; i < n; ++i) {
        const int c = __shfl_sync(FULL, my_col, i);
        const float a = __shfl_sync(FULL, my_val, i);
        if (c >= kdim) continue;  // never reads past the operand (warp-uniform)
        const float* src = operand + static_cast<size_t>(c) * s + c0 + lane * VEC;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (mine[v]) fma_vec(acc[v], a, load_vec<VEC>(src + v * 32 * VEC));
      }
    }

#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!mine[v]) continue;
      const int j = c0 + (v * 32 + lane) * VEC;
#pragma unroll
      for (int x = 0; x < VEC; ++x) {
        dst[j + x] = add != nullptr ? add[j + x] + acc[v][x] : acc[v][x];
      }
    }
  }
}

// 3. One block per long row: t = [t_in +] Σ its segments' partials, in order.
__global__ void combine_kernel(const float* __restrict__ partials, const int* __restrict__ seg,
                               const int* __restrict__ long_ptr, const float* __restrict__ t_in,
                               float* __restrict__ t_out, int s) {
  const int j0 = long_ptr[blockIdx.x];
  const int j1 = long_ptr[blockIdx.x + 1];
  const size_t row = static_cast<size_t>(seg[3 * j0]) * s;
  for (int c = threadIdx.x; c < s; c += blockDim.x) {
    float acc = 0.f;
    for (int j = j0; j < j1; ++j) acc += partials[static_cast<size_t>(j) * s + c];
    t_out[row + c] = t_in != nullptr ? t_in[row + c] + acc : acc;
  }
}

// The gather pass's arguments, as gather_kernel takes them.
struct Gather {
  const float* operand;
  const int* col;
  const float* val;
  const int* seg;
  int n_seg, n_long_seg;
  const float* t_in;
  float* t_out;
  float* partials;
  int kdim, s;
};

template <int VEC, int NV>
void launch_gather(const Gather& g, cudaStream_t stream) {
  gather_kernel<VEC, NV><<<(g.n_seg + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(
      g.operand, g.col, g.val, g.seg, g.n_seg, g.n_long_seg, g.t_in, g.t_out, g.partials,
      g.kdim, g.s);
}

template <int VEC>
void launch_gather_nv(int nv, const Gather& g, cudaStream_t stream) {
  switch (nv) {
    case 1: return launch_gather<VEC, 1>(g, stream);
    case 2: return launch_gather<VEC, 2>(g, stream);
    case 3: return launch_gather<VEC, 3>(g, stream);
    default: return launch_gather<VEC, 4>(g, stream);
  }
}

// operand and partials are the wrapper's scratch: [kdim, s] and
// [n_long_seg, s] f32 (either may be empty).
template <typename Operand>
int launch(const Operand& op, const void* col, const void* val, const void* seg,
           const void* long_ptr, const void* t_in, void* t_out, void* operand, void* partials,
           int m, int kdim, int s, int n_seg, int n_long_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_long_seg = n_seg - (m - n_long_rows);  // long rows' segments come first
  if (m <= 0 || s <= 0 || kdim < 0 || n_long_rows < 0 || n_long_seg < n_long_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* opnd = static_cast<float*>(operand);
  bc::write_operand(op, opnd, kdim, s, s, st);

  // VEC: the widest of 4, 2, 1 that divides s (the operand scratch, the
  // only vector-loaded tensor, comes aligned from the caching allocator);
  // float2 at s = 192 so that 3 x 2 x 32 lanes cover it with none idle.
  int vec = s % 4 == 0 ? 4 : s % 2 == 0 ? 2 : 1;
  if (vec == 4 && s % 128 != 0 && s % 64 == 0) vec = 2;
  const int nv = std::min(4, (s + 32 * vec - 1) / (32 * vec));
  const Gather g{opnd, static_cast<const int*>(col), static_cast<const float*>(val),
                 static_cast<const int*>(seg), n_seg, n_long_seg,
                 static_cast<const float*>(t_in), static_cast<float*>(t_out),
                 static_cast<float*>(partials), kdim, s};
  if (vec == 4) launch_gather_nv<4>(nv, g, st);
  else if (vec == 2) launch_gather_nv<2>(nv, g, st);
  else launch_gather_nv<1>(nv, g, st);
  if (n_long_rows > 0)
    combine_kernel<<<n_long_rows, 128, 0, st>>>(g.partials, g.seg,
                                                static_cast<const int*>(long_ptr), g.t_in,
                                                g.t_out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t_in may be NULL (plain mode); otherwise the acc mode adds it to the sum.
extern "C" int frontier_sparse_f32(const void* col, const void* val, const void* seg,
                                   const void* long_ptr, const void* sigma, const void* depth,
                                   const void* t_in, void* t_out, void* operand, void* partials,
                                   int m, int kdim, int s, int n_seg, int n_long_rows, int lvl,
                                   int device, void* stream) {
  const bc::FrontierOperand op{static_cast<const float*>(sigma), static_cast<const int*>(depth),
                               s, lvl - 1};
  return launch(op, col, val, seg, long_ptr, t_in, t_out, operand, partials, m, kdim, s, n_seg,
                n_long_rows, device, stream);
}

extern "C" int dependency_sparse_f32(const void* col, const void* val, const void* seg,
                                     const void* long_ptr, const void* sigma, const void* depth,
                                     const void* delta, const void* omega, const void* t_in,
                                     void* t_out, void* operand, void* partials, int m, int kdim,
                                     int s, int n_seg, int n_long_rows, int lvl, int device,
                                     void* stream) {
  const bc::DependencyOperand op{static_cast<const float*>(sigma),
                                 static_cast<const int*>(depth),
                                 static_cast<const float*>(delta),
                                 static_cast<const float*>(omega), s, lvl + 1};
  return launch(op, col, val, seg, long_ptr, t_in, t_out, operand, partials, m, kdim, s, n_seg,
                n_long_rows, device, stream);
}
