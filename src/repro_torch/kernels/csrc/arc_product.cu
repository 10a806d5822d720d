// The arc product: A @ x over an arc list sorted by destination, the local
// compute of the sparse engine (core/operators.py:_arc_product, on one
// device and on every rank of the 2-D path).
//
// Replaces no TPU kernel: the JAX package's sparse engine leaves this
// product to XLA's gather and segment_sum.  It was added because the
// torch version (a gather of x[src] into an [arcs, s] f32 tensor, widened
// to f64 and summed by segment_reduce) took 92 % of the device time of
// the paper's R-MAT scale 23 cell on an H100: at s = 24 the gathered
// messages alone are 256 489 418 × 96 B = 24.6 GB written and read back,
// then widened and summed in four column passes.
//
// With the arcs sorted by destination, src i32 [arcs], and the work list
// seg i32 [S, 3] of (row, lo, hi) arc ranges — first the pieces of the L
// rows longer than one piece (kernels/arc_product.py:arc_plan; long_ptr
// i32 [L + 1] says which pieces belong to which row, each row's pieces in
// order), then every other row whole, empty rows included, and no range
// of the sentinel row the padding arcs point at:
//
//     out[row, c] = f32( Σ_pieces ( Σ_{arcs of the piece} f64(x[src, c]) ) )
//
// Order and bits.  Each range is summed in arc order in f64, starting
// from 0.0; a long row's piece sums are then added in piece order in f64,
// starting from 0.0; the result is rounded once to f32.  That is the
// chain torch.segment_reduce's one-thread-per-output loop computes in both
// stages of the torch version (a short row is one piece there too, and
// 0.0 + p = p), so the kernel's output is bit-equal to it.  Adds are
// __dadd_rn (no fast math, nothing to contract), no atomics, and every
// output row is written exactly once: a launch is bitwise reproducible.
// An index past the operand reads nothing and adds +0.0, which leaves a
// sum that started from +0.0 unchanged.
//
// Bound: bytes, and random ones.  A call must read each arc's operand row
// once (arcs · s · 4 B: 24.6 GB at s = 24, 16.4 GB at s = 16 on R-MAT 23),
// the index once (4 B an arc, 1 GB) and write out once (0.8 GB at s = 24):
// 7.9 / 5.3 ms at 3.35 TB/s.  The FLOP (one f64 add per arc and column,
// 6.2 G at s = 24) are far under the card's f64 rate.  The operand rows
// are 64–96 B at random places of an 0.5–0.8 GB operand, so the reads are
// latency-bound sectors, not streams.
//
// Design, one or two launches on the caller's stream:
//   1. gather pass: a group of G lanes owns one work segment (G = 16 at
//      s ≤ 16, so two segments share a warp; 32 above); lane l owns
//      columns c0 + l + j·G, j < NC, and holds their sums in f64
//      registers.  The group loads 32 source indices at once, coalesced,
//      and broadcasts them by shuffle; it then issues the loads of BATCH
//      = 8 operand rows before it adds any of them, in arc order, so each
//      group keeps 8 rows (16 at two groups a warp) in flight: the card
//      needs ~2 MB in flight to reach its bandwidth, and a row is only
//      64–96 B.  A whole row is rounded and written to out; a long row's
//      piece writes its f64 partial [s] to the wrapper's scratch.  The
//      long rows' pieces come first, heaviest row first, so the longest
//      work starts first (R-MAT rows are skewed: a few hold ~10^5 arcs).
//   2. combine pass (only when L > 0): one warp per long row adds its
//      piece partials in piece order in f64 and writes the rounded row.
// Offsets into x, out and the scratch are size_t.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8;   // warps per block
constexpr int CHUNK = 32;  // source indices a group loads at once
constexpr int BATCH = 8;   // operand rows loaded before any is added

// 1. Group g of G lanes takes segment w; the segments of one warp are
// independent, so each group shuffles under its own lane mask.  At one
// column a lane (s <= 32, every width the callers use), 8 blocks an SM:
// 32 registers and 48 bytes of spills, where ptxas's own 40 registers left
// 48 warps an SM; more groups in flight beat the spills (R-MAT 23 on an
// H100: 12.9 -> 11.5 ms at s = 24, 7.7 -> 7.5 ms at s = 16).
template <int G, int NC>
__global__ void __launch_bounds__(32 * WARPS, NC == 1 ? 8 : 1)
    gather_kernel(const float* __restrict__ x, int kdim, int s, const int* __restrict__ src,
                  const int* __restrict__ seg, int n_seg, int n_long_seg,
                  float* __restrict__ out, double* __restrict__ partials) {
  constexpr int GROUPS = 32 / G;
  const int lane = threadIdx.x % 32;
  const int glane = lane % G;
  const int w = (blockIdx.x * WARPS + threadIdx.x / 32) * GROUPS + lane / G;
  if (w >= n_seg) return;  // group-uniform: no shuffle below misses a lane of its group
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane / G * G);
  const int row = seg[3 * w];
  const int lo = seg[3 * w + 1];
  const int hi = seg[3 * w + 2];
  const bool piece = w < n_long_seg;

  for (int c0 = 0; c0 < s; c0 += G * NC) {
    double acc[NC];
    bool mine[NC];  // this lane's column j lies inside s
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc[j] = 0.0;
      mine[j] = c0 + j * G + glane < s;
    }
    for (int base = lo; base < hi; base += CHUNK) {
      int idx[CHUNK / G];
#pragma unroll
      for (int q = 0; q < CHUNK / G; ++q) {
        const int e = base + q * G + glane;
        idx[q] = e < hi ? src[e] : -1;  // -1: past the segment, reads nothing
      }
      const int n = min(CHUNK, hi - base);
#pragma unroll
      for (int b = 0; b < CHUNK; b += BATCH) {
        if (b >= n) break;  // group-uniform
        float v[BATCH][NC];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int c = __shfl_sync(mask, idx[(b + u) / G], (b + u) % G, G);
          const bool ok = static_cast<unsigned>(c) < static_cast<unsigned>(kdim);
          const float* p = x + static_cast<size_t>(ok ? c : 0) * s + c0 + glane;
#pragma unroll
          for (int j = 0; j < NC; ++j) v[u][j] = ok && mine[j] ? __ldg(p + j * G) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[j] = __dadd_rn(acc[j], static_cast<double>(v[u][j]));
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (!mine[j]) continue;
      const int col = c0 + j * G + glane;
      if (piece)
        partials[static_cast<size_t>(w) * s + col] = acc[j];
      else
        out[static_cast<size_t>(row) * s + col] = __double2float_rn(acc[j]);
    }
  }
}

// 2. One warp per long row: out = f32(Σ its pieces' partials, in order).
__global__ void __launch_bounds__(32 * WARPS)
    combine_kernel(const double* __restrict__ partials, const int* __restrict__ seg,
                   const int* __restrict__ long_ptr, int n_long_rows, float* __restrict__ out,
                   int s) {
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= n_long_rows) return;
  const int j0 = long_ptr[r];
  const int j1 = long_ptr[r + 1];
  const size_t row = static_cast<size_t>(seg[3 * j0]) * s;
  for (int c = threadIdx.x % 32; c < s; c += 32) {
    double acc = 0.0;
    for (int j = j0; j < j1; ++j) acc = __dadd_rn(acc, partials[static_cast<size_t>(j) * s + c]);
    out[row + c] = __double2float_rn(acc);
  }
}

struct Gather {
  const float* x;
  int kdim, s;
  const int* src;
  const int* seg;
  int n_seg, n_long_seg;
  float* out;
  double* partials;
};

template <int G, int NC>
void launch_gather(const Gather& g, cudaStream_t stream) {
  constexpr int per_block = WARPS * (32 / G);
  gather_kernel<G, NC><<<(g.n_seg + per_block - 1) / per_block, 32 * WARPS, 0, stream>>>(
      g.x, g.kdim, g.s, g.src, g.seg, g.n_seg, g.n_long_seg, g.out, g.partials);
}

template <int G>
void launch_gather_nc(int nc, const Gather& g, cudaStream_t stream) {
  switch (nc) {
    case 1: return launch_gather<G, 1>(g, stream);
    case 2: return launch_gather<G, 2>(g, stream);
    case 3: return launch_gather<G, 3>(g, stream);
    default: return launch_gather<G, 4>(g, stream);
  }
}

}  // namespace

// x f32 [kdim, s], out f32 [m, s] with m = n_seg - n_long_seg + n_long_rows
// (every row written), partials the wrapper's f64 [n_long_seg, s] scratch
// (may be empty).  All contiguous, on `device`.
extern "C" int arc_product_f32(const void* x, const void* src, const void* seg,
                               const void* long_ptr, void* out, void* partials, int kdim, int s,
                               int n_seg, int n_long_seg, int n_long_rows, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s <= 0 || kdim < 0 || n_seg < 0 || n_long_rows < 0 || n_long_seg < n_long_rows ||
      n_long_seg > n_seg)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const Gather g{static_cast<const float*>(x), kdim, s, static_cast<const int*>(src),
                 static_cast<const int*>(seg), n_seg, n_long_seg, static_cast<float*>(out),
                 static_cast<double*>(partials)};
  if (n_seg > 0) {
    if (s <= 16) {
      launch_gather<16, 1>(g, st);
    } else {
      launch_gather_nc<32>(std::min(4, (s + 31) / 32), g, st);
    }
  }
  if (n_long_rows > 0)
    combine_kernel<<<(n_long_rows + WARPS - 1) / WARPS, 32 * WARPS, 0, st>>>(
        g.partials, g.seg, static_cast<const int*>(long_ptr), n_long_rows, g.out, s);
  return static_cast<int>(cudaGetLastError());
}
