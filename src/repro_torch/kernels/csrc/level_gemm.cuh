// Pipelined f32 main loop of the dense level kernels: K1 and K2
// (frontier_spmm.cu, dependency_spmm.cu, on a square adjacency), K3 and
// K4 (partial_spmm.cu, on a rectangular 2-D block):
//
//     acc = A[row0 : row0+BM, :] @ G[:, col0 : col0+BS]
//
// with A [m, kdim] row-major (f32 or bf16, 0/1 entries) and G the
// operand — the masked frontier σ ⊙ [d == lvl-1] (K1/K3) or g (K2/K4) —
// written once a launch by the operand pass (level_operand.cuh) into a
// [kdim, ld] f32 scratch, ld = s rounded up to a multiple of 4 so that
// every scratch row is 16-byte aligned and its pad columns hold 0.
//
// Bound: 2·m·kdim·s FLOP of f32 FFMA (24.6 ms at n = 65536, s = 192, and
// 16.4 ms at s = 128, on an H100 at 67 TFLOP/s) against 5.1 ms (f32 A) or
// 2.6 ms (bf16 A) to stream A, and 0.06 ms for the operand pass: f32
// compute.  No tensor cores and no TF32 (g is fractional and σ exact; the
// reference sums in f32), no --use_fast_math: the design feeds the FFMA
// pipe.
//
//   * A ring of STAGES shared-memory stages, each an A[BM x BK] and a
//     G[BK x BS] tile, filled by 16-byte cp.async.cg copies: while step k
//     multiplies, the copies of the next STAGES-1 steps are in flight
//     (they are issued after the step's first group of products, so the
//     warps leaving the step's one __syncthreads start on FFMA).  Dynamic
//     shared memory, 56-129 KB a block, so the launcher raises the 48 KB
//     limit per instantiation.
//   * A is stored k-contiguous, as it lies in device memory (no transpose
//     through registers), its rows padded by 16 bytes; a thread reads 4
//     k-values of one of its rows at once (float4 for f32; 8 bytes for
//     bf16, widened to floats at the read with a shift and a mask: a bf16
//     A is copied as bf16, half the bytes).
//   * 8x8 register micro-tiles of f32 FFMA.  Each warp owns a 32 x 64
//     tile of the output; lane = 8·ty + tx holds rows ty + 4i (i < 8) and
//     columns tx*4 + [0, 4) and 32 + tx*4 + [0, 4).  So one read of A by a
//     warp touches 4 neighbouring rows (4 distinct bank groups with the
//     pad) and one float4 read of G 8 consecutive float4: one shared-memory
//     wavefront each.
//   * Column tiles BS of 64, 128 and 192 (kernels/level_gemm.py:
//     column_tile picks one from s) with 16 x BS/8 threads: s = 128 and
//     s = 192, the forward and backward widths of the main path, each run
//     one column tile with no dead columns.  The 192 tile (384 threads, one
//     block an SM at <= 168 registers) steps 32 deep in 3 stages, which
//     halves its barriers; the others, capped at 128 registers for 2-4
//     blocks an SM, have no room for the deeper step and take 16 in 4.
//   * Each output's sum runs over k in order inside one thread: no atomics,
//     no split-k, so a launch is bitwise reproducible.
//
// Edges.  The 16-byte copies of A need 16-byte aligned rows (kdim·size a
// multiple of 16 and an aligned base); the wrapper asks for the FAST path
// only then.  The other instantiation loads A element by element into the
// same ring (plain loads, masked), the operand still by cp.async.  Ragged
// m, kdim and s are zero-filled: cp.async with a source size of 0 for
// rows or chunks past the edge (kdim is a multiple of the chunk on the
// FAST path; the operand's columns past s are the scratch's zero pad).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "level_operand.cuh"

namespace bc {
namespace gemm {

constexpr int TM = 8;        // micro-tile rows per thread
constexpr int TN = 8;        // micro-tile columns per thread
constexpr int A_VEC = 4;     // k values of an A row per fragment read (load_a)
constexpr int A_PAD = 16;    // bytes after each A row in shared memory

// A block tile: BM output rows x BS output columns, (BM/8) x (BS/8)
// threads of 8x8 outputs, a ring of STAGES steps of BK; FAST: 16-byte
// copies of A.
template <int BM_, int BS_, int BK_, int STAGES_, bool FAST_> struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BS = BS_;
  static constexpr int BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool FAST = FAST_;
  static constexpr int THREADS = (BM / 8) * (BS / 8);
  // blocks an SM that __launch_bounds__ asks registers for: <= 128 a
  // thread at 128 or 256 threads, <= 168 at 384
  static constexpr int MIN_BLOCKS = THREADS <= 256 ? 512 / THREADS : 1;
};

template <typename AT, typename T> __host__ __device__ constexpr int a_row_bytes() {
  return T::BK * int(sizeof(AT)) + A_PAD;
}
template <typename AT, typename T> __host__ __device__ constexpr int shared_bytes() {
  return T::STAGES * (T::BM * a_row_bytes<AT, T>() + T::BK * T::BS * 4);
}

template <typename AT> __device__ __forceinline__ AT zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// A[r, k .. k+4) as floats from a shared-memory A row (k a multiple of
// 4): one 16-byte (f32) or 8-byte (bf16) read.
__device__ __forceinline__ void load_a(const float* row, int k, float (&out)[A_VEC]) {
  const float4 v = *reinterpret_cast<const float4*>(row + k);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
// bf16 is the high half of an f32: a pair (low element first) widens with
// one shift and one mask, exactly.
__device__ __forceinline__ void load_a(const __nv_bfloat16* row, int k, float (&out)[A_VEC]) {
  const uint2 quad = *reinterpret_cast<const uint2*>(row + k);
  out[0] = __uint_as_float(quad.x << 16);
  out[1] = __uint_as_float(quad.x & 0xffff0000u);
  out[2] = __uint_as_float(quad.y << 16);
  out[3] = __uint_as_float(quad.y & 0xffff0000u);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a thread's 8x8 micro-tile lies in the block tile: warp w owns
// rows (w % (BM/32))·32 + [0, 32) and columns (w / (BM/32))·64 + [0, 64);
// lane = 8·ty + tx holds rows ty + 4i and columns tx*4 + [0, 4) and
// 32 + tx*4 + [0, 4) of them.  frag_col(0) and frag_col(4) start the two
// float4 groups.
template <typename T> __device__ __forceinline__ int frag_row(int i) {
  const int tid = threadIdx.x;
  return (tid / 32) % (T::BM / 32) * 32 + (tid % 32) / 8 + 4 * i;
}
template <typename T> __device__ __forceinline__ int frag_col(int j) {
  const int tid = threadIdx.x;
  const int base = (tid / 32) / (T::BM / 32) * 64 + (tid % 8) * 4;
  return (j < 4) ? base + j : base + 32 + (j - 4);
}

// acc[i][j] = Σ_k A[row0 + frag_row<T>(i), k] · G[k, col0 + frag_col<T>(j)];
// rows >= m, k >= kdim and columns >= ld contribute zero.  `smem` is the
// block's dynamic shared memory, shared_bytes<AT, T>() long.
template <typename AT, typename T>
__device__ __forceinline__ void main_loop(const AT* __restrict__ A, int m, int kdim,
                                          const float* __restrict__ G, int ld, int row0,
                                          int col0, unsigned char* smem,
                                          float (&acc)[TM][TN]) {
  constexpr int BM = T::BM;
  constexpr int BS = T::BS;
  constexpr int BK = T::BK;
  constexpr int STAGES = T::STAGES;
  constexpr int THREADS = T::THREADS;
  constexpr int A_ROW = a_row_bytes<AT, T>();
  constexpr int A_STAGE = BM * A_ROW;
  constexpr int A_EPC = 16 / int(sizeof(AT));        // A elements per 16-byte chunk
  constexpr int A_CPR = BK / A_EPC;                  // chunks per A row of a stage
  constexpr int A_CHUNKS = BM * A_CPR;
  constexpr int G_CPR = BS / 4;                      // chunks per G row of a stage
  constexpr int G_CHUNKS = BK * G_CPR;
  static_assert(BM % 32 == 0 && BS % 64 == 0 && A_ROW % 16 == 0 && BK % A_VEC == 0,
                "warp tiles of 32 x 64; 16-byte aligned rows");

  unsigned char* a_smem = smem;
  float* g_smem = reinterpret_cast<float*>(smem + STAGES * A_STAGE);
  const int tid = threadIdx.x;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // issue (FAST) or perform the copies of k-step kt into ring slot `slot`
  auto load = [&](int slot, int kt) {
    const int k0 = kt * BK;
    unsigned char* as = a_smem + slot * A_STAGE;
    if constexpr (T::FAST) {
#pragma unroll
      for (int r = 0; r < (A_CHUNKS + THREADS - 1) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        if (A_CHUNKS % THREADS != 0 && e >= A_CHUNKS) break;
        const int row = e / A_CPR;
        const int c = e % A_CPR;
        const int gr = row0 + row;
        const int gk = k0 + c * A_EPC;
        const bool ok = gr < m && gk < kdim;
        cp_async16(as + row * A_ROW + c * 16,
                   ok ? A + static_cast<size_t>(gr) * kdim + gk : A, ok);
      }
    } else {
#pragma unroll
      for (int r = 0; r < (BM * BK + THREADS - 1) / THREADS; ++r) {
        const int e = tid + r * THREADS;  // neighbouring threads walk along k
        if ((BM * BK) % THREADS != 0 && e >= BM * BK) break;
        const int row = e / BK;
        const int kk = e % BK;
        const int gr = row0 + row;
        const int gk = k0 + kk;
        reinterpret_cast<AT*>(as + row * A_ROW)[kk] =
            gr < m && gk < kdim ? A[static_cast<size_t>(gr) * kdim + gk] : zero<AT>();
      }
    }
    float* gs = g_smem + slot * (BK * BS);
#pragma unroll
    for (int r = 0; r < (G_CHUNKS + THREADS - 1) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      if (G_CHUNKS % THREADS != 0 && e >= G_CHUNKS) break;
      const int kk = e / G_CPR;
      const int c = (e % G_CPR) * 4;
      const int gk = k0 + kk;
      const int gj = col0 + c;
      const bool ok = gk < kdim && gj < ld;
      cp_async16(gs + kk * BS + c, ok ? G + static_cast<size_t>(gk) * ld + gj : G, ok);
    }
  };

  const int ktiles = (kdim + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }
  // the copies of a step are issued after the first group of the step's
  // products, so that the warps leaving the barrier start on FFMA
  static_assert(BK >= 2 * A_VEC, "a step holds at least two fragment groups");
  for (int kt = 0; kt < ktiles; ++kt) {
    // step kt's copies have landed (each thread's own), and after the
    // barrier every thread's have, and every thread is done with step kt-1,
    // whose slot the copies of step kt + STAGES - 1 overwrite
    cp_async_wait<STAGES - 2>();
    __syncthreads();

    const int slot = kt % STAGES;
    const AT* as = reinterpret_cast<const AT*>(a_smem + slot * A_STAGE);
    const float* gs = g_smem + slot * (BK * BS);
#pragma unroll
    for (int kk = 0; kk < BK; kk += A_VEC) {
      if (kk == A_VEC) {
        const int next = kt + STAGES - 1;
        if (next < ktiles) load(next % STAGES, next);
        cp_async_commit();
      }
      float a[TM][A_VEC];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        load_a(as + frag_row<T>(i) * (A_ROW / int(sizeof(AT))), kk, a[i]);
#pragma unroll
      for (int h = 0; h < A_VEC; ++h) {
        const float* grow = gs + (kk + h) * BS;
        const float4 b0 = *reinterpret_cast<const float4*>(grow + frag_col<T>(0));
        const float4 b1 = *reinterpret_cast<const float4*>(grow + frag_col<T>(4));
        const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][h], b[j], acc[i][j]);
      }
    }
  }
}

// The block grid: column tiles fastest, so the blocks that share an A row
// tile (s > BS) run side by side and find it in L2; row tiles on y
// (<= 65535 of them, kernels/ops.py:MAX_N).
template <typename T> inline dim3 grid(int m, int s) {
  return dim3((s + T::BS - 1) / T::BS, (m + T::BM - 1) / T::BM);
}

// Raise an instantiation's dynamic shared-memory limit above the default
// 48 KB and ask for the largest carveout, so that T::MIN_BLOCKS blocks
// fit on an SM.
template <typename Kernel> cudaError_t prepare(Kernel* kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// f(Tile{}) for the tile of column width bs: one instantiation per
// column tile (kernels/level_gemm.py:COLUMN_TILES lists the cases);
// an unknown width is refused with cudaErrorInvalidValue.
template <typename F> cudaError_t dispatch(int bs, bool fast, F&& f) {
  switch (bs) {
    case 64: return fast ? f(Tile<128, 64, 16, 4, true>{}) : f(Tile<128, 64, 16, 4, false>{});
    case 128:
      return fast ? f(Tile<128, 128, 16, 4, true>{}) : f(Tile<128, 128, 16, 4, false>{});
    case 192:
      return fast ? f(Tile<128, 192, 32, 3, true>{}) : f(Tile<128, 192, 32, 3, false>{});
    default: return cudaErrorInvalidValue;
  }
}

// The checks every launcher makes before it writes anything: the scratch
// stride ld is s rounded up to 4 and the scratch 16-byte aligned; the FAST
// path only for 16-byte aligned A rows.
template <typename AT>
cudaError_t check(const void* A, const void* operand, int m, int kdim, int s, int ld,
                  bool fast) {
  if (m < 0 || kdim < 0 || s <= 0 || ld != (s + 3) / 4 * 4) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(operand) % 16 != 0) return cudaErrorMisalignedAddress;
  if (fast && (reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
               (static_cast<size_t>(kdim) * sizeof(AT)) % 16 != 0))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace gemm
}  // namespace bc
