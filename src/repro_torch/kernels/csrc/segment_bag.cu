// K7 — EmbeddingBag (sum): the gather-reduce of the DLRM embedding lookup.
//
// Replaces the TPU kernel of the JAX package
//   kernels/segment_bag.py:segment_bag_kernel (wrapper segment_bag_pallas,
//   public op ops.segment_bag).
// With a table [V, D] (row-major f32 or bf16), ids idx i32 [B, L] (any
// negative id is padding) and optional weights w f32 [B, L]:
//
//     out[b, :] = Σ_l w[b,l] · table[idx[b,l], :]      (f32, [B, D])
//
// Bound: bytes.  Each bag moves L ids (+ L weights), L rows and one output
// row, and does 2·L·D FLOP on them (~0.1 FLOP a byte).  At DLRM-RM2
// serve_bulk (B = 262 144 × 26 bags, L = 1, D = 64, a flat table of
// 272 629 760 rows) the least the card can move is the distinct rows read
// once, the ids, and the [B, 64] f32 output written once: ≈ 3.5 GB
// (1.05 ms at 3.35 TB/s) for uniform ids, ≈ 1.8 GB for click-log (Zipf)
// ids, whose hot rows repeat.
//
// Design.  The Pallas kernel walks a sequential grid (B, D/bd, L) and
// keeps each bag's output block resident in VMEM across the L steps.
// Here a group of G threads (G = the next power of two ≥ D/VEC, at most
// one warp) owns one bag: each thread holds VEC columns of the sum in f32
// registers, loops over the bag's L ids, reads its 16 bytes of each row
// with one vectorised read-only load (float4, or 8 bf16), and stores its
// columns once at the end.  So every output row is written exactly once:
// no atomics, no zero pre-fill, and the table is read in place — never
// padded to a block width (the JAX wrapper pads [V, D] to [V, 128], which
// would copy 130 GB at full width).  Neighbouring groups take
// neighbouring bags, so the ids are read coalesced; a padded id reads no
// row at all.  Bags map to blockIdx.x (6 815 744 bags at serve_bulk
// exceed gridDim.y's 65 535), and every offset into the table is 64-bit:
// id·D reaches 1.74e10 at full width.  A D that is not a multiple of VEC,
// or a table that is not 16-byte aligned, takes the scalar path.
//
// Each term is one f32 multiply and one f32 add, rounded separately
// (__fmul_rn/__fadd_rn, never contracted to an FMA), taken in id order:
// the plain version (kernels/ref.py:segment_bag_ref) sums in the same
// order with the same roundings, so the two agree bit for bit on finite
// tables.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct RowVec;

// 16 bytes of an f32 row: 4 values
template <>
struct RowVec<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ static float scalar(const float* p) { return __ldg(p); }
};

// 16 bytes of a bf16 row: 8 values, widened to f32 exactly
template <>
struct RowVec<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32: widen by shifting
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    segment_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                       const float* __restrict__ weights, float* __restrict__ out,
                       long long num_bags, int L, int D, bool vec_rows, bool vec_out) {
  constexpr int VEC = RowVec<T>::kVec;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long bag = t / G;
  const int lane = static_cast<int>(t % G);
  if (bag >= num_bags) return;
  const int* bag_idx = idx + bag * L;
  const float* bag_w = weights != nullptr ? weights + bag * L : nullptr;
  float* bag_out = out + bag * static_cast<long long>(D);

  for (int c0 = lane * VEC; c0 < D; c0 += G * VEC) {
    const int width = min(VEC, D - c0);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int id = __ldg(bag_idx + l);
      if (id < 0) continue;  // padding: weight 0, no row read
      const float w = bag_w != nullptr ? __ldg(bag_w + l) : 1.0f;
      const T* row = table + static_cast<long long>(id) * D + c0;  // 64-bit offset
      float v[VEC];
      if (vec_rows && width == VEC) {
        RowVec<T>::load(row, v);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = i < width ? RowVec<T>::scalar(row + i) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, v[i]));
    }
    if (vec_out && width == VEC) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(bag_out + c0 + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (i < width) bag_out[c0 + i] = acc[i];
    }
  }
}

template <typename T, int G>
int launch_g(const T* table, const int* idx, const float* weights, float* out,
             long long num_bags, int L, int D, bool vec_rows, bool vec_out,
             cudaStream_t stream) {
  const long long blocks = (num_bags * G + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  segment_bag_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table, idx, weights, out, num_bags, L, D, vec_rows, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* table, const void* idx, const void* weights, void* out,
           long long num_bags, int L, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_bags <= 0 || L < 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = RowVec<T>::kVec;
  const int chunks = (D + VEC - 1) / VEC;
  int g = 1;
  while (g < chunks && g < 32) g *= 2;
  const bool vec_rows = D % VEC == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const bool vec_out = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* tb = static_cast<const T*>(table);
  const auto* ix = static_cast<const int*>(idx);
  const auto* wt = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1:
      return launch_g<T, 1>(tb, ix, wt, o, num_bags, L, D, vec_rows, vec_out, st);
    case 2:
      return launch_g<T, 2>(tb, ix, wt, o, num_bags, L, D, vec_rows, vec_out, st);
    case 4:
      return launch_g<T, 4>(tb, ix, wt, o, num_bags, L, D, vec_rows, vec_out, st);
    case 8:
      return launch_g<T, 8>(tb, ix, wt, o, num_bags, L, D, vec_rows, vec_out, st);
    case 16:
      return launch_g<T, 16>(tb, ix, wt, o, num_bags, L, D, vec_rows, vec_out, st);
    default:
      return launch_g<T, 32>(tb, ix, wt, o, num_bags, L, D, vec_rows, vec_out, st);
  }
}

}  // namespace

// weights may be NULL (every weight 1).
extern "C" int segment_bag_f32(const void* table, const void* idx, const void* weights,
                               void* out, long long num_bags, int L, int D, int device,
                               void* stream) {
  return launch<float>(table, idx, weights, out, num_bags, L, D, device, stream);
}

extern "C" int segment_bag_bf16(const void* table, const void* idx, const void* weights,
                                void* out, long long num_bags, int L, int D, int device,
                                void* stream) {
  return launch<__nv_bfloat16>(table, idx, weights, out, num_bags, L, D, device, stream);
}
