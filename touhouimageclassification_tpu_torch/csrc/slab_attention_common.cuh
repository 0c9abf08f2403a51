// Helpers shared by the slab attention kernels (slab_attention_fwd.cu, K1, and
// slab_attention_bwd.cu, K2): element pairs, rounding to the input type, warp
// reductions and the padded shared-memory row pitch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace tic {

constexpr int kBlockRows = 64;  // rows of N one block takes
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ typename Pair<T>::type from_floats(float a, float b);
template <>
__device__ __forceinline__ float2 from_floats<float>(float a, float b) {
  return make_float2(a, b);
}
template <>
__device__ __forceinline__ __nv_bfloat162 from_floats<__nv_bfloat16>(float a,
                                                                     float b) {
  return __floats2bfloat162_rn(a, b);
}

// Rounds an f32 value to the input type and back (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row pitch of a head row staged in shared memory. D + 2 makes the pitch an
// odd number of pairs, so 32 lanes reading pairs of 32 different rows hit 32
// different banks.
template <int D>
constexpr int kStride = D + 2;

// Stages columns `col` ... col + D of `rows` rows, `ld` elements apart, into
// shared memory at pitch kStride<D>, in element pairs, with every thread of
// the block.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows,
                                           size_t ld) {
  using T2 = typename Pair<T>::type;
  constexpr int kPairs = D / 2;
  for (int i = threadIdx.x; i < rows * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int p = i - r * kPairs;
    *reinterpret_cast<T2*>(dst + r * kStride<D> + 2 * p) =
        *reinterpret_cast<const T2*>(src + r * ld + 2 * p);
  }
}

// Loads one head row of D elements (pairs, broadcast to every lane) as f32.
template <typename T, int D>
__device__ __forceinline__ void load_row(float (&x)[D], const T* src) {
  using T2 = typename Pair<T>::type;
  const T2* row = reinterpret_cast<const T2*>(src);
#pragma unroll
  for (int p = 0; p < D / 2; ++p) {
    const float2 v = to_float2(row[p]);
    x[2 * p] = v.x;
    x[2 * p + 1] = v.y;
  }
}

// x . y for a register row x and a shared-memory row y, as one f32 FMA chain
// in element order (so a pass that holds y in registers and reads x from
// shared memory gets the same bits).
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float (&x)[D], const T* y) {
  using T2 = typename Pair<T>::type;
  const T2* row = reinterpret_cast<const T2*>(y);
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < D / 2; ++p) {
    const float2 v = to_float2(row[p]);
    s = fmaf(x[2 * p], v.x, s);
    s = fmaf(x[2 * p + 1], v.y, s);
  }
  return s;
}

}  // namespace tic
